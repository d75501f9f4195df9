"""The port's LoRA (tpu_bootstrap_torch/workload/lora.py) held to the JAX
reference's (tpu_bootstrap/workload/lora.py) on the CPU, in f32, at
tests/test_lora.py's sizes, on the reference's own base params and
adapters carried over by ``bridge.params_from_numpy``: the adapter init's
shapes and scales, zero-init identity, apply_lora leaf by leaf on float,
int8 and int4 bases, LoRA and QLoRA steps (losses and adapter gradients
step by step), training that moves the loss and leaves the base's bytes
alone, merge == on the fly, a checkpoint resume, and the refusals.

Tolerances, each for a reason: where apply_lora only dequantizes, the
leaves are bitwise the reference's (quantization is bit-equal); where it
adds A @ B, to f32 rounding (rtol 1e-6) of a rank-r sum taken in another
order. Losses agree to 1e-5 relative and adapter gradients to 5e-5
(tests/test_torch_train.py's limits). Adapters are held only where the
gradients are above 1e-4: one Adam step turns a gradient difference of a
few 1e-7 where |g| is near 1e-7 into a step difference of a few 1e-6
(ROADMAP.md, queue 3), and B starts at zero, so A's first gradient is zero and
its first update is the weight decay alone. There, as in
tests/test_torch_train.py, the first step's update agrees to 1e-4
relative and the adapters after every step to 1e-4 absolute (1% of one
step, lr = 1e-2): later steps divide each moment by the square root of a
sum over steps, which carries a gradient's relative difference into the
update.
The three tests of the reference that need its 8-device mesh run on gloo
ranks (tests/test_torch_mesh_finetune.py); here such a mesh refuses
without a process group of its size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import lora as jlora
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh
from tpu_bootstrap.workload.train import TrainConfig as JTrainConfig
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import checkpoint as tckpt
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import flash_attention as tfa
from tpu_bootstrap_torch.workload import lora as tlora
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import quant as tquant
from tpu_bootstrap_torch.workload import train as ttrain

torch.set_num_threads(2)

SIZES = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
             embed_dim=32, mlp_dim=64, max_seq_len=16)
JMODEL = jmodel.ModelConfig(**SIZES)
TMODEL = tmodel.ModelConfig(**SIZES)
RANK, ALPHA = 4, 8.0
TARGETS = {"qv": ("wq", "wv"), "attn": ("wq", "wk", "wv", "wo"),
           "mlp": ("w_up", "w_down")}
KINDS = ("float", "int8", "int4")
LR = 1e-2
STEPS = 4

_jloss = jax.jit(jmodel.loss_fn, static_argnums=2)


def _lcfgs(targets=("wq", "wv")):
    return (jlora.LoraConfig(rank=RANK, alpha=ALPHA, targets=targets),
            tlora.LoraConfig(rank=RANK, alpha=ALPHA, targets=targets))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return bridge.params_from_numpy(_np(tree), device="cpu")


def _flat(tree, path=()):
    """{path: numpy array} of a params or adapter tree of either package
    (quantized leaves by their q and s)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + (i,)).items()}
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return {path + ("q",): _arr(tree.q), path + ("s",): _arr(tree.s)}
    return {path: _arr(tree)}


def _arr(x):
    # A copy: the reference's step donates its adapters.
    return (x.detach().numpy().copy() if isinstance(x, torch.Tensor)
            else np.array(x))


@pytest.fixture(scope="module")
def jbase():
    return jax.jit(jmodel.init_params, static_argnums=0)(
        JMODEL, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tokens():
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                       64))


def _bases(jbase, kind):
    """(reference base, port base): the float params, or each package's
    own quantizer on them (bit-equal)."""
    tbase = _to_port(jbase)
    if kind == "int8":
        return jquant.quantize_params(jbase), tquant.quantize_params(tbase)
    if kind == "int4":
        return jquant.quantize_params4(jbase), tquant.quantize_params4(tbase)
    return jbase, tbase


def _adapters(jbase, jl, seed):
    """The reference's adapter tree with B drawn nonzero (numpy, seeded),
    as after some training."""
    rng = np.random.default_rng(seed)
    return {"blocks": [{name: {"a": ad["a"], "b": jnp.asarray(
        0.1 * rng.standard_normal(ad["b"].shape), jnp.float32)}
        for name, ad in blk.items()} for blk in jl["blocks"]]}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("targets", list(TARGETS))
def test_init_lora_shapes_and_scales(jbase, kind, targets):
    jcfg, tcfg = _lcfgs(TARGETS[targets])
    jb, tb = _bases(jbase, kind)
    want = jlora.init_lora(jb, jcfg, jax.random.PRNGKey(2))
    got = tlora.init_lora(tb, tcfg, seed=2, device="cpu")
    assert len(got["blocks"]) == len(want["blocks"])
    for g_blk, w_blk in zip(got["blocks"], want["blocks"]):
        assert set(g_blk) == set(w_blk) == set(TARGETS[targets])
        for name, g in g_blk.items():
            for part in ("a", "b"):
                assert tuple(g[part].shape) == w_blk[name][part].shape
                assert g[part].dtype == torch.float32
            assert not g["b"].any()
            k_in = g["a"].shape[0]
            std = float((g["a"] * np.sqrt(k_in)).std())
            assert 0.7 < std < 1.3, (name, std)
    again = tlora.init_lora(tb, tcfg, seed=2, device="cpu")
    other = tlora.init_lora(tb, tcfg, seed=3, device="cpu")
    for g_blk, a_blk, o_blk in zip(got["blocks"], again["blocks"],
                                   other["blocks"]):
        for name, g in g_blk.items():
            assert torch.equal(g["a"], a_blk[name]["a"])
            assert not torch.equal(g["a"], o_blk[name]["a"])


@pytest.mark.parametrize("kind", KINDS)
def test_zero_init_is_identity(jbase, tokens, kind):
    """B = 0: the adapted model is the base (dequantized) model, and its
    loss is the reference's."""
    jcfg, tcfg = _lcfgs()
    jb, tb = _bases(jbase, kind)
    lora = tlora.init_lora(tb, tcfg, seed=2, device="cpu")
    eff = tlora.apply_lora(tb, lora, tcfg)
    got = tmodel.loss_fn(eff, torch.from_numpy(tokens), TMODEL)
    if kind == "float":
        want_base = tmodel.loss_fn(tb, torch.from_numpy(tokens), TMODEL)
        assert torch.equal(got, want_base)
    for blk, qblk in zip(eff["blocks"], tb["blocks"]):
        for name in tlora._FORWARD_LEAVES:
            w = qblk[name]
            plain = (tquant.dequantize_any(w).reshape(w.shape)
                     if tquant.is_quantized(w) else w)
            assert torch.equal(blk[name], plain), name
    jeff = jlora.apply_lora(jb, jlora.init_lora(jb, jcfg,
                                                jax.random.PRNGKey(2)), jcfg)
    np.testing.assert_allclose(
        got.item(), float(_jloss(jeff, jnp.asarray(tokens), JMODEL)),
        rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("targets", list(TARGETS))
def test_apply_lora_matches_reference(jbase, kind, targets):
    """Leaf by leaf on the same bridged base and adapters: bitwise where
    apply_lora only dequantizes (or passes a leaf through), to f32
    rounding where it adds A @ B; the same keys dropped."""
    jcfg, tcfg = _lcfgs(TARGETS[targets])
    jb, tb = _bases(jbase, kind)
    jl = _adapters(jbase, jlora.init_lora(jb, jcfg, jax.random.PRNGKey(2)),
                   seed=5)
    want = _flat(jlora.apply_lora(jb, jl, jcfg))
    got = _flat(tlora.apply_lora(tb, _to_port(jl), tcfg))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path[0] == "blocks" and path[2] in TARGETS[targets]:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))


def _jgrad_fn(jb, jcfg, tokens, attn=None):
    def loss(lora):
        return jmodel.loss_from_inputs(jlora.apply_lora(jb, lora, jcfg),
                                       tokens[:, :-1], tokens[:, 1:], JMODEL,
                                       attn_fn=attn)
    return jax.jit(jax.grad(loss))


def _tgrads(tb, tl, tcfg, tokens, attn=None):
    leaves = ttrain.tree_leaves(tl)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = tmodel.loss_from_inputs(tlora.apply_lora(tb, tl, tcfg),
                                       tokens[:, :-1], tokens[:, 1:], TMODEL,
                                       attn_fn=attn)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    # Rebuild the tree's shape so _flat names each gradient by its path.
    it = iter(grads)
    return {"blocks": [{n: {k: next(it) for k in ad} for n, ad in blk.items()}
                       for blk in tl["blocks"]]}


def _lockstep(jbase, tokens, kind, targets, attention="dense"):
    """STEPS LoRA steps of each package from the reference's adapters:
    before each step, both packages' adapter gradients at their own
    adapters; the step's losses; the adapters at the start and the end."""
    jcfg, tcfg = _lcfgs(targets)
    jb, tb = _bases(jbase, kind)
    jattn = tattn = None
    if attention == "flash":
        from tpu_bootstrap.workload import flash_attention as jfa

        jattn = jfa.make_flash_attn_fn(block_size=16)
        tattn = tfa.make_flash_attn_fn()
    jstep, jopt = jlora.make_lora_train_step(
        JTrainConfig(model=JMODEL, learning_rate=LR), build_mesh(JMesh()),
        jb, jcfg, attn_fn=jattn)
    tstep, topt = tlora.make_lora_train_step(
        ttrain.TrainConfig(model=TMODEL, learning_rate=LR),
        ttrain.MeshConfig(), tb, tcfg, attn_fn=tattn)
    jl = jlora.init_lora(jb, jcfg, jax.random.PRNGKey(2))
    start = _flat(jl)
    tl = _to_port(jl)
    jstate, tstate = jopt.init(jl), topt.init(tl)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    jgrads = _jgrad_fn(jb, jcfg, jt, jattn)
    out = {"jloss": [], "tloss": [], "jgrad": [], "tgrad": [],
           "start": start}
    for _ in range(STEPS):
        out["jgrad"].append(_flat(jgrads(jl)))
        out["tgrad"].append(_flat(_tgrads(tb, tl, tcfg, tt, tattn)))
        jl, jstate, jloss = jstep(jl, jstate, jt)
        tl, tstate, tloss = tstep(tl, tstate, tt)
        out["jloss"].append(float(jloss))
        out["tloss"].append(tloss.item())
        if "jfirst" not in out:
            out["jfirst"], out["tfirst"] = _flat(jl), _flat(tl)
    out["jend"], out["tend"] = _flat(jl), _flat(tl)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("targets", ["qv", "mlp"])
def test_steps_match_reference(jbase, tokens, kind, targets):
    """LoRA (float base) and QLoRA (int8, int4 bases), step by step:
    each step's loss, each step's adapter gradients, the adapters after
    the steps where every step's gradient is above 1e-4."""
    run = _lockstep(jbase, tokens, kind, TARGETS[targets])
    np.testing.assert_allclose(run["tloss"], run["jloss"], rtol=1e-5)
    assert run["tloss"][-1] < run["tloss"][0]
    for jg, tg in zip(run["jgrad"], run["tgrad"]):
        assert set(jg) == set(tg)
        for path, w in jg.items():
            np.testing.assert_allclose(tg[path], w, atol=5e-5, rtol=5e-5,
                                       err_msg=str(path))
    held = 0
    for path, p0 in run["start"].items():
        big1 = np.abs(run["jgrad"][0][path]) > 1e-4
        np.testing.assert_allclose((run["tfirst"][path] - p0)[big1],
                                   (run["jfirst"][path] - p0)[big1],
                                   rtol=1e-4, err_msg=str(path))
        big = np.all([np.abs(g[path]) > 1e-4 for g in run["jgrad"]], axis=0)
        np.testing.assert_allclose(run["tend"][path][big],
                                   run["jend"][path][big], atol=1e-4,
                                   err_msg=str(path))
        held += int(big.sum())
    assert held > 0


def test_flash_steps_match_reference(jbase, tokens):
    """The LoRA step with the flash attn_fn (the port's K3/K4 plain
    versions, the reference's Pallas kernels in interpret mode)."""
    run = _lockstep(jbase, tokens, "int8", TARGETS["qv"], "flash")
    np.testing.assert_allclose(run["tloss"], run["jloss"], rtol=1e-5)
    for jg, tg in zip(run["jgrad"], run["tgrad"]):
        for path, w in jg.items():
            np.testing.assert_allclose(tg[path], w, atol=5e-5, rtol=5e-5,
                                       err_msg=str(path))


@pytest.mark.parametrize("targets", list(TARGETS))
def test_training_moves_loss_and_freezes_base(jbase, tokens, targets):
    _, lcfg = _lcfgs(TARGETS[targets])
    base = _to_port(jbase)
    before = {k: v.copy() for k, v in _flat(base).items()}
    cfg = ttrain.TrainConfig(model=TMODEL, learning_rate=LR)
    step, opt = tlora.make_lora_train_step(cfg, ttrain.MeshConfig(), base,
                                           lcfg)
    lora = tlora.init_lora(base, lcfg, seed=2, device="cpu")
    opt_state = opt.init(lora)
    toks = torch.from_numpy(tokens)
    first = None
    for _ in range(10):
        lora, opt_state, loss = step(lora, opt_state, toks)
        first = first if first is not None else loss.item()
    assert loss.item() < first, (first, loss.item())
    assert tmodel.loss_fn(base, toks, TMODEL).item() == pytest.approx(
        first, rel=1e-5)
    # The base is never written, and never asks for gradients.
    for path, v in _flat(base).items():
        np.testing.assert_array_equal(v, before[path], err_msg=str(path))
    assert not any(p.requires_grad for p in ttrain.tree_leaves(base))
    # The optimizer state exists only for the adapters.
    n_adapter = sum(x.numel() for x in ttrain.tree_leaves(lora))
    n_base = sum(x.numel() for x in ttrain.tree_leaves(base))
    assert n_adapter < n_base / 5
    assert sum(x.numel() for x in opt_state["mu"] + opt_state["nu"]) == (
        2 * n_adapter)
    # step() reports the pre-update loss: the adapted model's loss is what
    # the next step reports.
    adapted = tlora.apply_lora(base, lora, lcfg)
    _, _, next_loss = step(lora, opt_state, toks)
    assert tmodel.loss_fn(adapted, toks, TMODEL).item() == pytest.approx(
        next_loss.item(), rel=1e-5)


def test_merge_matches_on_the_fly(jbase, tokens):
    """Serving: merged params reproduce the adapted model, and generate
    runs on them."""
    _, lcfg = _lcfgs()
    base = _to_port(jbase)
    cfg = ttrain.TrainConfig(model=TMODEL, learning_rate=LR)
    step, opt = tlora.make_lora_train_step(cfg, ttrain.MeshConfig(), base,
                                           lcfg)
    lora = tlora.init_lora(base, lcfg, seed=3, device="cpu")
    opt_state = opt.init(lora)
    toks = torch.from_numpy(tokens)
    for _ in range(3):
        lora, opt_state, _ = step(lora, opt_state, toks)
    merged = tlora.merge_lora(base, lora, lcfg)
    eff = tlora.apply_lora(base, lora, lcfg)
    np.testing.assert_allclose(tmodel.loss_fn(merged, toks, TMODEL).item(),
                               tmodel.loss_fn(eff, toks, TMODEL).item(),
                               rtol=1e-6)
    prompt = toks[:2, :4]
    assert torch.equal(tdecode.generate(merged, prompt, TMODEL, 5,
                                        device="cpu"),
                       tdecode.generate(eff, prompt, TMODEL, 5, device="cpu"))


def _nbytes(blocks) -> int:
    return sum(t.numel() * t.element_size() for b in blocks
               for v in b.values()
               for t in ((v.q, v.s) if tquant.is_quantized(v) else (v,)))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_qlora_frozen_base(jbase, tokens, kind):
    """QLoRA: the frozen base rides as int8 or int4, adapters train in f32
    on top; the zero-init model tracks the float base's loss within the
    format's rounding, training moves the loss, the base's bytes never
    change, and merged serving params are plain float projections with
    the fused decode copies dropped."""
    _, lcfg = _lcfgs()
    base = _to_port(jbase)
    qbase = (tquant.quantize_params(base) if kind == "int8"
             else tquant.quantize_params4(base))
    before = {k: v.copy() for k, v in _flat(qbase).items()}
    cfg = ttrain.TrainConfig(model=TMODEL, learning_rate=LR)
    step, opt = tlora.make_lora_train_step(cfg, ttrain.MeshConfig(), qbase,
                                           lcfg)
    lora = tlora.init_lora(qbase, lcfg, seed=2, device="cpu")
    toks = torch.from_numpy(tokens)
    eff0 = tlora.apply_lora(qbase, lora, lcfg)
    assert tmodel.loss_fn(eff0, toks, TMODEL).item() == pytest.approx(
        tmodel.loss_fn(base, toks, TMODEL).item(), rel=0.05)
    opt_state = opt.init(lora)
    first = None
    for _ in range(10):
        lora, opt_state, loss = step(lora, opt_state, toks)
        first = first if first is not None else loss.item()
    assert loss.item() < first
    for path, v in _flat(qbase).items():
        np.testing.assert_array_equal(v, before[path], err_msg=str(path))
    resident = [{k: v for k, v in b.items() if k != "wqkv"}
                for b in qbase["blocks"]]
    bf16 = [{k: v.to(torch.bfloat16) for k, v in b.items()}
            for b in base["blocks"]]
    assert _nbytes(resident) < 0.75 * _nbytes(bf16)
    merged = tlora.merge_lora(qbase, lora, lcfg)
    assert all("wqkv" not in b for b in merged["blocks"])
    assert all(not tquant.is_quantized(b[n]) for b in merged["blocks"]
               for n in tlora._FORWARD_LEAVES)
    out = tdecode.generate(merged, toks[:2, :4], TMODEL, 4, device="cpu")
    assert out.shape == (2, 4)


def test_checkpoint_resume(jbase, tokens, tmp_path):
    """The port's checkpoint module saves LoRA state unchanged: resuming
    from step 2 replays steps 3-4 exactly (adapter-sized files; the
    frozen base is never written)."""
    _, lcfg = _lcfgs()
    base = _to_port(jbase)
    cfg = ttrain.TrainConfig(model=TMODEL, learning_rate=LR)
    step, opt = tlora.make_lora_train_step(cfg, ttrain.MeshConfig(), base,
                                           lcfg)
    mgr = tckpt.make_manager(str(tmp_path / "lora"), max_to_keep=4)
    toks = torch.from_numpy(tokens)
    lora = tlora.init_lora(base, lcfg, seed=2, device="cpu")
    opt_state = opt.init(lora)
    losses = []
    for i in range(4):
        lora, opt_state, loss = step(lora, opt_state, toks)
        losses.append(loss.item())
        tckpt.save(mgr, i + 1, lora, opt_state)
    assert tckpt.steps(mgr) == [1, 2, 3, 4]
    lora2, opt2 = tckpt.restore(mgr, 2, device="cpu")
    assert opt2["count"] == 2
    resumed = []
    for _ in range(2):
        lora2, opt2, loss = step(lora2, opt2, toks)
        resumed.append(loss.item())
    assert resumed == losses[2:]
    for a, b in zip(ttrain.tree_leaves(lora2), ttrain.tree_leaves(lora)):
        assert torch.equal(a, b)
    saved = (tmp_path / "lora" / "4" / tckpt.STATE_FILE).stat().st_size
    base_bytes = sum(p.numel() * 4 for p in ttrain.tree_leaves(base))
    assert saved < base_bytes / 2


def _message(exc_type, fn):
    with pytest.raises(exc_type) as info:
        fn()
    return str(info.value)


def test_rejects_bad_configs(jbase):
    """The reference's three ValueErrors and the pipeline refusal, with
    its messages."""
    base = _to_port(jbase)
    key = jax.random.PRNGKey(0)
    for bad in (dict(rank=0), dict(targets=("nope",)),
                dict(targets=("attn_norm",))):
        want = _message(ValueError, lambda: jlora.init_lora(
            jbase, jlora.LoraConfig(**bad), key))
        got = _message(ValueError, lambda: tlora.init_lora(
            base, tlora.LoraConfig(**bad), device="cpu"))
        assert got == want
    moe = {**SIZES, "num_experts": 2}
    jmoe = jax.jit(jmodel.init_params, static_argnums=0)(
        jmodel.ModelConfig(**moe), key)
    want = _message(ValueError, lambda: jlora.init_lora(
        jmoe, jlora.LoraConfig(targets=("w_up",)), key))
    got = _message(ValueError, lambda: tlora.init_lora(
        _to_port(jmoe), tlora.LoraConfig(targets=("w_up",)), device="cpu"))
    assert got == want and "expert" in got
    jcfg = JTrainConfig(model=JMODEL, mesh=JMesh(pipe=2, data=4))
    want = _message(ValueError, lambda: jlora.make_lora_train_step(
        jcfg, build_mesh(jcfg.mesh), jbase, jlora.LoraConfig()))
    tcfg = ttrain.TrainConfig(model=TMODEL,
                              mesh=ttrain.MeshConfig(pipe=2, data=4))
    got = _message(ValueError, lambda: tlora.make_lora_train_step(
        tcfg, tcfg.mesh, base, tlora.LoraConfig()))
    assert got == want and "pipeline" in got


@pytest.mark.parametrize("mesh", [dict(data=2), dict(fsdp=2), dict(tensor=2),
                                  dict(seq=2), dict(expert=2), dict(dcn=2),
                                  dict(data=2, fsdp=2, tensor=2)])
def test_multi_device_mesh_raises_item_11(jbase, mesh):
    """A mesh of several devices (seq and expert included, ported since
    item 11b) needs a process group of that size, which this process has
    not, and refuses rather than train on one device. The sharded LoRA
    tests run on gloo ranks (tests/test_torch_mesh_finetune.py, and on a
    seq mesh tests/test_torch_mesh_parallel.py)."""
    cfg = ttrain.TrainConfig(model=TMODEL)
    with pytest.raises(ValueError, match="mesh needs"):
        tlora.make_lora_train_step(cfg, ttrain.MeshConfig(**mesh),
                                   _to_port(jbase), tlora.LoraConfig())


def test_remat_equals_no_remat(jbase, tokens):
    _, lcfg = _lcfgs()
    base = tquant.quantize_params(_to_port(jbase))
    toks = torch.from_numpy(tokens)
    runs = []
    for remat in (False, True):
        cfg = ttrain.TrainConfig(model=TMODEL, learning_rate=LR, remat=remat)
        step, opt = tlora.make_lora_train_step(cfg, ttrain.MeshConfig(),
                                               base, lcfg)
        lora = tlora.init_lora(base, lcfg, seed=2, device="cpu")
        opt_state = opt.init(lora)
        losses = []
        for _ in range(2):
            lora, opt_state, loss = step(lora, opt_state, toks)
            losses.append(loss.item())
        runs.append((losses, lora))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(ttrain.tree_leaves(runs[0][1]),
                    ttrain.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_config_defaults_match_reference():
    j, t = jlora.LoraConfig(), tlora.LoraConfig()
    assert (t.rank, t.alpha, t.targets, t.scale) == (
        j.rank, j.alpha, j.targets, j.scale)
    assert tlora._FORWARD_LEAVES == jlora._FORWARD_LEAVES
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.rank = 2
    assert tlora.__all__ == jlora.__all__
