"""The GPipe schedule of the port's pipeline (``workload/pipeline.py``) on
a world of 8 gloo ranks, held to the JAX reference on the CPU: every GPipe
case of tests/test_pipeline.py, the reference's own ``make_pipeline_loss``
on 8 XLA CPU devices, ``pipeline_on_one_device`` against the world, a
clipped step, the checkpoint resume and distillation on a pipe mesh.

One module-scoped world (``tests/test_torch_mesh_ranks.py``, program
``mesh_pipeline``) runs every case; the reference's values are computed
here on one JAX device from the same params (its own init, carried over
by ``bridge.params_from_numpy``) and tokens. Tolerances are the reference
tests': losses 1e-5 relative (flash 2e-4 under ``seq``), gradients 1e-4
relative and 1e-6 absolute (``seq`` 1e-5 absolute, 5e-4 relative under
flash; MoE 2e-4 and 1e-5), train steps 2e-5 (2e-4 under flash), the aux
oracle 2e-5 on the loss and 5e-4 on the gradients. In place of the
reference's XLA memory analysis (:676) the schedules report what they
held: GPipe keeps all M microbatches' graphs a stage."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import distill as jdistill
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import pipeline as jpipeline
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap.workload.moe import moe_mlp as jmoe_mlp
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh as jbuild_mesh
from tpu_bootstrap_torch.workload import bridge

from tests.test_torch_mesh_ranks import spawn_world

torch.set_num_threads(2)

WORLD = 8
MODEL = dict(vocab_size=64, num_layers=4, num_heads=2, head_dim=8,
             embed_dim=32, mlp_dim=64, max_seq_len=16)
SEQ_MODEL = {**MODEL, "max_seq_len": 17}  # shifts to 16
MOE_MODEL = {**MODEL, "num_experts": 4, "expert_top_k": 2,
             "expert_capacity_factor": 4.0, "moe_aux_coef": 0.0}
AUX_MODEL = {**MOE_MODEL, "num_layers": 2, "moe_aux_coef": 0.1}
BLOCK_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_down", "attn_norm",
                "mlp_norm")
MOE_LEAVES = ("wq", "wo", "router", "w_up", "w_down", "attn_norm",
              "mlp_norm")

LOSS_CASES = [(2, 2), (2, 4), (4, 4), (4, 8)]
TRAIN_MESHES = {"pp-dp": dict(pipe=2, data=4), "pp4-dp": dict(pipe=4, data=2),
                "dcn-pp-dp": dict(dcn=2, pipe=2, data=2)}
COMPOSED = {"pp-dp-tp": dict(pipe=2, data=2, tensor=2),
            "pp-dp-fsdp": dict(pipe=2, data=2, fsdp=2),
            "pp-fsdp-tp": dict(pipe=2, fsdp=2, tensor=2)}
COMPOSED_TRAIN = {"pp-dp-tp-dense": (COMPOSED["pp-dp-tp"], "dense"),
                  "pp-dp-tp-flash": (COMPOSED["pp-dp-tp"], "flash"),
                  "pp-fsdp-tp-flash": (COMPOSED["pp-fsdp-tp"], "flash")}
SEQ_CASES = {"pp-dp-sp-dense": (dict(pipe=2, data=2, seq=2), "dense", None),
             "pp-dp-sp-flash": (dict(pipe=2, data=2, seq=2), "flash", None),
             "pp-sp-tp-dense": (dict(pipe=2, seq=2, tensor=2), "dense", None),
             "pp-dp-sp-mqa": (dict(pipe=2, data=2, seq=2), "dense", 1),
             "pp-sp-ep-dense": (dict(pipe=2, seq=2, expert=2), "dense",
                                None)}
MOE_MESHES = {"pp-dp-ep": dict(pipe=2, data=2, expert=2),
              "pp-ep-tp": dict(pipe=2, expert=2, tensor=2),
              "pp-fsdp-ep": dict(pipe=2, fsdp=2, expert=2),
              "pp-dp-moe": dict(pipe=2, data=4)}
REJECTIONS = ("seq_moe", "odd_tp", "few_microbatches", "init_layers",
              "apply_layers")
CLIP = dict(mesh=dict(pipe=2, fsdp=2, tensor=2), clip=0.5)
TEACHER = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
               embed_dim=32, mlp_dim=64, max_seq_len=48)
STUDENT = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=4,
               embed_dim=16, mlp_dim=32, max_seq_len=48)


# -- the reference's side (shared with tests/test_torch_pipeline_1f1b.py) --


def port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


def jparams(model: dict):
    return jmodel.init_params(jmodel.ModelConfig(**model),
                              jax.random.PRNGKey(0))


def tokens_of(key: int, rows: int, model: dict):
    return jax.random.randint(jax.random.PRNGKey(key),
                              (rows, model["max_seq_len"]), 0,
                              model["vocab_size"])


def torch_tokens(tokens):
    return torch.tensor(np.asarray(tokens))


@functools.lru_cache(maxsize=None)
def _jitted_value_and_grad(model: tuple):
    cfg = jmodel.ModelConfig(**dict(model))
    return jax.jit(jax.value_and_grad(
        lambda p, tokens: jmodel.loss_fn(p, tokens, cfg)))


def value_and_grads(model: dict, params, tokens) -> tuple:
    """The sequential model's loss and gradients, blocks stacked."""
    loss, g = _jitted_value_and_grad(tuple(sorted(model.items())))(params,
                                                                  tokens)
    g = {**g, "blocks": jpipeline.stack_block_params(g["blocks"])}
    return float(loss), jax.tree.map(np.asarray, g)


def single_losses(model: dict, tokens, steps: int = 2, **kw) -> list:
    """The reference's single-device train steps from its init."""
    cfg = jtrain.TrainConfig(model=jmodel.ModelConfig(**model), **kw)
    mesh = jbuild_mesh(JMesh())
    params, opt_state, p_sh = jtrain.init_train_state(
        cfg, mesh, jax.random.PRNGKey(0))
    step = jtrain.make_train_step(cfg, mesh, p_sh)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return losses


def aux_oracle(model: dict, M: int, dsz: int):
    """tests/test_pipeline.py:750-842's estimator as one differentiable
    expression with the reference's own functions: the full batch's nll
    plus coef times the mean over (microbatch, data shard) of each row
    group's aux, microbatch m being rows {i*M + m}."""
    cfg = jmodel.ModelConfig(**model)

    def run_blocks(blocks, x):
        aux_total = 0.0
        for blk in blocks:
            x = x + jmodel._attention(blk, x, cfg)
            out, aux = jmoe_mlp(blk, jmodel._rms_norm(x, blk["mlp_norm"]),
                                cfg)
            x = x + out
            aux_total = aux_total + aux
        return x, aux_total / len(blocks)

    def oracle(p, inputs, targets):
        x_full = p["embed"][inputs]
        y_full, _ = run_blocks(p["blocks"], x_full)
        nll = jpipeline._head_nll(y_full, p["final_norm"], p["embed"],
                                  targets)
        per = inputs.shape[0] // M // dsz
        groups = [[i * M + m for i in range(d * per, (d + 1) * per)]
                  for m in range(M) for d in range(dsz)]
        aux = [run_blocks(p["blocks"], x_full[jnp.asarray(rows)])[1]
               for rows in groups]
        return nll + cfg.moe_aux_coef * jnp.mean(jnp.stack(aux))

    return oracle


def reference_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def grad_case(model, mesh, params, tokens, M, **kw) -> dict:
    return {"kind": "grad", "model": model, "mesh": mesh,
            "params": port(params), "tokens": torch_tokens(tokens), "M": M,
            **kw}


def same_on_every_rank(world, name, key="loss"):
    got = [r[name][key] for r in world if r[name]]
    assert all(g == got[0] for g in got), got
    return got[0]


def assert_grads(got: dict, want: dict, names, rtol, atol, outer=()):
    for name in names:
        np.testing.assert_allclose(got["blocks"][name].numpy(),
                                   want["blocks"][name], rtol=rtol,
                                   atol=atol, err_msg=name)
    for name in outer:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


# -- the world --------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's values and the world's cases."""
    refs, cases = {}, {}
    params = jparams(MODEL)
    for pipe, M in LOSS_CASES:
        data = WORLD // pipe
        tokens = tokens_of(1, M * data, MODEL)
        refs[("loss", pipe, M)] = value_and_grads(MODEL, params, tokens)[0]
        cases[("loss", pipe, M)] = {
            "kind": "value", "model": MODEL, "mesh": dict(pipe=pipe,
                                                          data=data),
            "params": port(params), "tokens": torch_tokens(tokens), "M": M}
    tokens8 = tokens_of(1, 8, MODEL)
    refs["seq8"] = value_and_grads(MODEL, params, tokens8)
    cases["grads"] = grad_case(MODEL, dict(pipe=2, data=4), params, tokens8,
                               2)
    cases["remat"] = grad_case(MODEL, dict(pipe=2, data=4), params, tokens8,
                               2, remat=True)
    for name, mesh in COMPOSED.items():
        cases[name] = grad_case(MODEL, mesh, params, tokens8, 2)
    mqa = {**MODEL, "num_kv_heads": 1}
    mqa_params = jparams(mqa)
    refs["mqa"] = value_and_grads(mqa, mqa_params, tokens_of(1, 8, mqa))
    cases["gqa-fallback"] = grad_case(mqa, COMPOSED["pp-dp-tp"], mqa_params,
                                      tokens_of(1, 8, mqa), 2)

    tokens16 = tokens_of(7, 16, MODEL)
    refs["single"] = single_losses(MODEL, tokens16, learning_rate=1e-2)
    train = dict(kind="train", model=MODEL, params=port(params),
                 tokens=torch_tokens(tokens16), M=4, lr=1e-2, steps=2)
    for name, mesh in TRAIN_MESHES.items():
        cases[("train", name)] = {**train, "mesh": mesh}
    cases[("train", "pp-dp-flash")] = {**train, "mesh": TRAIN_MESHES["pp-dp"],
                                       "attention": "flash", "block": 8}
    for name, (mesh, attention) in COMPOSED_TRAIN.items():
        cases[("train", name)] = {**train, "mesh": mesh,
                                  "attention": attention, "block": 8}

    for name, (mesh, attention, kv) in SEQ_CASES.items():
        model = {**SEQ_MODEL, "num_kv_heads": kv}
        p = jparams(model)
        dsz = mesh.get("data", 1) * mesh.get("expert", 1)
        tokens = tokens_of(1, 4 * dsz, model)
        refs[name] = value_and_grads(model, p, tokens)
        cases[name] = grad_case(model, mesh, p, tokens, 2,
                                attention=attention, block=8)

    moe_params = jparams(MOE_MODEL)
    for name, mesh in MOE_MESHES.items():
        dsz = mesh.get("data", 1) * mesh.get("fsdp", 1) * mesh.get(
            "expert", 1)
        tokens = tokens_of(1, 2 * dsz, MOE_MODEL)
        refs[name] = value_and_grads(MOE_MODEL, moe_params, tokens)
        cases[name] = grad_case(MOE_MODEL, mesh, moe_params, tokens, 2)

    aux_params = jparams(AUX_MODEL)
    aux_tokens = tokens_of(1, 8, AUX_MODEL)
    oracle = aux_oracle(AUX_MODEL, M=2, dsz=4)
    args = (aux_tokens[:, :-1], aux_tokens[:, 1:])
    loss, g = jax.jit(jax.value_and_grad(oracle))(aux_params, *args)
    refs["aux"] = (float(loss), jax.tree.map(np.asarray, {
        **g, "blocks": jpipeline.stack_block_params(g["blocks"])}))
    cases["aux"] = grad_case(AUX_MODEL, dict(pipe=2, data=2, expert=2),
                             aux_params, aux_tokens, 2)
    cases["aux-value"] = {**cases["aux"], "kind": "value"}

    # The reference's own GPipe on 8 XLA devices: loss and gradients.
    mesh_cfg = JMesh(pipe=2, data=2, tensor=2)
    jmesh = jbuild_mesh(mesh_cfg)
    jloss = jpipeline.make_pipeline_loss(
        jtrain.TrainConfig(model=jmodel.ModelConfig(**MODEL),
                           mesh=mesh_cfg), jmesh, num_microbatches=2)
    stacked = {**params, "blocks": jpipeline.stack_block_params(
        params["blocks"])}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, tokens8[:, :-1], tokens8[:, 1:])))(stacked)
    refs["own"] = (float(loss), jax.tree.map(np.asarray, g))
    cases["own"] = grad_case(MODEL, COMPOSED["pp-dp-tp"], params, tokens8, 2)

    tokens64 = tokens_of(3, 64, MODEL)
    cases["stash"] = grad_case(MODEL, dict(pipe=2, data=4), params,
                               tokens64, 16)
    cases["one-device"] = {**grad_case(MODEL, dict(pipe=2, data=4), params,
                                       tokens16, 4), "kind": "one_device"}
    cases["world"] = grad_case(MODEL, dict(pipe=2, data=4), params,
                               tokens16, 4)

    refs["clip"] = single_losses(MODEL, tokens16, steps=3,
                                 learning_rate=1e-2,
                                 grad_clip_norm=CLIP["clip"])
    grads = value_and_grads(MODEL, params, tokens16)[1]
    refs["clip_norm"] = float(np.sqrt(sum(
        np.square(x).sum() for x in jax.tree.leaves(grads))))
    cases["clip"] = {**train, "mesh": CLIP["mesh"], "clip": CLIP["clip"],
                     "steps": 3}

    refs["errors"] = _errors(cases, params)

    teacher = jmodel.init_params(jmodel.ModelConfig(**TEACHER),
                                 jax.random.PRNGKey(0))
    student = jmodel.init_params(jmodel.ModelConfig(**STUDENT),
                                 jax.random.PRNGKey(1))
    distill_tokens = [jax.random.randint(jax.random.PRNGKey(100 + i),
                                         (8, 24), 0, 32) for i in range(3)]
    distill_case = {"teacher_model": TEACHER, "student_model": STUDENT,
                    "mesh": dict(pipe=2, data=4), "lr": 1e-2,
                    "teacher": port(teacher), "student": port(student),
                    "tokens": [torch_tokens(t) for t in distill_tokens]}
    step, opt = jdistill.make_distill_step(
        jmodel.ModelConfig(**STUDENT), teacher, jmodel.ModelConfig(**TEACHER),
        jbuild_mesh(JMesh()), learning_rate=1e-2)
    state, refs["distill"] = opt.init(student), []
    for t in distill_tokens:
        student, state, loss = step(student, state, t)
        refs["distill"].append(float(loss))
    resume = {"model": dict(vocab_size=64, num_layers=2, num_heads=2,
                            head_dim=8, embed_dim=16, mlp_dim=32,
                            max_seq_len=16),
              "mesh": dict(pipe=2, data=4), "M": 2}
    world = spawn_world("mesh_pipeline", WORLD,
                        tmp_path_factory.mktemp("pipeline"),
                        {"cases": cases, "resume": resume,
                         "distill": distill_case})
    return {"refs": refs, "world": world}


def _errors(cases: dict, params) -> dict:
    """The reference's messages for the rejections, and the world's cases
    that must raise them."""
    out = {}
    moe_seq = {**MOE_MODEL, "num_experts": 2, "max_seq_len": 17}
    odd = {**MODEL, "num_heads": 3, "mlp_dim": 66}
    three = {**MODEL, "num_layers": 3}
    specs = {
        "seq_moe": (moe_seq, dict(pipe=2, seq=2, expert=2), 2, "loss"),
        "odd_tp": (odd, dict(pipe=2, data=2, tensor=2), 2, "loss"),
        "few_microbatches": (MODEL, dict(pipe=4, data=2), 2, "loss"),
        "init_layers": (three, dict(pipe=2, data=4), 2, "init"),
        "apply_layers": (three, dict(pipe=2, data=4), 2, "loss"),
        "seq_length": (MODEL, dict(pipe=2, data=2, seq=2), 2, "loss")}
    for name, (model, mesh, M, call) in specs.items():
        cfg = jtrain.TrainConfig(model=jmodel.ModelConfig(**model),
                                 mesh=JMesh(**mesh))
        jmesh = jbuild_mesh(cfg.mesh)
        case = {"kind": "error", "model": model, "mesh": mesh, "M": M,
                "call": call}
        if call == "init":
            out[name] = reference_error(lambda: jtrain.init_train_state(
                cfg, jmesh, jax.random.PRNGKey(0)))
        elif name in ("apply_layers", "seq_length"):
            p = jmodel.init_params(cfg.model, jax.random.PRNGKey(0))
            stacked = {**p, "blocks": jpipeline.stack_block_params(
                p["blocks"])}
            tokens = tokens_of(1, 8, model)
            loss = jpipeline.make_pipeline_loss(cfg, jmesh,
                                                num_microbatches=M)
            out[name] = reference_error(
                lambda: loss(stacked, tokens[:, :-1], tokens[:, 1:]))
            case.update(params=port(p), tokens=torch_tokens(tokens))
        else:
            out[name] = reference_error(lambda: jpipeline.make_pipeline_loss(
                cfg, jmesh, num_microbatches=M))
        cases[("error", name)] = case
    return out


# -- tests/test_pipeline.py's GPipe cases -----------------------------------


@pytest.mark.parametrize("pipe,microbatches", LOSS_CASES)
def test_pipeline_loss_matches_sequential(ref, pipe, microbatches):
    got = same_on_every_rank(ref["world"], ("loss", pipe, microbatches))
    assert got == pytest.approx(ref["refs"][("loss", pipe, microbatches)],
                                rel=1e-5)


def test_pipeline_grads_match_sequential(ref):
    loss, want = ref["refs"]["seq8"]
    assert same_on_every_rank(ref["world"], "grads") == pytest.approx(
        loss, rel=1e-5)
    assert_grads(ref["world"][0]["grads"]["grads"], want, BLOCK_LEAVES,
                 1e-4, 1e-6, outer=("embed", "final_norm"))


def test_pipeline_remat_matches(ref):
    """Each layer recomputed in the backward: the loss to 1e-6 and the
    gradients as without remat."""
    world = ref["world"]
    assert same_on_every_rank(world, "remat") == pytest.approx(
        same_on_every_rank(world, "grads"), rel=1e-6)
    plain, remat = world[0]["grads"]["grads"], world[0]["remat"]["grads"]
    for name in BLOCK_LEAVES:
        np.testing.assert_allclose(remat["blocks"][name].numpy(),
                                   plain["blocks"][name].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_pipelined_train_step_matches_single_device(ref, mesh):
    np.testing.assert_allclose(
        same_on_every_rank(ref["world"], ("train", mesh), "losses"),
        ref["refs"]["single"], rtol=2e-5)


def test_pipelined_flash_matches_dense_pipeline(ref):
    """K3/K4's plain versions as each stage's core against the dense
    core, both pipelined."""
    world = ref["world"]
    np.testing.assert_allclose(
        same_on_every_rank(world, ("train", "pp-dp-flash"), "losses"),
        same_on_every_rank(world, ("train", "pp-dp"), "losses"), rtol=2e-4)


@pytest.mark.parametrize("mesh", sorted(COMPOSED))
def test_pipeline_composed_loss_and_grads_match_sequential(ref, mesh):
    loss, want = ref["refs"]["seq8"]
    assert same_on_every_rank(ref["world"], mesh) == pytest.approx(
        loss, rel=1e-5)
    assert_grads(ref["world"][0][mesh]["grads"], want, BLOCK_LEAVES, 1e-4,
                 1e-6)


def test_pipeline_tp_gqa_fallback_matches(ref):
    """One KV head over tensor 2: every rank expands it to the query heads
    and keeps its group."""
    loss, want = ref["refs"]["mqa"]
    assert same_on_every_rank(ref["world"], "gqa-fallback") == \
        pytest.approx(loss, rel=1e-5)
    assert_grads(ref["world"][0]["gqa-fallback"]["grads"], want,
                 ("wq", "wk", "wv", "wo"), 1e-4, 1e-6)


@pytest.mark.parametrize("name", sorted(COMPOSED_TRAIN))
def test_composed_pipelined_train_step_matches_single_device(ref, name):
    rtol = 2e-4 if COMPOSED_TRAIN[name][1] == "flash" else 2e-5
    np.testing.assert_allclose(
        same_on_every_rank(ref["world"], ("train", name), "losses"),
        ref["refs"]["single"], rtol=rtol)


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_pipeline_with_seq_parallelism_matches_sequential(ref, name):
    """The ring's local bodies over each stage's seq group, rotary phases
    on global positions."""
    flash = SEQ_CASES[name][1] == "flash"
    loss, want = ref["refs"][name]
    assert same_on_every_rank(ref["world"], name) == pytest.approx(
        loss, rel=2e-4 if flash else 1e-5)
    assert_grads(ref["world"][0][name]["grads"], want, BLOCK_LEAVES,
                 5e-4 if flash else 1e-4, 1e-5, outer=("embed",))


def test_pipeline_seq_requires_divisible_length(ref):
    for r in ref["world"]:
        assert r[("error", "seq_length")]["error"] == \
            ref["refs"]["errors"]["seq_length"]


@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
def test_pipeline_with_moe_matches_sequential(ref, mesh):
    loss, want = ref["refs"][mesh]
    assert same_on_every_rank(ref["world"], mesh) == pytest.approx(
        loss, rel=1e-5)
    assert_grads(ref["world"][0][mesh]["grads"], want, MOE_LEAVES, 2e-4,
                 1e-5, outer=("embed",))


def test_pipeline_moe_aux_matches_per_shard_oracle(ref):
    """The aux averaged per (microbatch, data shard), against the
    reference's functions run on each group's rows."""
    assert same_on_every_rank(ref["world"], "aux-value") == pytest.approx(
        ref["refs"]["aux"][0], rel=2e-5)


def test_pipeline_moe_aux_grads_match_oracle(ref):
    loss, want = ref["refs"]["aux"]
    assert same_on_every_rank(ref["world"], "aux") == pytest.approx(
        loss, rel=2e-5)
    assert_grads(ref["world"][0]["aux"]["grads"], want, MOE_LEAVES, 5e-4,
                 1e-5, outer=("embed",))


@pytest.mark.parametrize("name", REJECTIONS)
def test_pipeline_rejects_bad_configs(ref, name):
    """The reference's refusals, word for word: seq x MoE, a tensor axis
    the heads do not divide, fewer microbatches than stages, layers that do
    not divide over the stages (at init and in the schedule)."""
    for r in ref["world"]:
        assert r[("error", name)]["error"] == ref["refs"]["errors"][name]


def test_pipelined_checkpoint_resume_matches(ref):
    """train_loop on pipe=2, data=4 saved every step: two steps and a
    resume to four equal four uninterrupted, bit for bit."""
    for r in ref["world"]:
        got = r["resume"]
        assert got["first"] + got["resumed"] == got["full"]
        assert len(got["full"]) == 4


def test_gpipe_matches_the_reference_pipeline(ref):
    """The reference's own make_pipeline_loss on 8 XLA devices (pipe 2,
    data 2, tensor 2): its loss and jax.grad through it."""
    loss, want = ref["refs"]["own"]
    assert same_on_every_rank(ref["world"], "own") == pytest.approx(
        loss, rel=1e-5)
    assert_grads(ref["world"][0]["own"]["grads"], want, BLOCK_LEAVES, 1e-4,
                 1e-6, outer=("embed", "final_norm"))


def test_gpipe_holds_every_microbatch(ref):
    """At M = 16 on two stages GPipe keeps all 16 microbatches' graphs a
    stage before its first backward; every stage runs 2M turns."""
    stats = ref["world"][0]["stash"]["stats"]
    assert stats["peak_stash"] == 16
    assert stats["active_ticks"] == 2 * 16 * 2
    assert stats["total_ticks"] == 2 * (16 + 2 - 1) * 2


def test_pipeline_on_one_device_matches_the_world(ref):
    """Both stages in one process, in lockstep, against the gloo world's
    pipe=2, data=4: the same loss and gradients up to the order of sums."""
    world = ref["world"]
    one = world[0]["one-device"]
    assert one["loss"] == pytest.approx(same_on_every_rank(world, "world"),
                                        rel=1e-6)
    got, want = one["grads"], world[0]["world"]["grads"]
    for name in BLOCK_LEAVES:
        np.testing.assert_allclose(got["blocks"][name].numpy(),
                                   want["blocks"][name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(got["embed"].numpy(), want["embed"].numpy(),
                               rtol=1e-5, atol=1e-7)
    assert one["stats"] == world[0]["world"]["stats"]


def test_pipelined_clip_matches_single_device(ref):
    """grad_clip_norm 0.5 on pipe=2, fsdp=2, tensor=2, below the first
    step's gradient norm: the global norm counts each pipe-, fsdp- and
    tensor-sharded shard once."""
    assert ref["refs"]["clip_norm"] > CLIP["clip"]
    np.testing.assert_allclose(
        same_on_every_rank(ref["world"], "clip", "losses"),
        ref["refs"]["clip"], rtol=2e-5)


def test_distill_on_a_pipe_mesh(ref):
    """pipe is plain replication for distillation (the student is not
    stacked), as in the reference."""
    for r in ref["world"]:
        np.testing.assert_allclose(r["distill"], ref["refs"]["distill"],
                                   rtol=2e-5)


def test_stack_block_params_matches_reference():
    from tpu_bootstrap_torch.workload import pipeline

    params = jparams(MODEL)
    want = jax.tree.map(np.asarray,
                        jpipeline.stack_block_params(params["blocks"]))
    got = pipeline.stack_block_params(port(params)["blocks"])
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name].numpy(), want[name]), name

