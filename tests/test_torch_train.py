"""The port's training slice (tpu_bootstrap_torch/workload/{model,xent,train}.py)
held to the JAX reference on the CPU, in f32, on params carried over from
the reference's own init by ``bridge.params_from_numpy``: the loss with the
dense core and with the flash ``attn_fn`` (the reference's Pallas kernels in
interpret mode), the chunked cross-entropy head, the optimizer (schedule,
clipping, AdamW) update for update, one train step and a five-step loss
trajectory against the reference's ``make_train_step`` on a one-device
mesh, and remat against no remat.

Tolerances, each for a reason: losses and their gradients agree to f32
rounding of sums taken in another order (1e-5 relative on values, 5e-5 on
gradients); optimizer moments are linear in the gradients (1e-5); the
params after an Adam step are compared to 1e-4 absolute (1% of the step
size lr = 1e-2), because Adam's step g / (|g| + 1e-8) turns a rounding
difference in a gradient of about 1e-7 into a step difference of a few
1e-6, so only elements whose gradient is well above that (|g| > 1e-4) are
held tighter (1e-4 relative on the update)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_bootstrap.workload import flash_attention as jfa
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap.workload import xent as jxent
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import flash_attention as tfa
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import train as ttrain
from tpu_bootstrap_torch.workload import xent as txent

torch.set_num_threads(2)

BASE = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
            embed_dim=32, mlp_dim=48, max_seq_len=17, num_kv_heads=2)


def _params(seed=0, **kw):
    jcfg = jmodel.ModelConfig(**{**BASE, **kw})
    tcfg = tmodel.ModelConfig(**{**BASE, **kw})
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(seed, batch=2, length=BASE["max_seq_len"]):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"],
                                                (batch, length))


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_loss_and_grads_match_reference(attention):
    jcfg, tcfg, jparams, tparams = _params(seed=1)
    tokens = _tokens(2)
    jattn = (jfa.make_flash_attn_fn(block_size=16) if attention == "flash"
             else None)
    tattn = tfa.make_flash_attn_fn() if attention == "flash" else None
    want, jgrads = jax.value_and_grad(jmodel.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg, jattn)
    leaves = ttrain.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    got = tmodel.loss_fn(tparams, torch.from_numpy(tokens), tcfg, tattn)
    tgrads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # Both trees list their leaves in the same key order.
    for g, x in zip(tgrads, _leaves_np(jgrads)):
        np.testing.assert_allclose(g.numpy(), x, atol=5e-5, rtol=5e-5)


def test_vocab_chunked_loss_matches_reference():
    jcfg, tcfg, jparams, tparams = _params(seed=3, vocab_chunk=16)
    tokens = _tokens(4)
    want = jmodel.loss_fn(jparams, jnp.asarray(tokens), jcfg)
    got = tmodel.loss_fn(tparams, torch.from_numpy(tokens), tcfg)
    dense = tmodel.loss_fn(tparams, torch.from_numpy(tokens),
                           tmodel.ModelConfig(**BASE))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got.item(), dense.item(), rtol=1e-5)


def test_chunked_xent_value_and_grads_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    embed = (rng.standard_normal((48, 16)) * 0.5).astype(np.float32)
    targets = rng.integers(0, 48, (2, 7))

    def jloss(x, e):
        return jxent.chunked_mean_xent(x, e, jnp.asarray(targets), 16)

    want, (jdx, jde) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(embed))
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(embed).requires_grad_(True)
    got = txent.chunked_mean_xent(tx, te, torch.from_numpy(targets), 16)
    dx, de = torch.autograd.grad(got, (tx, te))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(de.numpy(), np.asarray(jde), atol=1e-6,
                               rtol=1e-5)
    # ... and the dense head's log_softmax gather, inside the port.
    tx2 = torch.from_numpy(x).requires_grad_(True)
    te2 = torch.from_numpy(embed).requires_grad_(True)
    logp = torch.log_softmax(tmodel.head_logits(tx2, te2), dim=-1)
    dense = -torch.gather(logp, -1, torch.from_numpy(targets)[..., None]).mean()
    for a, b in zip((dx, de), torch.autograd.grad(dense, (tx2, te2))):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="positive divisor"):
        txent.chunked_nll(tx, te, torch.from_numpy(targets), 20)


def test_schedule_matches_optax():
    cfg = ttrain.TrainConfig(learning_rate=3e-3, warmup_steps=3,
                             total_steps=10)
    ours = ttrain.make_schedule(cfg)
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 3, 10)
    for count in range(14):
        np.testing.assert_allclose(ours(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
    assert ours(0) == 0.0  # the first update has learning rate 0
    assert ttrain.make_schedule(ttrain.TrainConfig())(0) == pytest.approx(3e-4)
    with pytest.raises(ValueError, match="positive decay_steps"):
        ttrain.make_schedule(ttrain.TrainConfig(warmup_steps=5, total_steps=5))


@pytest.mark.parametrize("clip", [0.0, 0.5, 100.0])
def test_optimizer_updates_match_optax(clip):
    """Three updates of random gradients: with clipping off, triggered
    (norm >= 0.5) and not triggered (norm < 100)."""
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg = ttrain.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                             total_steps=5, grad_clip_norm=clip,
                             weight_decay=0.1)
    jopt = jtrain.make_optimizer(cfg)
    jstate = jopt.init([jnp.asarray(p) for p in params])
    topt = ttrain.make_optimizer(cfg)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tparams)
    jparams = [jnp.asarray(p) for p in params]
    for step in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jupd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate,
                                   jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd = topt.update([torch.from_numpy(g) for g in grads], tstate,
                           tparams)
        for p, u in zip(tparams, tupd):
            p.add_(u)
        for a, b in zip(tupd, jupd):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9,
                                       rtol=1e-5)
        if step == 0:  # learning rate 0 on the first update
            assert all(float(u.abs().max()) == 0.0 for u in tupd)
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=1e-6)


def _reference_run(cfg_kw, attention, tokens, steps, block=16):
    jcfg = jtrain.TrainConfig(model=jmodel.ModelConfig(**BASE),
                              attention=attention, attention_block=block,
                              **cfg_kw)
    mesh = build_mesh(JMesh(), jax.devices()[:1])
    params, opt_state, p_sh = jtrain.init_train_state(
        jcfg, mesh, jax.random.PRNGKey(0))
    # Copies: the step donates (and may reuse) the params' buffers.
    start = jax.tree.map(lambda x: np.array(x, copy=True), params)
    step = jtrain.make_train_step(jcfg, mesh, p_sh)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return start, losses, params, opt_state


def _port_run(start, cfg_kw, attention, tokens, steps, remat=False):
    cfg = ttrain.TrainConfig(model=tmodel.ModelConfig(**BASE),
                             attention=attention, remat=remat, **cfg_kw)
    params = bridge.params_from_numpy(start, device="cpu")
    opt_state = ttrain.make_optimizer(cfg).init(params)
    step = ttrain.make_train_step(cfg)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(tokens))
        losses.append(loss.item())
    return losses, params, opt_state


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_one_train_step_matches_reference(attention):
    kw = dict(learning_rate=1e-2)  # constant rate: the update is real
    tokens = _tokens(7)
    start, jlosses, jparams, jstate = _reference_run(kw, attention, tokens, 1)
    losses, params, state = _port_run(start, kw, attention, tokens, 1)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    adam = jstate[0]
    assert int(adam.count) == state["count"] == 1
    for a, b in zip(state["mu"], _leaves_np(adam.mu)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-8, rtol=1e-5)
    for a, b in zip(state["nu"], _leaves_np(adam.nu)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-12, rtol=1e-5)
    got = ttrain.tree_leaves(params)
    for p, x, p0, g in zip(got, _leaves_np(jparams), _leaves_np(start),
                           _leaves_np(adam.mu)):
        np.testing.assert_allclose(p.numpy(), x, atol=1e-4)
        big = np.abs(g) > 1e-5  # (mu = 0.1 * grad after one step)
        np.testing.assert_allclose((p.numpy() - p0)[big], (x - p0)[big],
                                   rtol=1e-4)


def test_loss_trajectory_matches_reference():
    """Five steps with a warmup of 2, cosine decay over 6 and clipping at
    0.5 (it triggers: the first gradients' norm is above 1): the first
    update has learning rate 0, so steps 1 and 2 report the same loss."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
              grad_clip_norm=0.5)
    tokens = _tokens(8)
    start, jlosses, _, _ = _reference_run(kw, "dense", tokens, 5)
    losses, _, _ = _port_run(start, kw, "dense", tokens, 5)
    assert losses[0] == losses[1]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_remat_equals_no_remat():
    _, _, _, tparams = _params(seed=9)
    start = jax.tree.map(lambda t: t.numpy(), tparams,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    tokens = _tokens(10)
    kw = dict(learning_rate=1e-2)
    plain = _port_run(start, kw, "flash", tokens, 2)
    remat = _port_run(start, kw, "flash", tokens, 2, remat=True)
    assert plain[0] == remat[0]
    for a, b in zip(ttrain.tree_leaves(plain[1]), ttrain.tree_leaves(remat[1])):
        assert torch.equal(a, b)


def test_unported_options_raise():
    mesh = ttrain.MeshConfig(data=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.make_train_step(ttrain.TrainConfig(mesh=mesh))
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.train_loop(ttrain.TrainConfig(mesh=ttrain.MeshConfig(seq=2)),
                          1, device="cpu")
    with pytest.raises(ValueError, match="unknown attention"):
        ttrain.make_train_step(ttrain.TrainConfig(attention="ring"))


def test_synthetic_batch_and_batch_size():
    cfg = ttrain.TrainConfig(model=tmodel.ModelConfig(**BASE))
    a = ttrain.synthetic_batch(cfg, 3, seed=1)
    assert a.shape == (2, BASE["max_seq_len"]) and a.dtype == torch.int64
    assert torch.equal(a, ttrain.synthetic_batch(cfg, 3, seed=1))
    assert not torch.equal(a, ttrain.synthetic_batch(cfg, 4, seed=1))
    assert 0 <= int(a.min()) and int(a.max()) < BASE["vocab_size"]
    # Unpipelined meshes: the pipelined factor comes with multi-device.
    for mesh in (ttrain.MeshConfig(), ttrain.MeshConfig(data=2, fsdp=2),
                 ttrain.MeshConfig(dcn=2, expert=2)):
        jmesh = JMesh(**{f: getattr(mesh, f) for f in
                         ("dcn", "pipe", "data", "fsdp", "expert", "seq",
                          "tensor")})
        assert ttrain.global_batch_size(ttrain.TrainConfig(mesh=mesh)) == \
            jtrain.global_batch_size(jtrain.TrainConfig(mesh=jmesh))
