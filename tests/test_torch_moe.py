"""The port's mixture-of-experts layer (tpu_bootstrap_torch/workload/
moe.py) and the MoE model held to the JAX reference on the CPU: moe_mlp's
output and aux loss with float, int8 and int4 expert stacks (the int8 and
int4 stacks through the plain versions of kernels K1e and K6e on the
port's side, the Pallas kernels in interpret mode on the reference's),
the per-token oracle of the reference's own tests, dropped overflow,
a single expert equal to the dense MLP, routing ties, and the MoE
model's logits, loss and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_moe import oracle_moe
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import moe as jmoe
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import moe as tmoe
from tpu_bootstrap_torch.workload import quant as tquant

torch.set_num_threads(2)

BASE = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
            embed_dim=32, mlp_dim=64, max_seq_len=16, num_experts=4,
            expert_top_k=2, expert_capacity_factor=2.0)
# Float stacks: only the order of f32 sums differs. Quantized stacks: the
# kernels round their activations to bf16, and an f32 activation one ulp
# apart between the frameworks may round to the neighbouring bf16 value.
TOL = {"float": (1e-5, 1e-5), "int8": (0.0, 5e-3), "int4": (0.0, 5e-3)}


def _cfgs(**kw):
    return (jmodel.ModelConfig(**{**BASE, **kw}),
            tmodel.ModelConfig(**{**BASE, **kw}))


def _block(seed, cfg, fmt):
    """A MoE block from a seed (the reference test's scales), in ``fmt``,
    for both packages."""
    rng = np.random.default_rng(seed)
    e, m, f = cfg.num_experts, cfg.embed_dim, cfg.mlp_dim
    block = {"router": rng.standard_normal((m, e)).astype(np.float32),
             "w_up": (rng.standard_normal((e, m, f)) * 0.1).astype(np.float32),
             "w_down": (rng.standard_normal((e, f, m)) * 0.1
                        ).astype(np.float32)}
    jblock = {k: jnp.asarray(v) for k, v in block.items()}
    if fmt != "float":
        quantize = (jquant.quantize_expert_weight if fmt == "int8" else
                    lambda w: jquant.quantize_expert_weight4(w, group=16))
        for name in ("w_up", "w_down"):
            jblock[name] = quantize(jblock[name])
    tblock = bridge.params_from_numpy(jax.tree.map(np.asarray, jblock),
                                      device="cpu")
    return jblock, tblock


def _h(seed, b, s, m):
    return np.random.default_rng(seed).standard_normal((b, s, m)).astype(
        np.float32)


@pytest.fixture(scope="module")
def reference_moe():
    """The reference's moe_mlp (out, aux) on the three stack formats, from
    the same block and activations, computed once."""
    jcfg, tcfg = _cfgs()
    h = _h(1, 2, 12, BASE["embed_dim"])
    out = {}
    for fmt in TOL:
        jblock, tblock = _block(0, jcfg, fmt)
        want, aux = jmoe.moe_mlp(jblock, jnp.asarray(h), jcfg)
        out[fmt] = (tblock, np.asarray(want), float(aux))
    return tcfg, h, out


@pytest.mark.parametrize("fmt", sorted(TOL))
def test_moe_mlp_matches_reference(reference_moe, fmt):
    tcfg, h, out = reference_moe
    tblock, want, want_aux = out[fmt]
    got, aux = tmoe.moe_mlp(tblock, torch.from_numpy(h), tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    rtol, atol = TOL[fmt]
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    assert aux.item() == pytest.approx(want_aux, rel=1e-6)


def test_moe_matches_oracle_and_drops_overflow():
    """The reference test's per-token oracle (choice rank, then sequence
    order) in float64; at capacity_factor 1e-6 each expert keeps one
    slot and the overflow contributes exactly zero."""
    jcfg, tcfg = _cfgs()
    jblock, tblock = _block(2, tcfg, "float")
    h = _h(3, 2, BASE["max_seq_len"], BASE["embed_dim"])
    got, aux = tmoe.moe_mlp(tblock, torch.from_numpy(h), tcfg)
    np.testing.assert_allclose(got.numpy(), oracle_moe(jblock, h, jcfg),
                               rtol=2e-4, atol=2e-5)
    assert aux.item() >= 1.0 - 1e-5
    jcfg, tcfg = _cfgs(num_experts=2, expert_top_k=1,
                       expert_capacity_factor=1e-6)
    jblock, tblock = _block(4, tcfg, "float")
    h = _h(5, 1, 8, BASE["embed_dim"])
    got, _ = tmoe.moe_mlp(tblock, torch.from_numpy(h), tcfg)
    np.testing.assert_allclose(got.numpy(), oracle_moe(jblock, h, jcfg),
                               rtol=2e-4, atol=2e-5)
    assert int((got[0].abs().sum(-1) > 1e-9).sum()) <= 2


def test_single_expert_equals_dense_mlp():
    _, tcfg = _cfgs(num_experts=1, expert_top_k=1)
    _, dense_cfg = _cfgs(num_experts=0)
    _, tblock = _block(6, tcfg, "float")
    dense_block = {"mlp_norm": torch.ones(BASE["embed_dim"]),
                   "w_up": tblock["w_up"][0], "w_down": tblock["w_down"][0]}
    x = torch.from_numpy(_h(7, 2, BASE["max_seq_len"], BASE["embed_dim"]))
    h = tmodel._rms_norm(x, dense_block["mlp_norm"])
    got, aux = tmoe.moe_mlp(tblock, h, tcfg)
    want = tmodel._mlp(dense_block, x, dense_cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert aux.item() == pytest.approx(1.0)


def test_tied_gates_route_like_reference():
    """A zero router makes every gate equal: lax.top_k then takes the
    lowest expert indices, and so must the port; capacity (tight here)
    then drops the same tokens."""
    jcfg, tcfg = _cfgs(expert_capacity_factor=1.0)
    jblock, tblock = _block(8, tcfg, "float")
    jblock["router"] = jnp.zeros_like(jblock["router"])
    tblock["router"] = torch.zeros_like(tblock["router"])
    h = _h(9, 2, 6, BASE["embed_dim"])
    jd, jc, jaux = jmoe._route(jblock, jnp.asarray(h), jcfg)
    td, tc, taux = tmoe._route(tblock, torch.from_numpy(h), tcfg)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert taux.item() == pytest.approx(float(jaux))
    # Experts 0 and 1 take every token's two choices; 2 and 3 stay empty.
    assert td[..., 2:, :].sum() == 0 and td[..., :2, :].sum() > 0


@pytest.mark.parametrize("s", [1, 5])
def test_expert_capacity_equals_reference(s):
    for e, k, cf in ((4, 2, 2.0), (8, 2, 2.0), (3, 1, 1e-6), (8, 2, 1.25)):
        assert (tmoe.expert_capacity(s, e, k, cf)
                == jmoe.expert_capacity(s, e, k, cf))


@pytest.fixture(scope="module")
def moe_model():
    jcfg, tcfg = _cfgs()
    jparams = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))
    tokens = np.random.default_rng(4).integers(0, BASE["vocab_size"], (2, 12))
    return jcfg, tcfg, jparams, tokens


def test_moe_forward_with_aux_matches_reference(moe_model):
    jcfg, tcfg, jparams, tokens = moe_model
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    want, want_aux = jmodel.forward_with_aux(jparams, jnp.asarray(tokens),
                                             jcfg)
    got, aux = tmodel.forward_with_aux(tparams, torch.from_numpy(tokens),
                                       tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert aux.item() == pytest.approx(float(want_aux), rel=1e-5)


def test_moe_loss_and_gradients_match_reference(moe_model):
    """loss_fn adds moe_aux_coef * aux; the loss and every parameter's
    gradient (router and expert stacks included) agree with JAX's."""
    jcfg, tcfg, jparams, tokens = moe_model
    want, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn),
                           static_argnums=2)(jparams, jnp.asarray(tokens), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    leaves = jax.tree.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tmodel.loss_fn(tparams, torch.from_numpy(tokens), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=5e-5)
    router = tparams["blocks"][0]["router"]
    assert next(g for g, p in zip(grads, leaves) if p is router).abs().sum() > 0
    # The aux term is in the loss: dropping the coefficient changes it.
    without = tmodel.loss_fn(
        jax.tree.map(lambda p: p.detach(), tparams), torch.from_numpy(tokens),
        tmodel.ModelConfig(**{**BASE, "moe_aux_coef": 0.0}))
    assert without.item() != pytest.approx(loss.item(), abs=1e-7)


def test_quantized_moe_block_leaves_router_float():
    _, tcfg = _cfgs()
    params = tmodel.init_params(tcfg, seed=1, device="cpu")
    for quantize in (tquant.quantize_params,
                     lambda p: tquant.quantize_params4(p, group=16)):
        block = quantize(params)["blocks"][0]
        assert "wqkv" not in block
        assert isinstance(block["router"], torch.Tensor)
        assert block["w_up"].q.shape[0] == BASE["num_experts"]
        assert all(tquant.is_quantized(block[n])
                   for n in ("wq", "wk", "wv", "wo", "w_up", "w_down"))
