"""The port's dense model (tpu_bootstrap_torch/workload/model.py) and
weight bridge held to the JAX reference on the CPU: the bridge round
trip, forward logits on MHA, GQA and gated configs from the reference's
own init_params, the numerics that differ between the frameworks by
default, and the FLOP / KV-byte price lists."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import quant as tquant

torch.set_num_threads(2)

BASE = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
            embed_dim=32, mlp_dim=48, max_seq_len=32)
CONFIGS = {"mha": {}, "gqa": {"num_kv_heads": 2}, "mqa": {"num_kv_heads": 1},
           "gated": {"mlp_gated": True}}


def _pair(**kw):
    return (jmodel.ModelConfig(**{**BASE, **kw}),
            tmodel.ModelConfig(**{**BASE, **kw}))


def test_bridge_round_trip_float_and_quantized():
    jcfg, _ = _pair(mlp_gated=True)
    jparams = jquant.quantize_params(
        jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    got = bridge.params_from_numpy(tree, device="cpu")
    jleaves = jax.tree.leaves(tree)
    # Quantized leaves come over as QuantizedWeight with the same shape
    # metadata; every array is bit-equal, leaf for leaf.
    assert tquant.is_quantized(got["blocks"][0]["wqkv"])
    assert got["blocks"][0]["wqkv"].shape == tree["blocks"][0]["wqkv"].shape
    flat = []
    for leaf in jax.tree.leaves(got, is_leaf=tquant.is_quantized):
        if tquant.is_quantized(leaf):
            flat += [leaf.q.numpy(), leaf.s.numpy()]
        else:
            flat.append(leaf.numpy())
    assert len(flat) == len(jleaves)
    for a, b in zip(flat, jleaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bridge_refuses_int4_leaves():
    """int4 leaves (a ``group`` field) are carried, not refused: they
    come over as Quantized4Weight with their group, kdim and shape, the
    packed bytes and scales bit-equal; MoE expert stacks keep their
    leading E axis."""
    jcfg, _ = _pair(num_experts=4)
    jparams = jquant.quantize_params4(
        jmodel.init_params(jcfg, jax.random.PRNGKey(0)), group=8,
        head="int4")
    tree = jax.tree.map(np.asarray, jparams)
    got = bridge.params_from_numpy(tree, device="cpu")
    for name in ("wq", "wo", "w_up", "w_down", "lm_head"):
        want = (tree["lm_head"] if name == "lm_head"
                else tree["blocks"][1][name])
        leaf = got["lm_head"] if name == "lm_head" else got["blocks"][1][name]
        assert isinstance(leaf, tquant.Quantized4Weight), name
        assert (leaf.group, leaf.kdim, leaf.shape) == (
            want.group, want.kdim, tuple(want.shape)), name
        assert leaf.q.dtype == torch.uint8 and leaf.s.dtype == torch.float32
        np.testing.assert_array_equal(leaf.q.numpy(), want.q)
        np.testing.assert_array_equal(leaf.s.numpy(), want.s)
    assert got["blocks"][0]["w_up"].q.shape == (4, BASE["embed_dim"] // 2,
                                                BASE["mlp_dim"])
    assert isinstance(got["blocks"][0]["router"], torch.Tensor)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_reference(name):
    jcfg, tcfg = _pair(**CONFIGS[name])
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    tokens = np.random.default_rng(2).integers(0, BASE["vocab_size"],
                                               (2, 11))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tmodel.forward(tparams, torch.from_numpy(tokens), tcfg).numpy()
    assert got.shape == want.shape == (2, 11, BASE["vocab_size"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_numerics_that_differ_by_default_between_frameworks():
    """tanh gelu, interleaved-pair rotary with f32 angles cast to the
    activation dtype, and rsqrt cast before the multiply -- in bf16,
    where the cast points show."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5) + 7
    scale = rng.standard_normal(16).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    pairs = [
        (jax.nn.gelu(jx), tmodel._gelu(tx)),
        (jmodel._rotary(jx, jnp.asarray(pos)),
         tmodel._rotary(tx, torch.from_numpy(pos))),
        (jmodel._rms_norm(jx, jnp.asarray(scale)),
         tmodel._rms_norm(tx, torch.from_numpy(scale))),
    ]
    for want, got in pairs:
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        # One bf16 ulp where the two libraries' transcendental functions
        # round differently; the layouts and cast points match exactly.
        np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)
    jr = jmodel._rotary(jnp.asarray(x), jnp.asarray(pos))
    tr = tmodel._rotary(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"num_kv_heads": 2}, {"mlp_gated": True},
                                {"num_experts": 4, "expert_top_k": 2}])
def test_price_lists_equal_reference(kw):
    jcfg, tcfg = _pair(**kw)
    assert tmodel.flops_model(tcfg) == jmodel.flops_model(jcfg)
    for kv_quant in (False, True):
        assert (tmodel.kv_bytes_per_token(tcfg, kv_quant)
                == jmodel.kv_bytes_per_token(jcfg, kv_quant))
    bf = tmodel.ModelConfig(**{**BASE, **kw}, compute_dtype=torch.bfloat16)
    jbf = jmodel.ModelConfig(**{**BASE, **kw}, compute_dtype=jnp.bfloat16)
    assert tmodel.kv_bytes_per_token(bf) == jmodel.kv_bytes_per_token(jbf)


def test_init_params_shapes_and_seeded_generator():
    _, tcfg = _pair(mlp_gated=True, num_kv_heads=2)
    a = tmodel.init_params(tcfg, seed=4, device="cpu")
    b = tmodel.init_params(tcfg, seed=4, device="cpu")
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jmodel.init_params(
        jmodel.ModelConfig(**{**BASE, "mlp_gated": True, "num_kv_heads": 2}),
        jax.random.PRNGKey(0)))
    tshapes = jax.tree.map(lambda x: tuple(x.shape), a,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert tshapes == jshapes
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)


def test_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.resolve_device(None)
    # The entry points default to the card: the bridge too.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy({"w": np.zeros(2, np.float32)})
    # MoE blocks are built (on the CPU when asked): a float router and
    # expert stacks in place of the dense FFN, the reference's shapes.
    cfg = tmodel.ModelConfig(**{**BASE, "num_experts": 3})
    block = tmodel.init_params(cfg, device="cpu")["blocks"][0]
    jblock = jmodel.init_params(jmodel.ModelConfig(**{**BASE,
                                                      "num_experts": 3}),
                                jax.random.PRNGKey(0))["blocks"][0]
    assert {k: tuple(v.shape) for k, v in block.items()} == {
        k: tuple(v.shape) for k, v in jblock.items()}
    assert block["router"].shape == (BASE["embed_dim"], 3)
    with pytest.raises(ValueError, match="dense FFN only"):
        tmodel.init_params(tmodel.ModelConfig(num_experts=2, mlp_gated=True),
                           device="cpu")
