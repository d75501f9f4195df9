"""The port's int4 and expert quantization (tpu_bootstrap_torch/workload/
quant.py) held to the JAX reference on the CPU: packed bytes and scales
bit-equal for the int4 and expert quantizers (even groups, K tails, zero
columns), the dequantization bit-equal, the plain versions of kernels K6,
K6e and K1e against the reference's Pallas kernels in interpret mode and
their oracles, the byte counters name for name, and the int4 / MoE trees
leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap_torch import telemetry as ttelemetry
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import quant as tquant

torch.set_num_threads(2)

BASE = dict(vocab_size=48, num_layers=2, num_heads=4, head_dim=8,
            embed_dim=32, mlp_dim=40, max_seq_len=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# The reference's init, jitted: eager it dispatches (and compiles) op by
# op, which costs seconds a call on the CPU. Its quantizers stay eager:
# under jit XLA turns the division by 7 into a product with the
# reciprocal, which moves scales by one ulp.
_jinit = jax.jit(jmodel.init_params, static_argnums=0)


def _weights(seed, shape, zero_col=True):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if zero_col:
        w[..., 3] = 0.0  # absmax 0 in every group: scale 1, zero nibbles
    return w


def _assert_same4(got, want):
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    assert got.q.dtype == torch.uint8 and got.s.dtype == torch.float32
    assert (got.group, got.kdim, got.shape) == (want.group, want.kdim,
                                                tuple(want.shape))


@pytest.mark.parametrize("k,n,group", [(64, 24, 2), (66, 9, 6), (128, 40, 64),
                                       (100, 33, 16), (30, 8, 64)])
def test_quantize_weight4_bit_equal(k, n, group):
    """Packed nibbles and group scales byte for byte, including K tails
    (K % group != 0, K < group) and an all-zero column; the
    dequantization bit for bit at the logical K."""
    w = _weights(k * n + group, (k, n))
    want = jquant.quantize_weight4(jnp.asarray(w), group=group)
    got = tquant.quantize_weight4(torch.from_numpy(w), group=group)
    _assert_same4(got, want)
    back = tquant.dequantize_weight4(got)
    assert back.shape == (k, n)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jquant.dequantize_weight4(want)))
    assert torch.equal(tquant.dequantize_any(got), back)


@pytest.mark.parametrize("group", [2, 6, 64])
def test_quantize_expert_weights_bit_equal(group):
    w = _weights(group, (3, 100, 24))
    want8 = jquant.quantize_expert_weight(jnp.asarray(w))
    got8 = tquant.quantize_expert_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got8.q.numpy(), np.asarray(want8.q))
    np.testing.assert_array_equal(got8.s.numpy(), np.asarray(want8.s))
    assert got8.s.shape == (3, 1, 24) and got8.shape == (3, 100, 24)
    np.testing.assert_array_equal(
        tquant.dequantize_any(got8).numpy(),
        np.asarray(jquant.dequantize_any(want8)))
    want4 = jquant.quantize_expert_weight4(jnp.asarray(w), group=group)
    got4 = tquant.quantize_expert_weight4(torch.from_numpy(w), group=group)
    _assert_same4(got4, want4)
    np.testing.assert_array_equal(
        tquant.dequantize_weight4(got4).numpy(),
        np.asarray(jquant.dequantize_weight4(want4)))


@pytest.mark.parametrize("group", [0, 1, 3, 63])
def test_group_validation_raises_as_reference(group):
    w = np.ones((8, 4), np.float32)
    for fn, arr in ((jquant.quantize_weight4, jnp.asarray(w)),
                    (tquant.quantize_weight4, torch.from_numpy(w)),
                    (jquant.quantize_expert_weight4, jnp.asarray(w[None])),
                    (tquant.quantize_expert_weight4, torch.from_numpy(w[None]))):
        with pytest.raises(ValueError, match="even"):
            fn(arr, group=group)


def _tol(dtype):
    # f32: only the order of f32 sums differs (every product of two bf16
    # values is exact in f32); bf16: one bf16 ulp of the output.
    return (1e-5, 1e-6) if dtype == "float32" else (8e-3, 1e-3)


@pytest.mark.parametrize("t,k,n,group", [(1, 30, 48, 64), (3, 100, 131, 16),
                                         (5, 130, 72, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_plain_matches_reference_kernel(t, k, n, group, dtype):
    """K6's plain version against the reference's Pallas kernel in
    interpret mode and against its dequant oracle, with K tails."""
    rng = np.random.default_rng(t + k + n + group)
    x = rng.standard_normal((t, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jqw = jquant.quantize_weight4(jnp.asarray(w), group=group)
    tqw = tquant.quantize_weight4(torch.from_numpy(w), group=group)
    jx = jnp.asarray(x).astype(dtype)
    got = tquant.int4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                             tqw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (t, n)
    got = got.float().numpy()
    kernel = np.asarray(jquant.int4_matmul(jx, jqw, interpret=True)
                        .astype(jnp.float32))
    oracle = np.asarray(jnp.dot(
        jx.astype(jnp.bfloat16),
        jquant.dequantize_weight4(jqw).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32).astype(dtype).astype(jnp.float32))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got, kernel, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, oracle, rtol=rtol, atol=atol)


@pytest.mark.parametrize("e,t,k,n,group", [(3, 5, 100, 130, 16),
                                           (4, 1, 30, 9, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_matmuls_plain_match_reference_kernels(e, t, k, n, group,
                                                      dtype):
    """K1e's and K6e's plain versions against the reference's expert
    launches (grid (E, N tiles, K tiles)) in interpret mode."""
    rng = np.random.default_rng(e * 100 + t + k + n)
    x = rng.standard_normal((e, t, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rtol, atol = _tol(dtype)
    pairs = (
        (jquant.int8_expert_matmul, jquant.quantize_expert_weight(
            jnp.asarray(w)), tquant.int8_expert_matmul,
         tquant.quantize_expert_weight(torch.from_numpy(w))),
        (jquant.int4_expert_matmul, jquant.quantize_expert_weight4(
            jnp.asarray(w), group=group), tquant.int4_expert_matmul,
         tquant.quantize_expert_weight4(torch.from_numpy(w), group=group)),
    )
    for jfn, jqw, tfn, tqw in pairs:
        got = tfn(tx, tqw)
        assert got.dtype == tx.dtype and got.shape == (e, t, n)
        want = np.asarray(jfn(jx, jqw, interpret=True).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=atol)
    # The dispatchers route by format.
    for _, _, tfn, tqw in pairs:
        assert torch.equal(tquant.quantized_expert_matmul(tx, tqw),
                           tfn(tx, tqw))


def test_int4_rejects_contraction_mismatch_and_foreign_device():
    qw = tquant.quantize_weight4(torch.randn(30, 8), group=16)  # Ks 32
    with pytest.raises(ValueError, match="contraction"):
        tquant.int4_matmul(torch.randn(2, 32), qw)  # K is the logical 30
    with pytest.raises(ValueError, match="no kernel"):
        tquant.int4_matmul(torch.randn(2, 30, device="meta"), qw)
    qe = tquant.quantize_expert_weight(torch.randn(2, 16, 8))
    with pytest.raises(ValueError, match="expert"):
        tquant.int8_expert_matmul(torch.randn(3, 1, 16), qe)


@pytest.fixture
def fresh_registries():
    jtelemetry.metrics().reset()
    ttelemetry.metrics().reset()
    yield
    jtelemetry.metrics().reset()
    ttelemetry.metrics().reset()


def _quant_counters(registry):
    return {k: v for k, v in registry.to_json().items()
            if k.startswith("quant_") and k.endswith("_total")}


def test_byte_counters_equal_reference_name_for_name(fresh_registries):
    """int4 dense (with a group tail), int8 and int4 expert launches,
    tagged and not, tick the same counters by the same amounts."""
    rng = np.random.default_rng(9)
    launches = [("int4", (2, 80), (80, 64), 32, "head"),
                ("int8e", (2, 5, 64), (2, 64, 96), 0, "moe_up"),
                ("int4e", (2, 3, 96), (2, 96, 64), 32, "")]
    for kind, xs, ws, group, tag in launches:
        x = rng.standard_normal(xs).astype(np.float32)
        w = rng.standard_normal(ws).astype(np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        if kind == "int4":
            jquant.int4_matmul(jx, jquant.quantize_weight4(
                jnp.asarray(w), group=group), interpret=True, tag=tag)
            tquant.int4_matmul(tx, tquant.quantize_weight4(
                torch.from_numpy(w), group=group), tag=tag)
        elif kind == "int8e":
            jquant.int8_expert_matmul(jx, jquant.quantize_expert_weight(
                jnp.asarray(w)), interpret=True, tag=tag)
            tquant.int8_expert_matmul(tx, tquant.quantize_expert_weight(
                torch.from_numpy(w)), tag=tag)
        else:
            jquant.int4_expert_matmul(jx, jquant.quantize_expert_weight4(
                jnp.asarray(w), group=group), interpret=True, tag=tag)
            tquant.int4_expert_matmul(tx, tquant.quantize_expert_weight4(
                torch.from_numpy(w), group=group), tag=tag)
    want = _quant_counters(jtelemetry.metrics())
    got = _quant_counters(ttelemetry.metrics())
    assert want and got == want
    # Half a byte per element plus the group scales, the tail padded.
    assert got["quant_int4_matmul_head_weight_bytes_total"] == (
        96 * 64 // 2 + 3 * 64 * 4)


def _cfgs(**kw):
    base = {**BASE, **kw}
    return jmodel.ModelConfig(**base)


@pytest.mark.parametrize("moe,head", [(False, "int8"), (True, "int4"),
                                      (True, False)])
def test_quantize_params4_bit_equal_to_reference(moe, head):
    """Every leaf of the int4 tree (fused wqkv on dense blocks; separate
    wq/wk/wv, int4 expert stacks and a float router on MoE blocks; the
    three head options) carries the reference's exact bytes and
    metadata, and the streamed-bytes accounting agrees."""
    kw = {"num_experts": 3} if moe else {"mlp_gated": True,
                                        "num_kv_heads": 2}
    jparams = _jinit(_cfgs(**kw), jax.random.PRNGKey(2))
    jq = jquant.quantize_params4(jparams, group=8, head=head)
    want = bridge.params_from_numpy(_np_tree(jq), device="cpu")
    got = tquant.quantize_params4(
        bridge.params_from_numpy(_np_tree(jparams), device="cpu"), group=8,
        head=head)
    assert set(got) == set(want)
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert set(gb) == set(wb)
        assert ("wqkv" in gb) == (not moe)
        for name, wl in wb.items():
            gl = gb[name]
            assert type(gl) is type(wl), name
            if tquant.is_quantized(wl):
                assert torch.equal(gl.q, wl.q) and torch.equal(gl.s, wl.s)
                assert gl.shape == wl.shape, name
                if isinstance(wl, tquant.Quantized4Weight):
                    assert (gl.group, gl.kdim) == (wl.group, wl.kdim), name
            else:
                assert torch.equal(gl, wl), name
    if head:
        assert type(got["lm_head"]) is type(want["lm_head"])
        assert torch.equal(got["lm_head"].q, want["lm_head"].q)
        assert torch.equal(got["lm_head"].s, want["lm_head"].s)
    else:
        assert "lm_head" not in got
    assert tquant.decode_stream_bytes(got) == jquant.decode_stream_bytes(jq)


def test_quantize_block_moe_int8_bit_equal():
    jparams = _jinit(_cfgs(num_experts=4), jax.random.PRNGKey(5))
    want = bridge.params_from_numpy(
        _np_tree(jquant.quantize_block(jparams["blocks"][0])), device="cpu")
    got = tquant.quantize_block(bridge.params_from_numpy(
        _np_tree(jparams["blocks"][0]), device="cpu"))
    assert set(got) == set(want) and "wqkv" not in got
    for name in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        assert torch.equal(got[name].q, want[name].q), name
        assert torch.equal(got[name].s, want[name].s), name
    assert torch.equal(got["router"], want["router"])


@pytest.mark.parametrize("head", ["int2", 1, 0, None])
def test_quantize_params4_validates_head_before_packing(head, monkeypatch):
    """A bad ``head`` raises before any block is packed; the integers 1
    and 0 are typos, not booleans."""
    params = bridge.params_from_numpy(_np_tree(_jinit(
        _cfgs(), jax.random.PRNGKey(0))), device="cpu")

    def boom(*a, **k):
        raise AssertionError("packed before validating head")

    monkeypatch.setattr(tquant, "quantize_block4", boom)
    with pytest.raises(ValueError, match="head"):
        tquant.quantize_params4(params, group=8, head=head)


def test_fuse_n_int4_needs_shared_k_and_group():
    a = tquant.quantize_weight4(torch.randn(32, 8), group=8)
    b = tquant.quantize_weight4(torch.randn(32, 8), group=16)
    c = tquant.quantize_weight4(torch.randn(30, 8), group=8)
    with pytest.raises(ValueError, match="share K and group"):
        tquant._fuse_n([a, b], (32, 16))
    with pytest.raises(ValueError, match="share K and group"):
        tquant._fuse_n([a, c], (32, 16))
    fused = tquant._fuse_n([a, a], (32, 16))
    x = torch.randn(3, 32)
    assert torch.equal(tquant.int4_matmul(x, fused),
                       torch.cat([tquant.int4_matmul(x, a)] * 2, dim=1))
