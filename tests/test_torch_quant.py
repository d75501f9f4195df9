"""The port's int8 weight quantization and int8 matmul
(tpu_bootstrap_torch/workload/quant.py) held to the JAX reference on the
CPU: quantized bytes and scales bit-equal, the matmul's plain version
against the reference's Pallas kernel (interpret mode) and its oracle,
and the per-launch byte counters name for name."""

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
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import quant as tquant

torch.set_num_threads(2)


def _cfgs(**kw):
    base = dict(vocab_size=48, num_layers=2, num_heads=4, head_dim=8,
                embed_dim=32, mlp_dim=40, max_seq_len=32)
    base.update(kw)
    return jmodel.ModelConfig(**base), tmodel.ModelConfig(**base)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_quantize_weight_bit_equal_including_zero_columns():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((37, 19)).astype(np.float32)
    w[:, 4] = 0.0  # absmax 0: scale 1, all-zero column
    w[3, 7] = 1e-30  # a tiny column maximum
    want = jquant.quantize_weight(jnp.asarray(w))
    got = tquant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    assert got.q.dtype == torch.int8 and got.shape == tuple(want.shape)


@pytest.mark.parametrize("gated", [False, True])
def test_quantize_params_bit_equal_to_reference(gated):
    """Every quantized leaf (block projections, fused wqkv / w_gateup,
    the transposed lm_head) carries the reference's exact bytes, and the
    streamed-bytes accounting agrees."""
    jcfg, _ = _cfgs(mlp_gated=gated, num_kv_heads=2)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    want = bridge.params_from_numpy(_np_tree(jquant.quantize_params(jparams)),
                                    device="cpu")
    got = tquant.quantize_params(bridge.params_from_numpy(_np_tree(jparams),
                                                          device="cpu"))
    names = {"wq", "wk", "wv", "wo", "w_up", "w_down", "wqkv"}
    if gated:
        names |= {"w_gate", "w_gateup"}
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert set(gb) == set(wb)
        for name in names:
            assert tquant.is_quantized(gb[name]), name
            assert torch.equal(gb[name].q, wb[name].q), name
            assert torch.equal(gb[name].s, wb[name].s), name
            assert gb[name].shape == wb[name].shape, name
    assert torch.equal(got["lm_head"].q, want["lm_head"].q)
    assert torch.equal(got["lm_head"].s, want["lm_head"].s)
    assert got["lm_head"].q.is_contiguous()
    assert (tquant.decode_stream_bytes(got)
            == jquant.decode_stream_bytes(jquant.quantize_params(jparams)))


@pytest.mark.parametrize("t,k,n", [(1, 64, 48), (3, 77, 131), (8, 256, 40),
                                   (13, 130, 257)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_reference_kernel(t, k, n, dtype):
    """The plain version against the reference's Pallas kernel in
    interpret mode and against its oracle: f32 to rtol 1e-5 (only the
    order of f32 sums differs), bf16 to one bf16 ulp of the output."""
    rng = np.random.default_rng(t * 1000 + k + n)
    x = rng.standard_normal((t, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jqw = jquant.quantize_weight(jnp.asarray(w))
    tqw = tquant.quantize_weight(torch.from_numpy(w))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tquant.int8_matmul(tx, tqw)
    assert got.dtype == tx.dtype and got.shape == (t, n)
    got = got.float().numpy()
    kernel = np.asarray(jquant.int8_matmul(jx, jqw, interpret=True)
                        .astype(jnp.float32))
    oracle = np.asarray(jquant.reference_int8_matmul(jx, jqw)
                        .astype(jnp.float32))
    rtol, atol = (1e-5, 1e-6) if dtype == "float32" else (8e-3, 1e-3)
    np.testing.assert_allclose(got, kernel, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, oracle, rtol=rtol, atol=atol)


def test_int8_matmul_rejects_contraction_mismatch_and_foreign_device():
    qw = tquant.quantize_weight(torch.randn(16, 8))
    with pytest.raises(ValueError, match="contraction"):
        tquant.int8_matmul(torch.randn(2, 12), qw)
    with pytest.raises(ValueError, match="no kernel"):
        tquant.int8_matmul(torch.randn(2, 16, device="meta"), qw)


def test_byte_counters_equal_reference_name_for_name():
    """The same launches (untagged, qkv, head; f32 and bf16 activations)
    tick the same ``quant_*_total`` counters by the same amounts."""
    rng = np.random.default_rng(5)
    launches = [(4, 32, 96, "float32", ""), (1, 32, 96, "bfloat16", "qkv"),
                (3, 40, 64, "float32", "head"), (2, 32, 96, "bfloat16", "")]
    jtelemetry.metrics().reset()
    ttelemetry.metrics().reset()
    try:
        for t, k, n, dtype, tag in launches:
            x = rng.standard_normal((t, k)).astype(np.float32)
            w = rng.standard_normal((k, n)).astype(np.float32)
            jquant.int8_matmul(jnp.asarray(x).astype(dtype),
                               jquant.quantize_weight(jnp.asarray(w)),
                               interpret=True, tag=tag)
            tquant.int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                               tquant.quantize_weight(torch.from_numpy(w)),
                               tag=tag)
        want = {k: v for k, v in jtelemetry.metrics().to_json().items()
                if k.startswith("quant_") and k.endswith("_total")}
        got = {k: v for k, v in ttelemetry.metrics().to_json().items()
               if k.startswith("quant_")}
    finally:
        jtelemetry.metrics().reset()
        ttelemetry.metrics().reset()
    assert want and got == want


def test_weight_stream_bytes_float_and_quantized():
    w = torch.randn(24, 10)
    assert tquant.weight_stream_bytes(w) == 24 * 10 * 4
    assert tquant.weight_stream_bytes(tquant.quantize_weight(w)) == (
        24 * 10 + 10 * 4)


def test_not_ported_weight_formats_raise():
    """Every weight format is ported now: a MoE block quantizes (its
    projections int8, no fused wqkv, the router float), a float weight
    handed to the quantized dispatch is refused by type, and expert
    parallelism over several devices without the expert axis's process
    group raises (it runs on gloo ranks,
    tests/test_torch_mesh_parallel.py)."""
    from tpu_bootstrap_torch.workload import moe as tmoe

    rng = np.random.default_rng(8)
    block = {name: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
        for name, shape in (("wq", (8, 2, 4)), ("wk", (8, 2, 4)),
                            ("wv", (8, 2, 4)), ("wo", (2, 4, 8)),
                            ("router", (8, 3)), ("w_up", (3, 8, 6)),
                            ("w_down", (3, 6, 8)))}
    q = tquant.quantize_block(block)
    assert "wqkv" not in q and q["router"] is block["router"]
    assert q["w_up"].s.shape == (3, 1, 6)
    with pytest.raises(TypeError, match="Tensor"):
        tquant.quantized_matmul(torch.zeros(1, 4), torch.zeros(4, 4))
    with pytest.raises(TypeError, match="Tensor"):
        tquant.quantized_expert_matmul(torch.zeros(3, 1, 8), block["w_up"])
    cfg = tmodel.ModelConfig(num_experts=3, embed_dim=8, mlp_dim=6)
    with pytest.raises(ValueError, match="process group of 'expert'"):
        tmoe.moe_mlp_manual(block, torch.zeros(1, 2, 8), cfg, n_expert=2)
