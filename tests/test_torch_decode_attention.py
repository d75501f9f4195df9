"""The port's int8 decode attention
(tpu_bootstrap_torch/workload/decode_attention.py) held to the JAX
reference's Pallas kernels in interpret mode. Paged (K2's plain
version): the reference test case, MQA / GQA / MHA groupings, tables
that alias a block across rows, and invariance to garbage wherever a
row's table and length do not reach. Contiguous (K5's plain version):
MHA / GQA / MQA groupings, prefix masks and masks with holes, bf16 and
f32 queries, and invariance to garbage at masked positions. The int8 KV
quantizer is held to the reference bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import decode as jdecode
from tpu_bootstrap.workload import decode_attention as jda
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import decode_attention as tda

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 2e-6


def _case(seed, b, h, hk, d, bs, nblk, tables, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((nblk, bs, hk, d)).astype(np.float32)
    v = rng.standard_normal((nblk, bs, hk, d)).astype(np.float32)
    return (q, k, v, np.asarray(tables, np.int32),
            np.asarray(lengths, np.int32))


def _both(q, k, v, bt, lengths, garbage=None):
    """Quantize K/V on both sides (asserting equal bytes), optionally
    overwrite positions with garbage, and run both attentions."""
    jkq, jks = jdecode._quantize_kv(jnp.asarray(k))
    jvq, jvs = jdecode._quantize_kv(jnp.asarray(v))
    tkq, tks = tdecode._quantize_kv(torch.from_numpy(k))
    tvq, tvs = tdecode._quantize_kv(torch.from_numpy(v))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(tvq.numpy(), np.asarray(jvq))
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    kq, ks, vq, vs = (np.asarray(a) for a in (jkq, jks, jvq, jvs))
    if garbage is not None:
        kq, vq = kq.copy(), vq.copy()
        kq[garbage] = 127
        vq[garbage] = -128
    want = jda.paged_decode_attention_int8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(bt), jnp.asarray(lengths),
        interpret=True)
    got = tda.paged_decode_attention_int8(
        *(torch.from_numpy(np.array(a)) for a in
          (q, kq, ks, vq, vs, bt, lengths)))
    return got.numpy(), np.asarray(want)


REFERENCE_CASE = dict(b=3, h=8, hk=2, d=16, bs=8, nblk=12,
                      tables=[[3, 7, 1], [5, 2, 0], [9, 0, 0]],
                      lengths=[20, 11, 5])


@pytest.mark.parametrize("case", [
    REFERENCE_CASE,
    # MQA: one KV head under four query heads.
    dict(b=2, h=4, hk=1, d=16, bs=8, nblk=6, tables=[[2, 4], [1, 3]],
         lengths=[13, 16]),
    # MHA, three blocks per row, full and one-token rows.
    dict(b=3, h=2, hk=2, d=32, bs=16, nblk=9,
         tables=[[1, 2, 3], [6, 5, 4], [8, 0, 0]], lengths=[48, 33, 1]),
    # Aliased tables: rows 0 and 1 share physical block 4 (a shared
    # prefix), read-only.
    dict(b=2, h=4, hk=2, d=16, bs=8, nblk=6, tables=[[4, 1], [4, 2]],
         lengths=[16, 9]),
], ids=["reference", "mqa", "mha", "aliased"])
def test_paged_plain_matches_reference_kernel(case):
    q, k, v, bt, lengths = _case(7, case["b"], case["h"], case["hk"],
                                 case["d"], case["bs"], case["nblk"],
                                 case["tables"], case["lengths"])
    got, want = _both(q, k, v, bt, lengths)
    assert got.shape == (case["b"], case["h"], case["d"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_paged_plain_ignores_unowned_and_masked_positions():
    """Garbage in the null block, a block no table names, and row 1's
    positions past its length-11 frontier leaves every output bit
    unchanged, in the port as in the reference."""
    c = REFERENCE_CASE
    q, k, v, bt, lengths = _case(1, c["b"], c["h"], c["hk"], c["d"],
                                 c["bs"], c["nblk"], c["tables"],
                                 c["lengths"])
    base, base_ref = _both(q, k, v, bt, lengths)
    garbage = np.zeros((c["nblk"], c["bs"]), bool)
    garbage[0] = garbage[11] = True
    garbage[2, 3:] = True
    got, want = _both(q, k, v, bt, lengths, garbage=garbage)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_array_equal(want, base_ref)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_paged_plain_keeps_q_dtype():
    c = REFERENCE_CASE
    q, k, v, bt, lengths = _case(2, c["b"], c["h"], c["hk"], c["d"],
                                 c["bs"], c["nblk"], c["tables"],
                                 c["lengths"])
    kq, ks = tdecode._quantize_kv(torch.from_numpy(k))
    vq, vs = tdecode._quantize_kv(torch.from_numpy(v))
    qb = torch.from_numpy(q).to(torch.bfloat16)
    out = tda.paged_decode_attention_int8(
        qb, kq, ks, vq, vs, torch.from_numpy(bt), torch.from_numpy(lengths))
    assert out.dtype == torch.bfloat16
    ref = tda.paged_decode_attention_int8(
        qb.float(), kq, ks, vq, vs, torch.from_numpy(bt),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=1e-2, atol=1e-2)


def test_quantize_kv_bit_equal_on_edge_values():
    """Zero vectors (scale floored at 1e-8), exact halves (round half to
    even) and large magnitudes quantize to the reference's bytes."""
    x = np.zeros((3, 2, 16), np.float32)
    x[1, 0] = np.linspace(-127, 127, 16)
    x[1, 1] = np.arange(16) - 7.5
    x[2] = np.random.default_rng(4).standard_normal((2, 16)) * 1e4
    jq, js = jdecode._quantize_kv(jnp.asarray(x))
    tq, ts = tdecode._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_paged_supports_is_the_kernels_own_rule():
    assert tda.paged_supports(64, 16, 64, 16)
    assert tda.paged_supports(64, 4, 64, 16)  # group of 4
    assert tda.paged_supports(12, 4, 64)  # any block size the smem holds
    assert not tda.paged_supports(64, 4, 24)  # head_dim not a 16-multiple
    assert tda.paged_supports(256, 1, 128, 4)  # opts into > 48 KB smem
    # One block's shared memory past what a CTA may opt into.
    assert not tda.paged_supports(1024, 1, 128, 64)
    c = REFERENCE_CASE
    q, k, v, bt, lengths = _case(3, c["b"], c["h"], c["hk"], c["d"],
                                 c["bs"], c["nblk"], c["tables"],
                                 c["lengths"])
    kq, ks = tdecode._quantize_kv(torch.from_numpy(k[..., :8]))
    with pytest.raises(ValueError, match="paged_supports"):
        tda.paged_decode_attention_int8(
            torch.from_numpy(q[..., :8]), kq, ks, kq, ks,
            torch.from_numpy(bt), torch.from_numpy(lengths))


# The contiguous cache of the reference's own K5 tests
# (tests/test_decode_attention.py): L = 96 runs as one Pallas tile.
B, L, D = 2, 96, 16


def _contiguous(heads, kv_heads, seed):
    """q and the int8 cache, quantized by the reference (bit-equal to the
    port's quantizer, test_quantize_kv_bit_equal_on_edge_values)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, heads, D)).astype(np.float32)
    out = [q]
    for _ in range(2):
        x = rng.standard_normal((B, L, kv_heads, D)).astype(np.float32)
        quantized, scale = jdecode._quantize_kv(jnp.asarray(x))
        out += [np.asarray(quantized), np.asarray(scale)]
    return out  # q, kq, ks, vq, vs


def _both_contiguous(q, kq, ks, vq, vs, valid, dtype=torch.float32):
    """The reference kernel (interpret mode) and the port's wrapper (the
    plain version, on the CPU) on the same inputs, q in ``dtype``."""
    qt = torch.from_numpy(q).to(dtype)
    qj = jnp.asarray(q).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = jda.decode_attention_int8(
        qj, *(jnp.asarray(a) for a in (kq, ks, vq, vs)), jnp.asarray(valid),
        interpret=True)
    got = tda.decode_attention_int8(
        qt, *(torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)),
        torch.from_numpy(np.array(valid)))
    assert got.dtype == dtype
    return (got.float().numpy(),
            np.asarray(want.astype(jnp.float32)))


# bf16 queries: both sides compute in f32 (agreeing to RTOL) and round the
# output to bf16 once, so an element may land one bf16 step (2^-8
# relative) apart where its f32 values straddle a rounding boundary.
BF16_RTOL = 2 ** -8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2), (4, 1)])
def test_contiguous_plain_matches_reference_kernel(heads, kv_heads, dtype):
    q, kq, ks, vq, vs = _contiguous(heads, kv_heads, seed=heads + kv_heads)
    valid = np.ones(L, bool)
    got, want = _both_contiguous(q, kq, ks, vq, vs, valid, dtype)
    assert got.shape == (B, heads, D)
    rtol = RTOL if dtype == torch.float32 else BF16_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


def _holes():
    """Slot 0 valid (as in every mask generate builds), a run of masked
    slots, scattered holes and a valid last slot."""
    valid = np.random.default_rng(5).random(L) < 0.6
    valid[0] = valid[-1] = True
    valid[10:30] = False
    return valid


@pytest.mark.parametrize("mask", ["0", "7", "40", "L-2", "holes"])
def test_contiguous_plain_respects_mask(mask):
    """Prefix frontiers (the reference's pos cases) and a mask with holes:
    the port matches the reference kernel, and garbage (kq = 127,
    vq = -128) at every masked slot leaves both outputs bitwise
    unchanged."""
    q, kq, ks, vq, vs = _contiguous(8, 2, seed=1)
    if mask == "holes":
        valid = _holes()
    else:
        pos = L - 2 if mask == "L-2" else int(mask)
        valid = np.arange(L) <= pos
    got, want = _both_contiguous(q, kq, ks, vq, vs, valid)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    kq2, vq2 = kq.copy(), vq.copy()
    kq2[:, ~valid] = 127
    vq2[:, ~valid] = -128
    got2, want2 = _both_contiguous(q, kq2, ks, vq2, vs, valid)
    np.testing.assert_array_equal(got2, got)
    np.testing.assert_array_equal(want2, want)


def test_contiguous_plain_all_masked_row_is_zero():
    """Outside the contract (every mask generate builds admits slot 0):
    an all-masked row gives zeros, as the CUDA kernel does."""
    q, kq, ks, vq, vs = (torch.from_numpy(np.array(a))
                         for a in _contiguous(4, 2, seed=3))
    out = tda.decode_attention_int8(q, kq, ks, vq, vs,
                                    torch.zeros(L, dtype=torch.bool))
    assert torch.equal(out, torch.zeros_like(q))


def test_supports_is_the_kernels_own_rule():
    """K5 takes any length (no Mosaic tiling rule): 17 and 520, which the
    reference's supports refuses, are fine; head dims must be 16-multiples
    and a chunk's shared memory must fit what a CTA may opt into."""
    assert not jda.supports(17, 4, 64) and not jda.supports(520, 4, 64)
    assert tda.supports(17, 4, 64) and tda.supports(520, 4, 64)
    assert tda.supports(1, 16, 64, 16) and tda.supports(256, 2, 128, 16)
    assert not tda.supports(0, 4, 64)
    assert not tda.supports(96, 4, 24)  # head_dim not a 16-multiple
    assert tda.supports(96, 1, 256)  # opts into > 48 KB smem
    assert not tda.supports(96, 1, 256, 256)  # a chunk over the limit
    q, kq, ks, vq, vs = (torch.from_numpy(np.array(a))
                         for a in _contiguous(4, 2, seed=4))
    with pytest.raises(ValueError, match="supports"):
        tda.decode_attention_int8(q[..., :8].contiguous(),
                                  kq[..., :8].contiguous(), ks,
                                  vq[..., :8].contiguous(), vs,
                                  torch.ones(L, dtype=torch.bool))
    # An odd length runs, and agrees with the same slots masked out of a
    # longer cache (the sums run over other lengths: to RTOL, not bitwise).
    odd = tda.decode_attention_int8(q, kq[:, :17], ks[:, :17], vq[:, :17],
                                    vs[:, :17], torch.ones(17, dtype=torch.bool))
    valid = torch.arange(L) < 17
    np.testing.assert_allclose(
        odd.numpy(), tda.decode_attention_int8(q, kq, ks, vq, vs,
                                               valid).numpy(),
        rtol=RTOL, atol=ATOL)
