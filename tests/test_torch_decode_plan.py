"""The split of the int8 decode-attention kernels K2 and K5
(tpu_bootstrap_torch/workload/kernels.py: paged_plan, decode_plan,
chunk_bounds, rank_chunks, the shared-memory mirror) and the scheme the
kernels compute (csrc/decode_attention.cuh): a row's positions cut into
chunks at fixed logical boundaries, each chunk's partial softmax (m, l, acc)
in f32, the partials combined in chunk order. An emulation of that scheme
in plain PyTorch, built from the plan's chunk bounds and rank assignment,
is held to the reference's Pallas kernels in interpret mode, and gives the
same bits for any number of ranks (the invariance argument the kernels
rest on). The CUDA kernels themselves run only on the card
(chip_smoke.py)."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import decode as jdecode
from tpu_bootstrap.workload import decode_attention as jda
from tpu_bootstrap_torch.workload import decode_attention as tda
from tpu_bootstrap_torch.workload import kernels

torch.set_num_threads(2)

# f32 against the reference's kernels: the same math summed in another
# order (per chunk, then across chunks), as tests/test_torch_decode_
# attention.py holds the plain versions.
RTOL, ATOL = 2e-5, 2e-6


# ------------------------------------------------------------------ the plan

def test_plans_take_no_batch_and_no_lengths():
    assert list(inspect.signature(kernels.paged_plan).parameters) == [
        "bs", "hk", "g", "d"]
    assert list(inspect.signature(kernels.decode_plan).parameters) == [
        "length", "hk", "g", "d"]
    # The decode model's geometries: a chunk per 64-position block, one
    # rank per chunk up to a cluster of 8.
    assert kernels.paged_plan(64, 16, 1, 64) == kernels.DecodePlan(64, 8)
    assert kernels.paged_plan(64, 4, 4, 64) == kernels.DecodePlan(64, 8)
    assert kernels.decode_plan(256, 16, 1, 64) == kernels.DecodePlan(64, 4)
    assert kernels.decode_plan(512, 4, 4, 64) == kernels.DecodePlan(64, 8)
    assert kernels.decode_plan(5000, 16, 1, 64).ranks == (
        kernels.DECODE_MAX_RANKS)
    assert kernels.decode_plan(1, 16, 1, 64).ranks == 1


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 200, 512, 1000])
@pytest.mark.parametrize("chunk", [1, 12, 64])
def test_chunks_cover_the_row_once_in_order(length, chunk):
    bounds = kernels.chunk_bounds(length, chunk)
    assert [p for a, b in bounds for p in range(a, b)] == list(range(length))
    assert all(0 < b - a <= chunk for a, b in bounds)
    assert all(a % chunk == 0 for a, _ in bounds)  # fixed logical cuts
    # A table of nb blocks caps K2's chunks; a wider table adds none.
    capped = kernels.chunk_bounds(length, chunk, limit=3)
    assert capped == bounds[:3]
    assert kernels.chunk_bounds(length, chunk, limit=len(bounds) + 4) == (
        bounds)


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 8])
def test_ranks_hold_every_chunk_once(ranks):
    for chunks in range(0, 20):
        held = [kernels.rank_chunks(chunks, ranks, r) for r in range(ranks)]
        assert sorted(c for h in held for c in h) == list(range(chunks))
        for r, h in enumerate(held):  # the ring's order: r, r + ranks, ...
            assert h == list(range(r, chunks, ranks))


@pytest.mark.parametrize("g", [1, 4, 16])
def test_smem_mirror_fits_the_limit_it_claims(g):
    for d in (16, 48, 64, 128, 256):
        for bs in (8, 64, 256):
            plan = kernels.paged_plan(bs, 16, g, d)
            if plan is not None:
                assert kernels.paged_attention_smem_bytes(
                    bs, d, g) <= kernels.DECODE_SMEM_LIMIT
        assert kernels.decode_plan(512, 16, g, d) is not None
        assert kernels.decode_attention_smem_bytes(d, g) <= (
            kernels.DECODE_SMEM_LIMIT)
    # The layout (decode_attention.cuh's make_layout) at the decode model's
    # block: q, scores, four warps' p . v, row maxima and sums, a chunk's
    # partial, two ring slots of K, V, scales and flags.
    assert kernels.paged_attention_smem_bytes(64, 64, 1) == (
        256 + 256 + 4 * 256 + 32 + 272 + 2 * (2 * 4096 + 2 * 256 + 64))
    # Just over the limit: no plan, and the split is refused.
    big = kernels.DecodePlan(1024, 1)
    assert kernels.decode_smem_bytes(1024, 128, 64) > (
        kernels.DECODE_SMEM_LIMIT)
    assert kernels.paged_plan(1024, 1, 64, 128) is None
    assert not kernels.decode_split_ok(1, 64, 128, big)


def test_split_ok_refuses_what_the_kernels_cannot_run():
    ok = kernels.DecodePlan(64, 8)
    assert kernels.decode_split_ok(16, 1, 64, ok)
    assert not kernels.decode_split_ok(16, 1, 64, ok._replace(ranks=0))
    assert not kernels.decode_split_ok(16, 1, 64, ok._replace(
        ranks=kernels.DECODE_MAX_RANKS + 1))
    assert not kernels.decode_split_ok(16, 1, 24, ok)
    assert not kernels.decode_split_ok(16, 1, 8, ok)
    assert not kernels.decode_split_ok(0, 1, 64, ok)
    assert not kernels.decode_split_ok(16, 1, 64, ok._replace(chunk=0))


def _a16(v):
    return (v + 15) & ~15


def _old_smem(tile, d, g):
    """The layout the kernels had before the split over positions: one
    tile of ``tile`` positions a CTA, within 48 KB."""
    return (2 * _a16(g * d * 4) + _a16(g * tile * 4) + 3 * _a16(g * 4)
            + 2 * _a16(tile * 4) + _a16(tile * (d + 4)) + _a16(tile * d))


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16, 32, 64])
def test_supports_accept_every_geometry_accepted_before(g):
    """The rules may only widen: a narrower supports would send
    decode._block_step to the einsum path, a hidden fallback."""
    checked = 0
    for d in [*range(16, 257, 16), 512, 1024, 2048, 4096]:
        for hk in (1, 2, 16):
            for bs in (1, 2, 8, 12, 16, 32, 64, 100, 128, 256, 512):
                if _old_smem(bs, d, g) <= 48 * 1024:
                    assert tda.paged_supports(bs, hk, d, hk * g), (bs, d, g)
                    checked += 1
            if _old_smem(128, d, g) <= 48 * 1024:
                for length in (1, 17, 64, 65, 256, 520, 4096):
                    assert tda.supports(length, hk, d, hk * g), (length, d, g)
                    checked += 1
    assert checked > 0


# ------------------------------------------------- the scheme, emulated

def _partial(q, k, v, admitted):
    """One chunk's f32 partial for each query row of q (r, D): scores
    against the admitted positions of k (n, D), m = their max (-inf when
    none), p = e^(s - m), l = sum p, acc = p . v."""
    s = torch.full((q.shape[0], k.shape[0]), -math.inf)
    s[:, admitted] = q @ k[admitted].T
    m = s.amax(-1)
    p = torch.where(admitted[None, :] & (m[:, None] > -math.inf),
                    torch.exp(s - m[:, None]), torch.zeros(()))
    acc = p[:, admitted] @ v[admitted]
    return m, p.sum(-1), acc


def _combine(parts):
    """Partials in chunk order -> out: M = max m_c, then sum_c w_c l_c and
    sum_c w_c acc_c with w_c = e^(m_c - M) (0 for an empty chunk), summed
    in order; a row with nothing admitted gives zeros."""
    if not parts:
        return None
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l_sum, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for m, l_c, acc_c in parts:
        w = torch.where(m > -math.inf, torch.exp(m - mx), torch.zeros(()))
        l_sum = l_sum + w * l_c
        acc = acc + w[:, None] * acc_c
    return torch.where(l_sum[:, None] > 0, acc / l_sum[:, None],
                       torch.zeros(()))


def _emulate(q, rows, ranks):
    """q (B, H, D) f32; rows[b] = (K, V, admitted, bounds): row b's
    dequantized (L_b, Hk, D) K/V, which positions are admitted, and its
    chunks. Each rank computes the chunks it holds, in the ring's order,
    into a workspace of partials by chunk; then each row's partials are
    combined in chunk order. Never reads a position that is not admitted
    (the scales there may be NaN)."""
    b, h, d = q.shape
    out = torch.zeros(b, h, d)
    for r, (k, v, admitted, bounds) in enumerate(rows):
        hk = k.shape[1]
        g = h // hk
        qg = q[r].reshape(hk, g, d) * (d ** -0.5)
        work = [None] * len(bounds)
        for rank in range(ranks):
            for c in kernels.rank_chunks(len(bounds), ranks, rank):
                lo, hi = bounds[c]
                ok = admitted[lo:hi]
                work[c] = [_partial(qg[kh], k[lo:hi, kh], v[lo:hi, kh], ok)
                           for kh in range(hk)]
        for kh in range(hk):
            got = _combine([w[kh] for w in work])
            if got is not None:
                out[r, kh * g:(kh + 1) * g] = got
    return out


def _dequant(q8, s, admitted):
    """int8 (L, Hk, D) with scales (L, Hk) in f32, zeros at positions not
    admitted (their NaN scales are never multiplied)."""
    out = torch.zeros(q8.shape)
    out[admitted] = q8[admitted].float() * s[admitted][..., None]
    return out


def _paged_rows(kq, ks, vq, vs, tables, lengths):
    """Each row's K/V in logical order through its table, up to its
    length, and K2's chunks: one a block, capped by the table width."""
    n, bs = kq.shape[:2]
    nb = tables.shape[1]
    rows = []
    for r in range(tables.shape[0]):
        blocks = tables[r].long()
        span = nb * bs
        admitted = torch.arange(span) < int(lengths[r])
        k = _dequant(kq[blocks].reshape(span, *kq.shape[2:]),
                     ks[blocks].reshape(span, -1), admitted)
        v = _dequant(vq[blocks].reshape(span, *vq.shape[2:]),
                     vs[blocks].reshape(span, -1), admitted)
        rows.append((k, v, admitted,
                     kernels.chunk_bounds(int(lengths[r]), bs, nb)))
    return rows


def _contiguous_rows(kq, ks, vq, vs, valid):
    length = kq.shape[1]
    return [(_dequant(kq[r], ks[r], valid), _dequant(vq[r], vs[r], valid),
             valid, kernels.chunk_bounds(length, kernels.DECODE_CHUNK))
            for r in range(kq.shape[0])]


def _quantized(rng, shape):
    q8, s = jdecode._quantize_kv(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)))
    return torch.from_numpy(np.array(q8)), torch.from_numpy(np.array(s))


def _paged_case():
    """B=5, H=8, Hk=2, D=16, bs=8 over a 16-block pool: lengths across
    block boundaries (1, a full block, one past it, a long row, a
    mid-block end); row 4's first block aliases row 3's; every position no
    row may read holds int8 extremes and NaN scales."""
    rng = np.random.default_rng(11)
    bs, nb, hk, d = 8, 5, 2, 16
    lengths = torch.tensor([1, 8, 9, 37, 20], dtype=torch.int32)
    tables = torch.zeros(5, nb, dtype=torch.int32)
    nxt = 1
    for r, length in enumerate(lengths.tolist()):
        for j in range(-(-length // bs)):
            tables[r, j] = nxt
            nxt += 1
    tables[4, 0] = tables[3, 0]
    n = 16
    kq, ks = _quantized(rng, (n, bs, hk, d))
    vq, vs = _quantized(rng, (n, bs, hk, d))
    readable = torch.zeros(n, bs, dtype=torch.bool)
    for r, length in enumerate(lengths.tolist()):
        for p in range(length):
            readable[tables[r, p // bs], p % bs] = True
    poisoned = [a.clone() for a in (kq, ks, vq, vs)]
    poisoned[0][~readable] = 127
    poisoned[2][~readable] = -128
    poisoned[1][~readable] = math.nan
    poisoned[3][~readable] = math.nan
    q = torch.from_numpy(rng.standard_normal((5, 8, d)).astype(np.float32))
    return q, (kq, ks, vq, vs), poisoned, tables, lengths


def _contiguous_case(length, mask):
    """B=3, H=8, Hk=2, D=16 at cache length ``length``; the mask's hidden
    positions hold int8 extremes and NaN scales in the poisoned copy."""
    rng = np.random.default_rng(length)
    kq, ks = _quantized(rng, (3, length, 2, 16))
    vq, vs = _quantized(rng, (3, length, 2, 16))
    cols = torch.arange(length)
    valid = {"full": cols < length,
             "prefix": cols <= 70,  # ends inside the second chunk
             # chunk 1 (64..127) admits nothing; holes elsewhere
             "holes": (torch.from_numpy(np.random.default_rng(3).random(
                 length) < 0.6) | (cols == 0)) & ~((cols >= 64)
                                                   & (cols < 128))}[mask]
    poisoned = [a.clone() for a in (kq, ks, vq, vs)]
    poisoned[0][:, ~valid] = 127
    poisoned[2][:, ~valid] = -128
    poisoned[1][:, ~valid] = math.nan
    poisoned[3][:, ~valid] = math.nan
    q = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    return q, (kq, ks, vq, vs), poisoned, valid


def test_paged_scheme_matches_reference_kernel():
    """Ragged lengths across chunk boundaries, an aliased table, NaN
    scales wherever no row may read: the emulation (on the poisoned pool)
    against the reference's _paged_kernel (on the clean one)."""
    q, clean, poisoned, tables, lengths = _paged_case()
    want = jda.paged_decode_attention_int8(
        jnp.asarray(q.numpy()), *(jnp.asarray(a.numpy()) for a in clean),
        jnp.asarray(tables.numpy()), jnp.asarray(lengths.numpy()),
        interpret=True)
    got = _emulate(q, _paged_rows(*poisoned, tables, lengths), ranks=3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("length,mask", [(96, "full"), (200, "prefix"),
                                         (200, "holes"), (256, "holes")])
def test_contiguous_scheme_matches_reference_kernel(length, mask):
    """Full, a frontier inside a chunk, and holes with a chunk that admits
    nothing (it must add exactly 0): the emulation (NaN scales at masked
    positions) against the reference's _kernel (clean cache)."""
    q, clean, poisoned, valid = _contiguous_case(length, mask)
    want = jda.decode_attention_int8(
        jnp.asarray(q.numpy()), *(jnp.asarray(a.numpy()) for a in clean),
        jnp.asarray(valid.numpy()), interpret=True)
    got = _emulate(q, _contiguous_rows(*poisoned, valid), ranks=4)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_all_masked_row_gives_zeros():
    """A K5 row that admits nothing (every chunk empty, every scale NaN)
    gives zeros and no NaN, as the plain version does."""
    q, _, poisoned, _ = _contiguous_case(130, "full")
    none = torch.zeros(130, dtype=torch.bool)
    poisoned[1][:] = math.nan
    poisoned[3][:] = math.nan
    got = _emulate(q, _contiguous_rows(*poisoned, none), ranks=2)
    assert torch.equal(got, torch.zeros_like(q))
    assert torch.equal(tda.decode_attention_int8_plain(
        q, *poisoned, none), torch.zeros_like(q))


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_paged_scheme_is_bitwise_the_same_for_any_ranks(ranks):
    q, _, poisoned, tables, lengths = _paged_case()
    base = _emulate(q, _paged_rows(*poisoned, tables, lengths), ranks=1)
    got = _emulate(q, _paged_rows(*poisoned, tables, lengths), ranks=ranks)
    assert torch.equal(got, base)
    # A wider table and a row alone change no bit either.
    wide = torch.cat([tables, torch.zeros_like(tables)], dim=1)
    assert torch.equal(_emulate(q, _paged_rows(*poisoned, wide, lengths),
                                ranks=ranks), base)
    alone = _emulate(q[3:4], _paged_rows(*poisoned, tables[3:4],
                                         lengths[3:4]), ranks=ranks)
    assert torch.equal(alone[0], base[3])


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_contiguous_scheme_is_bitwise_the_same_for_any_ranks(ranks):
    q, _, poisoned, valid = _contiguous_case(256, "holes")
    base = _emulate(q, _contiguous_rows(*poisoned, valid), ranks=1)
    assert torch.equal(_emulate(q, _contiguous_rows(*poisoned, valid),
                                ranks=ranks), base)
    alone = _emulate(q[1:2], _contiguous_rows(
        *(a[1:2] for a in poisoned), valid), ranks=ranks)
    assert torch.equal(alone[0], base[1])
