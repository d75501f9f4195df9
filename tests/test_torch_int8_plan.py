"""K1/K1e's launch plan (tpu_bootstrap_torch/workload/kernels.py) on the
CPU: the split of the contraction depends on the weight's shape and the
card, never on T; it fills an H100 (132 SMs) at every int8 projection of
the decode and MoE models; its bounds fall on whole ring slots and cover K;
a split the kernel does not take is refused; the shared-memory layout
lets the kernel's CTAs share an SM. And the plain versions of K1 and K1e
against the reference's Pallas kernel in interpret mode at the shapes the
CUDA kernel handles apart: several T tiles (T = 17), a second group of T
tiles (T = 33), N not a multiple of 16 (no tensor map on the card), K not
a multiple of 64 (a partial ring slot) and three experts."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap_torch.workload import kernels
from tpu_bootstrap_torch.workload import quant as tquant

torch.set_num_threads(2)

H100_SMS = 132
# (E, K, N) of every int8 projection of the decode model and its MoE form
# (chip_smoke.py K1_SHAPES, MOE_SHAPES).
DECODE_SHAPES = {"wqkv": (1, 1024, 3072), "wo": (1, 1024, 1024),
                 "w_up": (1, 1024, 4096), "w_down": (1, 4096, 1024),
                 "lm_head": (1, 1024, 32768), "moe_up": (8, 1024, 4096),
                 "moe_down": (8, 4096, 1024)}


def test_plan_takes_no_t():
    assert list(inspect.signature(kernels.int8_plan).parameters) == [
        "e", "k", "n", "sms"]


@pytest.mark.parametrize("name", sorted(DECODE_SHAPES))
def test_plan_fills_an_h100_at_decode_shapes(name):
    e, k, n = DECODE_SHAPES[name]
    plan = kernels.int8_plan(e, k, n, H100_SMS)
    assert plan.ctas >= H100_SMS
    assert plan.ctas == e * -(-n // kernels.QUANT_TILE_N) * plan.split
    assert 1 <= plan.split <= kernels.QUANT_MAX_SPLIT
    # About INT8_CTAS_PER_SM CTAs an SM, where the splits allow.
    tiles = plan.ctas // plan.split
    assert plan.split == min(kernels.QUANT_MAX_SPLIT, k // 64, max(
        -(-H100_SMS // tiles), kernels.INT8_CTAS_PER_SM * H100_SMS // tiles))
    bounds = kernels.int8_split_bounds(k, plan.split)
    assert plan.stages == -(-max(k1 - k0 for k0, k1 in bounds)
                            // kernels.QUANT_STAGE_K)


def test_plan_splits_the_narrow_projections_and_not_the_wide():
    # wo and w_down have 16 column tiles: split to fill 132 SMs; the
    # lm_head and moe_up have 512 tiles: no split.
    for name in ("wo", "w_down"):
        assert kernels.int8_plan(*DECODE_SHAPES[name], H100_SMS).split == 16
    for name in ("lm_head", "moe_up"):
        assert kernels.int8_plan(*DECODE_SHAPES[name], H100_SMS).split == 1


@pytest.mark.parametrize("k", [1024, 4096, 1000, 16, 17, 64, 100, 1,
                               3072])
def test_split_bounds_cover_k_on_whole_slots(k):
    units = kernels.int8_units(k)
    assert units == -(-k // 64)
    for split in range(1, min(kernels.QUANT_MAX_SPLIT, units) + 1):
        bounds = kernels.int8_split_bounds(k, split)
        assert len(bounds) == split
        assert bounds[0][0] == 0 and bounds[-1][1] == -(-k // 16) * 16 >= k
        for (k0, k1), (n0, _) in zip(bounds, bounds[1:] + [(bounds[-1][1],
                                                            None)]):
            assert k0 < k1 == n0  # contiguous, none empty
            assert k0 % 64 == 0 and k1 % 16 == 0
            assert k1 % 64 == 0 or k1 == bounds[-1][1]  # a partial tail


@pytest.mark.parametrize("k,split", [(1024, 0), (1024, 17), (32, 2),
                                     (1, 2), (1024, -1), (1000, 17),
                                     (256, 5)])
def test_bad_plan_is_refused(k, split):
    with pytest.raises(ValueError, match="int8 split"):
        kernels.int8_split_bounds(k, split)


def test_plan_never_exceeds_the_units_or_the_cluster():
    for k in (1, 16, 40, 64, 1 << 16):
        for n in (16, 64, 1000):
            plan = kernels.int8_plan(1, k, n, H100_SMS)
            assert 1 <= plan.split <= min(kernels.QUANT_MAX_SPLIT,
                                          kernels.int8_units(k))


def test_smem_layout_fits_the_resident_ctas():
    """The Python mirror of the kernel's shared memory (checked against
    the CUDA side by chip_smoke.py's build phase): int8's 5 slots of 64
    rows x 64 bytes and its 64 column scales, int4's 6 slots of 32 packed
    rows plus 4 scale rows, beside the 32 KB activation chunk, barriers and
    alignment slack; each lets QUANT_RESIDENT_CTAS CTAs share an H100 SM."""
    assert kernels.quant_smem_bytes(8) == (32768 + 5 * 4096 + 5 * 16 + 256
                                           + 1024)
    assert kernels.quant_smem_bytes(4) == (32768 + 6 * (2048 + 1024)
                                           + 6 * 16 + 1024)
    for bits in (4, 8):
        smem = kernels.quant_smem_bytes(bits)
        assert kernels.QUANT_RESIDENT_CTAS * (
            smem + kernels.CTA_RESERVED_SMEM) <= kernels.SM_SMEM_BYTES
    # A sixth int8 slot would leave room for 3 CTAs only.
    assert kernels.QUANT_RESIDENT_CTAS * (
        kernels.quant_smem_bytes(8) + 4096 + 16
        + kernels.CTA_RESERVED_SMEM) > kernels.SM_SMEM_BYTES


def test_wrapper_passes_the_same_split_for_every_t(monkeypatch):
    """What the wrapper hands the C entry, with the library and the device
    checks stood in for: the split follows the weight, whatever T."""
    calls = []

    class FakeLib:
        def tpubc_int8_matmul(self, *args):
            calls.append(args)
            return 0

    def need(t, name, dtypes, ndim):
        assert t.dtype in dtypes and t.ndim == ndim, name

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "_need", need)
    monkeypatch.setattr(kernels, "_stream", lambda: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    qw = tquant.quantize_weight(torch.randn(1024, 1024))
    qe = tquant.quantize_expert_weight(torch.randn(8, 4096, 128))
    for t in (1, 8, 17, 64, 300):
        kernels.int8_matmul(torch.randn(t, 1024, dtype=torch.bfloat16), qw.q,
                            qw.s)
        kernels.int8_expert_matmul(torch.randn(8, t, 4096), qe.q, qe.s)
    dense = {c[-2] for c in calls[0::2]}
    expert = {c[-2] for c in calls[1::2]}
    assert dense == {kernels.int8_plan(1, 1024, 1024, H100_SMS).split} == {16}
    assert expert == {kernels.int8_plan(8, 4096, 128, H100_SMS).split}
    assert [c[5] for c in calls[0::2]] == [1, 8, 17, 64, 300]
    assert [c[4] for c in calls[1::2]] == [8] * 5


def _tol(dtype):
    # As tests/test_torch_quant.py: f32 only the order of f32 sums
    # differs; bf16 one bf16 ulp of the output.
    return (1e-5, 1e-6) if dtype == "float32" else (8e-3, 1e-3)


@pytest.mark.parametrize("e,t,k,n", [(0, 17, 128, 64), (0, 33, 96, 40),
                                     (0, 5, 100, 72), (3, 17, 100, 40),
                                     (3, 33, 64, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_at_t_tiles_and_ragged_shapes(e, t, k, n,
                                                              dtype):
    """K1's and K1e's plain versions against the reference's Pallas kernel
    in interpret mode: T = 17 spans three 8-row tiles, T = 33 a second
    group of four; N = 40 and 72 are not multiples of 16; K = 96 and 100
    are not multiples of 64 (K = 100 not of 16); E = 3 experts."""
    rng = np.random.default_rng(e * 1000 + t + k + n)
    lead = (e,) if e else ()
    x = rng.standard_normal((*lead, t, k)).astype(np.float32)
    w = (rng.standard_normal((*lead, k, n)) / np.sqrt(k)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if e:
        jqw = jquant.quantize_expert_weight(jnp.asarray(w))
        tqw = tquant.quantize_expert_weight(torch.from_numpy(w))
        want = jquant.int8_expert_matmul(jx, jqw, interpret=True)
        got = tquant.int8_expert_matmul(tx, tqw)
    else:
        jqw = jquant.quantize_weight(jnp.asarray(w))
        tqw = tquant.quantize_weight(torch.from_numpy(w))
        want = jquant.int8_matmul(jx, jqw, interpret=True)
        got = tquant.int8_matmul(tx, tqw)
    assert got.dtype == tx.dtype and got.shape == (*lead, t, n)
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
