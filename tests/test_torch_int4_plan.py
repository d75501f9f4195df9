"""K6/K6e's launch plan (tpu_bootstrap_torch/workload/kernels.py) on the
CPU: the split of the contraction depends on the weight's shape and the
card, never on T; it fills an H100 (132 SMs) at every projection of the
decode models; its bounds fall on whole k-steps (whole groups at g = 64);
a split the kernel does not take is refused. And the plain versions of K6
and K6e against the reference's Pallas kernel in interpret mode at the
shapes the CUDA kernel handles apart: several T tiles (T = 17) and N that
is not a multiple of 16."""

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
# (E, K, N) of every int4 projection of the decode model and its MoE form
# (chip_smoke.py K1_SHAPES, MOE_SHAPES), group 64.
DECODE_SHAPES = {"wqkv": (1, 1024, 3072), "wo": (1, 1024, 1024),
                 "w_up": (1, 1024, 4096), "w_down": (1, 4096, 1024),
                 "lm_head": (1, 1024, 32768), "moe_up": (8, 1024, 4096),
                 "moe_down": (8, 4096, 1024)}


def test_plan_takes_no_t():
    assert list(inspect.signature(kernels.int4_plan).parameters) == [
        "e", "ks", "n", "group", "sms"]


@pytest.mark.parametrize("name", sorted(DECODE_SHAPES))
def test_plan_fills_an_h100_at_decode_shapes(name):
    e, k, n = DECODE_SHAPES[name]
    plan = kernels.int4_plan(e, k, n, 64, H100_SMS)
    assert plan.ctas >= H100_SMS
    assert plan.ctas == e * -(-n // kernels.QUANT_TILE_N) * plan.split
    assert 1 <= plan.split <= kernels.QUANT_MAX_SPLIT
    # About INT4_CTAS_PER_SM CTAs an SM, where the splits allow.
    tiles = plan.ctas // plan.split
    assert plan.split == min(kernels.QUANT_MAX_SPLIT, k // 64, max(
        -(-H100_SMS // tiles), kernels.INT4_CTAS_PER_SM * H100_SMS // tiles))
    bounds = kernels.int4_split_bounds(k, 64, plan.split)
    assert plan.stages == -(-max(k1 - k0 for k0, k1 in bounds)
                            // kernels.QUANT_STAGE_K)


@pytest.mark.parametrize("ks,group", [(1024, 64), (4096, 64), (1024, 16),
                                      (1536, 48), (1026, 6), (96, 6),
                                      (64, 64), (2048, 128)])
def test_split_bounds_fall_on_whole_steps_and_groups(ks, group):
    units = kernels.int4_units(ks, group)
    for split in range(1, min(kernels.QUANT_MAX_SPLIT, units) + 1):
        bounds = kernels.int4_split_bounds(ks, group, split)
        assert len(bounds) == split
        assert bounds[0][0] == 0 and bounds[-1][1] == -(-ks // 16) * 16
        for (k0, k1), (n0, _) in zip(bounds, bounds[1:] + [(bounds[-1][1],
                                                            None)]):
            assert k0 < k1 == n0  # contiguous, none empty
            assert k0 % 16 == 0 and k1 % 16 == 0
            if group % 16 == 0:
                assert k0 % group == 0 and k1 % group == 0


@pytest.mark.parametrize("ks,group,split", [(1024, 64, 0), (1024, 64, 17),
                                            (128, 64, 3), (32, 6, 3),
                                            (1024, 64, -1)])
def test_bad_plan_is_refused(ks, group, split):
    with pytest.raises(ValueError, match="int4 split"):
        kernels.int4_split_bounds(ks, group, split)


def test_plan_never_exceeds_the_units_or_the_cluster():
    for ks, group in ((64, 64), (128, 64), (32, 6), (1 << 16, 64)):
        for n in (16, 64, 1000):
            plan = kernels.int4_plan(1, ks, n, group, H100_SMS)
            assert 1 <= plan.split <= min(kernels.QUANT_MAX_SPLIT,
                                          kernels.int4_units(ks, group))


def test_wrapper_passes_the_same_split_for_every_t(monkeypatch):
    """What the wrapper hands the C entry, with the library and the device
    checks stood in for: the split follows the weight, whatever T."""
    calls = []

    class FakeLib:
        def tpubc_int4_matmul(self, *args):
            calls.append(args)
            return 0

    def need(t, name, dtypes, ndim):
        assert t.dtype in dtypes and t.ndim == ndim, name

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "_need", need)
    monkeypatch.setattr(kernels, "_stream", lambda: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: H100_SMS)
    qw = tquant.quantize_weight4(torch.randn(1024, 1024), group=64)
    qe = tquant.quantize_expert_weight4(torch.randn(8, 4096, 128), group=64)
    for t in (1, 8, 17, 64, 300):
        kernels.int4_matmul(torch.randn(t, 1024, dtype=torch.bfloat16), qw.q,
                            qw.s, 64, 1024)
        kernels.int4_expert_matmul(torch.randn(8, t, 4096), qe.q, qe.s, 64,
                                   4096)
    dense = {c[-2] for c in calls[0::2]}
    expert = {c[-2] for c in calls[1::2]}
    assert dense == {kernels.int4_plan(1, 1024, 1024, 64, H100_SMS).split}
    assert expert == {kernels.int4_plan(8, 4096, 128, 64, H100_SMS).split}
    assert [c[5] for c in calls[0::2]] == [1, 8, 17, 64, 300]


def _tol(dtype):
    # As tests/test_torch_quant4.py: f32 only the order of f32 sums
    # differs; bf16 one bf16 ulp of the output.
    return (1e-5, 1e-6) if dtype == "float32" else (8e-3, 1e-3)


@pytest.mark.parametrize("e,t,k,n,group", [(0, 17, 130, 72, 16),
                                           (0, 17, 96, 40, 6),
                                           (3, 17, 100, 40, 16),
                                           (2, 9, 64, 24, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_at_t_tiles_and_ragged_n(e, t, k, n, group,
                                                         dtype):
    """K6's and K6e's plain versions against the reference's Pallas
    kernel in interpret mode: T = 17 spans three 8-row tiles, N is not a
    multiple of 16 (no tensor map on the card), K has a tail."""
    rng = np.random.default_rng(e * 1000 + t + k + n + group)
    lead = (e,) if e else ()
    x = rng.standard_normal((*lead, t, k)).astype(np.float32)
    w = (rng.standard_normal((*lead, k, n)) / np.sqrt(k)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if e:
        jqw = jquant.quantize_expert_weight4(jnp.asarray(w), group=group)
        tqw = tquant.quantize_expert_weight4(torch.from_numpy(w), group=group)
        want = jquant.int4_expert_matmul(jx, jqw, interpret=True)
        got = tquant.int4_expert_matmul(tx, tqw)
    else:
        jqw = jquant.quantize_weight4(jnp.asarray(w), group=group)
        tqw = tquant.quantize_weight4(torch.from_numpy(w), group=group)
        want = jquant.int4_matmul(jx, jqw, interpret=True)
        got = tquant.int4_matmul(tx, tqw)
    assert got.dtype == tx.dtype and got.shape == (*lead, t, n)
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
