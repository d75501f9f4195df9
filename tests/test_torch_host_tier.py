"""The paged engine's host tier (tpu_bootstrap_torch/workload/serving.py:
HostBlockPool, the hierarchical prefix plan, demotion through the
allocator's eviction seam, swap-out of preemption victims, the batched
restore, the cost model's arms, reset) held to the JAX reference:
HostBlockPool op sequences against the reference's (keys in LRU order,
bytes and stats after every op), the arms of both packages' cost models
on the same rows, the working-set traffic of bench.py:951-1057 at a tiny
width on both pools (the host hit rate chip_smoke.py holds the card to),
and the mirrors of the reference's tests/test_host_tier.py on the port's
pool (device="cpu", K2's plain version): swapped-and-restored streams
equal the never-swapped ones exactly, and a restore writes the pool
tensors in place, bitwise the demoted bytes.

test_host_tier.py:141 (sampled streams and prompt lookup) is mirrored in
tests/test_torch_sampled_serving.py and tests/test_torch_spec_serving.py
(with a model draft too, whose pools' half of a host entry is held
there). The kv_quant=False case of :120 (the float pool) is in
tests/test_torch_float_pool.py. Not mirrored: :166 (marked slow in the
reference)."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_scheduler import (
    JCFG,
    JPARAMS,
    POOL,
    TCFG,
    TPARAMS,
    _alloc_state,
    _drive,
    _reqs,
    _solo,
    _specs,
)
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import faults
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)


def _drain(pool):
    got = {}
    while pool.has_active():
        for rid, ev in pool.step_round().items():
            if ev["done"]:
                got[rid] = ev["generated"]
    return got


def _check_allocator(pool):
    """The partition and index invariants: free + live + cached is the id
    space exactly, the index maps are inverse, the host accounting adds
    up."""
    a = pool.allocator
    ids = list(a._free) + list(a._ref) + list(a._cached)
    assert len(set(ids)) == len(ids)
    assert set(ids) == set(range(1, a.num_blocks + 1))
    assert {a._index[k]: k for k in a._index} == dict(a._key_of)
    if pool.host is not None:
        assert len(pool.host) <= pool.host.capacity
        assert pool.host.bytes == sum(
            e["bytes"] for e in pool.host._entries.values())


def _pools_snapshot(pool, ids):
    return [{n: a[ids].clone() for n, a in layer.items()}
            for layer in pool.pools]


# ---- HostBlockPool against the reference's --------------------------------


def _host_state(h) -> tuple:
    return (list(h.keys()), h.bytes, dict(h.stats), len(h),
            h.snapshot_json(), h.digest_json())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_pool_differential_against_reference(seed):
    """Seeded sequences of put (new and parked keys), get, pop, clear and
    capacity overflow on both HostBlockPools: after every op the same
    result and the same keys in LRU order, bytes and stats."""
    rng = np.random.default_rng(seed)
    ref, port = jserving.HostBlockPool(4, 8), tserving.HostBlockPool(4, 8)
    keys = [tserving.block_hash(b"", [i] * 8) for i in range(7)]
    for _ in range(200):
        op = int(rng.integers(0, 10))
        k = keys[int(rng.integers(len(keys)))]
        if op < 6:
            nbytes = int(rng.integers(1, 100))
            for h in (ref, port):
                h.put(k, {"t": None, "d": None, "bytes": nbytes})
        elif op < 8:
            assert (port.get(k) is None) == (ref.get(k) is None)
            assert (k in port) == (k in ref)
        elif op == 8 and k in ref:
            assert port.pop(k)["bytes"] == ref.pop(k)["bytes"]
        elif op == 9 and rng.random() < 0.2:
            ref.clear()
            port.clear()
        assert _host_state(port) == _host_state(ref)
    with pytest.raises(ValueError, match="capacity"):
        tserving.HostBlockPool(0, 8)


def test_eviction_cascade_order():
    """test_host_tier.py:345."""
    host = tserving.HostBlockPool(2, block_size=8)
    k1, k2, k3 = (tserving.block_hash(b"", [i] * 8) for i in (1, 2, 3))
    host.put(k1, {"t": None, "d": None, "bytes": 10})
    host.put(k2, {"t": None, "d": None, "bytes": 20})
    assert list(host.keys()) == [k1, k2] and host.bytes == 30
    host.put(k1, {"t": None, "d": None, "bytes": 10})
    assert list(host.keys()) == [k2, k1] and host.bytes == 30
    host.put(k3, {"t": None, "d": None, "bytes": 5})
    assert list(host.keys()) == [k1, k3]
    assert host.bytes == 15 and host.stats["drops"] == 1
    assert k2 not in host
    snap = host.snapshot_json()
    assert snap["blocks"] == 2 and snap["dropped"] == 1
    d = host.digest_json()
    assert d["blocks"] == len(d["fps"]) == 2


# ---- the tier on the pool ----------------------------------------------------


def test_tier_env_sizes_and_disables(monkeypatch):
    """TPUBC_KV_HOST_BLOCKS: unset or "auto" is the pool's block count,
    0 none, a number that many; the tier needs the prefix cache; the
    port's default is the reference's."""
    monkeypatch.delenv("TPUBC_KV_HOST_BLOCKS", raising=False)
    kw = dict(block_size=8, kv_blocks=12)
    assert tserving.PagedPool(TPARAMS, TCFG, 2, **kw,
                              **POOL).host.capacity == 12
    assert jserving.PagedPool(JPARAMS, JCFG, 2, **kw,
                              kv_quant=True).host.capacity == 12
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "auto")
    assert tserving.PagedPool(TPARAMS, TCFG, 2, **kw,
                              **POOL).host.capacity == 12
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "5")
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, **kw, **POOL)
    assert pool.host.capacity == 5
    assert pool.allocator.evict_hook == pool._demote_block
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, **kw, **POOL)
    assert pool.host is None and pool.allocator.evict_hook is None
    assert tserving.PagedPool(TPARAMS, TCFG, 2, host_blocks=8,
                              prefix_cache=False, **kw, **POOL).host is None
    with pytest.raises(ValueError, match="host_blocks"):
        tserving.PagedPool(TPARAMS, TCFG, 2, host_blocks=-1, **kw, **POOL)


def test_tier_off_env_disables_and_matches(monkeypatch):
    """test_host_tier.py:91: tier off streams exactly as tier on, on a
    preempting overcommit shape, and both as the never-preempted engine."""
    reqs = _reqs(tserving, _specs(8, seed=7))
    monkeypatch.setenv("TPUBC_EXPECTED_NEW", "2")
    kw = dict(paged=True, block_size=8, kv_blocks=8, prefill_budget=4,
              overcommit=True, **POOL)
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")
    s_off: dict = {}
    off = tserving.serve(TPARAMS, TCFG, reqs, 8, stats=s_off, **kw)
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "64")
    s_on: dict = {}
    on = tserving.serve(TPARAMS, TCFG, reqs, 8, stats=s_on, **kw)
    assert off == on
    assert s_off["preemptions"] > 0 and s_on["preemptions"] > 0
    assert "swap_preempts" not in s_off and "host" not in s_off
    assert s_on["host"]["capacity"] == 64
    ref = tserving.serve(TPARAMS, TCFG, reqs, 8, paged=True, block_size=8,
                         prefill_budget=8, **POOL)
    assert off == ref


def test_swap_restore_streams_byte_identical(monkeypatch):
    """test_host_tier.py:120 (kv_quant=True): a generous link makes every
    victim swap; the streams equal the tier-off run's."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    monkeypatch.setenv("TPUBC_EXPECTED_NEW", "2")
    reqs = _reqs(tserving, _specs(8, seed=11))
    kw = dict(paged=True, block_size=8, kv_blocks=8, prefill_budget=4,
              overcommit=True, **POOL)
    swapped: dict = {}
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "64")
    on = tserving.serve(TPARAMS, TCFG, reqs, 8, stats=swapped, **kw)
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")
    off = tserving.serve(TPARAMS, TCFG, reqs, 8, **kw)
    assert on == off
    assert swapped["preemptions"] > 0
    assert swapped["swap_preempts"] > 0


def test_demoted_prefix_promotes_bit_exact(monkeypatch):
    """test_host_tier.py:188, and the bytes: every demoted payload is the
    block's bytes, and every promoted block holds its payload, bitwise, in
    all four tensors of every layer, written into the pool's own tensors
    (their addresses unchanged)."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    prompt = np.random.default_rng(17).integers(1, 32, 20).tolist()
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=16,
                              prefill_budget=8, host_blocks=16, **POOL)
    pool.admit(tserving.Request(rid=1, tokens=prompt, max_new=6))
    first = _drain(pool)[1]
    assert pool.allocator.cached() > 0
    cached = dict(pool.allocator._cached)  # bid -> key
    before = {k: _pools_snapshot(pool, b) for b, k in cached.items()}
    ptrs = [a.data_ptr() for layer in pool.pools for a in layer.values()]
    demoted = pool.demote_lru(pool.allocator.cached())
    assert demoted > 0 and len(pool.host) == demoted
    assert pool.allocator.cached() == 0
    for k, layers in before.items():
        entry = pool.host.get(k)
        for li, layer in enumerate(layers):
            for n, t in layer.items():
                assert torch.equal(entry["t"][li][n], t), n
    payload = {k: pool.host.get(k) for k in pool.host.keys()}
    plan, _cow, _ = pool._prefix_plan(prompt)
    assert plan and all(tier == "host" for tier, _b, _k in plan)
    pool.admit(tserving.Request(rid=2, tokens=prompt, max_new=6))
    assert pool.stats["host_hit_tokens"] > 0
    assert pool.host.stats["promotions"] > 0
    s = next(s for s in pool.slots if s is not None)
    for j, (_tier, _b, k) in enumerate(plan):
        for li, layer in enumerate(pool.pools):
            for n, a in layer.items():
                assert torch.equal(a[s.blocks[j]], payload[k]["t"][li][n]), n
    assert ptrs == [a.data_ptr() for layer in pool.pools
                    for a in layer.values()]
    assert _drain(pool)[2] == first
    cold = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=16,
                              prefill_budget=8, host_blocks=0, **POOL)
    cold.admit(tserving.Request(rid=3, tokens=prompt, max_new=6))
    assert _drain(cold)[3] == first == _solo(prompt, 6)
    _check_allocator(pool)


def test_promoted_block_rejoins_hbm_index(monkeypatch):
    """test_host_tier.py:220."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    prompt = list(range(1, 17))
    pool = tserving.PagedPool(TPARAMS, TCFG, 3, block_size=8, kv_blocks=16,
                              prefill_budget=8, host_blocks=16, **POOL)
    pool.admit(tserving.Request(rid=1, tokens=prompt + [20], max_new=4))
    _drain(pool)
    pool.demote_lru(pool.allocator.cached())
    pool.admit(tserving.Request(rid=2, tokens=prompt + [21], max_new=4))
    swap_ins = pool.host.stats["promotions"]
    assert swap_ins > 0
    plan, _cow, _ = pool._prefix_plan(prompt + [22])
    assert plan and all(tier == "hbm" for tier, _b, _k in plan)
    pool.admit(tserving.Request(rid=3, tokens=prompt + [22], max_new=4))
    assert pool.host.stats["promotions"] == swap_ins
    got = _drain(pool)
    assert got[3] == _solo(prompt + [22], 4)
    _check_allocator(pool)


# ---- the cost model ---------------------------------------------------------


def test_arm_selection_under_forced_bandwidths(monkeypatch):
    """test_host_tier.py:244, on both packages' pools at once: under the
    same forced link rates, prefill costs and peak, the same (arm, swap
    ms, recompute ms) for the same row (the two packages' unforced link
    seeds differ: the reference's is a TPU host's)."""
    monkeypatch.setenv("TPUBC_PEAK_TFLOPS", "989")
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "16")
    kw = dict(block_size=8, kv_blocks=16, prefill_budget=8, host_blocks=16)
    port = tserving.PagedPool(TPARAMS, TCFG, 2, **kw, **POOL)
    ref = jserving.PagedPool(JPARAMS, JCFG, 2, **kw, kv_quant=True)
    req = dict(rid=1, tokens=list(range(1, 18)), max_new=4)
    port.admit(tserving.Request(**req))
    ref.admit(jserving.Request(**req))
    ps = next(s for s in port.slots if s is not None)
    rs = next(s for s in ref.slots if s is not None)

    def arms():
        got, want = port._preempt_arm(ps), ref._preempt_arm(rs)
        assert got == want
        return got

    # Before any prefill is timed: the FLOPs price at the peak.
    assert port._prefill_ms_per_tok is None
    arms()
    for pool in (port, ref):
        pool._host_gbps_ema = 1e6
        pool._prefill_ms_per_tok = 0.5
    arm, swap_ms, recomp_ms = arms()
    assert arm == "swap" and swap_ms < recomp_ms
    for pool in (port, ref):
        pool._host_gbps_ema = 1e-9
    arm, swap_ms, recomp_ms = arms()
    assert arm == "recompute" and swap_ms > recomp_ms
    for pool in (port, ref):
        pool._host_gbps_ema = None
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1e-9")
    assert arms()[0] == "recompute"
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1e6")
    assert arms()[0] == "swap"
    for pool in (port, ref):
        pool.host = None
    assert arms()[0] == "recompute"


def test_arm_priced_at_h100_peak_without_a_card(monkeypatch):
    """With no card and no TPUBC_PEAK_TFLOPS, the recompute arm prices
    prefill at the H100 SXM's bf16 peak, the decision the card would
    make; TPUBC_HOST_XFER_GBPS unset seeds the link with the port's own
    rate, not the reference's TPU host figure."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: its name picks the peak")
    monkeypatch.delenv("TPUBC_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("TPUBC_HOST_XFER_GBPS", raising=False)
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=16,
                              host_blocks=16, **POOL)
    pool.admit(tserving.Request(rid=1, tokens=list(range(1, 18)),
                                max_new=4))
    s = next(s for s in pool.slots if s is not None)
    _arm, swap_ms, recomp_ms = pool._preempt_arm(s)
    per_tok = (tserving.flops_model(TCFG)["prefill"]
               / (telemetry.H100_SXM_BF16_TFLOPS * 1e12) * 1e3)
    assert recomp_ms == (len(s.history) - 1) * per_tok
    assert telemetry.host_xfer_gbps() == telemetry.DEFAULT_HOST_XFER_GBPS
    assert swap_ms == (len(s.history) * pool._kv_bytes_per_tok
                       / (telemetry.DEFAULT_HOST_XFER_GBPS * 1e9) * 1e3)


def test_measured_bandwidth_ema_feeds_the_model():
    """test_host_tier.py:269."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=8,
                              host_blocks=8, **POOL)
    assert pool._host_gbps_ema is None
    pool._note_bw(8e9, 1.0)
    assert pool._host_gbps() == pytest.approx(8.0)
    pool._note_bw(16e9, 1.0)
    assert pool._host_gbps() == pytest.approx(0.8 * 8.0 + 0.2 * 16.0)
    pool._note_bw(0, 0.0)
    assert pool._host_gbps() == pytest.approx(0.8 * 8.0 + 0.2 * 16.0)
    assert telemetry.metrics().to_json()["serve_swap_bandwidth_gbps"] == (
        round(0.8 * 8.0 + 0.2 * 16.0, 4))


# ---- churn, reset, LRU -------------------------------------------------------


def test_allocator_churn_demote_promote_defrag(monkeypatch):
    """test_host_tier.py:284: random demotion, defrag, preemption and
    quarantine churn under an overcommitted Scheduler; the invariants hold
    after every step and every stream equals its solo run."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    rng = np.random.default_rng(23)
    sysp = rng.integers(1, 32, 16).tolist()
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8, kv_blocks=12,
                              prefill_budget=8, host_blocks=10, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    expected, got = {}, {}
    for i in range(10):
        tail = rng.integers(1, 32, 3).tolist()
        r = tserving.Request(rid=i, tokens=sysp + tail, max_new=4)
        expected[i] = _solo(r.tokens, r.max_new)
        sched.submit(r)
        for _ in range(int(rng.integers(1, 4))):
            for rid, ev in sched.step().items():
                if ev["done"]:
                    got[rid] = ev["generated"]
            op = rng.integers(0, 4)
            if op == 0 and pool.allocator.cached():
                pool.demote_lru(int(rng.integers(1, 3)))
            elif op == 1:
                pool.defrag()
            elif op == 2 and pool.has_active():
                pool.preempt_one()
                sched._drain_preempted()
            elif op == 3:
                sched.requeue(pool.quarantine(reason="drill"))
            _check_allocator(pool)
    while sched.pending() or pool.has_active():
        for rid, ev in sched.step().items():
            if ev["done"]:
                got[rid] = ev["generated"]
        _check_allocator(pool)
    assert got == expected
    assert pool.host.stats["puts"] > 0 and pool.host.stats["promotions"] > 0


def test_host_tier_survives_reset_and_rehooks():
    """test_host_tier.py:325, and the port's in-place reset: the pool
    tensors are zeroed where they are (the captured steps read their
    addresses) and a promotion after the reset restores into them."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=16,
                              prefill_budget=8, host_blocks=16, **POOL)
    prompt = list(range(1, 18))
    pool.admit(tserving.Request(rid=1, tokens=prompt, max_new=4))
    first = _drain(pool)[1]
    pool.demote_lru(pool.allocator.cached())
    parked = len(pool.host)
    assert parked > 0
    ptrs = [a.data_ptr() for layer in pool.pools for a in layer.values()]
    pool.reset()
    assert len(pool.host) == parked
    assert pool.allocator.evict_hook == pool._demote_block
    assert ptrs == [a.data_ptr() for layer in pool.pools
                    for a in layer.values()]
    assert all(not a.any() for layer in pool.pools for a in layer.values())
    plan, _cow, _ = pool._prefix_plan(prompt)
    assert plan and all(tier == "host" for tier, _b, _k in plan)
    pool.admit(tserving.Request(rid=2, tokens=prompt, max_new=4))
    assert pool.stats["swap_in_blocks"] == len(plan)
    assert _drain(pool)[2] == first


def test_pool_demotion_follows_hbm_lru_order():
    """test_host_tier.py:367."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=16,
                              prefill_budget=8, host_blocks=3, **POOL)
    for rid, base in ((1, 0), (2, 40)):
        pool.admit(tserving.Request(
            rid=rid, tokens=[(base + t) % 31 + 1 for t in range(17)],
            max_new=4))
        _drain(pool)
    lru = [pool.allocator._cached[b] for b in pool.allocator._cached]
    pool.demote_lru(len(lru))
    assert list(pool.host.keys()) == lru[-3:]
    assert pool.host.stats["drops"] == len(lru) - 3


def test_digest_match_len_scores_host_tier(monkeypatch):
    """test_host_tier.py:386, and the digest equal to the reference's
    pool's on the same traffic, before and after the demotion."""
    kw = dict(block_size=8, kv_blocks=16, prefill_budget=8, host_blocks=16)
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, **kw, **POOL)
    ref = jserving.PagedPool(JPARAMS, JCFG, 2, **kw, kv_quant=True)
    prompt = list(range(1, 18))
    pool.admit(tserving.Request(rid=1, tokens=prompt, max_new=4))
    ref.admit(jserving.Request(rid=1, tokens=prompt, max_new=4))
    _drain(pool)
    _drain(ref)
    assert pool._cache_digest_json() == ref._cache_digest_json()
    hbm_score = tserving.digest_match_len(prompt, pool._cache_digest_json())
    assert hbm_score == 2
    pool.demote_lru(pool.allocator.cached())
    ref.demote_lru(ref.allocator.cached())
    d = pool._cache_digest_json()
    assert d == ref._cache_digest_json()
    assert d["blocks"] == 0 and d["host"]["blocks"] > 0
    assert tserving.digest_match_len(prompt, d) == hbm_score
    monkeypatch.setenv("TPUBC_CACHE_DIGEST", "0")
    off = tserving.PagedPool(TPARAMS, TCFG, 2, **kw, **POOL)
    assert off._cache_digest_json()["host"] == {"blocks": 0, "bytes": 0,
                                                "fps": []}


# ---- swap.xfer faults: degrade, never corrupt ------------------------------


def test_swap_xfer_fault_degrades_to_recompute(monkeypatch):
    """test_host_tier.py:405."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    reqs = _reqs(tserving, _specs(8, seed=29))
    faults.install(",".join(f"swap.xfer:1:{i}" for i in range(500)))
    try:
        pool = tserving.PagedPool(TPARAMS, TCFG, 8, block_size=8,
                                  kv_blocks=8, prefill_budget=4,
                                  host_blocks=64, **POOL)
        sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
        got = _drive(pool, sched, reqs)
        assert len(pool.host) == 0
        _check_allocator(pool)
    finally:
        faults.install(None)
    assert pool.stats["preemptions"] > 0
    off = tserving.serve(TPARAMS, TCFG, reqs, 8, paged=True, block_size=8,
                         kv_blocks=8, prefill_budget=4, overcommit=True,
                         **POOL)
    assert got == off


def test_promotion_claim_fault_truncates_plan(monkeypatch):
    """test_host_tier.py:430."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    prompt = list(range(1, 26))
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=16,
                              prefill_budget=8, host_blocks=16, **POOL)
    pool.admit(tserving.Request(rid=1, tokens=prompt, max_new=6))
    first = _drain(pool)[1]
    pool.demote_lru(pool.allocator.cached())
    assert len(pool.host) >= 3
    faults.install("swap.xfer:1:1")
    try:
        pool.admit(tserving.Request(rid=2, tokens=prompt, max_new=6))
    finally:
        faults.install(None)
    s = next(s for s in pool.slots if s is not None)
    assert s.prefilled == pool.block_size
    assert _drain(pool)[2] == first
    _check_allocator(pool)


# ---- bench.py's host-tier traffic on both packages -------------------------


def test_working_set_host_hit_rate_equals_reference():
    """bench.py:951-996's working set at chip_smoke.py's sizes (block 16,
    64 blocks, a host tier of 64, ten 40-token prompts, max_new 8) on a
    tiny model in both packages: after phase A, the demotion of every
    cached block and phase B, the same host keys, stats and allocator
    state, and phase B's host hit rate equal to chip_smoke.HOST_HIT_RATE,
    which the card is held to (it depends on lengths and sizes alone)."""
    cs = chip_smoke
    kw = dict(block_size=cs.HT_BLOCK, kv_blocks=cs.HT_POOL,
              host_blocks=cs.HT_POOL)
    port = tserving.PagedPool(TPARAMS, TCFG, 8, **kw, **POOL)
    ref = jserving.PagedPool(JPARAMS, JCFG, 8, **kw, kv_quant=True)
    prompts = cs._ht_prompts(TCFG.vocab_size)
    rates = []
    for pool, mod in ((port, tserving), (ref, jserving)):
        for rid0 in (0, 100):
            if rid0:
                pool.demote_lru(pool.allocator.cached())
                hh0 = pool.stats.get("host_hit_tokens", 0)
                pt0 = pool.stats["prompt_tokens"]
            cs._ht_drive(pool, [mod.Request(rid=rid0 + i, tokens=t,
                                            max_new=cs.HT_NEW)
                                for i, t in enumerate(prompts)])
        rates.append((pool.stats["host_hit_tokens"] - hh0)
                     / (pool.stats["prompt_tokens"] - pt0))
    assert rates == [cs.HOST_HIT_RATE, cs.HOST_HIT_RATE]
    assert list(port.host.keys()) == list(ref.host.keys())
    assert port.host.snapshot_json() == ref.host.snapshot_json()
    assert _alloc_state(port.allocator) == _alloc_state(ref.allocator)
    assert {k: port.stats[k] for k in ref.stats} == ref.stats
    assert port.allocator.cached() + len(port.host) == 20


def test_bench_burst_never_preempts_in_either_package():
    """bench.py:1001-1044's preempting burst (12 requests of 8 tokens,
    max_new 24, batch 8, block 16, 12 blocks, expected_new 2) never
    preempts: the admission watermark keeps each admitted row's growth to
    its whole 2-block footprint free, so at most 6 rows run and they fit.
    The same in the reference; chip_smoke.py therefore measures the swap
    arm on bench.py:1160-1172's tight pool."""
    cs = chip_smoke
    stats = []
    for mod, params, cfg, pkw in ((tserving, TPARAMS, TCFG, POOL),
                                  (jserving, JPARAMS, JCFG,
                                   {"kv_quant": True})):
        pool = mod.PagedPool(params, cfg, 8, block_size=cs.HT_BLOCK,
                             kv_blocks=cs.HT_BURST_BLOCKS,
                             host_blocks=cs.HT_POOL, **pkw)
        sched = mod.Scheduler(pool, overcommit=True, expected_new=2)
        _drive(pool, sched, cs._burst(mod, cfg.vocab_size, cs.HT_BURST,
                                      cs.HT_BURST_SEED, 200,
                                      cs.HT_BURST_NEW))
        stats.append(dict(pool.stats))
    assert stats[0] == stats[1]
    assert stats[0]["preemptions"] == 0 and stats[0]["grown_blocks"] > 0
