"""The paged engine's fault seams and crash-is-preemption recovery
(tpu_bootstrap_torch/workload/serving.py: the ``pool.device``, ``alloc``,
``sched.admit`` and ``swap.xfer`` seams, BlockAllocator.quarantine_to_cache,
PagedPool.quarantine, Scheduler._recover and the restart bound) and
deadlines (Scheduler._shed_expired, _PoolBase.cancel), held to the JAX
reference: differential runs on pinned clocks (tests/test_torch_requestz.py's
``differential``) set the same ``TPUBC_FAULT`` schedule in both packages and
compare everything after every step, exactly (f32): the same seams fire at
the same calls, the same rows are quarantined and salvaged, and the streams,
recoveries and sheds agree. Then the mirrors of the reference's
tests/test_faults.py:199-362, :585-679 and :736 on the port's pool
(device="cpu", K2's plain version), their ingress halves left out: the
engine-level schedule each chaos test pins, driven through the Scheduler.

The port writes its pools in place, so it cannot ask, as the reference
does, whether a failed round consumed its arrays: it marks each in-place
write, and a failure inside one resets the pools (in place, the addresses
kept) instead of salvaging a block some layers of which are new and others
old. Two tests cut a write short between two layers (a prefill chunk's
scatter, and defrag) and one fails a graph capture.

Not mirrored: :118-187 (the injector's grammar, ported with ckpt.save,
tests/test_torch_data_checkpoint.py); the kv_quant=False cases of :257
are in tests/test_torch_float_pool.py, and its sampled case, a crash
recovered with the streams kept, in tests/test_torch_sampled_serving.py. The ingress halves,
:439-583 and :679 (the drain, the watchdog, socket and scrape faults and
SIGTERM), are in tests/test_torch_ingress_faults.py."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_graphs import Replaying
from tests.test_torch_requestz import STEP_S, T0, clocks  # noqa: F401
from tests.test_torch_requestz import differential
from tests.test_torch_scheduler import (
    POOL,
    TCFG,
    TPARAMS,
    _drive,
    _reqs,
    _solo,
    _specs,
    pinned_cost,  # noqa: F401 - a fixture
)
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import bridge, faults, graphs
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import serving as tserving
from tpu_bootstrap_torch.workload.faults import InjectedFault

torch.set_num_threads(2)

# Two layers, so a write can be cut short between them.
BASE2 = dict(vocab_size=32, num_layers=2, num_heads=2, head_dim=16,
             embed_dim=16, mlp_dim=32, max_seq_len=64)
TCFG2 = tmodel.ModelConfig(**BASE2)
TPARAMS2 = bridge.params_from_numpy(jax.tree.map(
    np.asarray, jquant.quantize_params(jmodel.init_params(
        jmodel.ModelConfig(**BASE2), jax.random.PRNGKey(3)))), device="cpu")


@pytest.fixture(autouse=True)
def _no_lingering_faults():
    """Every test leaves the injector off: a schedule left behind would
    fire inside another test's rounds."""
    yield
    faults.install(None)


def _solo2(tokens, max_new):
    return tdecode.generate(TPARAMS2, [tokens], TCFG2, max_new,
                            kv_quant=True, kv_kernel=False,
                            device="cpu")[0].tolist()


def _check_allocator_invariants(pool):
    """test_faults.py:96: every table reference is a refcount, every id
    exactly one of free, live or cached, nothing aliased."""
    alloc = pool.allocator
    refs: dict = {}
    for s in pool.slots:
        if s is not None:
            for b in s.blocks:
                refs[b] = refs.get(b, 0) + 1
    assert set(refs) == set(alloc._ref), "live set != table-referenced set"
    for b, c in refs.items():
        assert alloc.refcount(b) == c, (b, c, alloc.refcount(b))
    assert len(alloc._free) == len(set(alloc._free)), "free-heap dup"
    assert (len(alloc._free) + len(alloc._ref) + len(alloc._cached)
            == alloc.num_blocks)
    assert not (set(alloc._free) & set(alloc._ref))
    assert not (set(alloc._free) & set(alloc._cached))
    assert not (set(alloc._ref) & set(alloc._cached))


def _addresses(pool) -> list:
    return [a.data_ptr() for layer in pool.pools for a in layer.values()]


# ---- against the reference --------------------------------------------------


TIGHT = dict(batch_size=8, block_size=8, kv_blocks=8, prefill_budget=4)
# (specs, pool kwargs, scheduler kwargs, TPUBC_FAULT spec)
FAULT_CASES = {
    # Two device aborts and an allocator breach mid-burst (test_faults.py
    # :266's schedule) on a roomy pool with the prefix cache.
    "device_alloc": (_specs(6, seed=7), dict(
        batch_size=4, block_size=8, prefill_budget=4), {},
        "pool.device:1:2,pool.device:1:6,alloc:1:4"),
    # The same with an admission fault, on a tight overcommitted pool whose
    # host tier swaps: recovery composes with preemption and swap-out.
    "all_seams_tight": (_specs(8, seed=7), dict(TIGHT, host_blocks=64),
                        dict(overcommit=True, expected_new=2),
                        "pool.device:1:3,pool.device:1:9,alloc:1:6,"
                        "sched.admit:1:4,swap.xfer:1:1"),
    # Without the prefix cache: nothing to salvage, the resume recomputes.
    "no_prefix_cache": (_specs(6, seed=7), dict(
        batch_size=4, block_size=8, prefill_budget=4, prefix_cache=False),
        {}, "pool.device:1:2,alloc:1:3,sched.admit:1:2"),
}


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_fault_recovery_differential_against_reference(name,
                                                       clocks):  # noqa: F811
    specs, pool_kw, sched_kw, spec = FAULT_CASES[name]
    done, pool, sched, fired = differential(
        specs, pool_kw, sched_kw, clocks, fault=spec,
        checks=_check_allocator_invariants)
    rules = spec.split(",")
    sites = {r.split(":")[0] for r in rules}
    assert set(fired["fired"]) == sites, fired
    assert sched.stats["recoveries"] == sum(
        1 for r in rules if not r.startswith("swap.xfer"))
    for i, t, m, _p in specs:
        assert done[i] == _solo(t, m), i
    assert pool.allocator.used() == 0
    crash = [e for r in sched.log.snapshot()["requests"]
             for e in r["events"]
             if e["kind"] == "preempted" and e["reason"] == "crash"]
    assert crash, "recovery must log preempted(reason=crash)"


def test_deadlines_differential_against_reference(clocks):  # noqa: F811
    """Deadlines that pass while the request waits (a low class behind a
    high one) and while it decodes, with arrivals over time, on both
    packages: the same sheds and cancels at the same boundaries."""
    specs = [(i, t, m, 1) for i, t, m, _p in _specs(6, seed=11)]
    specs += [(10, [3, 1, 4, 1], 12, 0), (11, [5, 9, 2], 30, 1),
              (12, [6, 5, 3, 5], 9, 0)]
    deadlines = {10: T0 + 1.5 * STEP_S, 11: T0 + 2.5 * STEP_S,
                 12: T0 + 40 * STEP_S}
    done, pool, sched, _ = differential(
        specs, dict(batch_size=3, block_size=8, prefill_budget=8), {},
        clocks, submit_at={11: 1, 12: 2}, deadlines=deadlines,
        checks=_check_allocator_invariants)
    assert done[10] == []  # still queued behind class 1 at step 2
    assert 0 < len(done[11]) < 30  # cancelled mid-decode
    assert done[11] == _solo([5, 9, 2], 30)[:len(done[11])]
    assert done[12] == _solo([6, 5, 3, 5], 9)  # in time
    assert sched.stats["deadline_shed"] == 2
    reasons = {r["rid"]: r["reason"] for r in sched.log.snapshot()["requests"]}
    assert reasons[10] == reasons[11] == "deadline"


def test_give_up_after_max_restarts_differential(clocks,  # noqa: F811
                                                 monkeypatch):
    """A persistent fault: both packages recover TPUBC_ENGINE_MAX_RESTARTS
    times, then raise the same error at the same step."""
    monkeypatch.setenv("TPUBC_ENGINE_MAX_RESTARTS", "3")
    spec = ",".join(f"pool.device:1:{i}" for i in range(12))
    _done, _pool, sched, fired = differential(
        [(0, [1, 2], 4, 0)], dict(batch_size=2, block_size=8, kv_blocks=8),
        {}, clocks, fault=spec)
    assert sched.stats["recoveries"] == 3 and fired["fired"] == {
        "pool.device": 4}
    assert sched.last_error.startswith("InjectedFault")


# ---- mirrors of tests/test_faults.py --------------------------------------


def test_allocator_quarantine_to_cache_partitions():
    """test_faults.py:199."""
    a = tserving.BlockAllocator(8, 4)
    ids = a.alloc(5)
    assert a.register(ids[0], b"k0") and a.register(ids[1], b"k1")
    a.incref(ids[0])
    a.quarantine_to_cache()
    assert a.used() == 0
    assert a.is_cached(ids[0]) and a.is_cached(ids[1])
    assert a.lookup(b"k0") == ids[0] and a.lookup(b"k1") == ids[1]
    assert len(a._free) + a.cached() == a.num_blocks
    assert len(a.alloc(8)) == 8


def test_alloc_seam_fires_before_any_mutation():
    """The alloc fault leaves the allocator as it was (test_faults.py:199's
    premise): recovery quarantines a self-consistent heap."""
    a = tserving.BlockAllocator(8, 4)
    a.alloc(2)
    before = (sorted(a._free), dict(a._ref), dict(a.stats))
    faults.install("alloc")
    with pytest.raises(InjectedFault):
        a.alloc(3)
    assert (sorted(a._free), dict(a._ref), dict(a.stats)) == before


def test_retry_after_tracks_queue_drain_rate():
    """test_faults.py:218."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=8,
                              **POOL)
    sched = tserving.Scheduler(pool)
    assert sched.retry_after_s(depth=50) == 1
    sched._retire_window.add(30)
    assert sched.retry_after_s(depth=10) == 20
    assert sched.retry_after_s(depth=1000) == 30
    assert sched.retry_after_s(depth=0) == 1


def test_queue_deadline_shed_without_compute():
    """test_faults.py:229."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=8,
                              **POOL)
    sched = tserving.Scheduler(pool)
    before = telemetry.metrics().to_json().get("serve_deadline_shed_total",
                                               0)
    sched.submit(tserving.Request(rid=7, tokens=[1, 2, 3], max_new=8,
                                  deadline=telemetry.monotonic() - 1.0))
    events = sched.step()
    assert events[7]["done"] and events[7]["deadline"]
    assert events[7]["generated"] == []
    assert "deadline" in events[7]["error"]
    assert sched.stats["deadline_shed"] == 1
    assert not sched.pending() and not pool.has_active()
    assert pool.stats["rounds"] == 0
    after = telemetry.metrics().to_json()["serve_deadline_shed_total"]
    assert after == before + 1


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_crash_recovery_byte_identity(prefix_cache):
    """test_faults.py:257, greedy with the int8 KV pool: two device aborts
    and an allocator breach mid-burst, every stream equal to the
    fault-free run and to solo generate."""
    reqs = _reqs(tserving, _specs(6, seed=7))
    kw = dict(paged=True, block_size=8, prefill_budget=4,
              prefix_cache=prefix_cache, **POOL)
    clean = tserving.serve(TPARAMS, TCFG, reqs, 4, **kw)
    inj = faults.install("pool.device:1:2,pool.device:1:6,alloc:1:4")
    stats: dict = {}
    faulted = tserving.serve(TPARAMS, TCFG, reqs, 4, stats=stats, **kw)
    fired = inj.stats()["fired"]
    faults.install(None)
    assert fired.get("pool.device") == 2 and fired.get("alloc") == 1, fired
    assert stats["scheduler"]["recoveries"] == 3
    assert faulted == clean
    for r in reqs:
        assert faulted[r.rid] == _solo(r.tokens, r.max_new), r.rid


def test_recovery_salvages_prefix_cache_and_counts_metrics():
    """test_faults.py:284."""
    restarts0 = telemetry.metrics().to_json().get(
        "serve_engine_restarts_total", 0)
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=4, kv_blocks=24,
                              prefill_budget=8, prefix_cache=True, **POOL)
    sched = tserving.Scheduler(pool)
    prompt = [5, 6, 7, 8, 9, 10, 11, 12]
    done = _drive(pool, sched, [tserving.Request(rid=0, tokens=prompt,
                                                 max_new=6)])
    assert done[0] == _solo(prompt, 6)
    faults.install("pool.device")
    done = _drive(pool, sched, [tserving.Request(rid=1, tokens=prompt,
                                                 max_new=6)])
    faults.install(None)
    _check_allocator_invariants(pool)
    assert sched.stats["recoveries"] == 1
    assert done[1] == _solo(prompt, 6)
    assert pool.stats["prefix_hit_tokens"] > 0
    mj = telemetry.metrics().to_json()
    assert mj["serve_engine_restarts_total"] == restarts0 + 1
    assert mj["serve_recovery_ms_count"] >= 1


def test_crash_loop_bound_gives_up_loudly(monkeypatch):
    """test_faults.py:311."""
    monkeypatch.setenv("TPUBC_ENGINE_MAX_RESTARTS", "3")
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=8,
                              **POOL)
    sched = tserving.Scheduler(pool)
    assert sched._max_restarts == 3
    faults.install(",".join("pool.device:1:%d" % i for i in range(12)))
    sched.submit(tserving.Request(rid=0, tokens=[1, 2], max_new=4))
    with pytest.raises(InjectedFault):
        for _ in range(20):
            sched.step()
    assert sched.stats["recoveries"] == 3


def test_device_runtime_error_is_not_recovered(monkeypatch):
    """An error of the CUDA runtime may poison the context: the recovery
    boundary re-raises it at once instead of quarantining."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    sched.submit(tserving.Request(rid=0, tokens=[1, 2], max_new=4))

    def boom():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(pool, "step_round", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sched.step()
    assert sched.stats["recoveries"] == 0


def test_slot_engine_reraises():
    """The slot engine has no quarantine: a failed round propagates."""
    pool = tserving.SlotPool(TPARAMS, TCFG, 2, device="cpu")
    sched = tserving.Scheduler(pool)
    sched.submit(tserving.Request(rid=0, tokens=[1, 2], max_new=2))
    faults.install("pool.device")
    with pytest.raises(InjectedFault):
        sched.step()
    assert sched.stats["recoveries"] == 0


def test_deadline_mid_decode_cancel_frees_blocks_for_cohort():
    """test_faults.py:328, on a virtual clock (a step a second) instead of
    the wall: the doomed row, past its deadline after one round, is
    cancelled mid-decode with its committed prefix, its blocks go back,
    and the survivor's stream is exact."""
    clock = {"t": 50.0}
    telemetry.set_clock(lambda: clock["t"])
    try:
        pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8,
                                  kv_blocks=16, prefill_budget=16, **POOL)
        sched = tserving.Scheduler(pool)
        sched.submit(tserving.Request(rid=0, tokens=[1, 2, 3], max_new=40,
                                      deadline=50.0 + 0.5))
        sched.submit(tserving.Request(rid=1, tokens=[4, 5], max_new=40))
        done, deadline_ev, rounds = {}, None, 0
        while sched.pending() or pool.has_active():
            rounds += 1
            assert rounds < 5000
            for rid, ev in sched.step().items():
                if ev.get("deadline"):
                    deadline_ev = ev
                if ev["done"]:
                    done[rid] = ev
            _check_allocator_invariants(pool)
            clock["t"] += 1.0
    finally:
        telemetry.set_clock(None)
    assert deadline_ev is not None and done[0] is deadline_ev
    assert 0 < len(deadline_ev["generated"]) < 40
    assert deadline_ev["generated"] == _solo([1, 2, 3], 40)[
        :len(deadline_ev["generated"])]
    assert done[1]["generated"] == _solo([4, 5], 40)
    assert sched.stats["deadline_shed"] == 1
    assert pool.allocator.used() == 0


def test_fault_schedule_fuzz_never_corrupts_leaks_or_hangs():
    """test_faults.py:362: seeded random schedules over a mini-burst; the
    streams stay exact, the partition holds after every round and the
    drive is bounded."""
    rng = np.random.default_rng(2026)
    for trial in range(4):
        spec = ",".join(
            "%s:%s:%d:%d" % (
                rng.choice(["pool.device", "alloc", "sched.admit"]),
                rng.choice(["1", "0.25"]), int(rng.integers(0, 8)),
                int(rng.integers(0, 1000)))
            for _ in range(int(rng.integers(1, 4))))
        reqs = _reqs(tserving, _specs(5, seed=100 + trial, lo_new=4,
                                      hi_new=12))
        pool = tserving.PagedPool(TPARAMS, TCFG, 3, block_size=4,
                                  kv_blocks=12, prefill_budget=4, **POOL)
        sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
        faults.install(spec)
        done = {}
        for r in reqs:
            sched.submit(r)
        rounds = 0
        while sched.pending() or pool.has_active():
            rounds += 1
            assert rounds < 5000, spec
            done.update({rid: ev["generated"]
                         for rid, ev in sched.step().items() if ev["done"]})
            _check_allocator_invariants(pool)
        faults.install(None)
        for r in reqs:
            assert done[r.rid] == _solo(r.tokens, r.max_new), (spec, r.rid)
        assert pool.allocator.used() == 0, spec


@pytest.mark.parametrize("schedule", [
    "pool.device:1:2,pool.device:1:5",  # test_faults.py:585
    "alloc:1:1",                        # :627
])
def test_chaos_schedules_on_the_engine(schedule):
    """test_faults.py:585 and :627 without the ingress: the pinned chaos
    schedules through the Scheduler; every stream recovers exactly, the
    log shows the crash legs, the partition holds."""
    jobs = [([3, 5, 7], 30), ([9, 2], 24), ([4, 4, 4, 4], 26)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=24,
                              **POOL)
    sched = tserving.Scheduler(pool)
    _drive(pool, sched, [tserving.Request(rid=99, tokens=[2, 3],
                                          max_new=2)])
    inj = faults.install(schedule)
    done = _drive(pool, sched, [tserving.Request(rid=i, tokens=t, max_new=m)
                                for i, (t, m) in enumerate(jobs)])
    fired = inj.stats()["fired"]
    faults.install(None)
    assert sum(fired.values()) == len(schedule.split(","))
    for i, (t, m) in enumerate(jobs):
        assert done[i] == _solo(t, m), i
    crash = [e for r in sched.log.snapshot()["requests"] for e in r["events"]
             if e["kind"] == "preempted" and e.get("reason") == "crash"]
    assert crash
    _check_allocator_invariants(pool)


def test_chaos_crash_during_swap(monkeypatch):
    """test_faults.py:736 without the ingress: a device abort while the
    host tier churns and a swap transfer that fails compose; every stream
    is exact and the tier's byte count stays coherent."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "64")
    monkeypatch.setenv("TPUBC_EXPECTED_NEW", "2")
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=8,
                              **POOL)
    sched = tserving.Scheduler(pool)
    assert pool.host is not None
    _drive(pool, sched, [tserving.Request(rid=99, tokens=[2, 3],
                                          max_new=2)])
    jobs = [([3, 5, 7], 30), ([9, 2], 24), ([4, 4, 4, 4], 26)]
    inj = faults.install("swap.xfer:1:1,pool.device:1:4")
    done = _drive(pool, sched, [tserving.Request(rid=i, tokens=t, max_new=m)
                                for i, (t, m) in enumerate(jobs)])
    fired = inj.stats()["fired"]
    faults.install(None)
    assert fired.get("pool.device") == 1 and fired.get("swap.xfer") == 1
    for i, (t, m) in enumerate(jobs):
        assert done[i] == _solo(t, m), i
    _check_allocator_invariants(pool)
    host = pool.host
    assert len(host) <= host.capacity
    assert host.bytes == sum(e["bytes"] for e in host._entries.values())
    assert pool.snapshot()["host"]["blocks"] == len(host)


# ---- a write cut short between two layers ---------------------------------


def test_torn_prefill_scatter_resets_and_registers_nothing_it_touched(
        monkeypatch):
    """A prefill chunk's scatter raises after writing layer 0 of 2: the
    round fails inside an in-place write, so quarantine resets the pools
    in place (same addresses) and salvages nothing; no block the scatter
    touched is registered afterwards, and every resumed stream equals the
    unfaulted run and solo generate."""
    sysp = list(range(1, 17))
    specs = [(i, sysp + [20 + i, 3 + i], 6) for i in range(4)]
    reqs = [tserving.Request(rid=i, tokens=t, max_new=m)
            for i, t, m in specs]
    kw = dict(block_size=4, kv_blocks=32, prefill_budget=4, **POOL)
    clean_pool = tserving.PagedPool(TPARAMS2, TCFG2, 2, **kw)
    clean = _drive(clean_pool, tserving.Scheduler(clean_pool), reqs)
    pool = tserving.PagedPool(TPARAMS2, TCFG2, 2, **kw)
    sched = tserving.Scheduler(pool)
    addresses = _addresses(pool)
    real = tserving._scatter_windows
    calls, touched = {"n": 0}, set()

    def torn(pools, windows, bt):
        calls["n"] += 1
        if calls["n"] != 6:
            return real(pools, windows, bt)
        touched.update(b for b in bt.flatten().tolist() if b)
        real(pools[:1], windows[:1], bt)  # layer 0 written, layer 1 not
        raise RuntimeError("scatter cut short between layers")

    monkeypatch.setattr(tserving, "_scatter_windows", torn)
    quarantined = []
    real_quarantine = pool.quarantine

    def watched(reason="crash"):
        torn_then = pool._torn
        recs = real_quarantine(reason)
        quarantined.append((torn_then, set(pool.allocator._key_of)))
        return recs

    monkeypatch.setattr(pool, "quarantine", watched)
    done = _drive(pool, sched, reqs)
    assert touched and sched.stats["recoveries"] == 1
    torn_then, registered = quarantined[0]
    assert torn_then and not (registered & touched) and not registered
    assert _addresses(pool) == addresses
    assert done == clean
    for i, t, m in specs:
        assert done[i] == _solo2(t, m), i


def test_torn_defrag_never_salvages_moved_content(monkeypatch):
    """defrag cut short after permuting layer 0: the allocator still names
    the old ids, so a salvage would index blocks whose layer-0 bytes moved
    (the control shows it); quarantine sees the cut write, resets in place
    and the resumed streams are exact."""
    def setup():
        pool = tserving.PagedPool(TPARAMS2, TCFG2, 3, block_size=4,
                                  kv_blocks=24, prefill_budget=8, **POOL)
        sched = tserving.Scheduler(pool)
        for rid, (t, m) in enumerate([([5, 6, 7, 8, 9, 10, 11], 3),
                                      ([1, 2, 3, 4, 5, 6, 7, 8, 9], 12),
                                      ([9, 8, 7, 6, 5, 4, 3, 2], 12)]):
            sched.submit(tserving.Request(rid=rid, tokens=t, max_new=m))
        done = {}
        while 0 not in done:  # rid 0 retires: its blocks leave a hole
            done.update({rid: ev["generated"] for rid, ev in
                         sched.step().items() if ev["done"]})
        return pool, sched, done

    class CutAfterLayer0(dict):
        def values(self):
            raise RuntimeError("defrag cut short between layers")

    def cut_defrag(pool):
        layer1 = pool.pools[1]
        pool.pools[1] = CutAfterLayer0(layer1)
        try:
            with pytest.raises(RuntimeError, match="cut short"):
                pool.defrag()
        finally:
            pool.pools[1] = layer1

    # The control: salvaging regardless of the cut write indexes blocks
    # whose layer-0 content is no longer what their key names.
    pool, sched, _ = setup()
    before = {b: pool.pools[0]["k"][b].clone()
              for b in pool.allocator._key_of}
    cut_defrag(pool)
    pool._torn = False
    pool.quarantine()
    stale = [b for b in pool.allocator._key_of
             if not torch.equal(pool.pools[0]["k"][b], before[b])]
    assert stale, "the cut defrag moved no registered block"

    pool, sched, done = setup()
    addresses = _addresses(pool)
    cut_defrag(pool)
    assert pool._torn
    sched.requeue(pool.quarantine())
    assert pool.allocator._key_of == {} and pool.allocator.used() == 0
    assert _addresses(pool) == addresses
    done.update(_drive(pool, sched, []))
    assert done[1] == _solo2([1, 2, 3, 4, 5, 6, 7, 8, 9], 12)
    assert done[2] == _solo2([9, 8, 7, 6, 5, 4, 3, 2], 12)


class _CaptureFailsOnce(Replaying):
    def __init__(self):
        super().__init__()
        self.failed = False

    def capture(self, body):
        if not self.failed:
            self.failed = True
            raise RuntimeError("stand-in capture failed")
        return super().capture(body)


def test_capture_fault_leaves_no_half_captured_graph(monkeypatch):
    """A decode chunk whose graph capture fails: no graph is stored under
    its key; the round is recovered (the warm-up step wrote the pools, so
    they are reset in place, the addresses kept) and the next chunk of that
    width warms up and captures afresh; every stream equals solo generate.
    (That a failed capture takes its launch counts back out is
    tests/test_torch_graphs.py's.)"""
    backend = _CaptureFailsOnce()
    monkeypatch.setattr(graphs, "for_device",
                        lambda device: graphs.StepGraphs(backend))
    reqs = [tserving.Request(rid=i, tokens=[3 + i, 4, 5, 6], max_new=7)
            for i in range(3)]
    pool = tserving.PagedPool(TPARAMS2, TCFG2, 3, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    addresses = _addresses(pool)
    real_run = pool._graphs.run
    seen = []

    def run(key, body, steps):
        try:
            return real_run(key, body, steps)
        finally:
            seen.append((key, set(pool._graphs._graphs), pool._torn))

    monkeypatch.setattr(pool._graphs, "run", run)
    done = _drive(pool, sched, reqs)
    key, stored, torn = seen[0]
    assert key not in stored and torn
    assert sched.stats["recoveries"] == 1
    assert pool._graphs.stats["captured"] >= 1 and key in pool._graphs._graphs
    assert _addresses(pool) == addresses
    for r in reqs:
        assert done[r.rid] == _solo2(r.tokens, r.max_new), r.rid
