"""The paged engine's request log (tpu_bootstrap_torch/workload/serving.py:
RequestLog, the pool's and the Scheduler's lifecycle events, the span tree
at retirement) held to the JAX reference. Differential runs push the same
submissions through the reference's Scheduler + PagedPool and the port's on
the bridged int8 weights of tests/test_torch_scheduler.py and compare,
after every step and exactly (f32): the events each rid's record holds
(kinds, attributes and times), each record's phases and summary, the
round's ledger token dict, the ledger, device_ms_by_rid, the scheduler's
and the pool's stats and slots, and the streams. Both packages run on
pinned clocks: one virtual monotonic clock (``telemetry.set_clock`` in
each), advanced between steps, stamps the events and decides deadlines,
and each serving module's ``time.perf_counter`` (the ledger's busy clock
and the prefill and transfer clocks) advances a fixed tick a read, so
equal call sequences give equal times. The swap-or-recompute cost model is
pinned as in tests/test_torch_scheduler.py. This module holds the shared
differential runner (``differential``); tests/test_torch_ledger.py and
tests/test_torch_faults.py use it.

Then the mirrors of the reference's tests/test_requestz.py:84-233 on the
port's pool (device="cpu", K2's plain version). Not mirrored: the
Prometheus-text half of :233 (the text exposition is the ingress's, queue 1
item 6) and :255-end (the ingress's /requestz, /poolz, /traces.json and
timing block, item 6)."""

import time

import numpy as np
import pytest
import torch

from tests.test_torch_scheduler import (
    JCFG,
    JPARAMS,
    POOL,
    TCFG,
    TPARAMS,
    _drive,
    _reqs,
    _solo,
    _specs,
    _state,
    pinned_cost,  # noqa: F401 - a fixture
)
from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import faults as jfaults
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import faults as tfaults
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

T0 = 1000.0  # the virtual monotonic clock's start, seconds
STEP_S = 0.01  # how far it advances between two steps


class _Ticks:
    """A serving module's ``time``: ``perf_counter`` advances half a
    millisecond a read; anything else is the real module's."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self) -> float:
        self.t += 5e-4
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def clocks(monkeypatch, pinned_cost):  # noqa: F811 - the imported fixture
    """Pins every clock both packages read (see the module docstring);
    yields the virtual clock, {"t": seconds}."""
    clock = {"t": T0}

    def now():
        return clock["t"]

    jtelemetry.set_clock(now)
    telemetry.set_clock(now)
    monkeypatch.setattr(jserving, "time", _Ticks())
    monkeypatch.setattr(tserving, "time", _Ticks())
    try:
        yield clock
    finally:
        jtelemetry.set_clock(None)
        telemetry.set_clock(None)
        jfaults.install(None)
        tfaults.install(None)


def _folds(sched) -> list:
    """Record each round's ledger token dict as the fold closes it."""
    seen, real = [], sched._ledger_fold

    def fold(led, t_start, t_end):
        seen.append({rid: dict(k) for rid, k in led.items()})
        return real(led, t_start, t_end)

    sched._ledger_fold = fold
    return seen


def _records(sched) -> list:
    """The log's records with the per-process trace ids left out."""
    recs = sched.log.snapshot()["requests"]
    return [{k: v for k, v in r.items() if k != "trace_id"} for r in recs]


def _step(sched):
    """step(), or the exception it raised (a fault past the restart
    bound), as a comparable value."""
    try:
        return sched.step()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__, str(e))


def differential(specs, pool_kw, sched_kw, clock, *, submit_at=None,
                 fault=None, deadlines=None, checks=None):
    """Drive the reference's and the port's Scheduler + PagedPool step by
    step on ``specs`` ((rid, tokens, max_new, priority) each, submitted at
    once or ``submit_at[rid]`` steps in; ``deadlines[rid]`` a virtual
    deadline) under the ``TPUBC_FAULT`` spec ``fault`` in both packages,
    comparing everything the module docstring lists after every step.
    ``checks(pool)`` runs on the port's pool after each step. Returns
    (streams, port pool, port scheduler, port injector's stats), or
    stops at the first step that raised in both."""
    jpool = jserving.PagedPool(JPARAMS, JCFG, kv_quant=True, **pool_kw)
    tpool = tserving.PagedPool(TPARAMS, TCFG, **POOL, **pool_kw)
    jsched = jserving.Scheduler(jpool, **sched_kw)
    tsched = tserving.Scheduler(tpool, **sched_kw)
    jfolds, tfolds = _folds(jsched), _folds(tsched)
    jinj, tinj = jfaults.install(fault), tfaults.install(fault)
    deadlines = deadlines or {}
    pairs = [tuple(mod.Request(rid=i, tokens=t, max_new=m, priority=p,
                               deadline=deadlines.get(i))
                   for mod in (jserving, tserving))
             for i, t, m, p in specs]
    submit_at = submit_at or {}
    done, step = {}, 0
    while True:
        for jr, tr in pairs:
            if submit_at.get(tr.rid, 0) == step:
                jsched.submit(jr)
                tsched.submit(tr)
        if not (tsched.pending() or tpool.has_active()
                or any(v > step for v in submit_at.values())):
            break
        jev, tev = _step(jsched), _step(tsched)
        assert tev == jev, step
        assert tfolds == jfolds, step
        assert tsched.ledger == jsched.ledger, step
        assert tsched.device_ms_by_rid == jsched.device_ms_by_rid, step
        assert tsched.stats == jsched.stats, step
        assert _records(tsched) == _records(jsched), step
        got, want = _state(tpool, tsched), _state(jpool, jsched)
        for key in want:
            assert got[key] == want[key], (step, key)
        if checks is not None:
            checks(tpool)
        if isinstance(tev, tuple):
            break
        done.update({k: v["generated"] for k, v in tev.items() if v["done"]})
        clock["t"] += STEP_S
        step += 1
        assert step < 2000
    if fault:
        assert tinj.stats() == jinj.stats()
    return done, tpool, tsched, (tinj.stats() if fault else None)


# (specs, pool kwargs, scheduler kwargs, submission step per rid or None)
LOG_CASES = {
    # Roomy, all at once: admitted, prefill_chunk, decode_round, retired.
    "plain": (_specs(6, seed=3), dict(
        batch_size=4, block_size=8, prefill_budget=4), {}, None),
    # Arrivals over time with priorities: the phases of a queued leg.
    "churned": (_specs(10, seed=3, priorities=True), dict(
        batch_size=4, block_size=8, kv_blocks=6, prefill_budget=8,
        host_blocks=8), dict(overcommit=True, expected_new=2),
        {i: 2 * i for i in range(10)}),
    # Tight and overcommitted: grown, preempted (both arms), resumed.
    "preempting": (_specs(8, seed=7), dict(
        batch_size=8, block_size=8, kv_blocks=8, prefill_budget=4,
        host_blocks=64), dict(overcommit=True, expected_new=2), None),
}


@pytest.mark.parametrize("name", sorted(LOG_CASES))
def test_request_log_differential_against_reference(name, clocks):
    specs, pool_kw, sched_kw, submit_at = LOG_CASES[name]
    done, pool, sched, _ = differential(specs, pool_kw, sched_kw, clocks,
                                        submit_at=submit_at)
    assert set(done) == {i for i, *_ in specs}
    for i, t, m, _p in specs:
        assert done[i] == _solo(t, m), i
    kinds = {e["kind"] for r in sched.log.snapshot()["requests"]
             for e in r["events"]}
    assert {"enqueued", "admitted", "prefill_chunk", "decode_round",
            "retired"} <= kinds
    if name == "preempting":
        assert {"grown", "preempted", "resumed"} <= kinds
        assert pool.stats["preemptions"] > 0


def test_slot_engine_log_and_ledger_differential(clocks):
    """The replay-slot engine's recording sites (SlotPool.admit's admitted
    event, the replayed histories billed as prefill tokens, the event
    fold's decode rounds and retirements) and a deadline cancelling one of
    its rows, against the reference's SlotPool step by step."""
    specs = [(0, [3, 14, 15], 5), (1, [9, 2, 6, 5, 3], 9), (2, [9, 7], 4),
             (3, [3, 2, 3, 8], 3)]
    jpool = jserving.SlotPool(JPARAMS, JCFG, 2, kv_quant=True)
    tpool = tserving.SlotPool(TPARAMS, TCFG, 2, kv_quant=True, device="cpu")
    jsched, tsched = jserving.Scheduler(jpool), tserving.Scheduler(tpool)
    jfolds, tfolds = _folds(jsched), _folds(tsched)
    for mod, sched in ((jserving, jsched), (tserving, tsched)):
        for i, t, m in specs:
            sched.submit(mod.Request(rid=i, tokens=t, max_new=m,
                                     deadline=T0 + 1.5 * STEP_S
                                     if i == 1 else None))
    done = {}
    while tsched.pending() or tpool.has_active():
        jev, tev = jsched.step(), tsched.step()
        assert tev == jev
        assert tfolds == jfolds and tsched.ledger == jsched.ledger
        assert tsched.device_ms_by_rid == jsched.device_ms_by_rid
        assert tsched.stats == jsched.stats
        assert _records(tsched) == _records(jsched)
        assert tpool.snapshot() == jpool.snapshot()
        done.update({k: v["generated"] for k, v in tev.items() if v["done"]})
        clocks["t"] += STEP_S
    assert tsched.stats["deadline_shed"] == 1 and 0 < len(done[1]) < 9
    for i, t, m in specs:
        assert done[i] == _solo(t, m)[:len(done[i])], i
    assert {f["prefill"] > 0 for fold in tfolds for f in fold.values()} == {
        True}


# ---- mirrors of tests/test_requestz.py -------------------------------------


def _tight_run(seed=7):
    """A run that must preempt (test_requestz.py:71)."""
    reqs = _reqs(tserving, _specs(8, seed=seed))
    pool = tserving.PagedPool(TPARAMS, TCFG, 8, block_size=8, kv_blocks=8,
                              prefill_budget=4, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    done = _drive(pool, sched, reqs)
    assert pool.stats["preemptions"] > 0, "pool was not actually tight"
    return reqs, pool, sched, done


def test_ring_bound_and_lru_eviction():
    """test_requestz.py:84."""
    log = tserving.RequestLog(capacity=4, enabled=True)
    for rid in range(6):
        log.start(rid, priority=0)
        log.event(rid, "admitted")
        log.event(rid, "retired", reason="eos", generated=1)
        log.retire(rid)
    snap = log.snapshot()
    assert len(snap["requests"]) == 4
    assert [r["rid"] for r in snap["requests"]] == [5, 4, 3, 2]


def test_ring_evicts_retired_before_inflight():
    """test_requestz.py:98."""
    log = tserving.RequestLog(capacity=2, enabled=True)
    log.start(0, priority=0)
    log.start(1, priority=0)
    log.event(1, "retired", reason="budget")
    log.retire(1)
    log.start(2, priority=0)
    assert {r["rid"] for r in log.snapshot()["requests"]} == {0, 2}


def test_event_cap_counts_drops():
    """test_requestz.py:109."""
    log = tserving.RequestLog(capacity=2, max_events=8, enabled=True)
    log.start(0)
    for _ in range(20):
        log.event(0, "decode_round", tokens=1)
    rec = log.snapshot()["requests"][0]
    assert len(rec["events"]) == 8
    assert rec["dropped_events"] == 20 - (8 - 1)  # start() wrote one


def test_events_env_gating(monkeypatch):
    """test_requestz.py:122."""
    assert tserving.request_events_enabled() is True
    monkeypatch.setenv("TPUBC_REQUEST_EVENTS", "0")
    assert tserving.request_events_enabled() is False
    monkeypatch.delenv("TPUBC_REQUEST_EVENTS")
    monkeypatch.setenv("TPUBC_TRACE_BUFFER", "0")
    assert tserving.request_events_enabled() is False


def test_streams_byte_identical_events_on_and_off(monkeypatch):
    """test_requestz.py:132: the log only observes; off, nothing is
    recorded and the pool has no log."""
    reqs = _reqs(tserving, _specs(6, seed=3))
    kw = dict(paged=True, block_size=8, prefill_budget=4, **POOL)
    on = tserving.serve(TPARAMS, TCFG, reqs, 4, **kw)
    monkeypatch.setenv("TPUBC_REQUEST_EVENTS", "0")
    off = tserving.serve(TPARAMS, TCFG, reqs, 4, **kw)
    assert on == off
    for r in reqs:
        assert on[r.rid] == _solo(r.tokens, r.max_new), r.rid
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    assert sched.log.enabled is False and pool.request_log is None
    _drive(pool, sched, [tserving.Request(rid=0, tokens=[1, 2], max_new=2)])
    assert sched.log.snapshot()["requests"] == []
    assert sched.request_timing(0) is None


def test_preempted_then_resumed_timeline_one_rid_both_legs():
    """test_requestz.py:157."""
    reqs, _pool, sched, done = _tight_run()
    victims = [r for r in sched.log.snapshot()["requests"]
               if r["preemptions"] > 0]
    assert victims, "no preemption reached the request log"
    rec = victims[0]
    kinds = [e["kind"] for e in rec["events"]]
    assert kinds[0] == "enqueued" and kinds.count("enqueued") == 1
    assert kinds[-1] == "retired" and kinds.count("retired") == 1
    i_adm, i_pre = kinds.index("admitted"), kinds.index("preempted")
    i_res = kinds.index("resumed")
    assert i_adm < i_pre < i_res < len(kinds) - 1
    assert rec["legs"] >= 2 and rec["state"] == "retired"
    pev = rec["events"][i_pre]
    assert pev["reason"] in ("priority", "phase", "arrival", "capacity")
    assert pev["phase"] in ("prefill", "decode")
    r = next(x for x in reqs if x.rid == rec["rid"])
    assert done[r.rid] == _solo(r.tokens, r.max_new)


def test_phase_durations_sum_at_most_total():
    """test_requestz.py:182."""
    _, _, sched, _ = _tight_run(seed=9)
    recs = sched.log.snapshot()["requests"]
    assert recs
    for rec in recs:
        ph = rec["phases"]
        total = (ph["queue_ms"] + ph["prefill_ms"] + ph["decode_ms"]
                 + ph["recompute_ms"])
        assert total <= ph["total_ms"] + 0.01, rec["rid"]
        assert ph["total_ms"] >= 0


def test_span_tree_under_request_span():
    """test_requestz.py:195."""
    telemetry.tracer().reset()
    _, _, sched, _ = _tight_run(seed=13)
    spans = telemetry.tracer().spans()
    rec = next(r for r in sched.log.snapshot()["requests"]
               if r["preemptions"] > 0)
    parents = [s for s in spans if s.name == "serve.request"
               and s.attrs.get("rid") == str(rec["rid"])]
    assert parents, "retirement did not emit the request span"
    parent = parents[-1]
    kids = [s for s in spans if s.parent_id == parent.span_id]
    names = {s.name for s in kids}
    assert "serve.phase.queue" in names and "serve.phase.decode" in names
    for k in kids:
        assert k.trace_id == parent.trace_id
        assert k.start_us >= parent.start_us
        assert k.start_us + k.dur_us <= parent.start_us + parent.dur_us + 1


def test_preempt_cost_metrics_live():
    """test_requestz.py:218."""
    reg = telemetry.metrics().to_json()
    rc0 = reg.get("serve_preempt_recompute_tokens_total", 0)
    gap0 = reg.get("serve_resume_gap_ms_count", 0)
    _tight_run(seed=17)
    reg = telemetry.metrics().to_json()
    assert reg.get("serve_resume_gap_ms_count", 0) > gap0
    assert reg.get("serve_preempt_recompute_tokens_total", 0) >= rc0


def test_per_class_histogram_labels():
    """test_requestz.py:233, its registry half (the Prometheus text is
    the ingress's, queue 1 item 6)."""
    reqs = [tserving.Request(rid=i, tokens=[1 + i, 2, 3], max_new=4,
                             priority=i % 3) for i in range(6)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    _drive(pool, sched, reqs)
    mj = telemetry.metrics().to_json()
    for c in ("0", "1", "2"):
        assert mj.get(f'serve_queue_wait_ms{{priority="{c}"}}_count', 0) >= 1


def test_trace_id_roots_the_request_span_and_snapshot_orders():
    """A client trace id roots the request's spans (the reference's
    Request.trace_id), arrivals come in submission order, and the pool's
    snapshot mirrors the allocator exactly (test_requestz.py:330's pool
    half, without the ingress)."""
    telemetry.tracer().reset()
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    sched.submit(tserving.Request(rid=5, tokens=[3, 4, 5], max_new=3,
                                  trace_id="feedc0de"))
    sched.submit(tserving.Request(rid=6, tokens=[6, 7], max_new=2))
    sched.step()
    snap = pool.snapshot()
    a = pool.allocator
    assert snap["blocks"]["live"] == a.used()
    assert snap["blocks"]["cached"] == a.cached()
    assert snap["blocks"]["available"] == a.available()
    assert sum(s["blocks"] for s in snap["slots"]) >= a.used()
    _drive(pool, sched, [])
    assert [r["rid"] for r in sched.log.arrivals()] == [5, 6]
    assert sched.log.trace_of(5) == "feedc0de"
    roots = [s for s in telemetry.tracer().spans()
             if s.name == "serve.request" and s.attrs["rid"] == "5"]
    assert roots and roots[0].trace_id == "feedc0de"
    assert sched.snapshot()["stats"]["retired"] == 2
    np.testing.assert_equal(sched.log.phase_shares()["queue"] >= 0, True)
