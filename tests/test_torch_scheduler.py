"""The overcommit Scheduler and the paged engine's preemption
(tpu_bootstrap_torch/workload/serving.py: Scheduler, PagedPool's
expected-footprint admission, capacity fold, victim policy, swap or
recompute arm and resume) held to the JAX reference: differential runs
push the same submissions through the reference's Scheduler + PagedPool
and the port's on the same bridged int8 weights and compare, after every
step, the slots, the waiting queue (where preempted rows wait with their
resume records), each preemption and its arm, the pool's, allocator's,
scheduler's and host tier's stats, the allocator's whole state, the host
keys in LRU order and the streams, exactly (f32, seeds without a
near-tie). Then the mirrors of the reference's own tests/test_scheduler.py
on the port's pool (device="cpu", K2's plain version), whose plain kernels
are batch- and table-invariant, so preempted streams equal never-preempted
ones and solo generate exactly.

Both packages time their prefill and their host transfers to price the
swap arm; the differential runs pin the cost model (a fixed prefill cost a
token, the seed rate for every transfer) so both make the same choices,
and pick a rate at which short victims recompute and long ones swap.

Mirrored elsewhere: test_scheduler.py:195 and :383-430 (prompt lookup) in
tests/test_torch_spec_serving.py, the sampled cases of :171 in
tests/test_torch_sampled_serving.py, both on this file's differential.
:171's kv_quant=False cases (the float pool) are in
tests/test_torch_float_pool.py, on this file's differential. :450-480 (the ingress) are in
tests/test_torch_ingress.py (429) and tests/test_torch_ingress_paged.py."""

import jax
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

# The reference's TINY model (test_scheduler.py:35) at the port's smallest
# head dim (K2 takes multiples of 16), int8 weights.
BASE = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=16,
            embed_dim=16, mlp_dim=32, max_seq_len=64)
JCFG = jmodel.ModelConfig(**BASE)
TCFG = tmodel.ModelConfig(**BASE)
JPARAMS = jquant.quantize_params(jmodel.init_params(JCFG,
                                                    jax.random.PRNGKey(1)))
TPARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                   device="cpu")
POOL = dict(kv_quant=True, device="cpu")

# The pinned cost model: a prefill token costs PREFILL_MS; the link runs at
# the rate at which a victim of SWAP_FROM history tokens or more is cheaper
# to swap (n x bytes a token / rate) than to re-prefill ((n - 1) x
# PREFILL_MS).
PREFILL_MS = 1e-3
SWAP_FROM = 12
PINNED_GBPS = (tmodel.kv_bytes_per_token(TCFG, True) * 1e-6
               / (PREFILL_MS * (1 - 1 / (SWAP_FROM - 0.5))))


def _solo(tokens, max_new):
    return tdecode.generate(TPARAMS, [tokens], TCFG, max_new, kv_quant=True,
                            kv_kernel=False, device="cpu")[0].tolist()


def _specs(n, seed=0, lo_new=8, hi_new=24, priorities=False):
    """The reference's preempting shape (test_scheduler.py:48): short
    varied prompts, budgets far past the overcommit reserve; as (rid,
    tokens, max_new, priority)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(1, 32, int(rng.integers(2, 10))).tolist()
        new = int(rng.integers(lo_new, hi_new))
        prio = int(rng.integers(0, 3)) if priorities else 0
        out.append((i, toks, new, prio))
    return out


def _reqs(mod, specs):
    return [mod.Request(rid=i, tokens=t, max_new=m, priority=p)
            for i, t, m, p in specs]


def _drive(pool, sched, requests):
    """serve()'s loop against an explicit Scheduler."""
    done = {}
    for r in requests:
        sched.submit(r)
    rounds = 0
    while sched.pending() or pool.has_active():
        rounds += 1
        assert rounds < 5000, "scheduler stopped making progress"
        for rid, ev in sched.step().items():
            if ev["done"]:
                done[rid] = ev["generated"]
    return done


@pytest.fixture
def pinned_cost(monkeypatch):
    """The same swap-or-recompute choices in both packages: no transfer
    is timed into the rate (the seed, PINNED_GBPS, prices every one), and
    every prefill phase leaves PREFILL_MS a token; the FLOPs price before
    the first prefill uses one peak in both."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", repr(PINNED_GBPS))
    monkeypatch.setenv("TPUBC_PEAK_TFLOPS", "989")
    for cls in (jserving.PagedPool, tserving.PagedPool):
        real = cls._prefill_phase

        def phase(self, real=real):
            real(self)
            if self._prefill_ms_per_tok is not None:
                self._prefill_ms_per_tok = PREFILL_MS

        monkeypatch.setattr(cls, "_prefill_phase", phase)
        monkeypatch.setattr(cls, "_note_bw", lambda self, nbytes, secs: None)


def _logged(pool, log):
    """Record every preemption's (rid, arm) and resume record."""
    arm_of, preempt = pool._preempt_arm, pool._preempt

    def arm(s):
        out = arm_of(s)
        log.append(("arm", s.rid, out[0]))
        return out

    def rec(i, reason="capacity"):
        r = preempt(i, reason)
        log.append(("preempted", reason, r["request"].rid,
                    list(r["request"].tokens), r["request"].max_new,
                    r["request"].priority, r["preload"], r["seq"]))
        return r

    pool._preempt_arm, pool._preempt = arm, rec


def _alloc_state(a) -> tuple:
    return (sorted(a._free), dict(a._ref), list(a._cached.items()),
            dict(a._index), dict(a._key_of), dict(a.stats), a.available())


def _slots(pool) -> list:
    return [None if s is None else
            (s.rid, list(s.history), s.remaining, list(s.generated),
             s.priority, s.seq, s.prompt_len, s.prefilled, s.prefill_chunks,
             s.admit_round, list(s.blocks), s.n_shared, s.registered,
             s.chain_key, s.cached_tokens)
            for s in pool.slots]


def _waiting(sched) -> list:
    return sorted((negp, dl, seq, r.rid, list(r.tokens), r.max_new,
                   r.priority, preload)
                  for negp, dl, seq, r, preload in sched._waiting)


def _host(pool):
    if pool.host is None:
        return None
    return (list(pool.host.keys()), pool.host.snapshot_json(),
            dict(pool.host.stats))


SCHED_KEYS = ("submitted", "admitted", "requeues", "retired")


def _state(pool, sched) -> dict:
    return {"slots": _slots(pool), "waiting": _waiting(sched),
            "pool_stats": dict(pool.stats),
            "sched_stats": {k: sched.stats[k] for k in SCHED_KEYS},
            "ema": sched._ema, "alloc": _alloc_state(pool.allocator),
            "host": _host(pool), "chunk_hint": pool.chunk_hint,
            "growth": pool.imminent_growth()}


def _differential(specs, pool_kw, sched_kw, submit_at=None, kv_quant=True):
    """Drive the reference's and the port's Scheduler + PagedPool (the int8
    KV pool, or the float one with ``kv_quant`` off) step by step on
    ``specs`` (submitted all at once, or ``submit_at[rid]`` steps in),
    comparing the whole state and the events after every step. Returns
    (streams, port pool, port scheduler, the preemption log)."""
    jpool = jserving.PagedPool(JPARAMS, JCFG, kv_quant=kv_quant, **pool_kw)
    tpool = tserving.PagedPool(TPARAMS, TCFG, **{**POOL,
                                                 "kv_quant": kv_quant},
                               **pool_kw)
    jsched = jserving.Scheduler(jpool, **sched_kw)
    tsched = tserving.Scheduler(tpool, **sched_kw)
    jlog, tlog = [], []
    _logged(jpool, jlog)
    _logged(tpool, tlog)
    jreqs, treqs = _reqs(jserving, specs), _reqs(tserving, specs)
    submit_at = submit_at or {}
    done, step = {}, 0
    while True:
        for jr, tr in zip(jreqs, treqs):
            if submit_at.get(tr.rid, 0) == step:
                jsched.submit(jr)
                tsched.submit(tr)
        if not (tsched.pending() or tpool.has_active()
                or any(v > step for v in submit_at.values())):
            break
        jev, tev = jsched.step(), tsched.step()
        assert {k: (v["new"], v["done"], v["generated"])
                for k, v in tev.items()} == {
            k: (v["new"], v["done"], v["generated"])
            for k, v in jev.items()}, step
        got, want = _state(tpool, tsched), _state(jpool, jsched)
        for key in want:
            assert got[key] == want[key], (step, key)
        assert tlog == jlog, step
        assert not (jsched.pending() or jpool.has_active()) == (
            not (tsched.pending() or tpool.has_active()))
        done.update({k: v["generated"] for k, v in tev.items() if v["done"]})
        step += 1
        assert step < 2000
    return done, tpool, tsched, tlog


# (specs, pool kwargs, scheduler kwargs, submission step per rid or None)
DIFF_CASES = {
    # Tight, overcommitted: growth, capacity preemptions, both arms.
    "tight_tier_on": (_specs(8, seed=7), dict(
        batch_size=8, block_size=8, kv_blocks=8, prefill_budget=4,
        host_blocks=64), dict(overcommit=True, expected_new=2), None),
    "tight_tier_off": (_specs(8, seed=7), dict(
        batch_size=8, block_size=8, kv_blocks=8, prefill_budget=4,
        host_blocks=0), dict(overcommit=True, expected_new=2), None),
    # Priorities arriving over time: priority-admission preemption.
    "priorities_staggered": (_specs(10, seed=3, priorities=True), dict(
        batch_size=4, block_size=8, kv_blocks=6, prefill_budget=8,
        host_blocks=8), dict(overcommit=True, expected_new=2),
        {i: 2 * i for i in range(10)}),
    # Refusal admission: whole footprints, no growth, no preemption.
    "refusal": (_specs(8, seed=5), dict(
        batch_size=4, block_size=8, kv_blocks=12, prefill_budget=4),
        dict(overcommit=False), None),
}


@pytest.mark.parametrize("name", sorted(DIFF_CASES))
def test_scheduler_differential_against_reference(name, pinned_cost):
    specs, pool_kw, sched_kw, submit_at = DIFF_CASES[name]
    done, pool, sched, log = _differential(specs, pool_kw, sched_kw,
                                           submit_at)
    assert set(done) == {i for i, *_ in specs}
    for i, t, m, _p in specs:
        assert done[i] == _solo(t, m), i
    preempts = [e for e in log if e[0] == "preempted"]
    arms = {e[2] for e in log if e[0] == "arm"}
    if name == "refusal":
        assert not preempts and pool.stats["grown_blocks"] == 0
    else:
        assert preempts and pool.stats["grown_blocks"] > 0
        assert sched.stats["requeues"] == pool.stats["preemptions"]
    if name == "tight_tier_on":
        assert arms == {"swap", "recompute"}
        assert pool.stats["swap_preempts"] > 0
    if name == "tight_tier_off":
        assert arms == {"recompute"} and "swap_preempts" not in pool.stats
    if name == "priorities_staggered":
        assert any(e[1] == "priority" for e in preempts)


def test_serve_defaults_equal_reference_defaults(monkeypatch, pinned_cost):
    """serve(paged=True, kv_quant=True) with nothing else is the
    reference's default engine: overcommit, the prefix cache and the host
    tier, on a pool tight enough to preempt; the streams and every stat
    equal the reference's."""
    monkeypatch.delenv("TPUBC_OVERCOMMIT", raising=False)
    monkeypatch.delenv("TPUBC_KV_HOST_BLOCKS", raising=False)
    monkeypatch.setenv("TPUBC_EXPECTED_NEW", "2")
    specs = _specs(8, seed=7)
    kw = dict(paged=True, kv_quant=True, block_size=8, kv_blocks=8,
              prefill_budget=4)
    want_stats, stats = {}, {}
    want = jserving.serve(JPARAMS, JCFG, _reqs(jserving, specs), 8,
                          stats=want_stats, **kw)
    got = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 8,
                         stats=stats, device="cpu", **kw)
    assert got == want
    for key in want_stats:
        if key != "scheduler":
            assert stats[key] == want_stats[key], key
    for key in stats["scheduler"]:
        assert stats["scheduler"][key] == want_stats["scheduler"][key], key
    assert stats["preemptions"] > 0 and stats["host"]["capacity"] == 8


# ---- mirrors of tests/test_scheduler.py -----------------------------------


def test_queue_orders_by_priority_then_deadline_then_arrival():
    """test_scheduler.py:74: the higher class first; within class 0,
    explicit deadlines (EDF) ahead of the deadline-less rid 0, the earlier
    deadline first. (Deadline 1.0 has passed on the monotonic clock: rid 3
    is shed at the first round boundary, and its event follows rid 2's in
    that round, as in the reference.)"""
    pool = tserving.PagedPool(TPARAMS, TCFG, 1, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    for rid, prio, dl in ((0, 0, None), (1, 0, 1e9), (2, 2, None),
                          (3, 0, 1.0)):
        sched.submit(tserving.Request(rid=rid, tokens=[rid + 1, rid + 2],
                                      max_new=2, priority=prio, deadline=dl))
    order = []
    while sched.pending() or pool.has_active():
        order += [rid for rid, ev in sched.step().items() if ev["done"]]
    assert order == [2, 3, 1, 0], order
    assert sched.stats["deadline_shed"] == 1


def test_expected_footprint_ema_converges_and_clamps():
    """test_scheduler.py:93."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=16)
    req = tserving.Request
    assert sched.expected_new(req(rid=9, tokens=[1], max_new=40)) == 16
    assert sched.expected_new(req(rid=9, tokens=[1], max_new=2)) == 2
    _drive(pool, sched, [req(rid=i, tokens=[1 + i, 2], max_new=3)
                         for i in range(6)])
    assert sched._ema < 8, sched._ema
    assert sched.expected_new(req(rid=9, tokens=[1], max_new=40)) < 16
    assert sched.expected_new(req(rid=9, tokens=[1], max_new=1)) == 1
    assert telemetry.metrics().to_json()["serve_expected_new"] == round(
        sched._ema, 2)


def test_overcommit_env_and_slot_engine_gating(monkeypatch):
    """test_scheduler.py:108."""
    monkeypatch.setenv("TPUBC_OVERCOMMIT", "0")
    assert tserving.Scheduler(tserving.PagedPool(
        TPARAMS, TCFG, 1, **POOL)).overcommit is False
    monkeypatch.delenv("TPUBC_OVERCOMMIT")
    assert tserving.Scheduler(tserving.PagedPool(
        TPARAMS, TCFG, 1, **POOL)).overcommit is True
    sp = tserving.Scheduler(tserving.SlotPool(TPARAMS, TCFG, 1,
                                              device="cpu"),
                            overcommit=True)
    assert sp.overcommit is False
    assert sp.expected_new(tserving.Request(rid=0, tokens=[1],
                                            max_new=9)) is None
    with pytest.raises(ValueError, match="expected_new"):
        tserving.Scheduler(sp.pool, expected_new=0)
    with pytest.raises(ValueError, match="ema_alpha"):
        tserving.Scheduler(sp.pool, ema_alpha=0.0)


def test_overcommit_off_reserves_whole_footprint_exactly():
    """test_scheduler.py:124."""
    reqs = _reqs(tserving, _specs(12, seed=3))
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8, kv_blocks=12,
                              **POOL)
    sched = tserving.Scheduler(pool, overcommit=False)
    refusal = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8,
                                 kv_blocks=12, **POOL)
    for r in reqs:
        res = sched.expected_new(r)
        assert pool.admits(r, reserve_new=res) == refusal.admits(r)
        if pool.admits(r, reserve_new=res):
            pool.admit(r, reserve_new=res)
            refusal.admit(r)
            s = next(s for s in pool.slots
                     if s is not None and s.rid == r.rid)
            assert len(s.blocks) == pool.blocks_needed(r)
    done = _drive(pool, sched, [])
    assert pool.stats["preemptions"] == 0
    assert pool.stats["grown_blocks"] == 0
    for rid, toks in done.items():
        r = next(x for x in reqs if x.rid == rid)
        assert toks == _solo(r.tokens, r.max_new)


def test_serve_overcommit_off_matches_on_and_solo():
    """test_scheduler.py:152."""
    specs = _specs(8, seed=5)
    kw = dict(paged=True, block_size=8, prefill_budget=4, **POOL)
    on = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4, **kw)
    off_stats: dict = {}
    off = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4,
                         overcommit=False, stats=off_stats, **kw)
    assert on == off
    assert off_stats["preemptions"] == 0
    for i, t, m, _p in specs:
        assert on[i] == _solo(t, m), i


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_preempted_streams_byte_identical(prefix_cache):
    """test_scheduler.py:171 (greedy, kv_quant=True): a tight
    overcommitted pool preempts, and every resumed stream equals the
    never-preempted one."""
    reqs = _reqs(tserving, _specs(8, seed=7))
    roomy = tserving.serve(TPARAMS, TCFG, reqs, 8, paged=True, block_size=8,
                           prefill_budget=4, prefix_cache=prefix_cache,
                           **POOL)
    pool = tserving.PagedPool(TPARAMS, TCFG, 8, block_size=8, kv_blocks=8,
                              prefill_budget=4, prefix_cache=prefix_cache,
                              **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    tight = _drive(pool, sched, reqs)
    assert pool.stats["preemptions"] > 0, "pool was not actually tight"
    assert sched.stats["requeues"] == pool.stats["preemptions"]
    assert tight == roomy


def test_priority_inversion_never_exceeds_one_round():
    """test_scheduler.py:212."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=4,
                              prefill_budget=8, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=16)
    low = tserving.Request(rid=0, tokens=[1, 2, 3, 4, 5, 6, 7, 8],
                           max_new=24, priority=0)
    sched.submit(low)
    sched.step()
    assert {s.rid for s in pool.slots if s is not None} == {0}
    high = tserving.Request(rid=1, tokens=[8, 7, 6, 5, 4, 3, 2, 1],
                            max_new=24, priority=3)
    sched.submit(high)
    events = sched.step()
    assert {s.rid for s in pool.slots if s is not None} == {1}, events
    assert pool.stats["preemptions"] == 1
    done = _drive(pool, sched, [])
    assert done[0] == _solo(low.tokens, low.max_new)
    assert done[1] == _solo(high.tokens, high.max_new)


def test_equal_priority_never_preempts():
    """test_scheduler.py:236."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=4,
                              prefill_budget=8, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=16)
    r0 = tserving.Request(rid=0, tokens=[1] * 8, max_new=24, priority=1)
    r1 = tserving.Request(rid=1, tokens=[2] * 8, max_new=24, priority=1)
    sched.submit(r0)
    sched.step()
    sched.submit(r1)
    sched._admit_phase()
    assert {s.rid for s in pool.slots if s is not None} == {0}
    assert pool.stats["preemptions"] == 0
    assert sched.queue_depth() == 1
    done = _drive(pool, sched, [])
    assert done[0] == _solo(r0.tokens, r0.max_new)
    assert done[1] == _solo(r1.tokens, r1.max_new)


def test_victim_policy_prefers_decode_phase_rows():
    """test_scheduler.py:256."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 3, block_size=8, kv_blocks=12,
                              prefill_budget=64, **POOL)
    req = tserving.Request
    pool.admit(req(rid=0, tokens=[1] * 8, max_new=24), reserve_new=4, seq=0)
    pool.admit(req(rid=1, tokens=[2] * 8, max_new=24), reserve_new=4, seq=1)
    pool.step_round()
    pool.admit(req(rid=2, tokens=[3] * 8, max_new=24), reserve_new=4, seq=2)
    rec = pool.preempt_one()
    assert rec["request"].rid == 1, "decode-phase latest arrival evicts"
    assert {s.rid for s in pool.slots if s is not None} == {0, 2}
    assert rec["preload"] == pool.preempted[0]["preload"]
    assert rec["request"].max_new == 24


def test_admission_watermark_holds_back_imminent_growth():
    """test_scheduler.py:276."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, kv_blocks=3,
                              prefill_budget=64, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=1)
    r0 = tserving.Request(rid=0, tokens=[1] * 7, max_new=16)
    sched.submit(r0)
    sched.step()
    assert pool.imminent_growth() >= 1
    r1 = tserving.Request(rid=1, tokens=[2] * 8, max_new=8)
    res = sched.expected_new(r1)
    assert pool.admits(r1, reserve_new=res), "raw capacity would admit"
    sched.submit(r1)
    sched._admit_phase()
    assert {s.rid for s in pool.slots if s is not None} == {0}
    assert sched.queue_depth() == 1
    assert pool.stats["preemptions"] == 0
    done = _drive(pool, sched, [])
    assert done[0] == _solo(r0.tokens, r0.max_new)
    assert done[1] == _solo(r1.tokens, r1.max_new)


def test_overcommit_chunk_follows_expectation_hint():
    """test_scheduler.py:301."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=5)
    sched.submit(tserving.Request(rid=0, tokens=[1, 2], max_new=8))
    sched.step()
    assert pool.chunk_hint == 5
    pool2 = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched2 = tserving.Scheduler(pool2, overcommit=False)
    done = _drive(pool2, sched2,
                  [tserving.Request(rid=0, tokens=[1, 2], max_new=8)])
    assert pool2.chunk_hint is None
    assert done[0] == _solo([1, 2], 8)


def _check_allocator_invariants(pool):
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


def test_fuzzed_churn_preserves_invariants_and_exactness():
    """test_scheduler.py:341."""
    rng = np.random.default_rng(42)
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=4, kv_blocks=10,
                              prefill_budget=4, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    done: dict = {}
    by_rid: dict = {}
    rid = 0
    for _ in range(50):
        if rng.random() < 0.6 and sched.queue_depth() < 6:
            r = tserving.Request(
                rid=rid, tokens=rng.integers(
                    1, 32, int(rng.integers(2, 10))).tolist(),
                max_new=int(rng.integers(1, 14)),
                priority=int(rng.integers(0, 3)))
            by_rid[rid] = r
            sched.submit(r)
            rid += 1
        for got_rid, ev in sched.step().items():
            if ev["done"]:
                done[got_rid] = ev["generated"]
        _check_allocator_invariants(pool)
    while sched.pending() or pool.has_active():
        for got_rid, ev in sched.step().items():
            if ev["done"]:
                done[got_rid] = ev["generated"]
        _check_allocator_invariants(pool)
    assert pool.stats["preemptions"] > 0, "churn never hit pressure"
    assert set(done) == set(by_rid)
    for got_rid, toks in done.items():
        r = by_rid[got_rid]
        assert toks == _solo(r.tokens, r.max_new), got_rid


def test_scheduler_telemetry_names():
    """The reference's metric names after a preempting run: the
    preemption counter and gauge, the queue-wait histogram plain and per
    class (rendered name{priority="..."}), the resume gap, the recompute
    tokens and the cost arms."""
    telemetry.metrics().reset()
    reqs = _reqs(tserving, _specs(8, seed=7))
    pool = tserving.PagedPool(TPARAMS, TCFG, 8, block_size=8, kv_blocks=8,
                              prefill_budget=4, host_blocks=0, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    _drive(pool, sched, reqs)
    m = telemetry.metrics().to_json()
    n = pool.stats["preemptions"]
    assert n > 0 and m["serve_preempt_total"] == m["serve_preemptions"] == n
    assert m["serve_queue_wait_ms_count"] == len(reqs)
    assert m['serve_queue_wait_ms{priority="0"}_count'] == len(reqs)
    assert m["serve_resume_gap_ms_count"] == n
    assert m["serve_preempt_recompute_tokens_total"] > 0
    assert m['serve_preempt_cost{arm="swap_est"}_count'] == n
    assert m['serve_preempt_cost{arm="recompute"}_count'] == n
    assert sched.queue_wait_p50_ms() >= 0.0
    assert m["serve_sched_queue_depth"] == 0
