"""The paged engine's speculative rounds in the port (queue 1 item 5.8)
held to the reference on the CPU: prompt-lookup drafting
(ngram_lookup_drafts), and PagedPool with a model draft (an unquantized
target drafted by its own int8 copy) or spec_lookup, differentially: the
same submissions step both packages' Scheduler + PagedPool and compare,
after every step, the slots, the queue, each preemption and its arm, the
pool's stats (verify_rounds, committed_tokens, draft_steps,
draft_proposed, draft_accepted among them), the allocator, the host tier
and the streams, exactly in f32. The draft's pools ride the target's
block ids: the prefix cache and copy-on-write, the host tier's "d" half,
defrag and crash recovery move both. Then the slot engine's speculative
accounting against the reference's (its ledger bills "verify" work).

Mirrors test_paged.py:285, test_prefix_cache.py:443, test_scheduler.py:195
and :383-430, and test_spec_serving.py's paged-engine halves (its slot
engine halves are in tests/test_torch_serving.py); the resident engine's
halves are in tests/test_torch_resident.py, the float pool's
(test_paged.py:285) in tests/test_torch_float_pool.py."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_scheduler import (
    JCFG,
    JPARAMS,
    TCFG,
    TPARAMS,
    _drive,
    _logged,
    _reqs,
    _specs,
    _state,
    pinned_cost,  # noqa: F401 - a fixture
)
from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import bridge, faults
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

# The unquantized target (the serve entry's WORKLOAD_SPECULATIVE model)
# and its int8 copy, the draft, in both packages.
JFLOAT = jmodel.init_params(JCFG, jax.random.PRNGKey(1))
JDRAFT = jquant.quantize_params(JFLOAT)
TFLOAT = bridge.params_from_numpy(jax.tree.map(np.asarray, JFLOAT),
                                  device="cpu")
TDRAFT = bridge.params_from_numpy(jax.tree.map(np.asarray, JDRAFT),
                                  device="cpu")
DRAFTED = ({"draft_params": JDRAFT, "draft_cfg": JCFG},
           {"draft_params": TDRAFT, "draft_cfg": TCFG})


def _solo(params, tokens, max_new):
    return tdecode.generate(params, [tokens], TCFG, max_new, kv_quant=True,
                            kv_kernel=False, device="cpu")[0].tolist()


def _spec_differential(specs, jparams, tparams, pool_kw, extra,
                       sched_kw):
    """tests/test_torch_scheduler.py's differential with each package's
    own params and draft (``extra``: (reference kwargs, port kwargs)):
    states, events, the preemption log and the streams compared after
    every step. Returns (streams, port pool, reference pool)."""
    jpool = jserving.PagedPool(jparams, JCFG, kv_quant=True, **pool_kw,
                               **extra[0])
    tpool = tserving.PagedPool(tparams, TCFG, kv_quant=True, device="cpu",
                               **pool_kw, **extra[1])
    jsched = jserving.Scheduler(jpool, **sched_kw)
    tsched = tserving.Scheduler(tpool, **sched_kw)
    jlog, tlog = [], []
    _logged(jpool, jlog)
    _logged(tpool, tlog)
    for jr, tr in zip(_reqs(jserving, specs), _reqs(tserving, specs)):
        jsched.submit(jr)
        tsched.submit(tr)
    done, step = {}, 0
    while tsched.pending() or tpool.has_active():
        jev, tev = jsched.step(), tsched.step()
        assert {k: (v["new"], v["done"], v["generated"])
                for k, v in tev.items()} == {
            k: (v["new"], v["done"], v["generated"])
            for k, v in jev.items()}, step
        got, want = _state(tpool, tsched), _state(jpool, jsched)
        for key in want:
            assert got[key] == want[key], (step, key)
        assert tlog == jlog, step
        done.update({k: v["generated"] for k, v in tev.items() if v["done"]})
        step += 1
        assert step < 2000
    assert not (jsched.pending() or jpool.has_active())
    return done, tpool, jpool


# ---- prompt-lookup drafting -------------------------------------------------


def test_ngram_lookup_drafts_unit_and_reference():
    """test_scheduler.py:383: the reference's cases, and random histories
    (repetitive ones, so lookups hit) equal to the reference's function."""
    look = tserving.ngram_lookup_drafts
    assert look([1, 2, 3, 1, 2], 3) == [3, 1, 2]
    assert look([1, 2, 9, 1, 2, 7, 1, 2], 1) == [7]
    assert look([4, 5, 4, 5], 4) == [4, 5, 5, 5]
    assert look([4, 5, 6, 4, 5, 6, 4, 5], 3) == [6, 4, 5]
    assert look([1, 2, 3], 2) == [3, 3]
    assert look([7], 3) == [7, 7, 7]
    with pytest.raises(ValueError):
        look([1, 2], 0)
    rng = np.random.default_rng(0)
    for _ in range(300):
        hist = rng.integers(0, 4, int(rng.integers(1, 40))).tolist()
        gamma, max_n = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        assert look(hist, gamma, max_n) == jserving.ngram_lookup_drafts(
            hist, gamma, max_n)


# ---- the paged engine's rounds against the reference ----------------------


def test_paged_self_draft_differential_against_reference():
    """test_paged.py:285: the unquantized target drafted by its int8 copy,
    gamma 3, every row committing its own accepted count: the reference's
    states, stats and streams at every step; the streams equal the
    target's solo greedy generate; more than one token committed a round;
    the phase timers observed every round."""
    reg = telemetry.metrics()
    before = {n: reg.to_json().get(f"{n}_count", 0)
              for n in ("serve_spec_draft_ms", "serve_spec_verify_ms",
                        "serve_spec_commit_ms")}
    specs = _specs(6, seed=23, lo_new=3, hi_new=14)
    done, pool, _ = _spec_differential(
        specs, JFLOAT, TFLOAT, dict(batch_size=4, block_size=8,
                                    prefill_budget=8, gamma=3,
                                    prefix_cache=False),
        DRAFTED, dict(overcommit=False))
    stats = pool.stats
    for i, t, m, _p in specs:
        assert done[i] == _solo(TFLOAT, t, m), i
    assert stats["committed_tokens"] == sum(len(v) for v in done.values())
    assert stats["committed_tokens"] / stats["verify_rounds"] > 1.0
    assert stats["draft_steps"] == 4 * stats["verify_rounds"]
    after = reg.to_json()
    for name, n in before.items():
        assert after[f"{name}_count"] - n >= stats["verify_rounds"], name
    assert after["serve_spec_accept_rate"] == round(
        stats["draft_accepted"] / stats["draft_proposed"], 4)
    assert after["serve_draft_stream_bytes"] > 0


def test_preempted_spec_lookup_differential_against_reference(pinned_cost):
    """test_scheduler.py:195: prompt lookup on a tight overcommitted pool
    with the prefix cache and the host tier: preemptions by swap and by
    recompute, each step equal to the reference's, the streams equal to
    the never-preempted run and to solo generate."""
    specs = _specs(8, seed=11)
    done, pool, _ = _spec_differential(
        specs, JPARAMS, TPARAMS, dict(batch_size=8, block_size=8,
                                      kv_blocks=10, prefill_budget=4,
                                      spec_lookup=True, gamma=3,
                                      host_blocks=64),
        ({}, {}), dict(overcommit=True, expected_new=2))
    assert pool.stats["preemptions"] > 0
    assert pool.stats["draft_steps"] == 0 < pool.stats["draft_proposed"]
    roomy = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 8,
                           paged=True, kv_quant=True, block_size=8,
                           prefill_budget=4, spec_lookup=True, gamma=3,
                           device="cpu")
    assert done == roomy
    for i, t, m, _p in specs:
        assert done[i] == _solo(TPARAMS, t, m), i


# ---- the draft's pools ride the target's blocks ----------------------------


def _shared_prefix(n, seed=23):
    """``n`` requests of 32 tokens on one 24-token system prompt, and a
    repeat of the first: its last prompt block, full in the cache, holds
    the token it re-feeds, so it is copied on write."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 32, 24).tolist()
    specs = [(i, system + rng.integers(1, 32, 8).tolist(), 8, 0)
             for i in range(n)]
    return specs + [(n, specs[0][1], 8, 0)]


def test_cached_speculative_bit_matches_and_shares_draft():
    """test_prefix_cache.py:443: one table drives both pools, so cached
    prefixes (and copy-on-write copies) cover the draft's KV too: warm ==
    cold == solo, with prefix hits."""
    specs = _shared_prefix(7)
    kw = dict(paged=True, kv_quant=True, block_size=8, prefill_budget=8,
              gamma=3, device="cpu", **DRAFTED[1])
    stats: dict = {}
    warm = tserving.serve(TFLOAT, TCFG, _reqs(tserving, specs), 4,
                          stats=stats, **kw)
    cold = tserving.serve(TFLOAT, TCFG, _reqs(tserving, specs), 4,
                          prefix_cache=False, **kw)
    assert warm == cold
    for i, t, m, _p in specs:
        assert warm[i] == _solo(TFLOAT, t, m), i
    assert stats["prefix_hit_tokens"] > 0 and stats["cow_copies"] > 0


@pytest.mark.parametrize("draft", [False, True], ids=["lookup", "drafted"])
def test_swap_restore_speculative(monkeypatch, draft):
    """test_host_tier.py:143's prompt-lookup case, and a model draft: a
    row whose KV (the draft's "d" half too) went through host memory keeps
    its stream."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    monkeypatch.setenv("TPUBC_EXPECTED_NEW", "2")
    specs = _specs(6, seed=7)
    params = TFLOAT if draft else TPARAMS
    kw = dict(paged=True, kv_quant=True, block_size=8, kv_blocks=8,
              prefill_budget=4, overcommit=True, device="cpu",
              **(DRAFTED[1] if draft else {"spec_lookup": True}))
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "64")
    stats: dict = {}
    on = tserving.serve(params, TCFG, _reqs(tserving, specs), 6,
                        stats=stats, **kw)
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")
    off = tserving.serve(params, TCFG, _reqs(tserving, specs), 6, **kw)
    assert on == off and stats.get("swap_preempts", 0) > 0
    for i, t, m, _p in specs:
        assert on[i] == _solo(params, t, m), i


def test_host_entry_carries_the_draft_half_bitwise():
    """A block fetched to the host holds the draft's layers beside the
    target's ("d"), and a restore into a zeroed block writes both back
    bit for bit, in place."""
    pool = tserving.PagedPool(TFLOAT, TCFG, 2, kv_quant=True, block_size=8,
                              gamma=3, device="cpu", **DRAFTED[1])
    r = tserving.Request(rid=0, tokens=list(range(1, 20)), max_new=4)
    pool.admit(r)
    while pool.has_active():
        pool.step_round()
    bid = next(b for b in range(1, pool.allocator.num_blocks + 1)
               if pool.allocator.is_cached(b))
    entry = pool._host_fetch(bid)
    assert entry["d"] is not None and len(entry["d"]) == TCFG.num_layers
    want = [{n: a[bid].clone() for n, a in layer.items()}
            for layer in pool.pools + pool.dpools]
    ptrs = [a.data_ptr() for layer in pool.dpools for a in layer.values()]
    for layer in pool.pools + pool.dpools:
        for a in layer.values():
            a[bid].zero_()
    pool._host_restore([bid], [entry])
    for layer, w in zip(pool.pools + pool.dpools, want):
        for n, a in layer.items():
            assert torch.equal(a[bid], w[n]), n
    assert ptrs == [a.data_ptr() for layer in pool.dpools
                    for a in layer.values()]
    assert entry["bytes"] == sum(x.numel() * x.element_size()
                                 for layer in entry["t"] + entry["d"]
                                 for x in layer.values())


def test_defrag_and_recovery_move_the_draft_pools():
    """Defrag mid-serve permutes the draft's pools with the target's, and a
    failed round recovered as a preemption of every row resumes them: the
    streams equal an undisturbed run's."""
    specs = _specs(6, seed=5, lo_new=6, hi_new=16)
    kw = dict(kv_quant=True, block_size=8, prefill_budget=8, gamma=3,
              device="cpu", **DRAFTED[1])
    want = tserving.serve(TFLOAT, TCFG, _reqs(tserving, specs), 3,
                          paged=True, **kw)
    pool = tserving.PagedPool(TFLOAT, TCFG, 3, **kw)
    sched = tserving.Scheduler(pool)
    for r in _reqs(tserving, specs):
        sched.submit(r)
    done, rounds, moved = {}, 0, 0
    faults.install("pool.device:1:7")
    try:
        while sched.pending() or pool.has_active():
            for rid, ev in sched.step().items():
                if ev["done"]:
                    done[rid] = ev["generated"]
            rounds += 1
            if rounds % 3 == 0:
                moved += pool.defrag()
    finally:
        faults.install(None)
    assert done == want
    assert moved > 0 and pool.stats.get("crash_preempts", 0) > 0
    # A reset zeroes the draft's pools in place, as the target's.
    pool.reset()
    assert all(int(a.abs().sum()) == 0 for layer in pool.dpools
               for a in layer.values())


# ---- refusals, serve, the ingress -----------------------------------------


def test_spec_loud_rejections_equal_reference():
    """test_scheduler.py:417: what both packages refuse, with the same
    message: a draft together with lookup, sampling with lookup or a
    draft, lookup on the slot engine, a request without gamma's headroom,
    a draft without its config, gamma below 1."""
    key = np.asarray(jax.random.PRNGKey(0))
    cases = [
        (dict(spec_lookup=True, draft=True), "REPLACES the model draft"),
        (dict(spec_lookup=True, temperature=0.5, key=key), "greedy-only"),
        (dict(draft=True, temperature=0.5, key=key), "greedy-only"),
        (dict(draft_params=True), "requires draft_cfg"),
        (dict(spec_lookup=True, gamma=0), "gamma must be >= 1"),
    ]
    for kw, match in cases:
        for mod, params, draft, cfg, extra in (
                (jserving, JPARAMS, JDRAFT, JCFG, {}),
                (tserving, TPARAMS, TDRAFT, TCFG, {"device": "cpu"})):
            args = dict(kw)
            if args.pop("draft", False):
                args.update(draft_params=draft, draft_cfg=cfg)
            elif args.get("draft_params") is True:
                args["draft_params"] = draft
            with pytest.raises(ValueError, match=match):
                mod.PagedPool(params, cfg, 2, kv_quant=True, **args, **extra)
    for mod, params, cfg, extra in ((jserving, JPARAMS, JCFG, {}),
                                    (tserving, TPARAMS, TCFG,
                                     {"device": "cpu"})):
        with pytest.raises(ValueError, match="resident/paged"):
            mod.serve(params, cfg, [mod.Request(rid=0, tokens=[1],
                                                max_new=1)], 2,
                      spec_lookup=True, **extra)
        pool = mod.PagedPool(params, cfg, 2, kv_quant=True, spec_lookup=True,
                             gamma=4, block_size=8, **extra)
        with pytest.raises(ValueError, match="gamma"):
            pool.validate(mod.Request(rid=0, tokens=[1] * 32, max_new=32),
                          cfg)
        # The overshoot is reserved: 30 + 2 + gamma 4 tokens, 5 blocks.
        assert pool.blocks_needed(mod.Request(rid=0, tokens=[1] * 30,
                                              max_new=2)) == 5


def test_spec_events_carry_acceptance():
    """The request log's decode_round events of a speculative round carry
    each row's accepted proposals, as the reference's do."""
    specs = _specs(3, seed=2, lo_new=4, hi_new=9)
    events = []
    for mod, params, extra in ((jserving, JPARAMS, {}),
                               (tserving, TPARAMS, {"device": "cpu"})):
        pool = mod.PagedPool(params, JCFG if mod is jserving else TCFG, 3,
                             kv_quant=True, block_size=8, prefill_budget=8,
                             spec_lookup=True, gamma=3, prefix_cache=False,
                             **extra)
        sched = mod.Scheduler(pool, overcommit=False)
        _drive(pool, sched, _reqs(mod, specs))
        events.append([(e["kind"], e.get("tokens"), e.get("accepted"))
                       for r, *_ in specs
                       for e in sched.log.snapshot(r)["requests"][0]["events"]
                       if e["kind"] == "decode_round"])
    assert events[1] == events[0]
    assert all(acc is not None for _k, _t, acc in events[1])


def test_slot_engine_speculative_accounting_equals_reference():
    """The slot engine's speculative rounds bill their tokens as verify
    work in the ledger, time each loop (serve_spec_round_ms), observe the
    committed tokens a round and export the draft's stream bytes, as the
    reference's do."""
    specs = _specs(3, seed=4, lo_new=4, hi_new=9)
    kinds, names = [], []
    for mod, params, draft, cfg, tel, extra in (
            (jserving, JFLOAT, JDRAFT, JCFG, jtelemetry, {}),
            (tserving, TFLOAT, TDRAFT, TCFG, telemetry, {"device": "cpu"})):
        pool = mod.SlotPool(params, cfg, 3, kv_quant=True, draft_params=draft,
                            draft_cfg=cfg, gamma=3, **extra)
        for r in _reqs(mod, specs):
            pool.admit(r)
        pool.ledger_tokens = {}
        before = tel.metrics().to_json()
        pool.step_round()
        after = tel.metrics().to_json()
        kinds.append({rid: sorted(k) for rid, k in pool.ledger_tokens.items()})
        names.append(sorted(
            n for n in ("serve_spec_round_ms_count",
                        "serve_spec_committed_per_round_count")
            if after.get(n, 0) > before.get(n, 0)))
        assert after["serve_draft_stream_bytes"] > 0
    assert kinds[1] == kinds[0] == {r: ["prefill", "verify"]
                                    for r, *_ in specs}
    assert names[1] == names[0] == ["serve_spec_committed_per_round_count",
                                    "serve_spec_round_ms_count"]


def test_ingress_paged_spec_lookup_streams_equal_serve():
    """The front door on the paged engine with prompt lookup: a request's
    answer is serve()'s stream."""
    import json
    import urllib.request

    from tpu_bootstrap_torch.workload import ingress as tingress

    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=2,
                                 paged=True, kv_quant=True, block_size=8,
                                 spec_lookup=True, gamma=3,
                                 host="127.0.0.1", device="cpu").start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/generate",
            data=json.dumps({"tokens": [3, 5, 3, 5, 3], "max_new": 9,
                             "stream": False}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())["tokens"]
        assert srv.pool.stats["verify_rounds"] > 0
    finally:
        srv.stop()
    assert got == _solo(TPARAMS, [3, 5, 3, 5, 3], 9)
