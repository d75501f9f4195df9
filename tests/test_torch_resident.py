"""The resident-cache engine in the port (queue 1 item 8:
tpu_bootstrap_torch/workload/serving.py: ResidentPool, _window_scan,
_resident_chunk, _prefill_temp, _paste_row, serve(resident=True) and the
ingress's resident engine) held to the JAX reference on the CPU.

Across the frameworks, on the same bridged weights and requests:
serve(resident=True)'s streams, with a float and an int8 KV cache, greedy,
sampled, drafted by an int8 copy and by prompt lookup, equal the
reference's (greedy streams may part only at a near-tie,
tests/test_torch_decode.py:NEAR_TIE, judged by the port's solo logits;
sampled ones are held exactly, f32), and so does every key of ``stats``.
A differential on pinned clocks (tests/test_torch_requestz.py's
``clocks``) steps both packages' Scheduler + ResidentPool and compares,
after every step and exactly, the events, the request log's records, each
round's ledger tokens, the ledger and the stats, with the speculative
rounds' serve_spec_* observations and the draft-stream gauge.

Within the port, in f32 and exactly: resident == replay pool == solo
``generate(kv_kernel=False)``, resident == paged, a reused slot shadows its
previous occupant, eos cuts as on the replay pool, and the resident chunk
as the graphs run it (a warm-up step, then replays through a CPU
stand-in for the CUDA side, as tests/test_torch_graphs.py's) equals the eager loop bitwise in
tokens and cache bytes.

Mirrors tests/test_resident.py except :230 (sharded params, item 11), and
test_paged.py:222 (the majority chunk on the resident pool)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_decode import assert_greedy_equal
from tests.test_torch_requestz import (  # noqa: F401 - fixtures
    STEP_S,
    _folds,
    _records,
    _step,
    clocks,
    pinned_cost,
)
from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import bridge, graphs, kernels
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import ingress as tingress
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import prng
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

# The reference's model (test_resident.py:31), float weights, and their
# int8 copy (the speculative rounds' draft).
BASE = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=16,
            embed_dim=64, mlp_dim=128, max_seq_len=64)
JCFG = jmodel.ModelConfig(**BASE)
TCFG = tmodel.ModelConfig(**BASE)
JPARAMS = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
JDRAFT = jquant.quantize_params(JPARAMS)
TPARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                   device="cpu")
TDRAFT = bridge.params_from_numpy(jax.tree.map(np.asarray, JDRAFT),
                                  device="cpu")
CPU = {"device": "cpu"}


def _solo(tokens, max_new, kv_quant=False):
    return tdecode.generate(TPARAMS, [tokens], TCFG, max_new,
                            kv_quant=kv_quant, kv_kernel=False,
                            device="cpu")[0].tolist()


def _specs(n, seed=0, max_budget=13):
    """test_resident.py:43's requests, as (rid, tokens, max_new)."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, BASE["vocab_size"],
                             int(rng.integers(2, 9))).tolist(),
             int(rng.integers(1, max_budget))) for i in range(n)]


def _reqs(mod, specs):
    return [mod.Request(rid=i, tokens=t, max_new=m) for i, t, m in specs]


class Replaying:
    """tests/test_torch_graphs.py's CPU stand-in for the CUDA side: the
    warm-up runs the step, a capture records it without running it, a
    replay runs it."""

    def __init__(self):
        self.captures = 0

    def warm_up(self, body):
        body()

    def capture(self, body):
        self.captures += 1
        return body

    def replay(self, graph):
        graph()


def _drain(pool):
    got = {}
    while pool.has_active():
        for rid, ev in pool.step_round().items():
            if ev["done"]:
                got[rid] = ev["generated"]
    return got


# ---- the reference's serve(resident=True), stream for stream ---------------

KEY = 21
CASES = {
    # name: (reference kwargs, port kwargs, batch)
    "greedy": ({}, {}, 4),
    "greedy_int8kv": ({"kv_quant": True}, {"kv_quant": True}, 4),
    "sampled": ({"temperature": 0.9, "top_k": 20,
                 "key": jax.random.PRNGKey(KEY)},
                {"temperature": 0.9, "top_k": 20,
                 "key": np.asarray(jax.random.PRNGKey(KEY))}, 3),
    "sampled_int8kv": ({"temperature": 0.8, "top_p": 0.9, "kv_quant": True,
                        "key": jax.random.PRNGKey(KEY)},
                       {"temperature": 0.8, "top_p": 0.9, "kv_quant": True,
                        "key": np.asarray(jax.random.PRNGKey(KEY))}, 3),
    "draft": ({"draft_params": JDRAFT, "draft_cfg": JCFG, "gamma": 3},
              {"draft_params": TDRAFT, "draft_cfg": TCFG, "gamma": 3}, 4),
    "lookup_int8kv": ({"spec_lookup": True, "gamma": 3, "kv_quant": True},
                      {"spec_lookup": True, "gamma": 3, "kv_quant": True}, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_resident_serve_equals_reference(name):
    """test_resident.py:51, :139 and :162 across the frameworks: the
    streams and every key of ``stats`` (the scheduler's sub-dict too)."""
    jkw, tkw, batch = CASES[name]
    specs = _specs(8, seed=23 if "draft" in name else 3)
    want_stats, stats = {}, {}
    want = jserving.serve(JPARAMS, JCFG, _reqs(jserving, specs), batch,
                          resident=True, stats=want_stats, **jkw)
    got = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), batch,
                         resident=True, stats=stats, **CPU, **tkw)
    assert set(got) == set(want)
    if "temperature" in tkw:
        assert got == want
    else:
        assert_greedy_equal(got, want, {i: t for i, t, _ in specs}, TPARAMS,
                            TCFG, kv_quant=tkw.get("kv_quant", False))
    assert stats.keys() == want_stats.keys()
    for key in want_stats:
        assert stats[key] == want_stats[key], key
    assert stats["prefill_tokens"] == sum(len(t) for _, t, _ in specs)
    if "gamma" in tkw:
        assert stats["verify_rounds"] == stats["rounds"]
        assert stats["committed_tokens"] == sum(len(v) for v in got.values())
        assert stats["committed_tokens"] / stats["verify_rounds"] > 1.0
        if "draft_params" in tkw:
            assert stats["draft_steps"] == stats["verify_rounds"] * 4


@pytest.mark.parametrize("kv_quant", [False, True])
def test_resident_equals_replay_solo_and_paged(kv_quant):
    """test_resident.py:51 within the port, exactly (f32): resident ==
    replay == paged (the int8 pool on K2's plain version, the float pool
    on the gathered route) == solo generate; admission prefills each
    prompt once."""
    specs = _specs(10, seed=3)
    rstats: dict = {}
    kw = {"kv_quant": kv_quant, **CPU}
    res = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4,
                         resident=True, stats=rstats, **kw)
    rep = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4, **kw)
    pg = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4,
                        paged=True, block_size=16, prefill_budget=8, **kw)
    assert res == rep == pg
    for i, t, m in specs:
        assert res[i] == _solo(t, m, kv_quant), i
    assert rstats["prefill_tokens"] == sum(len(t) for _, t, _ in specs)
    assert rstats["rounds"] > 1


def test_resident_sampled_equals_replay_and_solo():
    """test_resident.py:139 within the port: a different batch on the
    replay pool, and solo generate with each request's row key."""
    key = np.asarray(jax.random.PRNGKey(KEY))
    specs = _specs(6, seed=11)
    kw = {"temperature": 0.9, "top_k": 20, "key": key, **CPU}
    res = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 3,
                         resident=True, **kw)
    rep = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 2, **kw)
    assert res == rep
    pkey = prng.as_key(key, "cpu")
    for i, t, m in specs:
        row_key = prng.fold_in(prng.fold_in(pkey, 1), i)
        solo = tdecode.generate(TPARAMS, [t], TCFG, m, temperature=0.9,
                                top_k=20, row_keys=row_key[None],
                                row_key_offsets=torch.zeros(1,
                                                            dtype=torch.long),
                                device="cpu")
        assert res[i] == solo[0].tolist(), i


def test_resident_speculative_equals_replay_and_solo():
    """test_resident.py:162 within the port: each row commits its own
    count, the streams are the target's own greedy ones."""
    specs = _specs(8, seed=23)
    stats: dict = {}
    kw = {"draft_params": TDRAFT, "draft_cfg": TCFG, "gamma": 3, **CPU}
    res = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4,
                         resident=True, stats=stats, **kw)
    rep = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4, **kw)
    assert res == rep
    for i, t, m in specs:
        assert res[i] == _solo(t, m), i
    assert stats["committed_tokens"] / stats["verify_rounds"] > 1.0


def test_resident_slot_reuse_shadows_previous_occupant():
    """test_resident.py:70."""
    pool = tserving.ResidentPool(TPARAMS, TCFG, batch_size=1, **CPU)
    first = tserving.Request(rid=0, tokens=[9, 8, 7, 6, 5, 4, 3, 2],
                             max_new=16)
    pool.admit(first)
    got = _drain(pool)
    second = tserving.Request(rid=1, tokens=[2, 3], max_new=8)
    pool.admit(second)
    got.update(_drain(pool))
    assert got[0] == _solo(first.tokens, first.max_new)
    assert got[1] == _solo(second.tokens, second.max_new)


def test_resident_eos_and_utilization():
    """test_resident.py:93: fewer useful slot steps than a static batcher,
    and eos truncation equal to the replay pool's."""
    rng = np.random.default_rng(5)
    reqs = [tserving.Request(rid=i, tokens=rng.integers(1, 128, 4).tolist(),
                             max_new=1 if i % 2 else 12) for i in range(12)]
    stats: dict = {}
    out = tserving.serve(TPARAMS, TCFG, reqs, 4, resident=True, stats=stats,
                         **CPU)
    assert len(out) == len(reqs)
    assert stats["active_slot_steps"] < tserving.static_schedule_slot_steps(
        reqs, 4)
    eos = int(_solo(reqs[0].tokens, 12)[3])
    a = tserving.serve(TPARAMS, TCFG, [reqs[0]], 1, resident=True,
                       eos_id=eos, **CPU)
    b = tserving.serve(TPARAMS, TCFG, [reqs[0]], 1, eos_id=eos, **CPU)
    assert a == b and a[0][-1] == eos and len(a[0]) <= 4


def test_static_schedule_slot_steps_equals_reference():
    for seed in range(4):
        specs = _specs(int(np.random.default_rng(seed).integers(1, 20)),
                       seed=seed)
        for batch in (1, 3, 4):
            assert tserving.static_schedule_slot_steps(
                _reqs(tserving, specs), batch) == (
                jserving.static_schedule_slot_steps(_reqs(jserving, specs),
                                                    batch))


def test_resident_speculative_respects_gamma_headroom():
    """test_resident.py:194."""
    near_cap = tserving.Request(rid=0, tokens=[1] * 8,
                                max_new=TCFG.max_seq_len - 9)
    tserving.serve(TPARAMS, TCFG, [near_cap], 1, resident=True, **CPU)
    with pytest.raises(ValueError, match="gamma"):
        tserving.serve(TPARAMS, TCFG, [near_cap], 1, resident=True,
                       draft_params=TDRAFT, draft_cfg=TCFG, gamma=4, **CPU)


def test_resident_removes_replay_work():
    """test_resident.py:210: admission prefill + decode steps on the
    resident engine against the replay pool's replayed histories."""
    rng = np.random.default_rng(13)
    reqs = [tserving.Request(rid=i, tokens=rng.integers(1, 128, 4).tolist(),
                             max_new=int(rng.integers(16, 33)))
            for i in range(8)]
    rstats, sstats = {}, {}
    res = tserving.serve(TPARAMS, TCFG, reqs, 4, resident=True, stats=rstats,
                         **CPU)
    rep = tserving.serve(TPARAMS, TCFG, reqs, 4, stats=sstats, **CPU)
    assert res == rep
    resident_work = rstats["prefill_tokens"] + rstats["active_slot_steps"]
    replay_work = sstats["replayed_tokens"] + sstats["active_slot_steps"]
    assert resident_work < 0.5 * replay_work, (rstats, sstats)


def test_majority_chunk_on_the_resident_pool():
    """test_paged.py:222: a 1-remaining row retires inside one
    majority-sized round; useful steps exclude its overshoot."""
    pool = tserving.ResidentPool(TPARAMS, TCFG, 4, **CPU)
    rows = [tserving.Request(rid=0, tokens=[3, 4], max_new=1)] + [
        tserving.Request(rid=i, tokens=[5 + i, 2], max_new=8)
        for i in (1, 2, 3)]
    for r in rows:
        pool.admit(r)
    got = _drain(pool)
    assert pool.stats["rounds"] == 1, pool.stats
    for r in rows:
        assert got[r.rid] == _solo(r.tokens, r.max_new), r.rid
    assert pool.stats["active_slot_steps"] == 1 + 3 * 8
    assert pool.stats["slot_steps"] == 4 * 8


def test_resident_pool_refusals_equal_reference():
    """The constructor's and admit's checks, the reference's messages."""
    for kw, match in (({"temperature": 0.5}, "explicit PRNG key"),
                      ({"spec_lookup": True, "draft_params": True,
                        "draft_cfg": True}, "REPLACES"),
                      ({"batch_size": 0}, "batch_size")):
        for mod, params, extra in ((jserving, JPARAMS, {}),
                                   (tserving, TPARAMS, CPU)):
            args = {"batch_size": 2, **kw}
            if args.get("draft_params") is True:
                args["draft_params"] = (JDRAFT if mod is jserving
                                        else TDRAFT)
                args["draft_cfg"] = JCFG if mod is jserving else TCFG
            cfg = JCFG if mod is jserving else TCFG
            with pytest.raises(ValueError, match=match):
                mod.ResidentPool(params, cfg, **args, **extra)
    pool = tserving.ResidentPool(TPARAMS, TCFG, 1, **CPU)
    with pytest.raises(ValueError, match="nothing to resume"):
        pool.admit(tserving.Request(rid=0, tokens=[1], max_new=2),
                   preload=[3])
    with pytest.raises(ValueError, match="distinct engines"):
        tserving.serve(TPARAMS, TCFG, [], 1, paged=True, resident=True,
                       **CPU)


# ---- the request log and the ledger on pinned clocks ----------------------

SPEC_METRICS = ("serve_spec_draft_ms", "serve_spec_verify_ms",
                "serve_spec_commit_ms", "serve_spec_committed_per_round")


def _metric_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if k.startswith(SPEC_METRICS) and k.endswith(("_count", "_sum"))}


LOG_CASES = {
    "plain": ({}, {}),
    "draft": ({"draft_params": JDRAFT, "draft_cfg": JCFG, "gamma": 3},
              {"draft_params": TDRAFT, "draft_cfg": TCFG, "gamma": 3}),
    "lookup": ({"spec_lookup": True, "gamma": 2},
               {"spec_lookup": True, "gamma": 2}),
}


@pytest.mark.parametrize("name", sorted(LOG_CASES))
def test_request_log_and_ledger_differential_against_reference(name,
                                                              clocks):
    """Both packages' Scheduler + ResidentPool on pinned clocks, arrivals
    over time with priorities, compared after every step: the events, the
    log's records, each round's ledger token dict, the ledger,
    device_ms_by_rid, the scheduler's and the pool's stats and the
    streams; after the run, the serve_spec_* observations' counts and
    sums and the draft-stream gauge."""
    jkw, tkw = LOG_CASES[name]
    specs = _specs(7, seed=5, max_budget=10)
    jpool = jserving.ResidentPool(JPARAMS, JCFG, 3, **jkw)
    tpool = tserving.ResidentPool(TPARAMS, TCFG, 3, **CPU, **tkw)
    jsched, tsched = jserving.Scheduler(jpool), tserving.Scheduler(tpool)
    jfolds, tfolds = _folds(jsched), _folds(tsched)
    pairs = list(zip(_reqs(jserving, specs), _reqs(tserving, specs)))
    jm0 = jtelemetry.metrics().to_json()
    tm0 = telemetry.metrics().to_json()
    done, step = {}, 0
    while True:
        for jr, tr in pairs:
            if 2 * tr.rid == step:
                jsched.submit(jr)
                tsched.submit(tr)
        if not (tsched.pending() or tpool.has_active()
                or step <= 2 * len(specs)):
            break
        jev, tev = _step(jsched), _step(tsched)
        assert tev == jev, step
        assert tfolds == jfolds, step
        assert tsched.ledger == jsched.ledger, step
        assert tsched.device_ms_by_rid == jsched.device_ms_by_rid, step
        assert tsched.stats == jsched.stats, step
        assert tpool.stats == jpool.stats, step
        assert _records(tsched) == _records(jsched), step
        done.update({k: v["generated"] for k, v in tev.items() if v["done"]})
        clocks["t"] += STEP_S
        step += 1
        assert step < 500
    assert set(done) == {i for i, *_ in specs}
    for i, t, m in specs:
        assert done[i] == _solo(t, m), i
    kinds = {e["kind"] for r in tsched.log.snapshot()["requests"]
             for e in r["events"]}
    assert {"admitted", "prefill_chunk", "decode_round",
            "retired"} <= kinds
    led = {k for f in tfolds for row in f.values() for k in row}
    assert led == ({"prefill", "verify"} if tkw else {"prefill", "decode"})
    jm, tm = jtelemetry.metrics().to_json(), telemetry.metrics().to_json()
    # Equal tick counts; the sums only differ by the rounding of each
    # registry's earlier total, which the delta subtracts.
    assert _metric_delta(tm0, tm) == pytest.approx(_metric_delta(jm0, jm),
                                                   rel=1e-9)
    if tkw:
        assert _metric_delta(tm0, tm)["serve_spec_verify_ms_count"] == (
            tpool.stats["verify_rounds"])
        assert tm["serve_spec_accept_rate"] == jm["serve_spec_accept_rate"]
    if "draft_params" in tkw:
        assert tm["serve_draft_stream_bytes"] == jm[
            "serve_draft_stream_bytes"]


# ---- the captured step, rehearsed on the CPU ------------------------------


def _mid_serve(kv_quant, **kw):
    """A resident pool four requests into a serve, two rounds in."""
    pool = tserving.ResidentPool(TPARAMS, TCFG, 4, kv_quant=kv_quant, **kw,
                                 **CPU)
    for r in _reqs(tserving, _specs(4, seed=7, max_budget=30)):
        pool.admit(r)
    pool.step_round()
    pool.step_round()
    return pool


def _cache_clone(pool):
    return [{n: a.clone() for n, a in layer.items()} for layer in pool.caches]


@pytest.mark.parametrize("kv_quant,sampled", [(False, False), (True, False),
                                              (True, True)])
def test_graph_step_equals_eager_chunk(kv_quant, sampled, monkeypatch):
    """The resident chunk as its graphs run it (the first step of a width
    the warm-up, the capture, then replays of ``_resident_graph_step`` on
    the static buffers) against ``_resident_chunk`` on a clone of the
    caches: tokens and every cache byte equal, the caches written in place
    (addresses kept), one graph a slab width, and the launch counts those
    of the eager chunk."""
    kw = ({"temperature": 0.9, "top_k": 20,
           "key": np.asarray(jax.random.PRNGKey(3))} if sampled else {})
    pool = _mid_serve(kv_quant, **kw)
    ref = _mid_serve(kv_quant, **kw)
    backend = Replaying()
    pool._graphs = graphs.StepGraphs(backend)
    ptrs = [a.data_ptr() for layer in pool.caches for a in layer.values()]
    last, pos = pool._rows()
    active = [s for s in pool.slots if s is not None]
    chunk = tserving._majority_chunk(active, TCFG.max_seq_len)
    lb = min(tserving._bucket_up(max(len(s.history) for s in active)
                                 + chunk - 1), TCFG.max_seq_len)
    assert chunk >= 2
    sampler = None
    if sampled:
        keys, offs = ref._row_keys(ref.slots)
        ref._rkeys.copy_(keys)
        ref._roff.copy_(offs)
        sampler = ref._sampler
    kernels.reset_launches()
    want = tserving._resident_chunk(TPARAMS, ref.caches, last, pos, TCFG,
                                    chunk, lb, sampler).tolist()
    eager_launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    got = pool._decode_chunk(lb, last, pos, chunk)
    assert got == want
    assert dict(kernels.LAUNCHES) == eager_launches
    for gl, wl in zip(pool.caches, ref.caches):
        for n in wl:
            assert torch.equal(gl[n], wl[n]), n
    assert ptrs == [a.data_ptr() for layer in pool.caches
                    for a in layer.values()]
    assert backend.captures == 1
    assert pool._graphs.stats["replays"] == chunk - 1
    # A second chunk at the same width replays without a capture.
    pool._decode_chunk(lb, last, pos, 1)
    assert backend.captures == 1


def test_graphed_pool_serves_what_the_eager_pool_does(monkeypatch):
    """serve(resident=True) with the stand-in graphs equals the eager
    serve, greedy and speculative rounds untouched; reset zeroes the
    caches in place and the captured widths keep serving."""
    specs = _specs(8, seed=3)
    eager = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4,
                           resident=True, kv_quant=True, **CPU)
    monkeypatch.setattr(graphs, "for_device",
                        lambda device: graphs.StepGraphs(Replaying()))
    pool = tserving.ResidentPool(TPARAMS, TCFG, 4, kv_quant=True, **CPU)
    sched = tserving.Scheduler(pool)
    for r in _reqs(tserving, specs):
        sched.submit(r)
    got = {}
    while sched.pending() or pool.has_active():
        for rid, ev in sched.step().items():
            if ev["done"]:
                got[rid] = ev["generated"]
    assert got == eager
    assert pool._graphs.stats["captured"] >= 1
    ptrs = [a.data_ptr() for layer in pool.caches for a in layer.values()]
    pool.reset()
    assert ptrs == [a.data_ptr() for layer in pool.caches
                    for a in layer.values()]
    assert all(not a.any() for layer in pool.caches for a in layer.values())
    for r in _reqs(tserving, specs[:4]):
        pool.admit(r)
    again = _drain(pool)
    assert again == {i: eager[i] for i in range(4)}


def test_graph_capture_failure_raises():
    """A failed capture raises out of the round; nothing runs eagerly in
    its place."""

    class Failing(Replaying):
        def capture(self, body):
            raise RuntimeError("stand-in capture failed")

    pool = tserving.ResidentPool(TPARAMS, TCFG, 2, **CPU)
    pool._graphs = graphs.StepGraphs(Failing())
    pool.admit(tserving.Request(rid=0, tokens=[1, 2, 3], max_new=8))
    with pytest.raises(RuntimeError, match="stand-in capture failed"):
        pool.step_round()
    assert pool.slots[0].generated == []


# ---- the front door -------------------------------------------------------


def _post(port, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_resident_through_the_ingress():
    """test_resident.py:108: concurrent clients on the resident engine get
    their solo streams; /poolz names the engine and the banner's engine
    flags follow it."""
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=3,
                                 resident=True, host="127.0.0.1",
                                 **CPU).start()
    jobs = [(t, m) for _, t, m in _specs(5, seed=9)]
    results = [None] * len(jobs)
    errors: list = []

    def client(i):
        try:
            results[i] = _post(srv.port, {"tokens": jobs[i][0],
                                          "max_new": jobs[i][1],
                                          "stream": False})["tokens"]
        except Exception as e:  # noqa: BLE001
            errors.append(f"{i}: {e}")

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        for i, (tokens, max_new) in enumerate(jobs):
            assert results[i] == _solo(tokens, max_new), i
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/poolz",
                                    timeout=30) as r:
            poolz = json.loads(r.read())
        assert poolz["pool"]["engine"] == "ResidentPool"
        assert poolz["pool"]["stats"]["prefill_tokens"] == sum(
            len(t) for t, _ in jobs)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/requestz",
                                    timeout=30) as r:
            reqz = json.loads(r.read())
        assert len(reqz["requests"]) == len(jobs)
    finally:
        srv.stop()


def test_spec_resident_ingress_rejects_gamma_overflow_at_front_door():
    """test_resident.py:250: a request without the speculative pool's
    gamma headroom answers 400 and never reaches the engine, which goes
    on serving."""
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=2,
                                 resident=True, draft_params=TDRAFT,
                                 draft_cfg=TCFG, gamma=4, host="127.0.0.1",
                                 **CPU).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"tokens": [1] * 8,
                             "max_new": TCFG.max_seq_len - 9})
        assert e.value.code == 400
        assert "gamma" in json.loads(e.value.read())["error"]
        out = _post(srv.port, {"tokens": [5, 6], "max_new": 4,
                               "stream": False})
        assert out["done"] and out["tokens"] == _solo([5, 6], 4)
    finally:
        srv.stop()


def test_ingress_abort_all_resets_the_resident_pool(monkeypatch):
    """A failed resident round has no in-round recovery: the engine
    thread fails every in-flight request loudly, resets the pool (the
    caches zeroed in place) and serves the next request."""
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=2,
                                 resident=True, host="127.0.0.1",
                                 **CPU).start()
    real = tserving.ResidentPool.step_round
    fail = {"n": 1}

    def step_round(self):
        if fail["n"] and self.has_active():
            fail["n"] -= 1
            raise RuntimeError("injected resident round failure")
        return real(self)

    monkeypatch.setattr(tserving.ResidentPool, "step_round", step_round)
    try:
        bad = _post(srv.port, {"tokens": [3, 4], "max_new": 4,
                               "stream": False})
        assert "injected resident round failure" in bad["error"]
        out = _post(srv.port, {"tokens": [5, 6], "max_new": 4,
                               "stream": False})
        assert out["tokens"] == _solo([5, 6], 4)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert "injected" in health["last_error"]
    finally:
        srv.stop()
