"""The port's fleet front door (``tpu_bootstrap_torch.workload.router``)
against the reference's (``tpu_bootstrap.workload.router``).

Pure parts, port against reference on the same inputs: the circuit
breaker's seeded schedule and its open / half-open / closed walk,
``breaker_view``, the autoscaler's decisions tick by tick on the canned
burn series of tests/test_router.py, and the client writer's stream lines.

Live parts: the scenarios of tests/test_router.py on the same scriptable
``_FakeServe`` replicas, each run once behind the reference's router and
once behind the port's (``pkg``), holding both to the same placements,
``/routerz`` decisions and terminal chunks: placement by digest, stale
digests degrading to least queue, drain-aware routing, the misroute
signal, failover under the ``router.dispatch`` fault, pre-token death,
mid-stream death, hedging, breakers opened by scrape failures, the
``router.scrape`` seam, the all-open 503, and the local fleet driver's
drain before kill. Then a router in front of port replicas whose engine
raises in ``_profile_tick`` or while it publishes a round's events: one
terminal outcome per request, and the replica healthy again to the next
scrape. The kill-a-replica chaos scenario, on port replicas
in subprocesses, carries the reference's ``slow`` marker. The lock
discipline pass of ``tools.lint`` finds over the port's router and
fleetz what it finds over the reference's. Every wait is bounded."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from tests.test_router import (
    _COLD,
    BS,
    PROMPT,
    _burn,
    _digest_for,
    _FakeServe,
    _post_json,
    _stream,
    _wait,
    _wait_scraped,
)
from tests.test_torch_ingress import HTTP_TIMEOUT, get, solo, tokens_of
from tests.test_torch_ingress_faults import (
    _boom,
    _boom_once,
    _ended,
    _held_pair,
)
from tests.test_torch_scheduler import TCFG, TPARAMS
from tools.lint import SourceFile, locks
from tpu_bootstrap.workload import faults as jfaults
from tpu_bootstrap.workload import router as jrouter
from tpu_bootstrap_torch.workload import faults as tfaults
from tpu_bootstrap_torch.workload import ingress as tingress
from tpu_bootstrap_torch.workload import router as trouter

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"ref": SimpleNamespace(router=jrouter, faults=jfaults),
            "port": SimpleNamespace(router=trouter, faults=tfaults)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """The router under test: the reference's or the port's, with the
    faults module whose seams it fires."""
    p = PACKAGES[request.param]
    yield p
    p.faults.install(None)


def _router(pkg, replicas, **kw):
    kw.setdefault("scrape_s", 0.05)
    kw.setdefault("stale_s", 5.0)
    kw.setdefault("breaker_s", 0.2)
    kw.setdefault("hedge_s", 0.0)
    kw.setdefault("timeout_s", 10.0)
    kw.setdefault("connect_timeout_s", 2.0)
    return pkg.router.FleetRouter([r.addr for r in replicas], port=0,
                                  host="127.0.0.1", **kw).start()


_STOPPING: list = []


@pytest.fixture(scope="module", autouse=True)
def _servers_stopped():
    """Every server a test handed to ``_stop`` has stopped by the end of
    the module."""
    yield
    for t in _STOPPING:
        t.join(timeout=HTTP_TIMEOUT)
    assert not any(t.is_alive() for t in _STOPPING)


def _stop(router, *fakes):
    """Stop the router and the fakes on threads of their own: each HTTP
    server's shutdown waits out its poll interval, which the next tests
    need not wait for (the module's teardown joins them)."""
    for x in (router, *fakes):
        t = threading.Thread(target=x.stop)
        t.start()
        _STOPPING.append(t)


# ---- pure parts, port against reference -------------------------------------


@pytest.mark.parametrize("seed,base", [(42, 1.0), (7, 0.2), (0x7b5c, 1e-4),
                                       (3, 250.0)])
def test_breaker_schedule_equals_the_reference(seed, base):
    """The same seed and failure sequence give the same backoffs and the
    same allow / record walk, step by step, capped at BACKOFF_CAP_S."""
    def walk(mod):
        b = mod.CircuitBreaker(base, seed=seed)
        seen, now = [], 100.0
        for k in range(12):
            b.record_failure(now)
            seen.append(("fail", b.state, b.failures, b.backoff_s,
                         round(b.open_until - now, 9), b.snapshot(now)))
            for dt in (0.0, b.backoff_s * 0.5, b.backoff_s + 1e-3,
                       b.backoff_s + 2e-3):
                seen.append(("allow", dt, b.allow(now + dt), b.state,
                             b.snapshot(now + dt)))
            if k == 5:
                b.record_success()
                seen.append(("ok", b.state, b.failures, b.snapshot(now)))
            now += b.backoff_s + 1.0
        return seen

    assert walk(trouter) == walk(jrouter)


def test_breaker_view_equals_the_reference():
    for failures in (0, 1, 2, 7):
        for backoff in (0.0, 0.5, 4.0):
            for nxt, now in ((55.0, 60.0), (60.0, 60.0), (65.5, 60.0)):
                assert (trouter.breaker_view(failures, backoff, nxt, now)
                        == jrouter.breaker_view(failures, backoff, nxt, now))
    b = trouter.CircuitBreaker(1.0, seed=3)
    b.record_failure(50.0)
    view = trouter.breaker_view(1, b.backoff_s, 50.0 + b.backoff_s, 50.0)
    assert set(b.snapshot(50.0)) == set(view)


def _canned_series():
    """tests/test_router.py's canned series, then its floor and empty-doc
    cases: (controller args, [(current, burn, now), ...])."""
    return [
        ((1, 3), dict(up_ticks=2, down_ticks=3, cooldown_s=10.0,
                      burn_threshold=1.0),
         [(1, _burn(True), 0.0), (1, _burn(False, burn=0.9), 1.0),
          (1, _burn(True), 2.0), (1, _burn(True), 3.0),
          (2, _burn(True), 4.0), (2, _burn(True), 5.0),
          (2, _burn(True), 14.0), (3, _burn(True), 30.0),
          (3, _burn(True), 31.0), (3, _burn(False), 40.0),
          (3, _burn(False), 41.0), (3, _burn(False), 42.0),
          (2, _burn(False, burn=0.5), 60.0), (2, {}, 61.0),
          (2, _burn(False, burn=0.51), 62.0)]),
        ((1, 3), dict(up_ticks=2, down_ticks=1, cooldown_s=0.0),
         [(1, _burn(False), 0.0)]),
        ((1, 3), dict(up_ticks=1, down_ticks=1, cooldown_s=0.0),
         [(2, {}, 0.0), (2, {"r": {}}, 1.0), (2, None, 2.0),
          (2, {"r": {"s": "junk"}}, 3.0)]),
    ]


@pytest.mark.parametrize("case", range(3))
def test_autoscale_decisions_equal_the_reference(case):
    """Each tick's decision and the controller's snapshot after it, the
    action record's wall stamp aside."""
    args, kw, series = _canned_series()[case]

    def decisions(mod):
        c = mod.AutoscaleController(*args, **kw)
        out = []
        for current, burn, now in series:
            target = c.step(current, burn, now=now)
            snap = c.snapshot(now)
            if snap["last"] is not None:
                snap["last"] = {k: v for k, v in snap["last"].items()
                                if k != "t_us"}
            out.append((target, snap))
        return out

    got = decisions(trouter)
    assert got == decisions(jrouter)
    if case == 0:  # the reference test's asserted decisions
        assert [t for t, _ in got[:12]] == [None, None, None, 2, None, None,
                                            3, None, None, None, None, 2]
    with pytest.raises(ValueError):
        trouter.AutoscaleController(3, 2)


@pytest.mark.parametrize("failover", [False, True])
def test_client_writer_lines_equal_the_reference(failover):
    events = [{"tokens": [], "queued": True, "queue_position": 3},
              {"tokens": [1, 2]},
              {"tokens": [3], "done": True, "cached_tokens": 16,
               "timing": {"ttft_ms": 1.5}, "trace_id": "t-1"},
              {"tokens": [], "done": True, "draining": True,
               "error": "draining"},
              {"tokens": [], "done": True, "deadline_exceeded": True},
              {"done": True, "error": "boom", "cached_tokens": 0}]
    for rid in ("", "idem-1"):
        port = trouter._ClientWriter(None, True, rid)
        ref = jrouter._ClientWriter(None, True, rid)
        for ev in events:
            assert (json.dumps(port._line(ev, failover=failover))
                    == json.dumps(ref._line(ev, failover=failover)))


def test_knobs_read_as_the_reference(monkeypatch):
    readers = ("scrape_interval_s", "digest_stale_s", "breaker_base_s",
               "hedge_after_s", "max_retries")
    for env in ({}, {"TPUBC_ROUTER_SCRAPE_MS": "250",
                     "TPUBC_ROUTER_DIGEST_STALE_MS": "-5",
                     "TPUBC_ROUTER_BREAKER_MS": "junk",
                     "TPUBC_ROUTER_HEDGE_MS": "0",
                     "TPUBC_ROUTER_RETRIES": "7"},
                {"TPUBC_ROUTER_RETRIES": "x"}):
        for name in ("TPUBC_ROUTER_SCRAPE_MS", "TPUBC_ROUTER_DIGEST_STALE_MS",
                     "TPUBC_ROUTER_BREAKER_MS", "TPUBC_ROUTER_HEDGE_MS",
                     "TPUBC_ROUTER_RETRIES"):
            monkeypatch.delenv(name, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in readers:
            assert getattr(trouter, fn)() == getattr(jrouter, fn)(), fn


# ---- live scenarios behind either router -------------------------------------


def test_placement_beats_round_robin_on_warm_cold_pair(pkg):
    warm = _FakeServe(digest=_digest_for(PROMPT), queued=5,
                      cached_tokens=len(PROMPT))
    cold = _FakeServe(digest=dict(_COLD), queued=0)
    router = _router(pkg, [cold, warm])
    try:
        _wait_scraped(router, 2)
        for _ in range(4):
            out = _post_json(router.port, {"tokens": PROMPT, "max_new": 3,
                                           "stream": False})
            assert out["done"] is True and out["tokens"] == [7, 8, 9]
            assert out["cached_tokens"] == len(PROMPT)
        assert len(warm.posts) == 4 and len(cold.posts) == 0
        rz = router.routerz_json()["replicas"]
        assert rz[warm.addr]["dispatches"] == 4
        assert rz[warm.addr]["digest_blocks"] == len(PROMPT) // BS
        assert rz[cold.addr]["dispatches"] == 0
    finally:
        _stop(router, warm, cold)


def test_stale_digests_degrade_to_least_queue(pkg):
    warm = _FakeServe(digest=_digest_for(PROMPT), queued=5)
    cold = _FakeServe(digest=dict(_COLD), queued=0)
    router = _router(pkg, [warm, cold], scrape_s=30.0, stale_s=0.1)
    try:
        _wait_scraped(router, 2)
        _wait(lambda: all(
            e["digest_age_ms"] > 100.0
            for e in router.routerz_json()["replicas"].values()),
            msg="digests never aged")
        out = _post_json(router.port, {"tokens": PROMPT, "max_new": 2,
                                       "stream": False})
        assert out["done"] is True
        assert len(cold.posts) == 1 and len(warm.posts) == 0
        assert router.reg.to_json().get("fleet_route_degraded_total", 0) >= 1
    finally:
        _stop(router, warm, cold)


def test_drain_aware_routing_routes_around_draining_replica(pkg):
    draining = _FakeServe(digest=_digest_for(PROMPT), draining=True)
    survivor = _FakeServe(digest=dict(_COLD))
    router = _router(pkg, [draining, survivor])
    try:
        _wait_scraped(router, 2)
        out = _post_json(router.port, {"tokens": PROMPT, "max_new": 2,
                                       "stream": False})
        assert out["done"] is True
        assert len(survivor.posts) == 1 and len(draining.posts) == 0
        assert router.routerz_json()[
            "replicas"][draining.addr]["draining"] is True
    finally:
        _stop(router, draining, survivor)


def test_misroute_is_a_soft_signal(pkg):
    liar = _FakeServe(digest=_digest_for(PROMPT), cached_tokens=0)
    router = _router(pkg, [liar])
    try:
        _wait_scraped(router, 1)
        lines = _stream(router.port, {"tokens": PROMPT, "max_new": 3})
        assert lines[-1].get("done") is True and not lines[-1].get("error")
        assert [t for ln in lines for t in ln["tokens"]] == [7, 8, 9]
        _wait(lambda: router.reg.to_json().get(
            "fleet_route_misroutes_total", 0) == 1,
            msg="misroute counter never fired")
    finally:
        _stop(router, liar)


def test_failover_exactly_once_under_dispatch_fault(pkg):
    a = _FakeServe(digest=_digest_for(PROMPT), cached_tokens=16)
    b = _FakeServe(digest=_digest_for(PROMPT), cached_tokens=16)
    router = _router(pkg, [a, b])
    pkg.faults.install("router.dispatch:1:0")
    try:
        _wait_scraped(router, 2)
        lines = _stream(router.port, {"tokens": PROMPT, "max_new": 3,
                                      "request_id": "idem-f1"})
        assert lines[-1].get("done") is True and not lines[-1].get("error")
        assert [t for ln in lines for t in ln["tokens"]] == [7, 8, 9]
        assert all(ln["request_id"] == "idem-f1" for ln in lines)
        posts = a.posts + b.posts
        assert len(posts) == 1 and posts[0]["request_id"] == "idem-f1"
        m = router.reg.to_json()
        assert m.get("fleet_route_failovers_total", 0) == 1
        assert sum(v for k, v in m.items() if k.startswith(
            "fleet_route_dispatch_errors_total")) == 1
    finally:
        _stop(router, a, b)


def test_pre_token_death_fails_over_to_survivor(pkg):
    dying = _FakeServe(digest=_digest_for(PROMPT), mode="die_before_token")
    survivor = _FakeServe(digest=dict(_COLD), gen=(11, 12))
    router = _router(pkg, [dying, survivor])
    try:
        _wait_scraped(router, 2)
        lines = _stream(router.port, {"tokens": PROMPT, "max_new": 2})
        final = lines[-1]
        assert final.get("done") is True and not final.get("error")
        assert not final.get("failover")
        assert [t for ln in lines for t in ln["tokens"]] == [11, 12]
        assert len(dying.posts) == 1 and len(survivor.posts) == 1
        assert (dying.posts[0]["request_id"]
                == survivor.posts[0]["request_id"] != "")
        rz = router.routerz_json()["replicas"]
        assert rz[dying.addr]["failures"] >= 1
        assert rz[dying.addr]["breaker"]["state"] == "open"
    finally:
        _stop(router, dying, survivor)


def test_midstream_death_surfaces_terminal_failover_chunk(pkg):
    dying = _FakeServe(digest=_digest_for(PROMPT), mode="die_mid_stream")
    bystander = _FakeServe(digest=dict(_COLD))
    router = _router(pkg, [dying, bystander])
    try:
        _wait_scraped(router, 2)
        lines = _stream(router.port, {"tokens": PROMPT, "max_new": 3,
                                      "request_id": "mid-1"})
        final = lines[-1]
        assert set(final) == {"tokens", "done", "request_id", "error",
                              "failover"}
        assert final["tokens"] == [] and final["failover"] is True
        assert final["error"].startswith(f"replica {dying.addr} died "
                                         "mid-stream: ")
        assert sum(1 for ln in lines if ln.get("done")) == 1
        assert [t for ln in lines for t in ln["tokens"]] == [7]
        assert len(bystander.posts) == 0
        assert router.reg.to_json().get(
            "fleet_route_midstream_failovers_total", 0) == 1
    finally:
        _stop(router, dying, bystander)


def test_hedge_commits_first_token_winner(pkg):
    slow = _FakeServe(digest=_digest_for(PROMPT), token_delay_s=2.0,
                      beat_age_ms=60000.0)
    fast = _FakeServe(digest=dict(_COLD), gen=(21, 22))
    router = _router(pkg, [slow, fast], hedge_s=0.15)
    try:
        _wait_scraped(router, 2)
        lines = _stream(router.port, {"tokens": PROMPT, "max_new": 2})
        assert [t for ln in lines for t in ln["tokens"]] == [21, 22]
        assert len(slow.posts) == 1 and len(fast.posts) == 1
        assert slow.posts[0]["request_id"] == fast.posts[0]["request_id"]
        assert router.reg.to_json().get("fleet_route_hedges_total", 0) == 1
    finally:
        _stop(router, slow, fast)


def test_scrape_failure_opens_breaker_and_routes_around(pkg):
    a = _FakeServe(digest=_digest_for(PROMPT), scrape_fail=True)
    b = _FakeServe(digest=dict(_COLD), gen=(31,))
    router = _router(pkg, [a, b], breaker_s=60.0)
    try:
        _wait(lambda: router.routerz_json()["replicas"][a.addr]
              ["breaker"]["state"] == "open", msg="breaker never opened")
        _wait_scraped(router, 1)
        out = _post_json(router.port, {"tokens": PROMPT, "max_new": 1,
                                       "stream": False})
        assert out["done"] is True and out["tokens"] == [31]
        assert len(a.posts) == 0 and len(b.posts) == 1
        code = urllib.request.urlopen(
            f"http://127.0.0.1:{router.port}/healthz",
            timeout=HTTP_TIMEOUT).status
        assert code == 200
    finally:
        _stop(router, a, b)


def test_router_scrape_fault_seam_recovers(pkg):
    a = _FakeServe(digest=_digest_for(PROMPT))
    pkg.faults.install("router.scrape:1:0")
    router = _router(pkg, [a], breaker_s=0.05)
    try:
        _wait(lambda: router.routerz_json()["replicas"][a.addr]
              ["failures"] >= 1, msg="fault never charged the breaker")
        _wait_scraped(router, 1)
        doc = router.routerz_json()["replicas"][a.addr]
        assert doc["breaker"]["state"] == "closed"
        assert doc["digest_blocks"] == len(PROMPT) // BS
    finally:
        _stop(router, a)


def test_all_breakers_open_answers_503_with_retry_after(pkg):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    router = pkg.router.FleetRouter(
        [dead], port=0, host="127.0.0.1", scrape_s=0.05, breaker_s=30.0,
        connect_timeout_s=0.5, retries=1).start()
    try:
        _wait(lambda: router.routerz_json()["replicas"][dead]
              ["breaker"]["state"] == "open", msg="breaker never opened")
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post_json(router.port, {"tokens": [1], "max_new": 1,
                                     "stream": False})
        assert exc.value.code == 503
        assert 1 <= int(exc.value.headers["Retry-After"]) <= 30
        body = json.loads(exc.value.read())
        assert set(body) == {"error", "request_id"}
        assert body["error"] == "no replica available: no replica available"
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/healthz",
                timeout=HTTP_TIMEOUT)
        assert exc.value.code == 503
        assert json.loads(exc.value.read())["routable"] == 0
    finally:
        router.stop()


def test_bad_requests_answer_400_as_the_reference(pkg):
    a = _FakeServe(digest=dict(_COLD))
    router = _router(pkg, [a])
    try:
        for body in ({"max_new": 1}, {"tokens": [1, "x"], "max_new": 1},
                     {"tokens": [1], "max_new": 1, "request_id": 5}):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post_json(router.port, body)
            assert exc.value.code == 400
            assert json.loads(exc.value.read())["error"].startswith(
                "bad request: ")
        assert a.posts == []
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{router.port}/nope",
                                   timeout=HTTP_TIMEOUT)
        assert exc.value.code == 404
    finally:
        _stop(router, a)


def test_local_fleet_driver_drains_before_kill(pkg):
    a = _FakeServe(digest=dict(_COLD))
    router = _router(pkg, [a])
    calls = []
    driver = pkg.router.LocalFleetDriver(
        f"{sys.executable} -c 'import time; time.sleep(60)'", router,
        drain_grace_s=5.0)
    real_mark = router.mark_draining

    def spy(r):
        real_mark(r)
        calls.append(("drain", r, router.routerz_json()["replicas"][r]
                      ["draining"]))

    router.mark_draining = spy
    try:
        driver.scale_to(2)
        assert len(router.routerz_json()["replicas"]) == 3
        driver.scale_to(1)
        assert calls and calls[0][0] == "drain" and calls[0][2] is True
        victim = calls[0][1]
        _wait(lambda: victim not in router.routerz_json()["replicas"],
              timeout=10, msg="victim never reaped")
    finally:
        driver.stop()
        _stop(router, a)


def test_routerz_and_metrics_shapes_equal_the_reference():
    """A fresh router of each package over the same fake replica, after one
    request: /routerz, /healthz and the metrics document, times masked."""
    a = _FakeServe(digest=_digest_for(PROMPT), cached_tokens=16)
    try:
        docs = {}
        for name in sorted(PACKAGES):
            router = _router(PACKAGES[name], [a], scrape_s=3600.0)
            try:
                _wait_scraped(router, 1)
                _post_json(router.port, {"tokens": PROMPT, "max_new": 3,
                                         "stream": False,
                                         "request_id": f"shape-{name}"})
                # The dispatch's in-flight count drops after the answer
                # reaches the client.
                _wait(lambda: all(
                    e["inflight"] == 0
                    for e in router.routerz_json()["replicas"].values()),
                    msg="the dispatch never finished")
                rz = router.routerz_json()
                for e in rz["replicas"].values():
                    e["digest_age_ms"] = e["beat_age_ms"] = None
                rz["as_of_us"] = None
                hz = get(router.port, "/healthz")[1]
                hz["as_of_us"] = None
                docs[name] = (rz, hz, router.reg.to_json(),
                              router.arrival_records()[0]["prompt_len"])
            finally:
                router.stop()
        assert docs["port"] == docs["ref"]
    finally:
        a.stop()


# ---- a router in front of port replicas whose engine dies -------------------

REPLICA = dict(port=0, paged=True, kv_quant=True, block_size=8,
               host="127.0.0.1", device="cpu")


def _fault_behind_router(arm, handed_over):
    """Port replica A (batch 1) streams request 1 through the port's router
    and holds request 2 (``_held_pair``) when ``arm(a)`` installs a fault;
    replica B joins the router just before. Returns both streams' lines,
    B's served count and the router's failovers; then checks that A, on
    the same engine thread, reads healthy to a scrape and takes request 3
    with B removed."""
    a = tingress.IngressServer(TPARAMS, TCFG, batch_size=1, **REPLICA).start()
    b = tingress.IngressServer(TPARAMS, TCFG, batch_size=2,
                               **REPLICA).start()
    router = trouter.FleetRouter(
        [f"127.0.0.1:{a.port}"], port=0, host="127.0.0.1", scrape_s=3600.0,
        stale_s=3600.0, breaker_s=0.2, hedge_s=0.0, timeout_s=HTTP_TIMEOUT,
        connect_timeout_s=2.0).start()
    try:
        engine = a._engine
        stepper, first, second, threads = _held_pair(a, handed_over,
                                                     port=router.port)
        router.add_replica(f"127.0.0.1:{b.port}")
        arm(a)
        stepper.release()
        _ended(threads, first, second)
        out = (first, second, get(b.port, "/healthz")[1]["served"],
               router.reg.to_json().get("fleet_route_failovers_total", 0))
        assert a._engine is engine and engine.is_alive()
        router.remove_replica(f"127.0.0.1:{b.port}")

        def healed():
            # A breaker that a refusal opened admits the scrape once its
            # window passes; the scrape closes it.
            router.scrape_once()
            st = router._replicas[f"127.0.0.1:{a.port}"]
            return st["breaker"].state == "closed" and st["healthz"]["ok"]

        _wait(healed, timeout=HTTP_TIMEOUT, msg="A never healthy again")
        served = get(a.port, "/healthz")[1]["served"]
        third = _post_json(router.port, {"tokens": [7, 8], "max_new": 6,
                                         "stream": False},
                           timeout=HTTP_TIMEOUT)
        assert not third.get("error") and third["tokens"] == solo([7, 8], 6)
        assert get(a.port, "/healthz")[1]["served"] == served + 1
        return out
    finally:
        router.stop()
        a.stop()
        b.stop()


def test_engine_exit_behind_router_gives_one_terminal_outcome_each():
    """Replica A's ``_profile_tick`` raises in the round that hands request
    2 over (that once ended A's engine thread, leaving both clients on
    queues nobody fed): the round goes on, so both requests complete on A
    through the router, one terminal each and equal to the oracle, with
    nothing re-placed."""
    first, second, b_served, failovers = _fault_behind_router(
        lambda a: setattr(a, "_profile_tick", _boom), False)
    assert not first[-1].get("error") and not second[-1].get("error")
    assert tokens_of(first) == solo([1, 2, 3], 56)
    assert tokens_of(second) == solo([4, 5, 6], 8)
    assert b_served == 0 and failovers == 0


def test_publish_failure_behind_router_fails_over_the_untouched_request():
    """Replica A's publish of a round's events raises: A fails the streams
    it holds. Request 1, past its first token, ends with A's error chunk
    (one terminal, its tokens a prefix of the oracle's); request 2, with
    no token yet, is re-placed by the port's router on replica B and
    completes exactly, one execution."""
    first, second, b_served, failovers = _fault_behind_router(
        lambda a: _boom_once(a._tps_window), True)
    assert first[-1]["error"] == "RuntimeError: injected publish failure"
    got = tokens_of(first)
    assert 0 < len(got) < 56 and got == solo([1, 2, 3], 56)[:len(got)]
    assert not second[-1].get("error")
    assert tokens_of(second) == solo([4, 5, 6], 8)
    assert b_served == 1 and failovers == 1


# ---- the kill-a-replica chaos scenario, on port replicas --------------------

_REPLICA_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from tpu_bootstrap_torch.workload import model
from tpu_bootstrap_torch.workload.ingress import IngressServer
cfg = model.ModelConfig(vocab_size=32, num_layers=1, num_heads=2,
                        head_dim=16, embed_dim=16, mlp_dim=32,
                        max_seq_len=64)
srv = IngressServer(model.init_params(cfg, seed=1, device="cpu"), cfg,
                    port=0, batch_size=2, paged=True, kv_blocks=24,
                    block_size=8, host="127.0.0.1", device="cpu")
srv.serve_forever()
"""


def _spawn_replica():
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPLICA_CHILD.format(root=str(ROOT))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.monotonic() + 240
    port = None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if "ingress: serving on :" in line:
            port = int(line.split(":")[-1].split()[0].rstrip(")"))
            break
    assert port, "replica child never came up"
    return proc, port


@pytest.mark.slow
def test_fleet_chaos_kill_replica_recovers_goodput():
    """tests/test_router.py's chaos scenario behind the port's router: 3
    port replicas in subprocesses, a SIGKILL takes the busiest out
    mid-burst; every in-flight request reaches exactly one terminal
    outcome with no dropped socket, and a wave after the kill completes at
    >= 90% goodput on the survivors."""
    procs, router = [], None
    try:
        pairs = [_spawn_replica() for _ in range(3)]
        procs = [p for p, _ in pairs]
        replicas = [f"127.0.0.1:{port}" for _, port in pairs]
        router = trouter.FleetRouter(replicas, port=0, host="127.0.0.1",
                                     scrape_s=0.1, stale_s=5.0,
                                     breaker_s=0.3, hedge_s=0.0, retries=3,
                                     timeout_s=120.0).start()
        _wait(lambda: sum(
            1 for e in router.routerz_json()["replicas"].values()
            if e["digest_age_ms"] is not None) == 3, timeout=60,
            msg="router never scraped all replicas")

        def burst(n, tag):
            outs = [None] * n
            threads = []
            for i in range(n):
                def run(i=i):
                    try:
                        outs[i] = _stream(
                            router.port, {"tokens": [1, 2, 3 + i % 5],
                                          "max_new": 24,
                                          "request_id": f"{tag}-{i}"},
                            timeout=240)
                    except Exception as e:  # noqa: BLE001
                        outs[i] = [{"client_error": repr(e)}]
                threads.append(threading.Thread(target=run))
            for t in threads:
                t.start()
            return threads, outs

        threads, outs = burst(6, "burst")
        _wait(lambda: any(o for o in outs) or not any(
            t.is_alive() for t in threads) or any(
            e["inflight"] for e in router.routerz_json()[
                "replicas"].values()), timeout=120,
            msg="burst never reached a replica")
        rz = router.routerz_json()["replicas"]
        victim = max(range(3), key=lambda i: rz[replicas[i]]["inflight"])
        procs[victim].send_signal(signal.SIGKILL)
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads)
        for i, lines in enumerate(outs):
            assert lines, f"request {i} got nothing"
            assert not any("client_error" in ln for ln in lines), lines
            assert sum(1 for ln in lines if ln.get("done")) == 1, lines
        threads, outs = burst(6, "recovery")
        for t in threads:
            t.join(timeout=240)
        ok = sum(1 for lines in outs if lines and lines[-1].get("done")
                 and not lines[-1].get("error"))
        assert ok / 6 >= 0.9, f"goodput only {ok}/6 after the kill"
    finally:
        if router is not None:
            router.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.stdout.close()


# ---- lock discipline -------------------------------------------------------


def _lock_view(package: str) -> tuple:
    """tools.lint's locks pass over a package's router.py and fleetz.py:
    its findings with the module path cut to the file's name, and each
    class's guarded attributes, locks and aliases (what the pass checks
    against)."""
    files = [SourceFile(ROOT / package / "workload" / f"{name}.py", ROOT)
             for name in ("router", "fleetz")]
    findings = sorted((f.rule, os.path.basename(f.path), f.line, f.message)
                      for f in locks.run(files))
    classes = {name: (dict(c.guarded), sorted(c.locks), dict(c.aliases))
               for name, c in locks._classes(files).items()}
    return findings, classes


def test_lock_discipline_equals_the_reference():
    port_findings, port_classes = _lock_view("tpu_bootstrap_torch")
    ref_findings, ref_classes = _lock_view("tpu_bootstrap")
    assert [f[:1] + f[3:] for f in port_findings] == [
        f[:1] + f[3:] for f in ref_findings]
    assert port_classes == ref_classes
    assert port_classes["FleetRouter"][0]["_replicas"] == "_lock"
    assert port_classes["FleetAggregator"][0]["_state"] == "_lock"
