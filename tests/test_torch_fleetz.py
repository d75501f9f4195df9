"""The port's fleet telemetry aggregator (``tpu_bootstrap_torch.workload.
fleetz``) against the reference's (``tpu_bootstrap.workload.fleetz``) on the
same inputs: burn rates and alert transitions of the SLO engine on the
canned samples of tests/test_fleetz.py, the ``--slo`` grammar, the
federation and stitching helpers byte for byte, and a ``FleetAggregator``
of each package over the same fake replicas (one going stale, one answering
500): the same ``/fleetz`` document once times are masked, the same
federated text and the same seeded backoff schedule. Then the port's
aggregator over two live port replicas (``IngressServer(device="cpu")``,
the paged engine with the prefix cache on), merging their ``/cachez``
digests. Every HTTP wait is bounded."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tests.test_fleetz import _FakeReplica, _payloads, _span
from tests.test_torch_ingress import HTTP_TIMEOUT, post
from tests.test_torch_scheduler import TCFG, TPARAMS
from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import fleetz as jfleetz
from tpu_bootstrap_torch import telemetry as ttelemetry
from tpu_bootstrap_torch.workload import fleetz as tfleetz
from tpu_bootstrap_torch.workload import ingress as tingress

torch.set_num_threads(2)

PACKAGES = {"ref": jfleetz, "port": tfleetz}


def _masked(obj, keys=("t_us", "as_of_us", "since_us", "scrape_ms")):
    """``obj`` with every value under one of ``keys`` (wall-clock stamps,
    measured scrape times) replaced by a marker, nested anywhere."""
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in keys else _masked(v, keys))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_masked(v, keys) for v in obj]
    return obj


# ---- SLO burn rates --------------------------------------------------------


def _lat(mod):
    return mod.SloObjective("lat", "p99", "gt", 100.0, target=0.9)


def _case_multi_window(mod):
    """tests/test_fleetz.py's multi-window math: 5 of 10 samples bad at a
    10% budget (burn 5 in both windows, firing), then fresh good samples
    400 s later (the short window recovers, the alert resolves)."""
    eng = mod.SloEngine(objectives=[_lat(mod)], windows=(300, 3600),
                        burn_threshold=1.0, ring=64)
    now = 10_000.0
    for i in range(10):
        eng.record("r1", {"p99": 200.0 if i < 5 else 50.0}, t=now - 10 - i)
    first = eng.evaluate(now=now)
    later = now + 400.0
    for i in range(10):
        eng.record("r1", {"p99": 10.0}, t=later - 5 - i)
    return [first, eng.alerts(), eng.evaluate(now=later), eng.alerts()]


def _case_spike(mod):
    """An old incident beyond the short window may not page."""
    eng = mod.SloEngine(objectives=[_lat(mod)], windows=(300, 3600), ring=64)
    now = 10_000.0
    for i in range(10):
        eng.record("r2", {"p99": 500.0}, t=now - 2000 - i)
    for i in range(10):
        eng.record("r2", {"p99": 10.0}, t=now - 5 - i)
    return [eng.evaluate(now=now), eng.alerts()]


def _case_missing(mod):
    """Missing, boolean and non-numeric keys give no sample."""
    eng = mod.SloEngine(objectives=[_lat(mod)], windows=(300,), ring=8)
    eng.record("r3", {"other": 1.0, "p99": True, "p99_note": "n/a"}, t=1.0)
    return [eng.evaluate(now=2.0), eng.alerts()]


def _case_defaults(mod):
    """The default objectives over two replicas and a ring of 4 (older
    samples fall off), with a threshold of 2."""
    eng = mod.SloEngine(windows=(60, 600), burn_threshold=2.0, ring=4)
    for i in range(12):
        for r, ttft in (("a:1", 3000.0 if i % 3 else 10.0), ("b:2", 5.0)):
            eng.record(r, {"serve_ttft_ms_p99": ttft,
                           "serve_queue_depth": i * 7,
                           "serve_admitted_ratio": 0.4 + i / 20},
                       t=100.0 + 30 * i)
        if i % 4 == 3:
            eng.evaluate(now=100.0 + 30 * i)
    return [eng.evaluate(now=500.0), eng.alerts()]


@pytest.mark.parametrize("case", [_case_multi_window, _case_spike,
                                  _case_missing, _case_defaults],
                         ids=lambda f: f.__name__[6:])
def test_slo_engine_burn_rates_equal_the_reference(case):
    want = _masked(case(jfleetz))
    got = _masked(case(tfleetz))
    assert got == want
    assert json.dumps(got) == json.dumps(want)


def test_canned_burn_rates_hold_the_reference_tests_values():
    """The canned series' numbers themselves, on the port."""
    first, alerts, recovered, resolved = _case_multi_window(tfleetz)
    d = first["r1"]["lat"]
    assert d["windows"] == {"300s": pytest.approx(5.0),
                            "3600s": pytest.approx(5.0)}
    assert d["burn"] == pytest.approx(5.0) and d["firing"]
    assert alerts["transitions"][-1]["event"] == "firing"
    d = recovered["r1"]["lat"]
    assert d["windows"]["300s"] == 0.0 and d["windows"]["3600s"] > 1.0
    assert d["burn"] == 0.0 and not d["firing"]
    assert resolved["firing"] == []
    assert resolved["transitions"][-1]["event"] == "resolved"
    spike = _case_spike(tfleetz)[0]["r2"]["lat"]
    assert spike["windows"]["300s"] == 0.0 and not spike["firing"]
    assert _case_missing(tfleetz)[0] == {}


# ---- the --slo grammar -----------------------------------------------------


@pytest.mark.parametrize("spec", [
    "lat:serve_ttft_ms_p99:gt:2500:0.999", "g:x:lt:0.5", "q:y:gt:1e3",
    "lat:x:ge:1", "lat:x:gt", "lat:x:gt:1:1.5", "lat:x:gt:1:0",
    "a:b:c:d:e:f", "lat:x:lt:nope", "lat:x:gt:1:nope", ""])
def test_parse_objective_accepts_and_rejects_as_the_reference(spec):
    def parsed(mod):
        try:
            obj = mod.parse_objective(spec)
        except ValueError as e:
            return ("raises", str(e))
        return ("ok", (obj.name, obj.key, obj.comparator, obj.threshold,
                       obj.target))

    assert parsed(tfleetz) == parsed(jfleetz)


def test_default_objectives_equal_the_reference():
    assert ([(o.name, o.key, o.comparator, o.threshold, o.target)
             for o in tfleetz.DEFAULT_OBJECTIVES]
            == [(o.name, o.key, o.comparator, o.threshold, o.target)
                for o in jfleetz.DEFAULT_OBJECTIVES])
    assert tfleetz.BACKOFF_CAP_S == jfleetz.BACKOFF_CAP_S
    assert tfleetz.SCRAPE_PATHS == jfleetz.SCRAPE_PATHS


@pytest.mark.parametrize("ms,want", [(None, 2.0), ("500", 0.5), ("1", 0.05),
                                     ("junk", 2.0)])
def test_poll_interval_reads_the_knob_as_the_reference(monkeypatch, ms, want):
    if ms is None:
        monkeypatch.delenv("TPUBC_FLEET_POLL_MS", raising=False)
    else:
        monkeypatch.setenv("TPUBC_FLEET_POLL_MS", ms)
    assert tfleetz.poll_interval_s() == jfleetz.poll_interval_s() == want


# ---- federation and stitching, byte for byte --------------------------------

REPLICA_METRICS = {
    "a:1": {"serve_queue_depth": 3, "serve_qps": 2.5,
            "serve_ttft_ms_p99": 120.25, "serve_requests_total": 7,
            'serve_ttft_ms{priority="1"}_p99': 310.0,
            'serve_device_ms_total{priority="0"}': 12.5,
            "serve_engine_ok": True, "serve_note": "text",
            "fleet_tiny": 1e-7, "fleet_huge": 3.5e12},
    "b:2": {"serve_queue_depth": 5, "serve_qps": 0.0,
            "serve_requests_total": 0,
            'serve_ttft_ms{priority="0"}_p50': 8.0},
    "c:3": None,
}

WINDOW_DOC = {
    "window_secs": 30.0, "ring": 256,
    "series": {
        "serve_requests_total": {"now": 9, "delta": 4, "rate_per_sec": 0.133,
                                 "samples": 4},
        'serve_device_ms_total{priority="0"}': {"now": 12.5, "delta": 2.25},
        "serve_queue_depth": {"now": 3},
        "serve_ttft_ms": {"count": 9, "count_delta": 3, "sum_delta": 45.5,
                          "p50": 12.0, "p99": 30.0, "rate_per_sec": 0.1},
        'serve_ttft_ms{priority="1"}': {"count": 2, "count_delta": 0,
                                        "sum_delta": 0.0},
        "bad_entry": 7, "odd": {"now": "n/a", "delta": None}}}

TRACE_DOCS = {
    "a:1": {"process": "r-a", "dropped": 0, "spans": [
        _span("t-shared", "s1", "ingress", 100, 50),
        _span("t-solo", "s2", "decode", 10, 5),
        {"trace_id": None, "span_id": "s9", "name": "orphan",
         "start_us": None, "dur_us": None}]},
    "b:2": {"process": "r-b", "dropped": 2, "spans": [
        _span("t-shared", "s3", "prefill", 60, 30),
        {**_span("t-shared", "s4", "router.dispatch", 50, 90),
         "attrs": {"hop": 1}}]},
    "c:3": {"process": "r-c", "spans": []},
}


def _same_bytes(fn_name: str, *args, **kw):
    want = getattr(jfleetz, fn_name)(*args, **kw)
    got = getattr(tfleetz, fn_name)(*args, **kw)
    if isinstance(want, str):
        assert got == want
    else:
        assert json.dumps(got) == json.dumps(want)
    return got


@pytest.mark.parametrize("key", sorted(REPLICA_METRICS["a:1"])
                         + ['x{a="1",b="2"}_count', "plain{}", 'weird}{'])
def test_relabel_equals_the_reference(key):
    def relabeled(mod):
        try:
            return mod._relabel(key, "r:1")
        except ValueError as e:  # a brace pair out of order: both refuse
            return ("raises", str(e))

    assert relabeled(tfleetz) == relabeled(jfleetz)


def test_federate_and_flatten_window_byte_equal():
    text = _same_bytes("federate", REPLICA_METRICS, own="# own\nx 1\n")
    assert 'serve_ttft_ms_p99{priority="1",replica="a:1"} 310' in text
    assert text.count("# TYPE serve_requests counter") == 1
    assert _same_bytes("federate", {}) == ""
    flat = _same_bytes("flatten_window", WINDOW_DOC)
    assert flat["serve_requests_total_window_delta"] == 4
    assert _same_bytes("flatten_window", {}) == {}
    # A live registry's window document, the port's exposition.
    reg = ttelemetry.MetricsRegistry(ring=16)
    for v in (3.0, 5.0, 800.0):
        reg.observe("lat_ms", v, labels={"priority": "0"})
        reg.inc("reqs_total")
    reg.set_gauge("depth", 4)
    doc = reg.window_json(60)
    flat = _same_bytes("flatten_window", doc)
    _same_bytes("federate", {"a:1": flat, "b:2": reg.to_json()},
                own=reg.to_prometheus())


def test_stitch_and_stitch_chrome_byte_equal():
    doc = _same_bytes("stitch", TRACE_DOCS)
    assert doc["traces"]["t-shared"]["replicas"] == ["b:2", "a:1"]
    assert doc["dropped"] == 2
    chrome = _same_bytes("stitch_chrome", TRACE_DOCS)
    shared = [e for e in chrome["traceEvents"]
              if e["ph"] == "X" and e["args"]["trace_id"] == "t-shared"]
    assert {e["tid"] for e in shared} == {
        ttelemetry._chrome_tid("t-shared")} == {
        jtelemetry._chrome_tid("t-shared")}
    _same_bytes("stitch", {})
    _same_bytes("stitch_chrome", {})


# ---- the aggregator over fake replicas --------------------------------------


@pytest.fixture
def fakes():
    a = _FakeReplica(_payloads(
        "a", 3, 4, [_span("t-shared", "sa", "ingress", 100, 50)]))
    b = _FakeReplica(_payloads(
        "b", 5, 2, [_span("t-shared", "sb", "prefill", 40, 30)]))
    yield a, b
    a.stop()
    b.stop()


def _stale_and_failing(mod, a, b) -> list:
    """tests/test_fleetz.py's merge-then-stale walk on one package's
    aggregator: both healthy, then b answering 500 and rendered past the
    staleness horizon. Returns every rendered view."""
    agg = mod.FleetAggregator([a.addr, b.addr], poll_s=0.5,
                              stale_after_s=2.0)
    try:
        t0 = 1000.0
        b.fail = False
        views = [sorted(agg.poll_once(now=t0)), agg.fleetz_json(now=t0),
                 agg.federated_metrics(), mod.stitch(agg._trace_docs()),
                 agg.fleetz_json(now=t0, replica=a.addr)]
        b.fail = True
        views += [sorted(agg.poll_once(now=t0 + 1.0)),
                  agg.fleetz_json(now=t0 + 2.5), agg.federated_metrics(),
                  agg.reg.to_json(), agg.slo.alerts()]
        return views
    finally:
        agg.httpd.server_close()


def test_aggregator_views_equal_the_reference(fakes):
    a, b = fakes
    want = _masked(_stale_and_failing(jfleetz, a, b))
    got = _masked(_stale_and_failing(tfleetz, a, b))
    assert got == want
    doc = got[6]
    assert doc["replicas"][a.addr]["state"] == "healthy"
    assert doc["replicas"][b.addr]["state"] == "stale"
    assert doc["fleet"]["healthy"] == 1
    assert doc["replicas"][b.addr]["queue_depth"] == 5
    assert f'serve_queue_depth{{replica="{a.addr}"}} 3' in got[2]


def _backoff_walk(mod, f) -> list:
    """tests/test_fleetz.py's 500ing replica: four failed scrapes, each
    backoff waited out, then a recovery; every delay and next attempt."""
    agg = mod.FleetAggregator([f.addr], poll_s=0.1, stale_after_s=1e9)
    try:
        t, seen = 100.0, []
        f.fail = True
        for _ in range(4):
            due = agg.poll_once(now=t)
            with agg._lock:
                st = dict(agg._state[f.addr])
            skipped = agg.poll_once(now=t + st["backoff_s"] * 0.4)
            seen.append((due, skipped, st["failures"], st["state"],
                         st["backoff_s"], st["next_attempt"]))
            t = st["next_attempt"] + 1e-3
        f.fail = False
        agg.poll_once(now=t)
        with agg._lock:
            st = dict(agg._state[f.addr])
        seen.append((st["failures"], st["state"], st["next_attempt"]))
        return seen
    finally:
        agg.httpd.server_close()


def test_backoff_schedule_equals_the_reference():
    f = _FakeReplica(_payloads("f", 0, 0, []))
    try:
        want = _backoff_walk(jfleetz, f)
        got = _backoff_walk(tfleetz, f)
    finally:
        f.stop()
    assert got == want
    delays = [row[4] for row in got[:4]]
    assert all(0.8 * 0.1 * 2 ** i - 1e-3 <= d <= 1.2 * 0.1 * 2 ** i + 1e-3
               for i, d in enumerate(delays))
    assert got[-1][:2] == (0, "healthy")


def test_fleetz_http_routes_answer_as_the_reference(fakes):
    """The aggregators' own routes over HTTP (no poll loop: one scrape at a
    fixed time): /fleetz (and ?replica=, 404 on an unknown one), /metrics,
    /metrics.json, /traces.json and ?chrome=1, /healthz, an unknown path."""
    a, b = fakes
    answers = {}
    for name, mod in PACKAGES.items():
        agg = mod.FleetAggregator([a.addr, b.addr], poll_s=0.5,
                                  stale_after_s=1e9)
        t = threading.Thread(target=agg.httpd.serve_forever, daemon=True)
        t.start()
        try:
            agg.poll_once(now=10.0)
            got = {}
            for path in ("/fleetz?replica=" + a.addr, "/fleetz?replica=x:1",
                         "/traces.json", "/traces.json?chrome=1", "/healthz",
                         "/nope", "/metrics.json?window=abc"):
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{agg.port}{path}",
                            timeout=HTTP_TIMEOUT) as r:
                        got[path] = (r.status, json.loads(r.read()))
                except urllib.error.HTTPError as e:
                    got[path] = (e.code, json.loads(e.read()))
            answers[name] = got
        finally:
            agg.stop()
            t.join(timeout=HTTP_TIMEOUT)
        assert not t.is_alive()
    # /fleetz renders against the live clock: the ages and stamps differ.
    keys = ("t_us", "as_of_us", "since_us", "scrape_ms", "last_ok_age_ms",
            "retry_in_s")
    assert _masked(answers["port"], keys) == _masked(answers["ref"], keys)
    assert answers["port"]["/fleetz?replica=x:1"][0] == 404
    assert answers["port"]["/nope"][0] == 404
    assert answers["port"]["/metrics.json?window=abc"][0] == 400


# ---- live port replicas -----------------------------------------------------

REPLICA = dict(port=0, batch_size=2, paged=True, kv_quant=True,
               block_size=8, host="127.0.0.1", device="cpu")


def test_aggregator_merges_live_port_replicas_digests():
    """Two port replicas, each warm on its own prompt: the port's
    aggregator sees both healthy, each replica's /cachez digest as its
    cache_digest, the fleet's digest blocks their sum, replica labels on
    the federated text and each replica's spans in the stitched traces."""
    reps = [tingress.IngressServer(TPARAMS, TCFG, **REPLICA).start()
            for _ in range(2)]
    agg = None
    try:
        for i, srv in enumerate(reps):
            tokens = [1 + i + t for t in range(17)]  # two full blocks of 8
            code, _, out = post(srv.port, {"tokens": tokens, "max_new": 3,
                                           "stream": False,
                                           "trace_id": f"live-{i}"})
            assert code == 200 and out["done"] is True
        addrs = [f"127.0.0.1:{s.port}" for s in reps]
        agg = tfleetz.FleetAggregator(addrs, poll_s=3600.0,
                                      timeout_s=HTTP_TIMEOUT)
        assert sorted(agg.poll_once()) == sorted(addrs)
        doc = agg.fleetz_json()
        assert doc["fleet"]["replicas"] == 2 and doc["fleet"]["healthy"] == 2
        total = 0
        for addr, srv in zip(addrs, reps):
            with urllib.request.urlopen(f"http://{addr}/cachez",
                                        timeout=HTTP_TIMEOUT) as r:
                digest = json.loads(r.read())["digest"]
            entry = doc["replicas"][addr]
            assert entry["state"] == "healthy"
            assert entry["cache_digest"] == digest
            assert entry["digest_blocks"] == digest["blocks"] >= 2
            assert entry["blocks"]["total"] == srv.pool.allocator.num_blocks
            total += digest["blocks"]
        assert doc["fleet"]["digest_blocks"] == total
        assert set(doc["slo"]["burn"]) == set(addrs)
        text = agg.federated_metrics()
        for addr in addrs:
            assert f'serve_requests_total{{replica="{addr}"}}' in text
        stitched = tfleetz.stitch(agg._trace_docs())
        assert set(stitched["replicas"]) == set(addrs)
        for i in range(2):
            assert stitched["traces"][f"live-{i}"]["spans"] >= 1
    finally:
        if agg is not None:
            agg.httpd.server_close()
        for srv in reps:
            srv.stop()
