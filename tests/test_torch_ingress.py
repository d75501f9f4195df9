"""The HTTP front door (tpu_bootstrap_torch/workload/ingress.py:
IngressServer) held to the JAX reference's: live HTTP against both
packages' servers on the f32 bridged int8 weights of
tests/test_torch_scheduler.py, every server on 127.0.0.1:0 and stopped by
its fixture, every call with a timeout.

* The differential (``test_paged_ingress_differential_against_reference``):
  the reference's and the port's paged servers answer the same requests,
  one at a time, on pinned clocks (one virtual monotonic clock in both
  telemetry modules, the rings' clock included, and a tick a
  ``perf_counter`` read in both serving modules, as in
  tests/test_torch_requestz.py). Compared exactly: each answer's status,
  headers that matter and body (streams line by line, final objects with
  their timing blocks), then /healthz, /poolz, /cachez, /requestz (whole,
  ``?rid=``, ``?format=jsonl``), /metrics.json and its ``?window=`` view
  and the /metrics text, less the ``quant_*`` counters (the reference
  counts its matmuls when it traces them, the port when it calls them),
  and /traces.json's span names; every route's flat key set against the
  reference server's live answer and
  ``tools.lint.endpoint_catalog.CATALOG[("ingress", path)].keys``.
* The 429 and 503 answers of both servers (the engine never started).
* The engine knobs the paged engine reads when given None
  (``TPUBC_KV_BLOCK``, ``TPUBC_PREFILL_BUDGET``, ``TPUBC_PREFIX_CACHE``,
  ``TPUBC_SPEC_LOOKUP``), in both packages, and every engine option
  building the reference's engine.

The mirrors of the reference's tests/test_ingress.py are in
tests/test_torch_ingress_slot.py, the rest in
tests/test_torch_ingress_paged.py,
tests/test_torch_ingress_faults.py, tests/test_torch_fleet.py,
tests/test_torch_workload_metrics.py and
tests/test_torch_lock_regressions.py, which import the helpers here."""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from tests.test_torch_requestz import T0, _Ticks
from tests.test_torch_scheduler import (
    JCFG,
    JPARAMS,
    TCFG,
    TPARAMS,
    pinned_cost,  # noqa: F401 - a fixture
)
from tools.lint.endpoint_catalog import CATALOG
from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import ingress as jingress
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import ingress as tingress
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

HTTP_TIMEOUT = 60  # seconds, every HTTP call


def post(port, body, headers=None, path="/v1/generate",
         timeout=HTTP_TIMEOUT):
    """POST ``body``; (status, headers, answer): a stream as its list of
    JSON lines, anything else as one JSON object."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else b"",
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if r.headers.get("Content-Type") == "application/jsonl":
                return r.status, r.headers, [json.loads(ln) for ln in r
                                             if ln.strip()]
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def get(port, path, timeout=HTTP_TIMEOUT, raw=False):
    """(status, body): JSON, or bytes with ``raw``."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            body = r.read()
            return r.status, (body if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (body if raw else json.loads(body))


def tokens_of(answer) -> list:
    """Every token of an answer, streamed or not."""
    if isinstance(answer, list):
        return [t for ln in answer for t in ln.get("tokens", [])]
    return answer["tokens"]


def wait_until(pred, timeout=30.0, what="condition"):
    """Poll ``pred`` against a deadline (no fixed sleeps)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"{what} never held")


def solo(tokens, max_new, kv_quant=True):
    """The port's solo greedy generate on the einsum path."""
    return tdecode.generate(TPARAMS, [tokens], TCFG, max_new,
                            kv_quant=kv_quant, kv_kernel=False,
                            device="cpu")[0].tolist()


def flat_keys(obj, skip=()) -> set:
    """Every dict key in ``obj``, nested dicts and list elements included,
    not descending below a key in ``skip`` (containers whose keys are
    data: stats, ledgers, events)."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(k)
            if k not in skip:
                out |= flat_keys(v, skip)
    elif isinstance(obj, list):
        for v in obj:
            out |= flat_keys(v, skip)
    return out


# Containers of each route whose keys are data rather than contract (the
# catalog lists none of their keys), and /poolz's copy of the digest, whose
# keys the catalog lists under /cachez.
DATA_KEYS = {"/poolz": ("stats", "ledger", "cache_digest"),
             "/requestz": ("events", "phases", "device_ms_by_kind"),
             "/v1/generate": ("timing",),
             "/profilez": ("ledger",),
             "/traces.json": ("attrs",)}


def catalog_keys(path: str) -> set:
    return set(CATALOG[("ingress", path)].keys)


def check_keys(path: str, port_answer, ref_answer) -> None:
    """The port's flat key set equals the reference's live answer's (span
    attributes aside: the port's decode-chunk spans carry their own), and
    lies within the catalog's universe for ``path``."""
    assert (flat_keys(port_answer, ("attrs",))
            == flat_keys(ref_answer, ("attrs",))), path
    got = flat_keys(port_answer, DATA_KEYS.get(path, ()))
    assert got <= catalog_keys(path), (path, got - catalog_keys(path))


def drop_quant(metrics: dict) -> dict:
    """A metrics document less the quantized-matmul counters."""
    if "series" in metrics:
        return {**metrics, "series": drop_quant(metrics["series"])}
    return {k: v for k, v in metrics.items() if not k.startswith("quant_")}


@pytest.fixture
def pinned(monkeypatch, pinned_cost):  # noqa: F811 - the imported fixture
    """Both packages on one virtual monotonic clock (event stamps, the
    ingress's latencies, the metrics rings) and a tick a perf_counter
    read in each serving module; the same root trace id; fresh
    registries. Yields the clock, {"t": seconds}."""
    clock = {"t": T0}

    def now():
        return clock["t"]

    def pinned_time():
        return types.SimpleNamespace(
            monotonic=now, perf_counter=time.perf_counter,
            monotonic_ns=time.monotonic_ns, time=time.time,
            sleep=time.sleep)

    for tel in (jtelemetry, telemetry):
        tel.set_clock(now)
        monkeypatch.setattr(tel, "time", pinned_time())
        monkeypatch.setattr(tel, "_root_id", "feedfacecafe0001")
        tel.metrics().reset()
        tel.tracer().reset()
    monkeypatch.setattr(jserving, "time", _Ticks())
    monkeypatch.setattr(tserving, "time", _Ticks())
    try:
        yield clock
    finally:
        jtelemetry.set_clock(None)
        telemetry.set_clock(None)


PAGED = dict(batch_size=4, paged=True, kv_quant=True, block_size=8,
             host="127.0.0.1")

# (body, headers): streamed and not, priorities, trace ids in the body and
# the header, an idempotency key replayed streamed and not, a deadline that
# holds, a prefix-cache hit, and the front door's refusals.
LONG = list(range(1, 18))
DIFF_REQUESTS = [
    ({"tokens": LONG, "max_new": 6}, None),
    ({"tokens": LONG[:12], "max_new": 5, "stream": False, "priority": 1},
     None),
    ({"tokens": [5, 6], "max_new": 7, "request_id": "idem-1",
      "trace_id": "abcdef0123456789"}, None),
    ({"tokens": [5, 6], "max_new": 7, "request_id": "idem-1"}, None),
    ({"tokens": [5, 6], "max_new": 7, "request_id": "idem-1",
      "stream": False}, None),
    ({"tokens": [9, 10, 11], "max_new": 4, "stream": False,
      "deadline_ms": 60000}, {"X-Tpubc-Trace": "0011223344556677"}),
    ({"tokens": LONG, "max_new": 3, "stream": False}, None),
    ({"tokens": [1, 2, 3], "max_new": 1000}, None),
    ({"tokens": "nope", "max_new": 4}, None),
    ({"max_new": 4}, None),
    ({"tokens": [1], "max_new": 0}, None),
    ({"tokens": [1], "max_new": 1, "request_id": ["x"]}, None),
    ({"tokens": [1], "max_new": 1, "priority": "high"}, None),
    ({"tokens": [1], "max_new": 1, "deadline_ms": -5}, None),
]


def _request_spans(traces: dict) -> list:
    return sorted((s["name"], s["trace_id"]) for s in traces["spans"]
                  if s["name"] == "serve.request"
                  or s["name"].startswith("serve.phase."))


def test_paged_ingress_differential_against_reference(pinned):
    ref = jingress.IngressServer(JPARAMS, JCFG, port=0, **PAGED).start()
    port = tingress.IngressServer(TPARAMS, TCFG, port=0, device="cpu",
                                  **PAGED).start()
    served = []
    try:
        for body, headers in DIFF_REQUESTS:
            want = post(ref.port, body, headers)
            got = post(port.port, body, headers)
            assert got[0] == want[0], body
            assert got[2] == want[2], body
            assert (got[1].get("Retry-After")
                    == want[1].get("Retry-After")), body
            check_keys("/v1/generate", got[2], want[2])
            if got[0] == 200:
                served.append((body, tokens_of(got[2])))
            pinned["t"] += 0.25
        for path in ("/healthz", "/poolz", "/cachez", "/requestz",
                     "/requestz?rid=2", "/traces.json"):
            code, got = get(port.port, path)
            want_code, want = get(ref.port, path)
            assert code == want_code == 200, path
            if path == "/traces.json":
                # Span ids are random, and the port also times its decode
                # chunks: compare the request span trees' names.
                assert _request_spans(got) == _request_spans(want)
                assert len(_request_spans(got)) == 5  # one a request run
            else:
                assert got == want, path
            check_keys(path.split("?")[0], got, want)
        assert get(port.port, "/requestz?format=jsonl", raw=True) == get(
            ref.port, "/requestz?format=jsonl", raw=True)
        for path in ("/metrics.json", "/metrics.json?window=60"):
            assert drop_quant(get(port.port, path)[1]) == drop_quant(
                get(ref.port, path)[1]), path
        text = [get(srv.port, "/metrics", raw=True)[1].decode().splitlines()
                for srv in (port, ref)]
        assert [ln for ln in text[0] if "quant_" not in ln] == [
            ln for ln in text[1] if "quant_" not in ln]
        assert get(port.port, "/nope")[0] == get(ref.port, "/nope")[0] == 404
        assert (get(port.port, "/requestz?rid=zzz")
                == get(ref.port, "/requestz?rid=zzz"))
        for body, got in served:
            assert got == solo(body["tokens"], body["max_new"]), body
    finally:
        ref.stop()
        port.stop()


def test_throttle_429_and_drain_503_against_reference(pinned):
    """The engine not started, so the queue can only fill: the ack line,
    429 with the same Retry-After and body; then, draining, 503."""
    servers = [cls(params, cfg, port=0, batch_size=1, max_queue=1,
                   host="127.0.0.1", **kw)
               for cls, params, cfg, kw in (
                   (jingress.IngressServer, JPARAMS, JCFG, {}),
                   (tingress.IngressServer, TPARAMS, TCFG,
                    {"device": "cpu"}))]
    answers = []
    try:
        for srv in servers:
            threading.Thread(target=srv.httpd.serve_forever,
                             daemon=True).start()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/generate",
                data=json.dumps({"tokens": [1, 2], "max_new": 2}).encode())
            first = urllib.request.urlopen(req, timeout=HTTP_TIMEOUT)
            ack = json.loads(first.readline())
            code, headers, body = post(srv.port, {"tokens": [1, 2],
                                                  "max_new": 2})
            # The drain flag alone (no engine runs to finish it).
            with srv._lock:
                srv._draining = True
            drain = post(srv.port, {"tokens": [3], "max_new": 1})
            answers.append((ack, code, headers["Retry-After"], body,
                            drain[0], drain[2]))
            first.close()
    finally:
        for srv in servers:
            srv.httpd.shutdown()
            srv.httpd.server_close()
    assert answers[1] == answers[0]
    ack, code, retry, body, dcode, dbody = answers[1]
    assert ack == {"tokens": [], "queued": True, "queue_position": 0}
    assert code == 429 and retry == "1" and "no capacity" in body["error"]
    assert dcode == 503 and dbody["draining"] is True


# ---- the engine options and the engine knobs ------------------------------


@pytest.mark.parametrize("kw, item", [
    ({"resident": True}, "item 8"),
    ({"temperature": 1.5}, "item 5"),
    ({"top_k": 4}, "item 5"),
    ({"top_p": 0.9}, "item 5"),
    ({"paged": True, "kv_quant": True, "draft_params": TPARAMS,
      "draft_cfg": TCFG}, "item 5"),
    ({"paged": True, "kv_quant": True, "spec_lookup": True}, "item 5"),
    ({"paged": True}, "item 8"),
])
def test_unported_options_raise_naming_their_item(kw, item):
    """Every option is ported now. The sampling and speculative options
    (item 5) and the other engines (item 8: the resident engine, and the
    paged engine's float pool) build the server the reference's builds, or
    raise the reference's ValueError: a temperature without a key; filters
    alone build a greedy pool, as there. The item 8 engines also serve a
    request what the reference's engine serves."""
    jkw = {k: (JPARAMS if k == "draft_params" else
               JCFG if k == "draft_cfg" else v) for k, v in kw.items()}
    servers, started = [], []
    try:
        for build in (
                lambda: jingress.IngressServer(JPARAMS, JCFG, port=0,
                                               host="127.0.0.1", **jkw),
                lambda: tingress.IngressServer(TPARAMS, TCFG, port=0,
                                               host="127.0.0.1",
                                               device="cpu", **kw)):
            try:
                servers.append(build())
            except ValueError as exc:
                servers.append(str(exc))
        ref, port = servers
        if isinstance(ref, str):
            assert port == ref
            return
        assert type(port.pool).__name__ == type(ref.pool).__name__
        for attr in ("temperature", "top_k", "top_p", "gamma", "_spec",
                     "spec_lookup"):
            assert (getattr(port.pool, attr, None)
                    == getattr(ref.pool, attr, None)), attr
        assert (port.pool.stats.keys() == ref.pool.stats.keys())
        if item == "item 8":
            assert port.pool.kv_quant is ref.pool.kv_quant is False
            started.append(port.start())
            code, _h, got = post(port.port, {"tokens": [3, 1, 4, 1, 5],
                                             "max_new": 6, "stream": False})
            want = jserving.serve(
                JPARAMS, JCFG, [jserving.Request(rid=0, tokens=[3, 1, 4, 1, 5],
                                                 max_new=6)], 2, **jkw)
            assert code == 200 and got["tokens"] == want[0]
    finally:
        for srv in servers:
            if srv in started:
                srv.stop()
            elif not isinstance(srv, str):
                srv.httpd.server_close()


def test_paged_and_resident_together_refused_as_in_reference():
    for cls, params, cfg, kw in (
            (jingress.IngressServer, JPARAMS, JCFG, {}),
            (tingress.IngressServer, TPARAMS, TCFG, {"device": "cpu"})):
        with pytest.raises(ValueError, match="distinct engines"):
            cls(params, cfg, port=0, paged=True, resident=True,
                host="127.0.0.1", **kw)


# (knob, value, the pool attribute, its value): each differs from the
# default, so a pool that ignores the knob fails.
KNOBS = [("TPUBC_KV_BLOCK", "16", "block_size", 16),
         ("TPUBC_PREFILL_BUDGET", "8", "prefill_budget", 8),
         ("TPUBC_PREFIX_CACHE", "0", "prefix_cache", False)]


@pytest.mark.parametrize("knob, value, attr, want", KNOBS)
def test_paged_pool_reads_the_reference_knobs(monkeypatch, knob, value,
                                              attr, want):
    """Given None, both packages' PagedPool read the knob: under
    TPUBC_KV_BLOCK=16 both pools have 16-token blocks (the port ignored
    the four knobs before)."""
    monkeypatch.setenv(knob, value)
    pools = (jserving.PagedPool(JPARAMS, JCFG, 2, kv_quant=True),
             tserving.PagedPool(TPARAMS, TCFG, 2, kv_quant=True,
                                device="cpu"))
    assert [getattr(p, attr) for p in pools] == [want, want]
    stats = {}
    reqs = [tserving.Request(rid=0, tokens=LONG, max_new=4)]
    tserving.serve(TPARAMS, TCFG, reqs, 2, paged=True, kv_quant=True,
                   device="cpu", stats=stats)
    if attr == "block_size":
        # serve() leaves block_size None too: 17 + 4 tokens, 2 blocks.
        assert stats["blocks_peak"] == 2


def test_spec_lookup_knob_reaches_the_paged_raise(monkeypatch):
    """TPUBC_SPEC_LOOKUP=1 turns prompt lookup on in both packages' pools
    (the port raised here before the paged rounds were ported)."""
    monkeypatch.setenv("TPUBC_SPEC_LOOKUP", "1")
    assert jserving.PagedPool(JPARAMS, JCFG, 2, kv_quant=True).spec_lookup
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, kv_quant=True, device="cpu")
    assert pool.spec_lookup and pool._over() == pool.gamma == 4
    # Explicit arguments win over the knob, in both packages.
    assert not jserving.PagedPool(JPARAMS, JCFG, 2, kv_quant=True,
                                  spec_lookup=False).spec_lookup
    tserving.PagedPool(TPARAMS, TCFG, 2, kv_quant=True, spec_lookup=False,
                       device="cpu")


def test_explicit_knob_arguments_still_win(monkeypatch):
    monkeypatch.setenv("TPUBC_KV_BLOCK", "16")
    monkeypatch.setenv("TPUBC_PREFILL_BUDGET", "8")
    monkeypatch.setenv("TPUBC_PREFIX_CACHE", "0")
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, kv_quant=True, block_size=8,
                              prefill_budget=4, prefix_cache=True,
                              device="cpu")
    assert (pool.block_size, pool.prefill_budget, pool.prefix_cache) == (
        8, 4, True)
    monkeypatch.setenv("TPUBC_KV_BLOCK", "0")
    with pytest.raises(ValueError, match="block_size must be >= 1"):
        tserving.PagedPool(TPARAMS, TCFG, 2, kv_quant=True, device="cpu")
