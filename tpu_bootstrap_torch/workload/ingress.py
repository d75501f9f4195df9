"""The HTTP front door of a serve-mode replica, the counterpart of
``tpu_bootstrap/workload/ingress.py``: submit a prompt over HTTP, get its
tokens back, streamed as they decode.

``serving.serve_demo_from_env`` runs it when WORKLOAD_SERVE_PORT is set:

    WORKLOAD_MODE=serve WORKLOAD_QUANT=int8 WORKLOAD_KV_QUANT=1 \\
    WORKLOAD_PAGED=1 WORKLOAD_SERVE_PORT=8000 \\
    python -m tpu_bootstrap_torch.workload.train

Design, as in the reference: one ENGINE thread owns the pool (the paged
engine ``PagedPool``, the resident-cache ``ResidentPool``, or the
replay-slot ``SlotPool``) and its
``Scheduler`` and steps them against live queues: admission at round
boundaries, each request's output queue fed from every round's events.
HTTP handler threads never touch the card: they validate, enqueue and
stream what the engine publishes. Everything a handler reads (the events,
the ``/poolz`` snapshot, the ledger) is already Python numbers and lists,
converted on the engine thread, so no handler synchronizes the device or
meets a tensor in ``json.dumps``. The decode graphs (``graphs.py``) are
captured on the engine thread; a watchdog restart starts a new engine
thread that replays them.

Routes, keys, metric names and knobs are the reference's:

* ``POST /v1/generate`` with ``{"tokens": [ints], "max_new": N,
  "stream": bool, "priority": int, "deadline_ms": ms, "trace_id": str,
  "request_id": str}`` (or the ``X-Tpubc-Trace`` header for the trace id).
  Streamed: chunked JSON lines, a ``{"queued": true, "queue_position": N}``
  ack first, one ``{"tokens": [...]}`` a round, a final object with
  ``"done": true``, ``timing``, ``trace_id`` and, on the paged engine,
  ``cached_tokens``. Non-streamed: one object with every token. A known
  ``request_id`` attaches to the existing stream (``_StreamFan``) and
  never runs twice. 400: malformed or never fits; 429 + Retry-After: the
  waiting queue is full (TPUBC_INGRESS_MAX_QUEUE); 503 + Retry-After:
  draining; 504 (non-streamed) with ``deadline_exceeded``: the deadline
  passed.
* ``GET /healthz`` (``/health``): ``ok`` follows the engine thread, a
  stalled heartbeat (TPUBC_WATCHDOG_STALL_MS) and the drain; ``active``,
  ``queued``, ``served``, ``beat_age_ms``, rolling p50 TTFT and total.
* ``GET /poolz``, ``/cachez``, ``/requestz`` (``?rid=``,
  ``?format=jsonl``), ``/metrics``, ``/metrics.json`` (``?window=N``),
  ``/traces.json``.
* ``POST /profilez?ms=N`` (TPUBC_PROFILEZ): the engine thread opens
  ``torch.profiler`` (CPU activity, and CUDA on the card) at the next round
  boundary, closes it at the first boundary past N ms, exports a Chrome
  trace into the capture's directory and answers the ledger's delta over
  the window (busy share, MFU). ``mode`` is ``"profiler"``, or
  ``"ledger"`` with ``profiler_error`` when the profiler failed to open
  or close: the reference's reported contract. ``mfu`` is null without a
  known peak (``telemetry.peak_tflops``).
* SIGTERM (``serve_forever``) and ``drain()``: the front door answers 503,
  residents finish or are checkpoint-preempted at TPUBC_DRAIN_TIMEOUT_MS,
  and every open stream ends with a ``{"draining": true}`` chunk.

The port differs only here: the constructor takes ``device`` (None: the
card, through ``model.resolve_device``). The engine is the reference's
pick: ``paged`` (the int8 or float pool), ``resident``, or the replay-slot
one. Sampling (``temperature``, ``top_k``, ``top_p`` and the pool ``key``)
and the speculative rounds (a draft, or ``spec_lookup`` on the paged and
resident engines) are the pools' own, with the reference's checks.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import queue
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import faults
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    Params,
    resolve_device,
)
from tpu_bootstrap_torch.workload.serving import (
    PagedPool,
    Request,
    ResidentPool,
    Scheduler,
    SlotPool,
)


class _StreamFan:
    """One request's event stream when the client supplied a
    ``request_id``: the primary client queue plus any re-subscribers, with
    every event kept so that a re-submitted id replays what it missed and
    then follows live. Every call runs under the ingress lock, so the fan
    needs no lock of its own; it only has to quack like the queue.Queue of
    the other requests."""

    __slots__ = ("events", "subs", "done")

    def __init__(self, q):
        self.events: list = []
        self.subs: list = [q]
        self.done = False

    def put(self, ev) -> None:
        self.events.append(ev)
        if ev.get("done"):
            self.done = True
        for q in self.subs:
            q.put(ev)

    def attach(self) -> queue.Queue:
        """A fresh queue holding everything already delivered, live events
        following unless the stream already finished: the retry gets the
        same stream, never a second execution."""
        q: queue.Queue = queue.Queue()
        for ev in self.events:
            q.put(ev)
        if not self.done:
            self.subs.append(q)
        return q


def idem_cache_cap() -> int:
    """Completed idempotency records kept for replay
    (TPUBC_INGRESS_IDEM_CACHE, default 256); in-flight ones are never
    evicted."""
    try:
        return max(0, int(os.environ.get("TPUBC_INGRESS_IDEM_CACHE",
                                         "256")))
    except ValueError:
        return 256


class IngressServer:
    """Own the pool, the engine thread and the HTTP server. ``start()``
    runs in the background; ``serve_forever()`` blocks (the JobSet
    entry)."""

    def __init__(self, params: Params, cfg: ModelConfig, *, port: int,
                 batch_size: int = 8, kv_quant: bool = False,
                 eos_id: int | None = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, key=None,
                 draft_params: Params | None = None,
                 draft_cfg: ModelConfig | None = None, gamma: int = 4,
                 resident: bool = False, paged: bool = False,
                 kv_blocks: int | None = None, block_size: int | None = None,
                 prefill_budget: int | None = None,
                 prefix_cache: bool | None = None,
                 overcommit: bool | None = None,
                 spec_lookup: bool | None = None,
                 max_queue: int | None = None, host: str = "0.0.0.0",
                 watchdog_stall_ms: float | None = None, device=None):
        self.cfg = cfg
        if paged and resident:
            raise ValueError("paged and resident are distinct engines; "
                             "pick one")
        self.device = resolve_device(device)
        # Sampling is the pool's: its temperature and filters come from the
        # slice's env, and each request's stream from its server-assigned
        # rid under the pool key.
        if paged:
            self.pool = PagedPool(params, cfg, batch_size,
                                  kv_blocks=kv_blocks, block_size=block_size,
                                  prefill_budget=prefill_budget,
                                  kv_quant=kv_quant, eos_id=eos_id,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, key=key,
                                  draft_params=draft_params,
                                  draft_cfg=draft_cfg, gamma=gamma,
                                  prefix_cache=prefix_cache,
                                  spec_lookup=spec_lookup,
                                  device=self.device)
        elif resident:
            # Resident-cache engine: no history replay, per-row frontiers.
            self.pool = ResidentPool(params, cfg, batch_size,
                                     kv_quant=kv_quant, eos_id=eos_id,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p, key=key,
                                     draft_params=draft_params,
                                     draft_cfg=draft_cfg, gamma=gamma,
                                     spec_lookup=spec_lookup,
                                     device=self.device)
        else:
            if spec_lookup:
                raise ValueError(
                    "spec_lookup rides the resident/paged engines' split "
                    "draft/verify seam; pick one of them")
            self.pool = SlotPool(params, cfg, batch_size, kv_quant=kv_quant,
                                 eos_id=eos_id, temperature=temperature,
                                 top_k=top_k, top_p=top_p, key=key,
                                 draft_params=draft_params,
                                 draft_cfg=draft_cfg, gamma=gamma,
                                 device=self.device)
        # Admission, queueing and preemption live in the Scheduler; only
        # the engine thread steps it, handlers hand requests over through
        # _pending.
        self.sched = Scheduler(self.pool, overcommit=overcommit)
        # Past this many waiting requests the front door answers 429 +
        # Retry-After (server pressure is not a client error).
        if max_queue is None:
            max_queue = int(os.environ.get("TPUBC_INGRESS_MAX_QUEUE", "256"))
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: list = []  # [(Request, out_queue)] awaiting handoff  # guarded-by: _lock
        self._streams: dict = {}  # rid -> out_queue once handed to the engine  # guarded-by: _lock
        self._next_rid = 0  # guarded-by: _lock
        self._stop = False  # guarded-by: _lock
        self.last_error: str | None = None  # last failed round, /healthz  # guarded-by: _lock
        # Latency: each rid's (submit time, first-token time) in flight,
        # rolling windows of TTFT and total latency over the last 256
        # completions (/healthz) and the /metrics histograms.
        self._submit_t: dict = {}   # rid -> (t_submit, t_first or None)  # guarded-by: _lock
        self._ttft_ms = collections.deque(maxlen=256)  # guarded-by: _lock
        self._total_ms = collections.deque(maxlen=256)  # guarded-by: _lock
        self._served = 0  # guarded-by: _lock
        self._last_ev_t: dict = {}  # rid -> last event time (inter-token)  # guarded-by: _lock
        # rid -> prompt tokens the prefix cache served at admission: the
        # final object's cached_tokens and the cached/cold TTFT split.
        self._cached_toks: dict = {}  # guarded-by: _lock
        # rid -> (priority, trace id echoed on the final object).
        self._req_meta: dict = {}  # guarded-by: _lock
        # request_id -> _StreamFan, kept past completion up to
        # TPUBC_INGRESS_IDEM_CACHE completed records, oldest evicted first.
        self._idem = collections.OrderedDict()  # request_id -> _StreamFan  # guarded-by: _lock
        self._idem_cap = idem_cache_cap()
        self._qps_window = telemetry.RateWindow()
        self._tps_window = telemetry.RateWindow()
        # /poolz and /healthz read the engine's round-boundary publication,
        # never the engine-owned pool itself.
        self._poolz: dict = {  # guarded-by: _lock
            "as_of_us": telemetry.now_us(),
            "pool": self.pool.snapshot(),
            "scheduler": self.sched.snapshot(),
        }
        # Graceful drain (SIGTERM / drain()).
        self._draining = False  # guarded-by: _lock
        self._drained = False  # guarded-by: _lock
        self._drain_deadline: float | None = None  # guarded-by: _lock
        # The engine stamps a heartbeat at every round boundary; a stale
        # one with streams in flight flips /healthz (stall), a dead engine
        # thread is recovered and restarted by the watchdog.
        self._beat = telemetry.monotonic()  # guarded-by: _lock
        self._stalled = False  # guarded-by: _lock
        if watchdog_stall_ms is None:
            watchdog_stall_ms = float(os.environ.get(
                "TPUBC_WATCHDOG_STALL_MS", "30000"))
        self.watchdog_stall_ms = watchdog_stall_ms  # 0 disables
        self._watchdog: threading.Thread | None = None
        # The watchdog ticks on its own event: a waiter on _work would
        # consume the engine's notifications.
        self._watchdog_stop = threading.Event()
        # One /profilez capture at a time: the handler parks its record
        # here and waits on its event; the engine thread opens and closes
        # the profiler at round boundaries and fills in the result.
        self._profile: dict | None = None  # guarded-by: _lock

        outer = self

        class Handler(BaseHTTPRequestHandler):
            # The engine owns the card; handlers only enqueue and stream.
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet: the engine is the log
                pass

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                if path in ("/metrics", "/metrics.json"):
                    # An injected scrape failure answers 500, never a
                    # dropped socket.
                    try:
                        faults.fire("scrape")
                    except faults.InjectedFault as e:
                        return self._json(500, {"error": str(e)})
                if path == "/metrics":
                    body = telemetry.metrics().to_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/metrics.json":
                    w = parse_qs(url.query).get("window", [None])[0]
                    if w is not None:
                        try:
                            w = float(w)
                        except ValueError:
                            return self._json(
                                400, {"error": "window must be a number"})
                        return self._json(
                            200, telemetry.metrics().window_json(w))
                    return self._json(200, telemetry.metrics().to_json())
                if path.startswith("/requestz"):
                    q = parse_qs(url.query)
                    if q.get("format", [None])[0] == "jsonl":
                        return self._jsonl(outer.sched.log.arrivals())
                    rid = q.get("rid", [None])[0]
                    if rid is not None:
                        try:
                            rid = int(rid)
                        except ValueError:
                            return self._json(
                                400, {"error": "rid must be an int"})
                    return self._json(200, outer.sched.log.snapshot(rid=rid))
                if path == "/cachez":
                    # Pools without a prefix cache answer an empty digest,
                    # not a 404: a fleet poller treats replicas alike.
                    with outer._lock:
                        as_of = outer._poolz.get("as_of_us")
                        digest = outer._poolz["pool"].get("cache_digest")
                    if digest is None:
                        digest = {"version": 1, "block_size": 0,
                                  "blocks": 0, "fps": []}
                    return self._json(200, {"as_of_us": as_of,
                                            "digest": digest})
                if path == "/poolz":
                    # The pool half is the engine's round-boundary
                    # publication; the scheduler half is read live under
                    # the scheduler's own lock.
                    with outer._lock:
                        snap = dict(outer._poolz)
                    snap["scheduler"] = outer.sched.snapshot()
                    return self._json(200, snap)
                if path == "/traces.json":
                    return self._json(200, telemetry.tracer().to_json())
                if path not in ("/healthz", "/health"):
                    return self._json(404, {"error": f"unknown path {path}"})
                with outer._lock:
                    active = outer._poolz["pool"]["active"]
                    last_error = outer.last_error
                    served = outer._served
                    pending = len(outer._pending)
                    ttft = sorted(outer._ttft_ms)
                    total = sorted(outer._total_ms)
                    draining = outer._draining
                    stalled_ms = (telemetry.monotonic() - outer._beat) * 1e3
                    # The watchdog's verdict, revalidated against the live
                    # heartbeat so a resolved stall clears at once.
                    stalled = (outer._stalled
                               and stalled_ms > outer.watchdog_stall_ms)
                queued = pending + outer.sched.queue_depth()
                health = {"ok": (outer._engine.is_alive() and not stalled
                                 and not draining),
                          "active": active,
                          "queued": queued, "served": served,
                          "beat_age_ms": round(stalled_ms, 1)}
                if draining:
                    health["draining"] = True
                if stalled:
                    health["stalled_ms"] = round(stalled_ms, 1)
                if ttft:
                    health["p50_ttft_ms"] = round(ttft[len(ttft) // 2], 2)
                if total:
                    health["p50_total_ms"] = round(total[len(total) // 2], 2)
                if last_error:
                    health["last_error"] = last_error
                self._json(200 if health["ok"] else 503, health)

            def do_POST(self):
                if urlparse(self.path).path == "/profilez":
                    return self._profilez(urlparse(self.path))
                if self.path != "/v1/generate":
                    return self._json(404, {"error": f"unknown path {self.path}"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    tokens = body["tokens"]
                    max_new = int(body["max_new"])
                    stream = bool(body.get("stream", True))
                    priority = int(body.get("priority", 0))
                    # The body's trace id wins over the X-Tpubc-Trace
                    # header; echoed on the final object.
                    trace_id = (body.get("trace_id")
                                or self.headers.get("X-Tpubc-Trace") or "")
                    if not isinstance(trace_id, str) or len(trace_id) > 128:
                        raise ValueError(
                            "trace_id must be a string (<= 128 chars)")
                    request_id = body.get("request_id") or ""
                    if (not isinstance(request_id, str)
                            or len(request_id) > 128):
                        raise ValueError(
                            "request_id must be a string (<= 128 chars)")
                    deadline_ms = body.get("deadline_ms")
                    if deadline_ms is not None:
                        deadline_ms = float(deadline_ms)
                        if deadline_ms <= 0:
                            raise ValueError("deadline_ms must be > 0")
                    if (not isinstance(tokens, list)
                            or not all(isinstance(t, int) for t in tokens)):
                        raise ValueError("tokens must be a list of ints")
                # TypeError too: a non-dict body or a null max_new raises
                # it, and an uncaught one would drop the connection.
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                req = Request(
                    rid=-1, tokens=tokens, max_new=max_new,
                    priority=priority, trace_id=trace_id,
                    deadline=(telemetry.monotonic() + deadline_ms / 1e3
                              if deadline_ms is not None else None))
                try:
                    # The pool's own rules, at the front door: a request
                    # that can never fit is the client's error (400).
                    outer.pool.validate(req, outer.cfg)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                # A known id attaches before the drain gate: once accepted,
                # a retry is never refused.
                attached = outer._attach_idem(request_id)
                if attached is not None:
                    return self._pump(attached, stream, None, request_id)
                with outer._lock:
                    draining = outer._draining
                if draining:
                    return self._json(
                        503, {"error": "draining: replica is shutting "
                                       "down; retry elsewhere",
                              "draining": True},
                        headers={"Retry-After":
                                 str(outer._drain_retry_after_s())})
                submitted = outer._submit(req, request_id=request_id)
                if submitted is None:
                    # The waiting queue is at its bound. Retry-After is the
                    # scheduler's estimate of its drain time.
                    telemetry.metrics().inc("serve_throttled_total")
                    return self._json(
                        429, {"error": "no capacity: waiting queue is "
                                       f"full ({outer.max_queue}); retry",
                              "queued": outer.max_queue},
                        headers={"Retry-After": str(
                            outer.sched.retry_after_s(outer.max_queue))})
                out_q, qpos = submitted
                return self._pump(out_q, stream, qpos, request_id)

            def _pump(self, out_q, stream, qpos, request_id):
                """Render one request's event stream to the client, for a
                fresh submission or an idempotent re-attach (``qpos``
                None: the replayed ack carries the position)."""
                if stream:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/jsonl")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        while True:
                            ev = out_q.get()
                            line = json.dumps(
                                {"tokens": ev["new"],
                                 **({"done": True} if ev["done"] else {}),
                                 **({"queued": True,
                                     "queue_position": ev["queue_position"]}
                                    if ev.get("queued") else {}),
                                 **({"cached_tokens": ev["cached_tokens"]}
                                    if "cached_tokens" in ev else {}),
                                 **({"timing": ev["timing"]}
                                    if ev.get("timing") else {}),
                                 **({"trace_id": ev["trace_id"]}
                                    if ev.get("trace_id") else {}),
                                 **({"request_id": request_id}
                                    if request_id else {}),
                                 **({"draining": True}
                                    if ev.get("draining") else {}),
                                 **({"deadline_exceeded": True}
                                    if ev.get("deadline") else {}),
                                 **({"error": ev["error"]}
                                    if ev.get("error") else {})}
                            ).encode() + b"\n"
                            # An injected socket death costs what a real
                            # BrokenPipeError costs: nothing, to anyone
                            # else.
                            faults.fire("ingress.write")
                            self.wfile.write(
                                f"{len(line):x}\r\n".encode() + line + b"\r\n")
                            self.wfile.flush()
                            if ev["done"]:
                                break
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, faults.InjectedFault):
                        pass  # client left; the pool finishes its budget
                else:
                    while True:
                        ev = out_q.get()
                        if ev["done"]:
                            out = {"tokens": ev["generated"], "done": True}
                            if qpos is not None:
                                out["queue_position"] = qpos
                            if "cached_tokens" in ev:
                                out["cached_tokens"] = ev["cached_tokens"]
                            if ev.get("timing"):
                                out["timing"] = ev["timing"]
                            if ev.get("trace_id"):
                                out["trace_id"] = ev["trace_id"]
                            if request_id:
                                out["request_id"] = request_id
                            if ev.get("error"):
                                out["error"] = ev["error"]
                            # A deadline is a gateway timeout (504), a
                            # drain flush a 503; both carry the committed
                            # prefix.
                            code = 200
                            if ev.get("deadline"):
                                out["deadline_exceeded"] = True
                                code = 504
                            elif ev.get("draining"):
                                out["draining"] = True
                                code = 503
                            return self._json(code, out)

            def _profilez(self, url):
                # Opt-in per replica: TPUBC_PROFILEZ=1 captures into a tmp
                # dir, any other truthy value is the artifact directory.
                mode = os.environ.get("TPUBC_PROFILEZ", "0")
                if mode.lower() in ("", "0", "false"):
                    return self._json(403, {
                        "error": "profilez disabled: set TPUBC_PROFILEZ=1 "
                                 "(tmp-dir artifacts) or =<artifact dir>"})
                try:
                    ms = float(parse_qs(url.query).get("ms", ["500"])[0])
                except ValueError:
                    return self._json(400, {"error": "ms must be a number"})
                if not 0 < ms <= 60000:
                    return self._json(
                        400, {"error": "ms must be in (0, 60000]"})
                out_dir = (os.path.join(tempfile.gettempdir(),
                                        "tpubc-profilez")
                           if mode.lower() in ("1", "true") else mode)
                ev = threading.Event()
                with outer._work:
                    if outer._profile is not None:
                        return self._json(
                            409, {"error": "a capture is already in "
                                           "flight; retry after it"})
                    outer._profile = {"ms": ms, "dir": out_dir,
                                      "event": ev, "deadline": None,
                                      "result": None}
                    # Wake an idle engine: idle time is part of the answer.
                    outer._work.notify_all()
                ok = ev.wait(timeout=ms / 1e3 + 30.0)
                with outer._work:
                    prof, outer._profile = outer._profile, None
                if not ok or prof is None or prof.get("result") is None:
                    return self._json(
                        504, {"error": "capture did not complete "
                                       "(engine stalled or dead?)"})
                return self._json(200, prof["result"])

            def _json(self, code, obj, headers=None):
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def _jsonl(self, records):
                payload = "".join(
                    json.dumps(r) + "\n" for r in records).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._engine = threading.Thread(target=self._engine_loop, daemon=True)
        self._http_thread: threading.Thread | None = None

    # ---- engine ----------------------------------------------------------

    def _attach_idem(self, request_id: str):
        """A fresh queue replaying (and, live, following) the stream of a
        known ``request_id``; None for an unknown one."""
        if not request_id:
            return None
        with self._work:
            fan = self._idem.get(request_id)
            if fan is None:
                return None
            telemetry.metrics().inc("serve_idem_dedup_total")
            return fan.attach()

    def _idem_gc_locked(self) -> None:
        """Evict the oldest completed idempotency records past the cap
        (the caller holds the lock); in-flight fans always stay."""
        done = sum(1 for f in self._idem.values() if f.done)
        if done <= self._idem_cap:
            return
        for key in [k for k, f in self._idem.items() if f.done]:
            del self._idem[key]
            done -= 1
            if done <= self._idem_cap:
                break

    def _submit(self, req: Request, request_id: str = ""):
        """Assign a rid, hand the request to the engine and ack its
        queueing. Returns (out queue, queue position), or None when the
        waiting queue is at its bound."""
        client_q: queue.Queue = queue.Queue()
        out_q = client_q
        with self._work:
            depth = len(self._pending) + self.sched.queue_depth()
            if depth >= self.max_queue:
                return None
            req.rid = self._next_rid
            self._next_rid += 1
            if request_id:
                # The engine writes through the fan; the handler reads
                # client_q; the fan outlives the stream in _idem.
                fan = _StreamFan(client_q)
                self._idem[request_id] = fan
                self._idem_gc_locked()
                out_q = fan
            self._pending.append((req, out_q))
            self._submit_t[req.rid] = (telemetry.monotonic(), None)
            self._req_meta[req.rid] = (
                req.priority, req.trace_id or telemetry.root_trace_id())
            telemetry.metrics().set_gauge("serve_queue_depth", depth + 1)
            # The ack before any engine event can race it.
            out_q.put({"new": [], "done": False, "queued": True,
                       "queue_position": depth})
            # notify_all: drain() may wait on the same condition.
            self._work.notify_all()
        return client_q, depth

    def _fail_streams_locked(self, msg: str, streams) -> None:
        """Under the lock: end ``streams`` ((rid, queue) pairs) with an
        error chunk carrying each row's committed tokens, forget every
        in-flight request's records, and reset the pool and the queue."""
        generated = {s.rid: list(s.generated)
                     for s in self.pool.slots if s is not None}
        for rid, q in streams:
            q.put({"new": [], "done": True, "error": msg,
                   "generated": generated.get(rid, [])})
        self._streams.clear()
        self._submit_t.clear()
        self._last_ev_t.clear()
        self._cached_toks.clear()
        self._req_meta.clear()
        self.pool.reset()
        self.sched.reset()

    def _engine_loop(self):
        while True:
            with self._work:
                self._beat = telemetry.monotonic()
                while (not self._stop and not self._pending
                       and not self.pool.has_active()
                       and not self.sched.pending()
                       and not (self._draining and not self._drained)
                       and self._profile is None):
                    self._work.wait()
                    # Idle waits are not stalls.
                    self._beat = telemetry.monotonic()
                if self._stop:
                    return
                # The handoff under the lock, the round outside it; streams
                # register at handoff, so a failure reaches every client.
                incoming, self._pending = self._pending, []
                for req, out_q in incoming:
                    self._streams[req.rid] = out_q
                has_work = (bool(incoming) or self.pool.has_active()
                            or self.sched.pending()
                            or (self._draining and not self._drained))
            try:
                self._profile_tick()
            except Exception as e:  # noqa: BLE001
                # A failed tick fails the capture, never the streams: the
                # round goes on.
                self._fail_profile(f"profilez: {type(e).__name__}: {e}"[:300])
            if not has_work:
                # A capture in flight on an idle pool: poll its deadline
                # instead of running empty rounds.
                time.sleep(0.02)
                continue
            try:
                for req, _ in incoming:
                    self.sched.submit(req)
                events = self.sched.step()
                rct = getattr(self.pool, "request_cached_tokens", None)
                if rct:
                    with self._work:
                        for rid in list(rct):
                            self._cached_toks[rid] = rct.pop(rid)
                # The paged engine recovers a failed round inside step();
                # its cause still reaches /healthz.
                recovery_err = self.sched.last_error
                if recovery_err:
                    with self._work:
                        self.last_error = recovery_err
                self._publish_events(events)
            except Exception as e:  # noqa: BLE001
                # Abort-all, reached when in-round recovery is unavailable
                # (the slot engine) or exhausted, or when the publish
                # fails: every in-flight request fails loudly, the pool and
                # queue reset, the engine goes on serving.
                msg = f"{type(e).__name__}: {e}"[:300]
                with self._work:
                    self.last_error = msg
                    self._fail_streams_locked(msg,
                                              list(self._streams.items()))
                self._publish_poolz()
                continue
            # Round boundary: the one moment a coherent view of the pool
            # exists.
            self._publish_poolz()
            with self._work:
                draining = self._draining and not self._drained
            if draining:
                self._drain_tick()

    def _publish_events(self, events: dict) -> None:
        """ENGINE THREAD ONLY: hand a round's events to their streams and
        update the serve_* series."""
        now = telemetry.monotonic()
        reg = telemetry.metrics()
        with self._work:
            for rid, ev in events.items():
                if ev["done"]:
                    ev["cached_tokens"] = self._cached_toks.get(rid, 0)
                    timing = self.sched.request_timing(rid)
                    if timing is not None:
                        ev["timing"] = timing
                    ev["trace_id"] = self._req_meta.get(
                        rid, (0, ""))[1]
                self._streams[rid].put(ev)
                t_submit, t_first = self._submit_t.get(rid, (now, None))
                if ev["new"]:
                    self._tps_window.add(len(ev["new"]), t=now)
                    reg.inc("serve_tokens_total", len(ev["new"]))
                    last = self._last_ev_t.get(rid)
                    if last is not None:
                        # This round's wall time over the tokens it
                        # delivered: the cadence a client sees.
                        reg.observe("serve_inter_token_ms",
                                    (now - last) * 1e3 / len(ev["new"]))
                    self._last_ev_t[rid] = now
                if t_first is None and ev["new"]:
                    self._submit_t[rid] = (t_submit, now)
                    self._ttft_ms.append((now - t_submit) * 1e3)
                    reg.observe("serve_ttft_ms", (now - t_submit) * 1e3)
                    reg.observe(
                        "serve_ttft_ms", (now - t_submit) * 1e3,
                        labels={"priority": str(
                            self._req_meta.get(rid, (0, ""))[0])})
                    reg.observe("serve_cached_ttft_ms"
                                if self._cached_toks.get(rid, 0)
                                else "serve_cold_ttft_ms",
                                (now - t_submit) * 1e3)
                if ev["done"]:
                    del self._streams[rid]
                    self._submit_t.pop(rid, None)
                    self._last_ev_t.pop(rid, None)
                    self._cached_toks.pop(rid, None)
                    self._req_meta.pop(rid, None)
                    self._total_ms.append((now - t_submit) * 1e3)
                    self._served += 1
                    reg.inc("serve_requests_total")
                    reg.observe("serve_request_ms",
                                (now - t_submit) * 1e3)
                    self._qps_window.add(t=now)
            reg.set_gauge("serve_active_slots",
                          sum(1 for s in self.pool.slots
                              if s is not None))
            reg.set_gauge("serve_queue_depth",
                          len(self._pending) + self.sched.queue_depth())
            reg.set_gauge("serve_qps",
                          round(self._qps_window.per_sec(t=now), 3))
            reg.set_gauge("serve_tokens_per_sec",
                          round(self._tps_window.per_sec(t=now), 1))
            reg.set_gauge("serve_qps_window_secs",
                          self._qps_window.window)
            reg.set_gauge("serve_tokens_per_sec_window_secs",
                          self._tps_window.window)
            stats = self.pool.stats
            if stats.get("slot_steps"):
                reg.set_gauge(
                    "serve_slot_utilization",
                    round(stats["active_slot_steps"]
                          / stats["slot_steps"], 3))

    def _drain_tick(self) -> None:
        """ENGINE THREAD ONLY: one drain check at a round boundary.
        Residents decode on until they finish or TPUBC_DRAIN_TIMEOUT_MS
        expires; then the rest are checkpoint-preempted (quarantine) and
        every open stream gets a final ``{"draining": true}`` chunk."""
        with self._work:
            idle = (not self._pending and not self._streams
                    and not self.sched.pending()
                    and not self.pool.has_active())
            expired = (self._drain_deadline is not None
                       and telemetry.monotonic() >= self._drain_deadline)
            if not (idle or expired):
                return
            if not idle:
                generated = {s.rid: list(s.generated)
                             for s in self.pool.slots if s is not None}
                if hasattr(self.pool, "quarantine"):
                    # The records are dropped, not requeued: the process
                    # is exiting.
                    self.pool.quarantine(reason="drain")
                else:
                    for i, s in enumerate(self.pool.slots):
                        if s is not None:
                            self.pool.cancel(i, reason="drain")
                # _pending: a request that slipped past the front door as
                # the flag flipped still gets its goodbye.
                flush = list(self._streams.items()) + [
                    (req.rid, q) for req, q in self._pending]
                self._pending = []
                for rid, q in flush:
                    q.put({"new": [], "done": True, "draining": True,
                           "error": "draining: replica shut down before "
                                    "completion",
                           "generated": generated.get(rid, [])})
                self._streams.clear()
                self._submit_t.clear()
                self._last_ev_t.clear()
                self._cached_toks.clear()
                self._req_meta.clear()
                self.sched.reset(reason="drain")
            self._drained = True
            self._work.notify_all()
        self._publish_poolz()

    def _publish_poolz(self) -> None:
        """Snapshot the pool and the scheduler and publish them under the
        ingress lock (ENGINE THREAD ONLY)."""
        snap = {
            "as_of_us": telemetry.now_us(),
            "pool": self.pool.snapshot(),
            "scheduler": self.sched.snapshot(),
        }
        with self._work:
            self._poolz = snap

    def _profile_tick(self) -> None:
        """ENGINE THREAD ONLY: drive a /profilez capture. The first tick
        after a handler parked one opens ``torch.profiler`` and takes the
        ledger's baseline; the first tick past the deadline closes it,
        exports the Chrome trace into the capture's directory, sums the
        ledger's delta over the window and sets the handler's event."""
        with self._work:
            prof = self._profile
        if prof is None or prof.get("result") is not None:
            return
        now = telemetry.monotonic()
        if prof["deadline"] is None:
            prof["mode"] = "profiler"
            try:
                from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

                os.makedirs(prof["dir"], exist_ok=True)
                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof["profiler"] = profile(activities=acts)
                prof["profiler"].start()
            except Exception as e:  # noqa: BLE001 - the ledger-only answer
                prof["mode"] = "ledger"
                prof["profiler_error"] = f"{type(e).__name__}: {e}"[:200]
            # The window starts after the profiler opens: its first use
            # can take seconds.
            now = telemetry.monotonic()
            prof["base"] = dict(self.sched.ledger)
            prof["t0"] = now
            prof["deadline"] = now + prof["ms"] / 1e3
            return
        if now < prof["deadline"]:
            return
        if prof["mode"] == "profiler":
            try:
                p = prof.pop("profiler")
                p.stop()
                p.export_chrome_trace(os.path.join(
                    prof["dir"],
                    f"profilez-{os.getpid()}-{telemetry.now_us()}.json"))
            except Exception as e:  # noqa: BLE001 - keep the ledger half
                prof["mode"] = "ledger"
                prof["profiler_error"] = f"{type(e).__name__}: {e}"[:200]
        led, base = self.sched.ledger, prof["base"]
        delta = {k: (round(v - base.get(k, 0.0), 3)
                     if isinstance(v, float) else v - base.get(k, 0))
                 for k, v in led.items()}
        # The denominator is the capture window, not the ledger's wall.
        window = (now - prof["t0"]) * 1e3
        flops = delta["flops"]
        peak = telemetry.peak_tflops()
        result = {
            "mode": prof["mode"],
            "requested_ms": prof["ms"],
            "measured_ms": round(window, 1),
            "ledger": delta,
            "busy_frac": (round(min(1.0, delta["busy_ms"] / window), 4)
                          if window > 0 else 0.0),
            "mfu": (None if peak is None
                    else round(flops / (window * 1e-3 * peak * 1e12), 9)
                    if window > 0 else 0.0),
        }
        if prof["mode"] == "profiler":
            result["artifact_dir"] = prof["dir"]
        if prof.get("profiler_error"):
            result["profiler_error"] = prof["profiler_error"]
        prof["result"] = result
        prof["event"].set()

    def _fail_profile(self, msg: str) -> None:
        """ENGINE THREAD ONLY: a tick raised. A capture in flight closes
        its profiler and wakes its handler with no result (504)."""
        with self._work:
            self.last_error = msg
            prof = self._profile
        if prof is None:
            return
        opened = prof.pop("profiler", None)
        if opened is not None:
            with contextlib.suppress(Exception):
                opened.stop()
        prof["event"].set()

    # ---- drain / watchdog ------------------------------------------------

    def _drain_retry_after_s(self) -> int:
        """Retry-After while draining: the drain window left, rounded up,
        clamped to [1, 30] s."""
        with self._lock:
            deadline = self._drain_deadline
        if deadline is None:
            return 1
        return max(1, min(30, int(deadline - telemetry.monotonic()) + 1))

    def drain(self, timeout_ms: float | None = None) -> float:
        """Graceful drain (SIGTERM; tests call it directly): 503 at the
        front door, residents finish or, when the window
        (TPUBC_DRAIN_TIMEOUT_MS) expires, are checkpoint-preempted, and
        every open stream ends with ``{"draining": true}``. Blocks until
        the engine reports drained (30 s of grace past the window) and
        returns the ms it took (also the serve_drain_ms gauge).
        Idempotent."""
        if timeout_ms is None:
            timeout_ms = float(os.environ.get(
                "TPUBC_DRAIN_TIMEOUT_MS", "5000"))
        t0 = telemetry.monotonic()
        with self._work:
            if not self._draining:
                self._draining = True
                self._drain_deadline = t0 + timeout_ms / 1e3
            self._work.notify_all()
            grace = t0 + timeout_ms / 1e3 + 30.0
            while not self._drained and telemetry.monotonic() < grace:
                self._work.wait(0.1)
        ms = (telemetry.monotonic() - t0) * 1e3
        telemetry.metrics().set_gauge("serve_drain_ms", round(ms, 1))
        return ms

    def _watchdog_loop(self) -> None:
        """Stall detector and engine resurrection: streams in flight with
        a heartbeat older than the threshold flip /healthz (each stall
        counted once); a dead engine thread is recovered
        (crash-is-preemption) and replaced."""
        period = max(0.02, self.watchdog_stall_ms / 1e3 / 4)
        while not self._watchdog_stop.wait(period):
            dead = False
            with self._work:
                if self._stop:
                    return
                busy = bool(self._streams) or bool(self._pending)
                age_ms = (telemetry.monotonic() - self._beat) * 1e3
                alive = self._engine.is_alive()
                stalled = (busy and alive
                           and age_ms > self.watchdog_stall_ms)
                if stalled and not self._stalled:
                    self.last_error = (f"engine stall: no round "
                                       f"heartbeat for {age_ms:.0f}ms")
                    telemetry.metrics().inc("serve_engine_stalls_total")
                self._stalled = stalled
                if not alive and busy:
                    dead = True
            if dead:
                self._restart_engine()

    def _restart_engine(self) -> None:
        """A dead engine thread: the watchdog briefly owns the engine,
        quarantines what it left (resume records requeued under their
        keys on the paged engine; the slot engine fails its streams
        loudly), then hands over to a fresh engine thread."""
        reg = telemetry.metrics()
        if hasattr(self.pool, "quarantine"):
            self.sched.requeue(self.pool.quarantine())
        else:
            with self._work:
                self._fail_streams_locked("engine thread died",
                                          list(self._streams.items()))
        with self._work:
            if self._stop:
                return
            if not self.last_error:
                self.last_error = "engine thread died (restarted)"
            self._engine = threading.Thread(target=self._engine_loop,
                                            daemon=True)
            self._engine.start()
            self._work.notify_all()
        reg.inc("serve_engine_restarts_total")

    def _start_watchdog(self) -> None:
        if self.watchdog_stall_ms <= 0 or self._watchdog is not None:
            return
        self._watchdog = threading.Thread(target=self._watchdog_loop,
                                          daemon=True)
        self._watchdog.start()

    def _install_sigterm(self) -> None:
        """SIGTERM -> graceful drain, then stop. The handler only starts
        the drain thread (a signal handler must not block)."""

        def _on_sigterm(signum, frame):
            threading.Thread(target=self._drain_then_stop,
                             daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread

    def _drain_then_stop(self) -> None:
        self.drain()
        self.stop()

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "IngressServer":
        """Background mode: engine and HTTP threads, then return."""
        self._engine.start()
        self._start_watchdog()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self

    def serve_forever(self) -> None:
        """Foreground mode (the JobSet entry): block in the HTTP loop,
        SIGTERM draining first."""
        self._engine.start()
        self._start_watchdog()
        self._install_sigterm()
        print(f"ingress: serving on :{self.port} "
              f"(pool={self.pool.batch_size}, "
              f"speculative="
              f"{getattr(self.pool, 'draft_params', None) is not None}, "
              f"resident={isinstance(self.pool, ResidentPool)}, "
              f"paged={isinstance(self.pool, PagedPool)})", flush=True)
        self.httpd.serve_forever()

    def stop(self) -> None:
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._watchdog_stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()


__all__ = ["IngressServer"]
