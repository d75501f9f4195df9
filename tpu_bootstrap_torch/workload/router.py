"""Fleet front door — cache-aware placement with crash failover,
circuit breaking, hedging, and SLO-driven autoscaling; the port's copy of
``tpu_bootstrap/workload/router.py`` (the same HTTP contract, status
codes, terminal chunks, ``fleet_*`` series, knobs and seeded breaker
schedule; it imports the port's ``telemetry``, ``faults``, ``fleetz`` and
``serving.digest_match_len`` and nothing of the JAX package, and touches no
device: the replicas it fronts run the model).

A fleet of port replicas behind it, spawned by the autoscaler from the
port's serve entry (``{port}`` is filled in per replica)::

    python -m tpu_bootstrap_torch.workload.fleetz --replicas ... &
    python -m tpu_bootstrap_torch.workload.router --fleetz 127.0.0.1:9300 \
        --autoscale 1:2 --spawn-cmd "env WORKLOAD_MODE=serve \
        WORKLOAD_QUANT=int8 WORKLOAD_KV_QUANT=1 WORKLOAD_PAGED=1 \
        WORKLOAD_SERVE_PORT={port} python -m tpu_bootstrap_torch.workload.train"

``python -m tpu_bootstrap_torch.workload.router --replicas host:port,...``
serves the full ``/v1/generate`` contract (stream and non-stream,
priority / deadline / trace_id passthrough) and places each request on
the replica whose published ``/cachez`` digest covers the longest
leading-block prefix of the prompt (``digest_match_len``, host tier
included), tie-breaking by least load (scraped queue depth plus the
router's own in-flight count). ``--fleetz host:port`` discovers the
replica set from a running aggregator instead of a static list.

The robustness core, in the order a failure meets it:

* **Scrape plane** — a poll loop refreshes each replica's /cachez,
  /poolz and /healthz on its own cadence (TPUBC_ROUTER_SCRAPE_MS). A
  digest older than TPUBC_ROUTER_DIGEST_STALE_MS stops contributing a
  placement score: routing DEGRADES to least-queue rather than chasing
  a cache view that no longer exists.
* **Circuit breakers** — per replica, fed by both scrape and dispatch
  failures. Open with the scrape-loop's exponential backoff (base x
  2^(k-1), capped at 300s, seeded +-20% jitter — fleetz's scrape schedule),
  then a single half-open probe decides close-or-reopen. All breakers
  open answers 503 with an honest dynamic Retry-After (the soonest
  breaker's next probe).
* **Failover** — every request carries an idempotency key (the
  client's ``request_id`` or a router-minted one). A dispatch that
  dies before its first token chunk (connect refused, 5xx, stall,
  socket death) re-places on a survivor, excluding every replica
  already tried; a re-dispatch to the SAME replica attaches to the
  original stream (the ingress dedupe contract) so a retry never
  double-executes there. A death after first token cannot be restarted
  without duplicating delivered tokens, so it surfaces a terminal
  ``{"error": ..., "failover": true, "done": true}`` chunk instead of
  a dropped socket — every request gets exactly one terminal outcome.
* **Hedging** — while a dispatch waits for its first token past
  TPUBC_ROUTER_HEDGE_MS with the replica's heartbeat (`beat_age_ms`)
  stalled past the same threshold, the router launches one hedge leg
  on the next-best survivor; the first leg to produce a token commits
  and the loser is cancelled (its replica finishes the budget — the
  hedge cost is bounded by one duplicate execution, never a duplicate
  client token).
* **Drain-aware routing** — a replica answering ``draining`` stops
  receiving placements but keeps its in-flight streams; scale-down
  drains before it kills.
* **Autoscale** — ``--autoscale min:max`` runs a controller loop that
  feeds fleetz's SLO burn-rate document (the multi-window page
  condition) through hysteresis (consecutive-tick streaks plus a
  cooldown) and resizes the replica set: subprocess fleet locally
  (``--spawn-cmd``), CR replica count on k8s (``--scale-target``).

Misrouting is a SOFT signal: a placement promised by a digest scraped
before an eviction shows up as final ``cached_tokens`` short of the
promise — logged and counted (``fleet_route_misroutes_total``), never
an error (the replica recomputed; the request still completed).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import random
import shlex
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import faults
from tpu_bootstrap_torch.workload.fleetz import BACKOFF_CAP_S
from tpu_bootstrap_torch.workload.serving import digest_match_len


def _env_ms(name: str, default: float) -> float:
    try:
        return max(0.0, float(os.environ.get(name, str(default))))
    except ValueError:
        return default


def scrape_interval_s() -> float:
    """Router scrape cadence (TPUBC_ROUTER_SCRAPE_MS, default 500)."""
    return _env_ms("TPUBC_ROUTER_SCRAPE_MS", 500.0) / 1e3


def digest_stale_s() -> float:
    """Digest age beyond which placement degrades to least-queue
    (TPUBC_ROUTER_DIGEST_STALE_MS, default 3000)."""
    return _env_ms("TPUBC_ROUTER_DIGEST_STALE_MS", 3000.0) / 1e3


def breaker_base_s() -> float:
    """Circuit-breaker base open interval (TPUBC_ROUTER_BREAKER_MS,
    default 1000; doubles per consecutive failure, capped at 300s)."""
    return _env_ms("TPUBC_ROUTER_BREAKER_MS", 1000.0) / 1e3


def hedge_after_s() -> float:
    """First-token wait AND replica heartbeat age past which a hedge
    leg launches (TPUBC_ROUTER_HEDGE_MS, default 2000; 0 disables)."""
    return _env_ms("TPUBC_ROUTER_HEDGE_MS", 2000.0) / 1e3


def max_retries() -> int:
    """Failover re-dispatch budget per request
    (TPUBC_ROUTER_RETRIES, default 3)."""
    try:
        return max(0, int(os.environ.get("TPUBC_ROUTER_RETRIES", "3")))
    except ValueError:
        return 3


class CircuitBreaker:
    """Per-replica breaker: closed -> open (exponential backoff, seeded
    jitter — the fleetz scrape-loop schedule) -> half-open (exactly one
    probe) -> closed or back open. Pure state machine; every method is
    called under the router lock, so it carries no lock of its own.
    Deterministic for a fixed seed: the jitter stream is consumed once
    per failure, in failure order."""

    __slots__ = ("state", "failures", "backoff_s", "open_until",
                 "base_s", "_rng")

    def __init__(self, base_s: float, seed: int = 0x7b5c):
        self.state = "closed"
        self.failures = 0
        self.backoff_s = 0.0
        self.open_until = 0.0
        self.base_s = max(1e-3, float(base_s))
        self._rng = random.Random(seed)

    def allow(self, now: float) -> bool:
        """May a dispatch go to this replica now? An open breaker past
        its window transitions to half-open and admits exactly ONE
        probe; the probe's outcome (record_*) decides what follows."""
        if self.state == "closed":
            return True
        if self.state == "open" and now >= self.open_until:
            self.state = "half-open"
            return True
        return False

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self.backoff_s = 0.0

    def record_failure(self, now: float) -> None:
        self.failures += 1
        delay = min(self.base_s * (2 ** (self.failures - 1)),
                    BACKOFF_CAP_S)
        delay *= self._rng.uniform(0.8, 1.2)
        self.backoff_s = round(delay, 3)
        self.open_until = now + delay
        self.state = "open"

    def snapshot(self, now: float) -> dict:
        return {"state": self.state, "failures": self.failures,
                "backoff_s": self.backoff_s,
                "retry_in_s": (round(max(0.0, self.open_until - now), 3)
                               if self.state == "open" else 0.0)}


def breaker_view(failures: int, backoff_s: float, next_attempt: float,
                 now: float) -> dict:
    """The breaker-shaped health view DERIVED from scrape-backoff state
    (failures / backoff / next-attempt) — what fleetz publishes per
    replica so the aggregator and the router report one consistent
    shape even though fleetz's poll loop is not a dispatch path."""
    if failures == 0:
        state = "closed"
    elif now >= next_attempt:
        state = "half-open"
    else:
        state = "open"
    return {"state": state, "failures": failures,
            "backoff_s": backoff_s,
            "retry_in_s": (round(max(0.0, next_attempt - now), 3)
                           if state == "open" else 0.0)}


class AutoscaleController:
    """Hysteresis around the fleetz page condition. ``step()`` eats one
    SLO burn document (the ``/fleetz`` ``slo.burn`` shape: ``{replica:
    {slo: {"burn": x, "firing": bool, ...}}}``) per tick: a firing
    objective anywhere builds the up-streak, every burn under half the
    threshold builds the down-streak, the middle zone resets both. An
    action needs a full streak AND an elapsed cooldown, and scale-down
    additionally drains before the kill (the fleet driver's contract) — the
    flap-damping trio: streaks, cooldown, drain."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4, *,
                 up_ticks: int = 2, down_ticks: int = 6,
                 cooldown_s: float = 30.0, burn_threshold: float = 1.0):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min <= max, got {min_replicas}..{max_replicas}")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_ticks = max(1, up_ticks)
        self.down_ticks = max(1, down_ticks)
        self.cooldown_s = float(cooldown_s)
        self.burn_threshold = float(burn_threshold)
        self.up_streak = 0
        self.down_streak = 0
        self.cooldown_until = 0.0
        self.last: dict | None = None

    def step(self, current: int, burn: dict,
             now: float | None = None) -> int | None:
        """One evaluation; returns the new target size, or None while
        hysteresis holds. Pure in (current, burn, now) plus streak
        state — tests drive it with canned burn series."""
        now = telemetry.monotonic() if now is None else now
        burns = [d for slos in (burn or {}).values()
                 for d in slos.values() if isinstance(d, dict)]
        firing = any(d.get("firing") for d in burns)
        quiet = bool(burns) and all(
            (d.get("burn") or 0.0) <= 0.5 * self.burn_threshold
            for d in burns)
        if firing:
            self.up_streak += 1
            self.down_streak = 0
        elif quiet:
            self.down_streak += 1
            self.up_streak = 0
        else:
            self.up_streak = 0
            self.down_streak = 0
        if now < self.cooldown_until:
            return None
        if (firing and self.up_streak >= self.up_ticks
                and current < self.max_replicas):
            return self._act(current, current + 1, "scale-up", now)
        if (quiet and self.down_streak >= self.down_ticks
                and current > self.min_replicas):
            return self._act(current, current - 1, "scale-down", now)
        return None

    def _act(self, cur: int, target: int, action: str, now: float) -> int:
        self.up_streak = 0
        self.down_streak = 0
        self.cooldown_until = now + self.cooldown_s
        self.last = {"t_us": telemetry.now_us(), "action": action,
                     "from": cur, "to": target}
        return target

    def snapshot(self, now: float) -> dict:
        return {"min": self.min_replicas, "max": self.max_replicas,
                "up_streak": self.up_streak,
                "down_streak": self.down_streak,
                "cooldown_s": round(max(0.0, self.cooldown_until - now),
                                    3),
                "last": self.last}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class LocalFleetDriver:
    """Subprocess replica fleet for the local autoscale path. Spawn
    command is a shell-split template with a ``{port}`` placeholder;
    scale-down picks the youngest replica, marks it draining at the
    router (placements route around it immediately), sends SIGTERM
    (the ingress drain-then-stop path — in-flight streams finish), and
    only reaps after the grace window."""

    def __init__(self, spawn_cmd: str, router: "FleetRouter", *,
                 drain_grace_s: float = 15.0):
        self.spawn_cmd = spawn_cmd
        self.router = router
        self.drain_grace_s = drain_grace_s
        self._lock = threading.Lock()
        self._procs: dict = {}  # replica -> Popen, spawn order  # guarded-by: _lock

    def scale_to(self, n: int) -> None:
        while True:
            with self._lock:
                cur = len(self._procs)
            if cur < n:
                self._spawn_one()
            elif cur > n:
                self._drain_one()
            else:
                return

    def _spawn_one(self) -> None:
        port = _free_port()
        argv = [a.replace("{port}", str(port))
                for a in shlex.split(self.spawn_cmd)]
        proc = subprocess.Popen(argv)
        replica = f"127.0.0.1:{port}"
        with self._lock:
            self._procs[replica] = proc
        self.router.add_replica(replica)

    def _drain_one(self) -> None:
        with self._lock:
            if not self._procs:
                return
            replica, proc = next(reversed(self._procs.items()))
            del self._procs[replica]
        self.router.mark_draining(replica)
        proc.terminate()  # SIGTERM -> ingress drains, then exits

        def reap():
            try:
                proc.wait(timeout=self.drain_grace_s)
            except subprocess.TimeoutExpired:
                proc.kill()
            self.router.remove_replica(replica)

        threading.Thread(target=reap, daemon=True).start()

    def stop(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=self.drain_grace_s)
            except subprocess.TimeoutExpired:
                p.kill()


class KubeScaleDriver:
    """The k8s path: the autoscale decision becomes a replica count on
    the serving CR / Deployment (``kubectl scale``). The router never
    manages pods directly — the controller reconciles; the router just
    re-discovers the replica set from fleetz."""

    def __init__(self, target: str, *, namespace: str | None = None,
                 kubectl: str = "kubectl"):
        self.target = target
        self.namespace = namespace
        self.kubectl = kubectl

    def scale_to(self, n: int) -> None:
        argv = [self.kubectl, "scale", f"--replicas={n}", self.target]
        if self.namespace:
            argv += ["-n", self.namespace]
        subprocess.run(argv, check=False, capture_output=True,
                       timeout=30)

    def stop(self) -> None:
        pass


# Per-leg reader messages: (tag, kind, payload) with kind one of
# "ev" (a parsed stream line), "http" ((status, body-bytes) from an
# HTTP error), "err" (socket/connect death, payload=str), "eof"
# (stream ended without a done chunk — a dropped socket).


class FleetRouter:
    """The front-door daemon: scrape loop + placement + failover proxy
    + breakers + optional autoscale loop. ``start()`` backgrounds the
    threads (tests, bench); ``serve_forever()`` blocks (__main__)."""

    def __init__(self, replicas, *, port: int = 0, host: str = "0.0.0.0",
                 scrape_s: float | None = None,
                 stale_s: float | None = None,
                 breaker_s: float | None = None,
                 hedge_s: float | None = None,
                 retries: int | None = None,
                 timeout_s: float = 30.0,
                 connect_timeout_s: float = 5.0,
                 fleetz_addr: str | None = None,
                 autoscaler: AutoscaleController | None = None,
                 driver=None,
                 autoscale_poll_s: float = 2.0):
        if isinstance(replicas, str):
            replicas = [r for r in replicas.split(",") if r]
        self.scrape_s = (scrape_interval_s() if scrape_s is None
                         else float(scrape_s))
        self.stale_s = (digest_stale_s() if stale_s is None
                        else float(stale_s))
        self.breaker_s = (breaker_base_s() if breaker_s is None
                          else float(breaker_s))
        self.hedge_s = (hedge_after_s() if hedge_s is None
                        else float(hedge_s))
        self.retries = max_retries() if retries is None else int(retries)
        self.timeout_s = float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.fleetz_addr = fleetz_addr
        self.autoscaler = autoscaler
        self.driver = driver
        self.autoscale_poll_s = float(autoscale_poll_s)
        self.reg = telemetry.MetricsRegistry()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # Replica table: every per-replica signal placement reads. The
        # breaker objects are only ever touched under the lock.
        self._replicas: dict = {}  # replica -> state dict  # guarded-by: _lock
        self._rid_counter = 0  # guarded-by: _lock
        # Router-minted idempotency keys must be unique across router
        # restarts (a replica's dedupe cache may outlive us).
        self._rid_seed = f"{os.getpid():x}-{telemetry.now_us():x}"
        self._stop = threading.Event()
        # Arrival capture (/requestz?format=jsonl): every accepted
        # front-door request as a replayable arrival record, bounded.
        self._arrivals = deque(maxlen=4096)  # guarded-by: _lock
        self._scrape_thread: threading.Thread | None = None
        self._autoscale_thread: threading.Thread | None = None
        for r in (replicas or []):
            self._replicas[r] = self._fresh_state()
        if not self._replicas and not fleetz_addr and driver is None:
            raise ValueError("need --replicas, --fleetz, or a driver")

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

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

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                if path == "/routerz":
                    return self._json(200, outer.routerz_json())
                if path == "/requestz":
                    # Fleet-level arrival capture: the router's accepted
                    # front-door requests as replayable records.
                    # ?format=jsonl streams one line per arrival (the
                    # tools.sim --replay-trace input); bare wraps the
                    # same records in one JSON document.
                    fmt = parse_qs(url.query).get("format", [None])[0]
                    if fmt == "jsonl":
                        return self._jsonl(outer.arrival_records())
                    return self._json(
                        200, {"requests": outer.arrival_records()})
                if path == "/metrics":
                    body = outer.reg.to_prometheus().encode()
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
                            return self._json(
                                200, outer.reg.window_json(float(w)))
                        except ValueError:
                            return self._json(
                                400, {"error": "window must be a number"})
                    return self._json(200, outer.reg.to_json())
                if path == "/healthz":
                    now = telemetry.monotonic()
                    with outer._lock:
                        routable = sum(
                            1 for st in outer._replicas.values()
                            if not st["draining"]
                            and st["breaker"].state == "closed")
                        total = len(outer._replicas)
                    ok = routable > 0
                    return self._json(200 if ok else 503, {
                        "ok": ok, "replicas": total,
                        "routable": routable,
                        "as_of_us": telemetry.now_us()})
                return self._json(404, {"error": f"unknown path {path}"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    return self._json(
                        404, {"error": f"unknown path {self.path}"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    tokens = body["tokens"]
                    int(body["max_new"])
                    stream = bool(body.get("stream", True))
                    request_id = body.get("request_id") or ""
                    if (not isinstance(request_id, str)
                            or len(request_id) > 128):
                        raise ValueError(
                            "request_id must be a string (<= 128 chars)")
                    if (not isinstance(tokens, list)
                            or not all(isinstance(t, int)
                                       for t in tokens)):
                        raise ValueError("tokens must be a list of ints")
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                # The idempotency key EVERY dispatch carries: a retry
                # landing back on a replica that already saw the id
                # attaches to the original stream instead of running
                # the prompt again — the primitive failover rides on.
                if not request_id:
                    request_id = outer._gen_request_id()
                body["request_id"] = request_id
                outer._note_arrival(body, request_id)
                # The router always streams its replica leg: first-token
                # detection is what splits "safe to re-place" from
                # "terminal failover error", and a non-stream leg would
                # hide it. The client keeps whatever mode it asked for.
                body["stream"] = True
                outer._route(self, body, stream, request_id)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._http_thread: threading.Thread | None = None

    # ---- replica set -----------------------------------------------------

    def _fresh_state(self) -> dict:
        return {"digest": None, "digest_t": None,
                "queue_depth": None, "active": None,
                "healthz": None, "health_t": None,
                "beat_age_ms": None, "draining": False,
                "inflight": 0, "dispatches": 0, "failures": 0,
                "last_err": None,
                "breaker": CircuitBreaker(self.breaker_s)}

    def add_replica(self, replica: str) -> None:
        with self._lock:
            if replica not in self._replicas:
                self._replicas[replica] = self._fresh_state()

    def remove_replica(self, replica: str) -> None:
        with self._lock:
            self._replicas.pop(replica, None)

    def mark_draining(self, replica: str) -> None:
        """Placements route around it from this instant; its in-flight
        streams keep running to completion (nothing here touches
        them)."""
        with self._lock:
            st = self._replicas.get(replica)
            if st is not None:
                st["draining"] = True

    # ---- scrape plane ----------------------------------------------------

    def _fetch_json(self, replica: str, path: str):
        faults.fire("router.scrape")
        url = f"http://{replica}{path}"
        try:
            with urllib.request.urlopen(
                    url, timeout=self.connect_timeout_s) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            if path == "/healthz":
                # A 503 replica (draining, stalled) is alive and its
                # payload is the signal the scrape came for.
                try:
                    return json.loads(e.read().decode())
                except Exception:
                    pass
            raise

    def scrape_once(self, now: float | None = None) -> None:
        """One pass over every replica whose breaker admits a probe:
        refresh digest + queue + health, close the breaker on success,
        escalate it on failure. Runs outside the lock (a hung replica
        must not freeze placement); folds under it."""
        now = telemetry.monotonic() if now is None else now
        with self._lock:
            due = [r for r, st in self._replicas.items()
                   if st["breaker"].state == "closed"
                   or now >= st["breaker"].open_until]
        for replica in due:
            try:
                hz = self._fetch_json(replica, "/healthz")
                cz = self._fetch_json(replica, "/cachez")
                pz = self._fetch_json(replica, "/poolz")
            except Exception as e:  # noqa: BLE001 - any scrape death
                self._fold_scrape(replica, None, None, None,
                                  err=f"{type(e).__name__}: {e}")
                continue
            self._fold_scrape(replica, hz, cz, pz)
        if self.fleetz_addr is not None:
            self._discover_from_fleetz()

    def _fold_scrape(self, replica: str, hz, cz, pz,
                     err: str | None = None) -> None:
        now = telemetry.monotonic()
        with self._lock:
            st = self._replicas.get(replica)
            if st is None:
                return
            if err is not None:
                st["failures"] += 1
                st["last_err"] = err
                st["breaker"].record_failure(now)
            else:
                st["breaker"].record_success()
                st["last_err"] = None
                st["healthz"] = hz
                st["health_t"] = now
                if isinstance(hz, dict):
                    st["draining"] = bool(hz.get("draining"))
                    st["beat_age_ms"] = hz.get("beat_age_ms")
                digest = (cz or {}).get("digest") if isinstance(
                    cz, dict) else None
                if isinstance(digest, dict):
                    st["digest"] = digest
                    st["digest_t"] = now
                if isinstance(pz, dict):
                    sched = pz.get("scheduler") or {}
                    pool = pz.get("pool") or {}
                    st["queue_depth"] = sched.get("queue_depth")
                    st["active"] = pool.get("active")
        if err is not None:
            self.reg.inc("fleet_route_scrape_errors_total",
                         labels={"replica": replica})

    def _discover_from_fleetz(self) -> None:
        """Spawn-from-fleetz mode: adopt the aggregator's replica list
        (new replicas join cold; vanished ones leave unless the local
        driver owns them)."""
        try:
            doc = self._fetch_json(self.fleetz_addr, "/fleetz")
        except Exception:  # noqa: BLE001 - discovery is best-effort
            return
        seen = set((doc.get("replicas") or {}).keys())
        if not seen:
            return
        with self._lock:
            known = set(self._replicas.keys())
        for r in sorted(seen - known):
            self.add_replica(r)
        if self.driver is None:
            for r in sorted(known - seen):
                self.remove_replica(r)

    def _scrape_loop(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self._stop.wait(self.scrape_s)

    # ---- placement -------------------------------------------------------

    def _place(self, tokens, exclude=()):
        """Pick the dispatch target: longest fresh digest match, ties
        to least load (scraped queue depth + active + the router's own
        in-flight count — the between-scrapes correction). All digests
        stale -> pure least-queue (degraded). Returns (replica,
        promised_tokens, degraded) or None when no replica is
        eligible."""
        now = telemetry.monotonic()
        with self._lock:
            elig = []
            for r, st in self._replicas.items():
                if r in exclude or st["draining"]:
                    continue
                hz = st["healthz"]
                if isinstance(hz, dict) and hz.get("ok") is False:
                    continue
                if not st["breaker"].allow(now):
                    continue
                fresh = (st["digest_t"] is not None
                         and now - st["digest_t"] <= self.stale_s)
                load = ((st["queue_depth"] or 0) + (st["active"] or 0)
                        + st["inflight"])
                elig.append((r, st["digest"] if fresh else None, load))
        if not elig:
            return None
        scored = []
        for r, digest, load in elig:
            score = digest_match_len(tokens, digest) if digest else 0
            bs = int((digest or {}).get("block_size") or 0)
            # A replica always prefills at least the final prompt token
            # itself (it needs one to forward), so a full-prefix match
            # can honestly promise at most len - 1 cached tokens.
            scored.append((-score, load, r,
                           min(score * bs, len(tokens) - 1)))
        scored.sort()
        degraded = all(d is None for _, d, _ in elig)
        if degraded:
            self.reg.inc("fleet_route_degraded_total")
        neg_score, _load, replica, promised = scored[0]
        return replica, promised, degraded

    def retry_after_s(self) -> int:
        """Honest dynamic Retry-After for the all-breakers-open 503:
        the soonest half-open probe, clamped to [1, 30]s."""
        now = telemetry.monotonic()
        with self._lock:
            waits = [st["breaker"].open_until - now
                     for st in self._replicas.values()
                     if st["breaker"].state == "open"]
        if not waits:
            return 1
        return int(min(max(1.0, min(waits) + 0.5), 30.0))

    # ---- arrival capture -------------------------------------------------

    def _note_arrival(self, body: dict, request_id: str) -> None:
        """One accepted front-door request -> one replayable arrival
        record (the same flat shape RequestLog.arrivals() exports, with
        the router's idempotency key standing in for the engine rid)."""
        try:
            max_new = int(body.get("max_new") or 0)
        except (TypeError, ValueError):
            max_new = 0
        rec = {"rid": request_id,
               "t_arrival_us": telemetry.now_us(),
               "prompt_len": len(body.get("tokens") or ()),
               "max_new": max_new,
               "priority": body.get("priority") or 0,
               "deadline": body.get("deadline_ms"),
               "trace_id": body.get("trace_id") or ""}
        with self._lock:
            self._arrivals.append(rec)

    def arrival_records(self) -> list:
        """The /requestz?format=jsonl records, arrival order."""
        with self._lock:
            return [dict(r) for r in self._arrivals]

    # ---- dispatch + failover ---------------------------------------------

    def _gen_request_id(self) -> str:
        with self._lock:
            self._rid_counter += 1
            return f"rtr-{self._rid_seed}-{self._rid_counter}"

    def _read_leg(self, tag: str, replica: str, body: dict,
                  out_q: "queue.Queue", cancel: threading.Event) -> None:
        """One replica leg: POST the request, push every parsed stream
        line into the orchestrator's queue. Never raises — every exit
        becomes a message (the orchestrator owns terminal-outcome
        accounting)."""
        try:
            faults.fire("router.dispatch")
            rq = urllib.request.Request(
                f"http://{replica}/v1/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(
                    rq, timeout=self.timeout_s) as resp:
                for raw in resp:
                    if cancel.is_set():
                        out_q.put((tag, "err", "cancelled"))
                        return
                    if not raw.strip():
                        continue
                    ev = json.loads(raw)
                    out_q.put((tag, "ev", ev))
                    if ev.get("done"):
                        return
            out_q.put((tag, "eof", None))
        except urllib.error.HTTPError as e:
            try:
                payload = e.read()
            except Exception:  # noqa: BLE001
                payload = b""
            out_q.put((tag, "http",
                       (e.code, payload, dict(e.headers or {}))))
        except Exception as e:  # noqa: BLE001 - leg death is a message
            out_q.put((tag, "err", f"{type(e).__name__}: {e}"))

    def _note_dispatch(self, replica: str, delta: int) -> None:
        with self._lock:
            st = self._replicas.get(replica)
            if st is not None:
                st["inflight"] += delta
                if delta > 0:
                    st["dispatches"] += 1

    def _beat_stalled(self, replica: str) -> bool:
        with self._lock:
            st = self._replicas.get(replica)
            if st is None:
                return True
            age = st["beat_age_ms"]
        return age is None or age > self.hedge_s * 1e3

    def _breaker_fail(self, replica: str, err: str) -> None:
        now = telemetry.monotonic()
        with self._lock:
            st = self._replicas.get(replica)
            if st is not None:
                st["failures"] += 1
                st["last_err"] = err
                st["breaker"].record_failure(now)
        self.reg.inc("fleet_route_dispatch_errors_total",
                     labels={"replica": replica})

    def _breaker_ok(self, replica: str) -> None:
        with self._lock:
            st = self._replicas.get(replica)
            if st is not None:
                st["breaker"].record_success()

    def _route(self, handler, body: dict, stream: bool,
               request_id: str) -> None:
        """The per-request state machine: place -> proxy (with hedge)
        -> on pre-first-token failure re-place on survivors -> exactly
        one terminal outcome, whatever dies underneath."""
        self.reg.inc("fleet_route_requests_total")
        tokens = body["tokens"]
        tried: set = set()
        writer = _ClientWriter(handler, stream, request_id)
        attempts = 0
        last_err = "no replica available"
        while attempts <= self.retries:
            placement = self._place(tokens, exclude=tried)
            if placement is None:
                break
            replica, promised, _degraded = placement
            if attempts > 0:
                self.reg.inc("fleet_route_failovers_total")
            attempts += 1
            outcome, detail = self._proxy_once(
                replica, body, request_id, promised, tried, writer)
            if outcome == "done":
                return
            if outcome == "client-error":
                code, payload, headers = detail
                return writer.passthrough(code, payload, headers)
            if outcome == "midstream":
                # Tokens already reached the client: restarting would
                # duplicate them. Exactly-one-terminal-outcome says:
                # close with an explicit failover error chunk.
                self.reg.inc("fleet_route_midstream_failovers_total")
                return writer.terminal_error(detail, failover=True)
            last_err = detail  # "retry": keep placing on survivors
        self.reg.inc("fleet_route_unroutable_total")
        if writer.started:
            return writer.terminal_error(
                f"no replica available: {last_err}", failover=True)
        handler._json(
            503, {"error": f"no replica available: {last_err}",
                  "request_id": request_id},
            headers={"Retry-After": str(self.retry_after_s())})

    def _proxy_once(self, replica: str, body: dict, request_id: str,
                    promised_tokens: int, tried: set,
                    writer: "_ClientWriter"):
        """One placement: primary leg, optional hedge leg, commit at
        first token chunk. Returns (outcome, detail) with outcome one
        of "done", "retry" (safe to re-place: no token reached the
        client), "midstream" (committed leg died after tokens flowed),
        "client-error" ((code, body, headers) passthrough)."""
        tried.add(replica)
        out_q: queue.Queue = queue.Queue()
        cancels = {"p": threading.Event()}
        legs = {"p": replica}
        dispatched = [replica]  # every replica owed a -1 at exit
        self._note_dispatch(replica, +1)
        threading.Thread(
            target=self._read_leg,
            args=("p", replica, body, out_q, cancels["p"]),
            daemon=True).start()
        committed: str | None = None
        hedged = False
        cached_seen = 0
        t0 = telemetry.monotonic()
        try:
            while True:
                try:
                    tag, kind, payload = out_q.get(timeout=0.05)
                except queue.Empty:
                    if (committed is None and not hedged
                            and self.hedge_s > 0
                            and telemetry.monotonic() - t0 > self.hedge_s
                            and self._beat_stalled(replica)):
                        hedged = self._launch_hedge(
                            body, tried, legs, cancels, out_q,
                            dispatched)
                    continue
                if tag not in legs:
                    continue
                if kind == "ev":
                    res = self._on_event(
                        tag, payload, legs, cancels, writer,
                        committed, request_id)
                    committed, finished, detail = res
                    if committed is not None:
                        cached_seen = max(
                            cached_seen,
                            payload.get("cached_tokens") or 0)
                    if finished is not None:
                        if finished == "done":
                            self._breaker_ok(legs.get(tag, replica))
                            self._misroute_check(
                                legs.get(tag, replica),
                                promised_tokens, cached_seen)
                        return finished, detail
                elif kind == "http":
                    code, payload_b, headers = payload
                    res = self._on_http_error(
                        tag, code, payload_b, headers, legs, committed)
                    if res is not None:
                        return res
                else:  # "err" / "eof": the leg's socket died
                    msg = payload if kind == "err" else "stream ended " \
                        "without a terminal chunk"
                    leg_replica = legs.pop(tag)
                    if msg != "cancelled":
                        self._breaker_fail(leg_replica, msg)
                    if tag == committed:
                        return "midstream", (
                            f"replica {leg_replica} died mid-stream: "
                            f"{msg}")
                    if not legs:
                        return "retry", msg
        finally:
            for ev in cancels.values():
                ev.set()
            for leg_replica in dispatched:
                self._note_dispatch(leg_replica, -1)

    def _launch_hedge(self, body: dict, tried: set, legs: dict,
                      cancels: dict, out_q: "queue.Queue",
                      dispatched: list) -> bool:
        """Dispatch one hedge leg to the next-best survivor; the
        request_id rides along, so if both legs somehow land on one
        replica the second attaches instead of re-running."""
        placement = self._place(body["tokens"], exclude=tried)
        if placement is None:
            return True  # nobody to hedge to; don't retry every tick
        hedge_replica, _promised, _deg = placement
        tried.add(hedge_replica)
        legs["h"] = hedge_replica
        cancels["h"] = threading.Event()
        dispatched.append(hedge_replica)
        self._note_dispatch(hedge_replica, +1)
        self.reg.inc("fleet_route_hedges_total")
        threading.Thread(
            target=self._read_leg,
            args=("h", hedge_replica, body, out_q, cancels["h"]),
            daemon=True).start()
        return True

    def _on_event(self, tag: str, ev: dict, legs: dict, cancels: dict,
                  writer: "_ClientWriter", committed, request_id):
        """Fold one stream line. Returns (committed, finished, detail);
        finished None while the stream is live."""
        if ev.get("queued"):
            # Forward the primary's queued ack only (the client sees
            # one queue position, not one per leg).
            if tag == "p" and committed is None:
                writer.chunk(ev)
            return committed, None, None
        if committed is None:
            # First substantive chunk anywhere: did this leg fail
            # before producing anything? A draining/error terminal
            # chunk with no tokens is a replica-side refusal — safe to
            # re-place (nothing reached the client).
            if ev.get("done") and not ev.get("tokens"):
                leg_replica = legs.pop(tag)
                if ev.get("draining"):
                    self.mark_draining(leg_replica)
                    detail = f"replica {leg_replica} draining"
                elif ev.get("error"):
                    detail = (f"replica {leg_replica} errored: "
                              f"{ev['error']}")
                    self._breaker_fail(leg_replica, ev["error"])
                else:
                    # Legitimate empty completion (max_new hit
                    # instantly / deadline shed): commit and finish.
                    legs[tag] = leg_replica
                    committed = tag
                    writer.chunk(ev)
                    return committed, "done", None
                if not legs:
                    return None, "retry", detail
                return None, None, None
            # Token bearing: COMMIT this leg, cancel the rest.
            committed = tag
            for other, cancel in cancels.items():
                if other != tag:
                    cancel.set()
            for other in [t for t in legs if t != tag]:
                del legs[other]
        if tag != committed:
            return committed, None, None
        writer.chunk(ev)
        if ev.get("done"):
            return committed, "done", None
        return committed, None, None

    def _on_http_error(self, tag: str, code: int, payload: bytes,
                       headers: dict, legs: dict, committed):
        """An HTTP-level refusal from one leg (the connection worked;
        the replica said no). Only reachable pre-commit — a committed
        leg already holds a 200."""
        leg_replica = legs.pop(tag)
        if code == 400:
            # The replica's validation verdict is authoritative and
            # deterministic: every replica would refuse identically.
            return "client-error", (code, payload, headers)
        if code == 503:
            # Draining / shutting down: route around, not a fault.
            self.mark_draining(leg_replica)
            detail = f"replica {leg_replica} answered 503"
        elif code == 429:
            # Pressure, not a fault: the breaker stays closed, but
            # this request looks elsewhere.
            detail = f"replica {leg_replica} throttled (429)"
        else:
            detail = f"replica {leg_replica} answered {code}"
            self._breaker_fail(leg_replica, detail)
        if not legs:
            return "retry", detail
        return None

    def _misroute_check(self, replica: str, promised_tokens: int,
                        cached_tokens: int) -> None:
        """A digest scraped before an eviction can promise blocks the
        replica no longer holds. That is a SOFT signal — the replica
        recomputed and the request completed — so it logs and counts,
        never errors."""
        if promised_tokens <= 0 or cached_tokens >= promised_tokens:
            return
        self.reg.inc("fleet_route_misroutes_total")
        print(f"router: misroute on {replica}: digest promised "
              f">={promised_tokens} cached tokens, replica reported "
              f"{cached_tokens} (stale digest; served via recompute)",
              file=sys.stderr)

    # ---- views -----------------------------------------------------------

    def routerz_json(self) -> dict:
        now = telemetry.monotonic()
        with self._lock:
            snap = {}
            for r, st in self._replicas.items():
                snap[r] = {
                    "breaker": st["breaker"].snapshot(now),
                    "draining": st["draining"],
                    "digest_age_ms": (
                        None if st["digest_t"] is None
                        else round((now - st["digest_t"]) * 1e3, 1)),
                    "digest_blocks": (st["digest"] or {}).get("blocks"),
                    "queue_depth": st["queue_depth"],
                    "active": st["active"],
                    "inflight": st["inflight"],
                    "beat_age_ms": st["beat_age_ms"],
                    "dispatches": st["dispatches"],
                    "failures": st["failures"],
                    "last_err": st["last_err"],
                }
        out = {
            "as_of_us": telemetry.now_us(),
            "scrape_ms": round(self.scrape_s * 1e3, 1),
            "digest_stale_ms": round(self.stale_s * 1e3, 1),
            "hedge_ms": round(self.hedge_s * 1e3, 1),
            "retries": self.retries,
            "replicas": snap,
        }
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.snapshot(now)
        return out

    def _refresh_gauges(self) -> None:
        with self._lock:
            total = len(self._replicas)
            open_b = sum(1 for st in self._replicas.values()
                         if st["breaker"].state == "open")
        self.reg.set_gauge("fleet_route_replicas", total)
        self.reg.set_gauge("fleet_route_breakers_open", open_b)

    # ---- autoscale loop --------------------------------------------------

    def _fetch_burn(self):
        if self.fleetz_addr is None:
            return None
        try:
            doc = self._fetch_json(self.fleetz_addr, "/fleetz")
        except Exception:  # noqa: BLE001 - burn fetch is best-effort
            return None
        return ((doc.get("slo") or {}).get("burn")
                if isinstance(doc, dict) else None)

    def autoscale_once(self, burn=None, now: float | None = None) -> None:
        """One controller tick (the loop calls it; tests drive it with
        canned burn documents)."""
        if self.autoscaler is None or self.driver is None:
            return
        if burn is None:
            burn = self._fetch_burn()
        if burn is None:
            return
        with self._lock:
            current = sum(1 for st in self._replicas.values()
                          if not st["draining"])
        target = self.autoscaler.step(current, burn, now)
        if target is not None:
            action = "up" if target > current else "down"
            self.reg.inc("fleet_autoscale_events_total",
                         labels={"action": action})
            self.reg.set_gauge("fleet_autoscale_target", target)
            self.driver.scale_to(target)

    def _autoscale_loop(self) -> None:
        while not self._stop.is_set():
            self.autoscale_once()
            self._refresh_gauges()
            self._stop.wait(self.autoscale_poll_s)

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "FleetRouter":
        self._scrape_thread = threading.Thread(target=self._scrape_loop,
                                               daemon=True)
        self._scrape_thread.start()
        if self.autoscaler is not None:
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop, daemon=True)
            self._autoscale_thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self

    def serve_forever(self) -> None:
        self._scrape_thread = threading.Thread(target=self._scrape_loop,
                                               daemon=True)
        self._scrape_thread.start()
        if self.autoscaler is not None:
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop, daemon=True)
            self._autoscale_thread.start()
        with self._lock:
            n = len(self._replicas)
        print(f"router: fronting {n} replica(s) on :{self.port} "
              f"(scrape {self.scrape_s * 1e3:.0f}ms, "
              f"digest stale {self.stale_s * 1e3:.0f}ms)")
        self.httpd.serve_forever()

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.driver is not None:
            self.driver.stop()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5)


class _ClientWriter:
    """One request's client-side output discipline: stream mode writes
    chunked JSON lines as they commit; non-stream accumulates and
    answers once. ``started`` flips on the first byte a retry could
    not take back — the line between "re-place silently" and "terminal
    failover error chunk". Only the orchestrator thread touches it."""

    def __init__(self, handler, stream: bool, request_id: str):
        self.h = handler
        self.stream = stream
        self.request_id = request_id
        self.started = False
        self.generated: list = []
        self.final_ev: dict = {}
        self.broken = False

    def _line(self, ev: dict, failover: bool = False) -> dict:
        return {"tokens": ev.get("tokens") or [],
                **({"done": True} if ev.get("done") else {}),
                **({"queued": True,
                    "queue_position": ev["queue_position"]}
                   if ev.get("queued") else {}),
                **({"cached_tokens": ev["cached_tokens"]}
                   if "cached_tokens" in ev else {}),
                **({"timing": ev["timing"]}
                   if ev.get("timing") else {}),
                **({"trace_id": ev["trace_id"]}
                   if ev.get("trace_id") else {}),
                **({"request_id": self.request_id}
                   if self.request_id else {}),
                **({"draining": True} if ev.get("draining") else {}),
                **({"deadline_exceeded": True}
                   if ev.get("deadline_exceeded") else {}),
                **({"error": ev["error"]} if ev.get("error") else {}),
                **({"failover": True} if failover else {})}

    def chunk(self, ev: dict) -> None:
        if self.stream:
            self._write(self._line(ev))
        else:
            self.generated.extend(ev.get("tokens") or [])
            if ev.get("done"):
                self.final_ev = ev
        if ev.get("tokens") or ev.get("done"):
            self.started = True
        if ev.get("done") and not self.stream:
            self._finish_nonstream()
        elif ev.get("done") and self.stream:
            self._close_stream()

    def terminal_error(self, msg: str, failover: bool = False) -> None:
        """EXACTLY one terminal outcome, whatever already happened:
        stream mode appends a final error chunk; non-stream answers a
        502 carrying the partial tokens (work done is work kept)."""
        if self.stream:
            self._write(self._line({"tokens": [], "done": True,
                                    "error": msg}, failover=failover))
            self._close_stream()
        else:
            out = self._line({"tokens": self.generated, "done": True,
                              "error": msg}, failover=failover)
            self.h._json(502, out)

    def passthrough(self, code: int, payload: bytes,
                    headers: dict) -> None:
        """Forward a replica's refusal verbatim (400s: every replica
        would refuse identically, and the body names the reason)."""
        self.h.send_response(code)
        self.h.send_header("Content-Type", "application/json")
        self.h.send_header("Content-Length", str(len(payload)))
        for k in ("Retry-After",):
            if k in headers:
                self.h.send_header(k, headers[k])
        self.h.end_headers()
        self.h.wfile.write(payload)

    def _finish_nonstream(self) -> None:
        ev = dict(self.final_ev)
        ev["tokens"] = self.generated
        code = 200
        if ev.get("deadline_exceeded"):
            code = 504
        elif ev.get("draining"):
            code = 503
        self.h._json(code, self._line(ev))

    def _write(self, obj: dict) -> None:
        if self.broken:
            return
        line = json.dumps(obj).encode() + b"\n"
        try:
            if not self.started:
                self.h.send_response(200)
                self.h.send_header("Content-Type", "application/jsonl")
                self.h.send_header("Transfer-Encoding", "chunked")
                self.h.end_headers()
            self.h.wfile.write(
                f"{len(line):x}\r\n".encode() + line + b"\r\n")
            self.h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            self.broken = True  # client left; replica finishes budget
        self.started = True

    def _close_stream(self) -> None:
        if self.broken:
            return
        try:
            self.h.wfile.write(b"0\r\n\r\n")
            self.h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            self.broken = True


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m tpu_bootstrap_torch.workload.router",
        description="Fleet front door: cache-aware placement, crash "
                    "failover, circuit breakers, SLO autoscaling.")
    p.add_argument("--replicas", default="",
                   help="comma-separated host:port list (optional when "
                        "--fleetz or --spawn-cmd supplies the fleet)")
    p.add_argument("--fleetz", default=None,
                   help="host:port of a fleetz aggregator: discover "
                        "replicas and pull SLO burn rates from it")
    p.add_argument("--port", type=int, default=9400)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                   help="enable the autoscale controller loop")
    p.add_argument("--spawn-cmd", default=None,
                   help="local replica spawn template with a {port} "
                        "placeholder (subprocess fleet driver)")
    p.add_argument("--scale-target", default=None,
                   help="kubectl scale target (e.g. deployment/serve) "
                        "— the k8s CR-replica-count driver")
    p.add_argument("--namespace", default=None)
    p.add_argument("--up-ticks", type=int, default=2)
    p.add_argument("--down-ticks", type=int, default=6)
    p.add_argument("--cooldown-s", type=float, default=30.0)
    args = p.parse_args(argv)
    autoscaler = None
    driver = None
    if args.autoscale:
        lo, _, hi = args.autoscale.partition(":")
        autoscaler = AutoscaleController(
            int(lo), int(hi or lo), up_ticks=args.up_ticks,
            down_ticks=args.down_ticks, cooldown_s=args.cooldown_s)
        if args.autoscale and not args.fleetz:
            p.error("--autoscale needs --fleetz for burn rates")
    router = FleetRouter(args.replicas, port=args.port, host=args.host,
                         fleetz_addr=args.fleetz, autoscaler=autoscaler)
    if args.spawn_cmd:
        driver = LocalFleetDriver(args.spawn_cmd, router)
    elif args.scale_target:
        driver = KubeScaleDriver(args.scale_target,
                                 namespace=args.namespace)
    router.driver = driver
    if driver is not None and autoscaler is not None:
        driver.scale_to(autoscaler.min_replicas)
    router.serve_forever()


if __name__ == "__main__":
    main()


__all__ = ["FleetRouter", "CircuitBreaker", "AutoscaleController",
           "LocalFleetDriver", "KubeScaleDriver", "breaker_view"]
