"""Fleet telemetry aggregator — one pane over N serving replicas, the
port's copy of ``tpu_bootstrap/workload/fleetz.py`` (the same routes, JSON
keys, ``fleet_*`` series, knobs, burn-rate math and seeded backoff; it runs
on the port's ``telemetry`` and imports nothing of the JAX package, and no
device: the replicas it scrapes run the model).

``python -m tpu_bootstrap_torch.workload.fleetz --replicas host:port,...``
polls each replica's /healthz, /poolz, /cachez, /metrics.json and
/traces.json (per-replica exponential backoff on failures, same
schedule the native controller's workload scraper uses), tracks
health-state transitions and scrape staleness, and serves:

  /fleetz        merged JSON: per-replica health / queue depth / block
                 accounting / cache digest, fleet totals, SLO burn
                 rates, and an alerts block with firing/resolved
                 transitions
  /metrics       federated Prometheus text: every replica's series
                 re-labeled with replica="host:port", plus the
                 aggregator's own fleet_* series
  /metrics.json  the aggregator's own registry (fleet_* series)
  /traces.json   spans from ALL replicas stitched by trace id into one
                 timeline (?chrome=1 renders Chrome trace-event JSON,
                 one pid per replica — the Dapper out-of-band
                 collection pattern: replicas buffer locally, the
                 daemon joins)
  /healthz       the aggregator's own liveness + fleet health counts

The burn-rate engine is SRE-workbook multi-window: each objective's
error rate (fraction of scraped samples violating the objective) over
a short and a long window, divided by the error budget (1 - target).
An alert fires only when EVERY window burns above the threshold —
equivalently, when the minimum across windows exceeds it — so a brief
spike (long window still calm) and an old incident (short window
recovered) both stay quiet. This is the scale-up/scale-down signal the
fleet controller loop consumes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tpu_bootstrap_torch import telemetry

# Scraped per replica, in this order. healthz/metrics are REQUIRED for
# a scrape to count as a success; the rest are optional (a train-slice
# metrics server has no /poolz — the fleet poller treats every replica
# uniformly and records what it finds).
SCRAPE_PATHS = ("/healthz", "/metrics.json", "/poolz", "/cachez",
                "/traces.json")
_OPTIONAL = {"/poolz", "/cachez", "/traces.json"}
_PATH_KEY = {"/healthz": "healthz", "/metrics.json": "metrics",
             "/poolz": "poolz", "/cachez": "cachez",
             "/traces.json": "traces"}

BACKOFF_CAP_S = 300.0  # native scrape loop parity


def poll_interval_s() -> float:
    """Fleet poll cadence (TPUBC_FLEET_POLL_MS, default 2000)."""
    try:
        return max(0.05, float(os.environ.get(
            "TPUBC_FLEET_POLL_MS", "2000")) / 1e3)
    except ValueError:
        return 2.0


# ---- SLO objectives + burn rates ---------------------------------------


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One objective: samples of ``key`` (a /metrics.json entry) are BAD
    when ``comparator`` ("gt"/"lt") holds against ``threshold``; the
    error budget is 1 - target (target 0.99 -> 1% of samples may be
    bad before burn rate 1.0)."""
    name: str
    key: str
    comparator: str          # "gt" | "lt"
    threshold: float
    target: float = 0.99

    def bad(self, value: float) -> bool:
        if self.comparator == "gt":
            return value > self.threshold
        return value < self.threshold


DEFAULT_OBJECTIVES = (
    SloObjective("ttft_p99", "serve_ttft_ms_p99", "gt", 2500.0),
    SloObjective("queue_depth", "serve_queue_depth", "gt", 64.0),
    SloObjective("goodput", "serve_admitted_ratio", "lt", 0.5, target=0.9),
)


def parse_objective(spec: str) -> SloObjective:
    """``name:key:gt|lt:threshold[:target]`` -> SloObjective (the
    --slo flag's grammar)."""
    parts = spec.split(":")
    if len(parts) not in (4, 5):
        raise ValueError(
            f"--slo wants name:key:gt|lt:threshold[:target], got {spec!r}")
    name, key, comp, threshold = parts[:4]
    if comp not in ("gt", "lt"):
        raise ValueError(f"comparator must be gt or lt, got {comp!r}")
    target = float(parts[4]) if len(parts) == 5 else 0.99
    if not 0.0 < target < 1.0:
        raise ValueError(f"target must be in (0, 1), got {target}")
    return SloObjective(name, key, comp, float(threshold), target)


class SloEngine:
    """Multi-window burn rates over per-(replica, objective) sample
    rings, with firing/resolved alert transitions. Thread-safe; fed by
    the aggregator's scrape loop, read by /fleetz renders."""

    def __init__(self, objectives=None, windows=(300.0, 3600.0),
                 burn_threshold: float = 1.0, ring: int | None = None):
        self.objectives = tuple(objectives
                                if objectives is not None
                                else DEFAULT_OBJECTIVES)
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows:
            raise ValueError("need at least one burn-rate window")
        self.burn_threshold = float(burn_threshold)
        # Burn math needs history even when the process-wide ring knob
        # is 0 (that knob exists to keep the DATA PLANE byte-identical;
        # this engine lives in its own daemon), hence the `or 256`.
        self._cap = (telemetry.ring_capacity() or 256) if ring is None \
            else max(1, ring)
        self._lock = threading.Lock()
        self._rings: dict = {}        # (replica, slo) -> deque[(t, value)]  # guarded-by: _lock
        self._firing: dict = {}       # (replica, slo) -> since_us  # guarded-by: _lock
        self._transitions = deque(maxlen=64)  # guarded-by: _lock

    def record(self, replica: str, metrics: dict,
               t: float | None = None) -> None:
        """Feed one scraped /metrics.json instant: every objective whose
        key is present and numeric gains a sample."""
        t = telemetry.monotonic() if t is None else t
        with self._lock:
            for obj in self.objectives:
                v = metrics.get(obj.key)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    continue
                k = (replica, obj.name)
                ring = self._rings.get(k)
                if ring is None:
                    ring = self._rings[k] = deque(maxlen=self._cap)
                ring.append((t, float(v)))

    def _burn_locked(self, obj: SloObjective, ring,
                     window_s: float, now: float):
        """Burn rate over one window, or None with zero samples in it."""
        cutoff = now - window_s
        total = bad = 0
        for t, v in ring:
            if t <= cutoff:
                continue
            total += 1
            if obj.bad(v):
                bad += 1
        if total == 0:
            return None
        return (bad / total) / max(1.0 - obj.target, 1e-9)

    def evaluate(self, now: float | None = None) -> dict:
        """Per-(replica, objective) burn rates: each window's burn, the
        combined burn (min across windows with samples — the page
        condition "ALL windows exceed" ⇔ "min exceeds"), and the
        firing flag; updates alert state and records transitions."""
        now = telemetry.monotonic() if now is None else now
        out: dict = {}
        with self._lock:
            by_obj = {o.name: o for o in self.objectives}
            for (replica, slo), ring in sorted(self._rings.items()):
                obj = by_obj.get(slo)
                if obj is None or not ring:
                    continue
                per_w = {f"{int(w)}s": self._burn_locked(obj, ring, w, now)
                         for w in self.windows}
                with_samples = [b for b in per_w.values() if b is not None]
                burn = min(with_samples) if with_samples else None
                firing = burn is not None and burn > self.burn_threshold
                k = (replica, slo)
                was = k in self._firing
                if firing and not was:
                    self._firing[k] = telemetry.now_us()
                    self._transitions.append({
                        "t_us": telemetry.now_us(), "replica": replica,
                        "slo": slo, "event": "firing",
                        "burn": round(burn, 4)})
                elif not firing and was:
                    del self._firing[k]
                    self._transitions.append({
                        "t_us": telemetry.now_us(), "replica": replica,
                        "slo": slo, "event": "resolved",
                        "burn": None if burn is None else round(burn, 4)})
                out.setdefault(replica, {})[slo] = {
                    "burn": None if burn is None else round(burn, 6),
                    "windows": {w: (None if b is None else round(b, 6))
                                for w, b in per_w.items()},
                    "firing": firing,
                }
            return out

    def alerts(self) -> dict:
        with self._lock:
            return {
                "firing": [{"replica": r, "slo": s, "since_us": t}
                           for (r, s), t in sorted(self._firing.items())],
                "transitions": list(self._transitions),
            }


# ---- federation helpers -------------------------------------------------


def _relabel(key: str, replica: str) -> tuple:
    """A replica /metrics.json key -> (family, federated key). The json
    exposition appends histogram suffixes AFTER the label braces
    (``name{k="v"}_p99``); Prometheus wants them inside the family
    (``name_p99{k="v",replica="..."}``), so the suffix hops over."""
    rep = f'replica="{replica}"'
    if "{" in key and "}" in key:
        family, rest = key.split("{", 1)
        labels, suffix = rest.rsplit("}", 1)
        family += suffix
        return family, f"{family}{{{labels},{rep}}}"
    return key, f"{key}{{{rep}}}"


def flatten_window(doc: dict) -> dict:
    """A replica ``/metrics.json?window=N`` document flattened back to
    the flat ``{key: number}`` shape ``federate()`` speaks: value
    series contribute their instant plus windowed delta/rate
    (``_window_delta`` / ``_window_rate_per_sec``), histograms their
    windowed count/sum deltas and window-local quantiles. Suffixes ride
    AFTER any label braces — ``_relabel`` hops them back inside the
    family, same as the lifetime exposition's histogram suffixes."""
    out: dict = {}
    for name, e in (doc.get("series") or {}).items():
        if not isinstance(e, dict):
            continue
        if "now" in e:  # value series
            if isinstance(e.get("now"), (int, float)):
                out[name] = e["now"]
            for src, suffix in (("delta", "_window_delta"),
                                ("rate_per_sec", "_window_rate_per_sec")):
                if isinstance(e.get(src), (int, float)):
                    out[f"{name}{suffix}"] = e[src]
        else:  # histogram series
            for src, suffix in (("count_delta", "_window_count_delta"),
                                ("sum_delta", "_window_sum_delta"),
                                ("p50", "_window_p50"),
                                ("p99", "_window_p99"),
                                ("rate_per_sec", "_window_rate_per_sec")):
                if isinstance(e.get(src), (int, float)):
                    out[f"{name}{suffix}"] = e[src]
    return out


def federate(per_replica: dict, own: str = "") -> str:
    """Prometheus text for the whole fleet: every replica's scraped
    /metrics.json instant re-labeled with replica=..., grouped per
    family with one TYPE line (counter iff the family ends in _total,
    else gauge — histogram components arrive pre-flattened as _count /
    _sum / quantile gauges), followed by the aggregator's own series."""
    entries = []            # (family, key, value)
    for replica in sorted(per_replica):
        for key, v in (per_replica[replica] or {}).items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            family, fed = _relabel(key, replica)
            entries.append((family, fed, v))
    lines = []
    typed = set()
    for family, key, v in sorted(entries):
        counter = family.endswith("_total")
        fam = family[:-6] if counter else family
        if fam not in typed:
            typed.add(fam)
            lines.append(f"# TYPE {fam} {'counter' if counter else 'gauge'}")
        lines.append(f"{key} {v:g}" if isinstance(v, float)
                     else f"{key} {v}")
    text = "\n".join(lines) + ("\n" if lines else "")
    return text + own


def stitch(per_replica: dict) -> dict:
    """Spans from N replicas joined by trace id into one document: every
    span keeps its origin as a ``replica`` attr, the ``traces`` map
    shows which replicas each trace id crossed (the cross-replica join
    a single replica's buffer cannot see), and the span list comes back
    globally ordered by (trace_id, start_us)."""
    spans = []
    dropped = 0
    for replica in sorted(per_replica):
        doc = per_replica[replica] or {}
        dropped += int(doc.get("dropped") or 0)
        for s in doc.get("spans") or []:
            s = dict(s)
            s["attrs"] = dict(s.get("attrs") or {})
            s["attrs"]["replica"] = replica
            spans.append(s)
    spans.sort(key=lambda s: (s.get("trace_id") or "",
                              s.get("start_us") or 0))
    traces: dict = {}
    for s in spans:
        t = traces.setdefault(s.get("trace_id") or "", {
            "spans": 0, "replicas": []})
        t["spans"] += 1
        r = s["attrs"]["replica"]
        if r not in t["replicas"]:
            t["replicas"].append(r)
    return {
        "process": "tpubc-fleetz",
        "stitched": True,
        "replicas": sorted(per_replica),
        "dropped": dropped,
        "traces": traces,
        "spans": spans,
    }


def stitch_chrome(per_replica: dict) -> dict:
    """The stitched timeline as Chrome trace-event JSON: one pid per
    replica (named via process_name metas), rows grouped by trace id
    with the same crc32 tid rule both in-process tracers use — so a
    request that hopped replicas renders as one aligned row group."""
    doc = stitch(per_replica)
    pids = {r: i + 1 for i, r in enumerate(doc["replicas"])}
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": f"replica {r}"}}
              for r, pid in pids.items()]
    for s in doc["spans"]:
        args = {"trace_id": s.get("trace_id"), "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id")}
        args.update(s.get("attrs") or {})
        events.append({
            "name": s.get("name"),
            "cat": "tpubc-fleetz",
            "ph": "X",
            "ts": s.get("start_us") or 0,
            "dur": s.get("dur_us") or 0,
            "pid": pids[s["attrs"]["replica"]],
            "tid": telemetry._chrome_tid(s.get("trace_id") or ""),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---- the aggregator daemon ---------------------------------------------


class FleetAggregator:
    """Scrape N replicas on a backoff-aware schedule, keep the latest
    good snapshot of each, and serve the merged views. ``start()`` runs
    the poll + HTTP threads in the background (tests, bench);
    ``serve_forever()`` blocks (the __main__ entry)."""

    def __init__(self, replicas, *, port: int = 0, host: str = "0.0.0.0",
                 poll_s: float | None = None, objectives=None,
                 windows=(300.0, 3600.0), burn_threshold: float = 1.0,
                 timeout_s: float = 5.0, stale_after_s: float | None = None):
        if isinstance(replicas, str):
            replicas = [r for r in replicas.split(",") if r]
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("need at least one replica (host:port)")
        self.poll_s = poll_interval_s() if poll_s is None else float(poll_s)
        self.timeout_s = float(timeout_s)
        # A replica whose last good scrape is older than this renders as
        # "stale" even if the most recent attempt hasn't failed yet.
        self.stale_after_s = (max(3.0 * self.poll_s, 10.0)
                              if stale_after_s is None
                              else float(stale_after_s))
        self.reg = telemetry.MetricsRegistry()
        self.slo = SloEngine(objectives=objectives, windows=windows,
                             burn_threshold=burn_threshold)
        self._lock = threading.Lock()
        # per-replica scrape state; every field below is replaced (never
        # mutated in place) so renders can copy the dict under the lock
        # and read it lock-free afterwards.
        self._state: dict = {r: {  # guarded-by: _lock
            "state": "init", "failures": 0, "next_attempt": 0.0,
            "backoff_s": 0.0, "last_ok_t": None, "last_err": None,
            "scrape_ms": None, "scrapes": 0,
            "transitions": deque(maxlen=32),
            "healthz": None, "metrics": None, "poolz": None,
            "cachez": None, "traces": None,
        } for r in self.replicas}
        # Deterministic jitter, native scrape-loop parity (seed 0x7b5c).
        self._rng = random.Random(0x7b5c)  # guarded-by: _lock
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None
        self._http_thread: threading.Thread | None = None

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                window = parse_qs(url.query).get("window", [None])[0]
                if window is not None:
                    try:
                        window = float(window)
                    except ValueError:
                        return self._json(
                            400, {"error": "window must be a number"})
                if path == "/fleetz":
                    replica = parse_qs(url.query).get(
                        "replica", [None])[0]
                    if replica is not None and replica not in \
                            outer.replicas:
                        return self._json(404, {
                            "error": f"unknown replica {replica!r}",
                            "replicas": list(outer.replicas)})
                    return self._json(200, outer.fleetz_json(
                        window=window, replica=replica))
                if path == "/metrics":
                    body = outer.federated_metrics(window=window).encode()
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
                        return self._json(200, outer.reg.window_json(w))
                    return self._json(200, outer.reg.to_json())
                if path == "/traces.json":
                    chrome = parse_qs(url.query).get("chrome", ["0"])[0]
                    docs = outer._trace_docs()
                    if chrome not in ("0", "", "false"):
                        return self._json(200, stitch_chrome(docs))
                    return self._json(200, stitch(docs))
                if path == "/healthz":
                    snap = outer.fleetz_json()
                    return self._json(200, {
                        "ok": True,
                        "replicas": snap["fleet"]["replicas"],
                        "healthy": snap["fleet"]["healthy"],
                    })
                return self._json(404, {"error": f"unknown path {path}"})

            def _json(self, code, obj, headers=None):
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    # ---- scraping --------------------------------------------------------

    def _fetch_json(self, replica: str, path: str):
        """One GET. An HTTP error WITH a JSON body still returns that
        body for /healthz — a 503-draining replica is alive and its
        health payload is exactly the signal we came for. Raises on
        anything else."""
        url = f"http://{replica}{path}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            if path == "/healthz":
                try:
                    return json.loads(e.read().decode())
                except Exception:
                    pass
            raise

    def _scrape(self, replica: str) -> dict:
        """All paths for one replica, outside any aggregator lock (a 5s
        timeout under a lock would freeze every render)."""
        t0 = telemetry.monotonic()
        out = {"ok": True, "error": None}
        for path in SCRAPE_PATHS:
            key = _PATH_KEY[path]
            try:
                out[key] = self._fetch_json(replica, path)
            except Exception as e:
                out[key] = None
                if path in _OPTIONAL:
                    continue
                out["ok"] = False
                out["error"] = f"{path}: {e}"
                break
        out["scrape_ms"] = round((telemetry.monotonic() - t0) * 1e3, 3)
        return out

    def poll_once(self, now: float | None = None) -> list:
        """One scheduling round: scrape every replica whose backoff has
        elapsed, fold results into the per-replica state, feed the SLO
        engine, refresh the fleet gauges. Returns the replicas scraped
        (tests drive this directly; the poll thread just loops it)."""
        now = telemetry.monotonic() if now is None else now
        with self._lock:
            due = [r for r in self.replicas
                   if self._state[r]["next_attempt"] <= now]
        results = {r: self._scrape(r) for r in due}
        for r, res in results.items():
            self._fold(r, res, now)
        if due:
            self._refresh_gauges(now)
        return due

    def _fold(self, replica: str, res: dict, now: float) -> None:
        """Fold one scrape result into state + backoff + transitions."""
        if res["ok"]:
            hz = res.get("healthz") or {}
            new_state = "healthy" if hz.get("ok", True) else "unhealthy"
        else:
            new_state = "unreachable"
        with self._lock:
            st = self._state[replica]
            st["scrapes"] += 1
            if res["ok"]:
                st["failures"] = 0
                st["backoff_s"] = 0.0
                st["next_attempt"] = now + self.poll_s
                st["last_ok_t"] = now
                st["last_err"] = None
                for k in ("healthz", "metrics", "poolz", "cachez",
                          "traces"):
                    st[k] = res.get(k)
            else:
                st["failures"] += 1
                delay = min(self.poll_s * (2 ** (st["failures"] - 1)),
                            BACKOFF_CAP_S)
                delay *= self._rng.uniform(0.8, 1.2)
                st["backoff_s"] = round(delay, 3)
                st["next_attempt"] = now + delay
                st["last_err"] = res["error"]
            st["scrape_ms"] = res["scrape_ms"]
            if new_state != st["state"]:
                st["transitions"].append({
                    "t_us": telemetry.now_us(),
                    "from": st["state"], "to": new_state})
                st["state"] = new_state
        self.reg.inc("fleet_scrapes_total", labels={"replica": replica})
        if not res["ok"]:
            self.reg.inc("fleet_scrape_errors_total",
                         labels={"replica": replica})
        if res["ok"] and isinstance(res.get("metrics"), dict):
            self.slo.record(replica, res["metrics"], t=now)

    def _refresh_gauges(self, now: float) -> None:
        self.reg.set_gauge("fleet_replicas", len(self.replicas))
        with self._lock:
            view = {r: (st["state"], st["last_ok_t"], st["backoff_s"],
                        st["next_attempt"])
                    for r, st in self._state.items()}
        for r, (state, last_ok_t, backoff_s, next_attempt) in view.items():
            self.reg.set_gauge("fleet_replica_up",
                               1 if state == "healthy" else 0,
                               labels={"replica": r})
            self.reg.set_gauge("fleet_scrape_backoff_seconds",
                               round(max(0.0, next_attempt - now), 3)
                               if backoff_s else 0.0,
                               labels={"replica": r})
            if last_ok_t is not None:
                self.reg.observe("fleet_scrape_staleness_ms",
                                 (now - last_ok_t) * 1e3)
        for replica, slos in self.slo.evaluate(now=now).items():
            for slo, d in slos.items():
                if d["burn"] is not None:
                    self.reg.set_gauge(
                        "fleet_slo_burn_rate", d["burn"],
                        labels={"replica": replica, "slo": slo})
                for w, b in d["windows"].items():
                    if b is not None:
                        self.reg.set_gauge(
                            "fleet_slo_burn_window", b,
                            labels={"replica": replica, "slo": slo,
                                    "window": w})

    # ---- rendered views --------------------------------------------------

    def _effective_state(self, st: dict, now: float) -> str:
        """Stored scrape verdict, downgraded to "stale" when the last
        good scrape is too old — covers both a replica deep in backoff
        and one whose attempts hang."""
        if st["last_ok_t"] is not None and \
                now - st["last_ok_t"] > self.stale_after_s:
            return "stale"
        if st["state"] == "init" and st["failures"] > 0:
            return "unreachable"
        return st["state"]

    def _windowed_metrics(self, window: float) -> dict:
        """Live per-replica ``/metrics.json?window=N`` fetch, fanned out
        on threads (never under the aggregator lock). On demand because
        the poll loop's lifetime scrape cannot anticipate arbitrary
        windows; an unreachable replica contributes None."""
        out: dict = {}

        def fetch(r: str) -> None:
            try:
                out[r] = self._fetch_json(
                    r, f"/metrics.json?window={window:g}")
            except Exception:  # noqa: BLE001 - render survives any replica
                out[r] = None

        threads = [threading.Thread(target=fetch, args=(r,), daemon=True)
                   for r in self.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout_s + 1.0)
        return out

    def fleetz_json(self, now: float | None = None,
                    window: float | None = None,
                    replica: str | None = None) -> dict:
        # Deferred: router imports this module for BACKOFF_CAP_S, so the
        # shared breaker-view shape is fetched at call time, not import.
        from tpu_bootstrap_torch.workload.router import breaker_view
        now = telemetry.monotonic() if now is None else now
        windowed = (self._windowed_metrics(window)
                    if window is not None else {})
        with self._lock:
            snap = {r: dict(st) for r, st in self._state.items()}
            for st in snap.values():
                st["transitions"] = list(st["transitions"])
        replicas: dict = {}
        fleet = {"replicas": len(self.replicas), "healthy": 0,
                 "queue_depth": 0, "digest_blocks": 0,
                 "blocks": {"total": 0, "live": 0, "cached": 0},
                 "serve_qps": 0.0, "serve_tokens_per_sec": 0.0}
        for r, st in snap.items():
            eff = self._effective_state(st, now)
            m = st["metrics"] or {}
            pool = (st["poolz"] or {}).get("pool") or {}
            digest = ((st["cachez"] or {}).get("digest")
                      or pool.get("cache_digest") or {})
            blocks = pool.get("blocks") or {}
            entry = {
                "state": eff,
                "failures": st["failures"],
                "backoff_s": st["backoff_s"],
                # The router-consistent circuit view derived from this
                # poll loop's own backoff state: same state grammar
                # (closed / open / half-open) and keys as the router's
                # per-replica breaker snapshot, so the two panes never
                # disagree about what "open" means.
                "breaker": breaker_view(st["failures"], st["backoff_s"],
                                        st["next_attempt"], now),
                "last_ok_age_ms": None if st["last_ok_t"] is None
                else round((now - st["last_ok_t"]) * 1e3, 1),
                "last_err": st["last_err"],
                "scrape_ms": st["scrape_ms"],
                "scrapes": st["scrapes"],
                "transitions": st["transitions"],
                "health": st["healthz"],
                "queue_depth": m.get("serve_queue_depth"),
                "qps": m.get("serve_qps"),
                "tokens_per_sec": m.get("serve_tokens_per_sec"),
                # The router/autoscaler's utilization signal: device
                # busy fraction and MFU from the replica's round
                # ledger (None on replicas without a serving plane).
                "busy_frac": m.get("serve_engine_busy_frac"),
                "mfu": m.get("serve_mfu"),
                "blocks": blocks or None,
                "digest_blocks": digest.get("blocks"),
                "cache_digest": digest or None,
            }
            if window is not None:
                # The ?window=N pass-through: the replica's own windowed
                # series (deltas, rates, window-local quantiles), fetched
                # live — recent behavior, not process-lifetime blend.
                entry["window"] = windowed.get(r)
            replicas[r] = entry
            if eff == "healthy":
                fleet["healthy"] += 1
            for src, dst in (("serve_queue_depth", "queue_depth"),):
                if isinstance(m.get(src), (int, float)):
                    fleet[dst] += m[src]
            for src in ("serve_qps", "serve_tokens_per_sec"):
                if isinstance(m.get(src), (int, float)):
                    fleet[src] = round(fleet[src] + m[src], 3)
            if isinstance(digest.get("blocks"), int):
                fleet["digest_blocks"] += digest["blocks"]
            for k in ("total", "live", "cached"):
                if isinstance(blocks.get(k), int):
                    fleet["blocks"][k] += blocks[k]
        # Fleet utilization: mean busy-frac/MFU over replicas reporting
        # one — the scale-on-utilization signal, next to queue depth.
        for key, src in (("busy_frac", "busy_frac"), ("mfu", "mfu")):
            vals = [e[src] for e in replicas.values()
                    if isinstance(e.get(src), (int, float))]
            fleet[key] = (round(sum(vals) / len(vals), 6)
                          if vals else None)
        burn = self.slo.evaluate(now=now)
        if replica is not None:
            # ?replica= narrows the per-replica maps to one member;
            # the fleet rollup stays fleet-wide (it is labeled so).
            replicas = {r: e for r, e in replicas.items()
                        if r == replica}
            burn = {r: b for r, b in burn.items() if r == replica}
        out_window = None if window is None else float(window)
        return {
            "as_of_us": telemetry.now_us(),
            "window_secs": out_window,
            "poll_ms": round(self.poll_s * 1e3, 1),
            "replicas": replicas,
            "fleet": fleet,
            "slo": {
                "objectives": [dataclasses.asdict(o)
                               for o in self.slo.objectives],
                "windows_s": list(self.slo.windows),
                "burn_threshold": self.slo.burn_threshold,
                "burn": burn,
            },
            "alerts": self.slo.alerts(),
        }

    def federated_metrics(self, window: float | None = None) -> str:
        """Federated Prometheus text. ``window=N`` swaps the poll loop's
        lifetime instants for a live per-replica windowed scrape
        (deltas/rates/window-quantiles as ``*_window_*`` families) —
        the ?window=N contract holds end-to-end, replica through
        aggregator."""
        if window is not None:
            per = {r: (flatten_window(doc) if doc else None)
                   for r, doc in self._windowed_metrics(window).items()}
        else:
            with self._lock:
                per = {r: st["metrics"] for r, st in self._state.items()}
        return federate(per, own=self.reg.to_prometheus())

    def _trace_docs(self) -> dict:
        with self._lock:
            return {r: st["traces"] for r, st in self._state.items()
                    if st["traces"]}

    # ---- lifecycle -------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_s)

    def start(self) -> "FleetAggregator":
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             daemon=True)
        self._poll_thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self

    def serve_forever(self) -> None:
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             daemon=True)
        self._poll_thread.start()
        print(f"fleetz: aggregating {len(self.replicas)} replica(s) "
              f"on :{self.port} (poll {self.poll_s * 1e3:.0f}ms)")
        self.httpd.serve_forever()

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m tpu_bootstrap_torch.workload.fleetz",
        description="Fleet telemetry aggregator: /fleetz, federated "
                    "/metrics, stitched /traces.json, SLO burn rates.")
    p.add_argument("--replicas", required=True,
                   help="comma-separated host:port list to scrape")
    p.add_argument("--port", type=int, default=9300)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--poll-ms", type=float, default=None,
                   help="scrape cadence (default TPUBC_FLEET_POLL_MS)")
    p.add_argument("--slo", action="append", default=[],
                   help="extra objective name:key:gt|lt:threshold[:target] "
                        "(repeatable; replaces the defaults when given)")
    p.add_argument("--windows", default="300,3600",
                   help="burn-rate windows in seconds, comma-separated")
    p.add_argument("--burn-threshold", type=float, default=1.0)
    args = p.parse_args(argv)
    objectives = ([parse_objective(s) for s in args.slo]
                  if args.slo else None)
    windows = tuple(float(w) for w in args.windows.split(",") if w)
    agg = FleetAggregator(
        args.replicas, port=args.port, host=args.host,
        poll_s=None if args.poll_ms is None else args.poll_ms / 1e3,
        objectives=objectives, windows=windows,
        burn_threshold=args.burn_threshold)
    agg.serve_forever()


if __name__ == "__main__":
    main()


__all__ = ["FleetAggregator", "SloEngine", "SloObjective",
           "parse_objective", "federate", "flatten_window", "stitch",
           "stitch_chrome", "DEFAULT_OBJECTIVES"]
