"""The port's own small metrics registry and span tracer.

A copy of the subset of ``tpu_bootstrap.telemetry`` the port records
(that module is framework-free, but the port imports nothing of the JAX
package): named counters and gauges, fixed-bucket histograms with their
clamped quantiles, each series' time-series ring (``TPUBC_TS_RING``) and
the three expositions (``to_json``, ``to_prometheus``, ``window_json``),
the injectable monotonic clock (``set_clock``), the span ``Tracer`` that
``span`` and the serving request log record into, ``RateWindow``, the
train loop's heartbeat and the worker's ``start_metrics_server``, the MFU
denominator, the HBM roofline denominator and the host-link rate the paged
engine prices swaps with.

The trace plane is the reference's too, wire-compatible with the daemons'
tracer (native/src/trace.cc): the span-list JSON served at /traces.json
and the Chrome trace-event JSON ``Tracer.dump`` writes, so the controller's,
the admission daemon's and a worker's spans merge onto one timeline
(``merge_chrome_traces``). A worker's root spans join the trace id the
controller injects into the JobSet as ``TPUBC_TRACE_ID`` (the id the
admission webhook stamped on the CR's ``tpu.bacchus.io/trace-id``
annotation), and when ``TPUBC_TRACE_FILE`` is set the process writes its
spans there at exit.

Names are the reference's, so a scrape of either package reads the same
keys:
``quant_<kernel>_{calls,weight_bytes,activation_bytes,bytes}_total`` from
the quantized matmul seam, the ``kv_blocks_*`` pool gauges, the ``serve_*``
scheduler gauges (labelled series rendered ``name{k="v"}``) and the train
loop's ``workload_*`` gauges.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import secrets
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field

TRACE_ANNOTATION = "tpu.bacchus.io/trace-id"
TRACE_ID_ENV = "TPUBC_TRACE_ID"

DEFAULT_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                   10000)


class _Histogram:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """Linear interpolation within the containing bucket; a quantile in
        the overflow bucket clamps to the last finite bound (-1 when
        empty)."""
        if self.count == 0:
            return -1.0
        rank = min(int(q * self.count), self.count - 1)
        seen = 0
        for i, in_bucket in enumerate(self.counts):
            if seen + in_bucket > rank:
                if i == len(self.bounds):
                    return float(self.bounds[-1])
                lo = 0.0 if i == 0 else float(self.bounds[i - 1])
                hi = float(self.bounds[i])
                if in_bucket == 0:
                    return hi
                return lo + (hi - lo) * (rank - seen + 1) / in_bucket
            seen += in_bucket
        return float(self.bounds[-1])

    @property
    def overflow(self) -> int:
        return self.counts[-1]


def ring_capacity() -> int:
    """Per-series time-series ring capacity (TPUBC_TS_RING, default 256; 0
    keeps no history)."""
    try:
        return max(0, int(os.environ.get("TPUBC_TS_RING", "256")))
    except ValueError:
        return 256


def _label_key(name: str, labels) -> str:
    """A labelled series' key, rendered as the reference renders it:
    ``name{k="v",...}`` with the keys sorted; no labels keep the bare
    name."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _split_labels(key: str) -> tuple:
    """Inverse of _label_key: (family, label string)."""
    if key.endswith("}") and "{" in key:
        family, rest = key.split("{", 1)
        return family, rest[:-1]
    return key, ""


class MetricsRegistry:
    """Counters, gauges and histograms (thread-safe), each series with a
    bounded history ring sampled when it is recorded (``ring`` entries,
    default ``ring_capacity()``; 0 keeps none): a value series keeps (t,
    value), a histogram (t, count, sum, bucket counts). ``window_json``
    turns the rings into deltas, rates and windowed quantiles."""

    def __init__(self, ring: int | None = None):
        self._lock = threading.Lock()
        self._values: dict = {}      # guarded-by: _lock
        self._histograms: dict = {}  # guarded-by: _lock
        self.ring = ring_capacity() if ring is None else max(0, ring)
        self._rings: dict = {}       # series key -> deque  # guarded-by: _lock

    def _ring_append_locked(self, name: str, entry) -> None:
        ring = self._rings.get(name)
        if ring is None:
            ring = self._rings[name] = deque(maxlen=self.ring)
        ring.append(entry)

    def inc(self, name: str, delta=1, labels=None) -> None:
        name = _label_key(name, labels)
        with self._lock:
            v = self._values[name] = self._values.get(name, 0) + delta
            if self.ring:
                self._ring_append_locked(name, (time.monotonic(), v))

    def set_gauge(self, name: str, value, labels=None) -> None:
        name = _label_key(name, labels)
        with self._lock:
            self._values[name] = value
            if self.ring:
                self._ring_append_locked(name, (time.monotonic(), value))

    def observe(self, name: str, value: float, buckets=None,
                labels=None) -> None:
        """Record one observation; ``buckets`` fixes the bounds on the
        histogram's first observation."""
        name = _label_key(name, labels)
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = _Histogram(
                    buckets or DEFAULT_BUCKETS)
            h.observe(value)
            if self.ring:
                self._ring_append_locked(
                    name, (time.monotonic(), h.count, h.sum, tuple(h.counts)))

    def quantile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._histograms.get(name)
            return -1.0 if h is None else h.quantile(q)

    def to_json(self) -> dict:
        """Values by name; histograms as ``_count``/``_sum``/``_p50``/
        ``_p99``, plus ``_overflow`` when some observation passed the last
        bound."""
        with self._lock:
            out = dict(sorted(self._values.items()))
            for name in sorted(self._histograms):
                h = self._histograms[name]
                out[name + "_count"] = h.count
                out[name + "_sum"] = h.sum
                out[name + "_p50"] = h.quantile(0.50)
                out[name + "_p99"] = h.quantile(0.99)
                if h.overflow > 0:
                    out[name + "_overflow"] = h.overflow
            return out

    def to_prometheus(self) -> str:
        """The text exposition format: ``*_total`` series as counters, the
        rest as gauges, histograms as cumulative ``_bucket{le=...}`` series;
        every label set of a family contiguous under one TYPE line."""
        with self._lock:
            lines = []
            typed = set()

            def emit_type(family: str, kind: str) -> None:
                if family not in typed:
                    typed.add(family)
                    lines.append(f"# TYPE {family} {kind}")

            for key in sorted(self._values, key=_split_labels):
                family, labels = _split_labels(key)
                counter = family.endswith("_total")
                emit_type(family[:-6] if counter else family,
                          "counter" if counter else "gauge")
                v = self._values[key]
                lines.append(f"{key} {v:g}" if isinstance(v, float)
                             else f"{key} {v}")
            for key in sorted(self._histograms, key=_split_labels):
                family, labels = _split_labels(key)
                emit_type(family, "histogram")
                h = self._histograms[key]
                pre = labels + "," if labels else ""
                suffix = f"{{{labels}}}" if labels else ""
                cum = 0
                for b, c in zip(h.bounds, h.counts):
                    cum += c
                    lines.append(f'{family}_bucket{{{pre}le="{b:g}"}} {cum}')
                lines.append(f'{family}_bucket{{{pre}le="+Inf"}} {h.count}')
                lines.append(f"{family}_sum{suffix} {h.sum:g}")
                lines.append(f"{family}_count{suffix} {h.count}")
            return "\n".join(lines) + ("\n" if lines else "")

    def window_json(self, window_secs: float, now: float | None = None) -> dict:
        """``/metrics.json?window=N``: for each value series its instant,
        its delta over the trailing window and the delta a second; for each
        histogram the count, sum and bucket deltas and p50/p99 over the
        window's observations alone. The baseline is the last sample at or
        before the window's start; without one, zero while the ring holds
        the series' whole history, else its oldest sample. A series with
        no ring reports its instant only."""
        now = time.monotonic() if now is None else now
        cutoff = now - max(float(window_secs), 0.0)
        with self._lock:
            series: dict = {}
            for name in sorted(self._values):
                cur = self._values[name]
                entry: dict = {"now": cur}
                ring = self._rings.get(name)
                if ring:
                    base = None
                    n_in = 0
                    for t, v in ring:
                        if t <= cutoff:
                            base = v
                        else:
                            n_in += 1
                    if base is None:
                        base = ring[0][1] if len(ring) == ring.maxlen else 0
                    entry["samples"] = n_in
                    if (isinstance(cur, (int, float))
                            and isinstance(base, (int, float))):
                        entry["delta"] = cur - base
                        if window_secs > 0:
                            entry["rate_per_sec"] = round(
                                (cur - base) / window_secs, 6)
                series[name] = entry
            for name in sorted(self._histograms):
                h = self._histograms[name]
                ring = self._rings.get(name)
                base = None
                if ring:
                    for t, cnt, s, counts in ring:
                        if t <= cutoff:
                            base = (cnt, s, counts)
                        else:
                            break
                    if base is None and len(ring) == ring.maxlen:
                        base = tuple(ring[0][1:])
                b_cnt, b_sum, b_counts = base or (0, 0.0, (0,) * len(h.counts))
                wh = _Histogram(h.bounds)
                wh.counts = [a - b for a, b in zip(h.counts, b_counts)]
                wh.count = h.count - b_cnt
                wh.sum = h.sum - b_sum
                series[name] = {
                    "count": h.count,
                    "count_delta": wh.count,
                    "sum_delta": round(wh.sum, 6),
                    "p50": wh.quantile(0.50),
                    "p99": wh.quantile(0.99),
                    "bucket_deltas": list(wh.counts),
                    "bounds": list(h.bounds),
                }
                if window_secs > 0:
                    series[name]["rate_per_sec"] = round(
                        wh.count / window_secs, 6)
            return {"window_secs": float(window_secs),
                    "as_of_us": now_us(),
                    "ring": self.ring,
                    "series": series}

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            self._histograms.clear()
            self._rings.clear()


_metrics = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide registry."""
    return _metrics


_WALL_BASE_US = int(time.time() * 1e6)
_MONO_BASE_NS = time.monotonic_ns()

# The one injectable monotonic clock the serving timings read (queue
# waits, deadlines, resume gaps, request-event stamps). None is the real
# time.monotonic; tests install a virtual clock to pin every such read.
_CLOCK = None


def set_clock(fn) -> None:
    """Install an injected monotonic clock (a callable returning seconds),
    or restore the real one with ``set_clock(None)``."""
    global _CLOCK
    _CLOCK = fn


def monotonic() -> float:
    """Monotonic seconds from the injectable clock."""
    fn = _CLOCK
    return time.monotonic() if fn is None else fn()


def now_us() -> int:
    """Wall-aligned monotonic microseconds: a wall base taken once plus
    monotonic deltas; under an injected clock, its time in microseconds."""
    fn = _CLOCK
    if fn is not None:
        return int(fn() * 1e6)
    return _WALL_BASE_US + (time.monotonic_ns() - _MONO_BASE_NS) // 1000


def new_trace_id() -> str:
    return secrets.token_hex(8)


def new_span_id() -> str:
    return secrets.token_hex(8)


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start_us: int
    dur_us: int = 0
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start_us": self.start_us, "dur_us": self.dur_us,
                "attrs": dict(self.attrs)}


class Tracer:
    """Bounded in-process span buffer (thread-safe): ``TPUBC_TRACE_BUFFER``
    spans (default 4096), the oldest evicted and counted in ``dropped``."""

    def __init__(self, process: str = "tpu-bootstrap-workload",
                 capacity: int | None = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("TPUBC_TRACE_BUFFER", "4096"))
            except ValueError:
                capacity = 4096
        self.process = process
        self.capacity = max(capacity, 1)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)

    def add_span(self, name: str, start_us: int, dur_us: int, *,
                 trace_id: str = "", parent_id: str = "", **attrs) -> Span:
        """Record a span after the fact (a serving request, whose start is
        known to be a span's only once it retires)."""
        span = Span(trace_id or root_trace_id(), new_span_id(), parent_id,
                    name, start_us, max(int(dur_us), 0),
                    {k: str(v) for k, v in attrs.items()})
        self.record(span)
        return span

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def to_json(self) -> dict:
        """The daemons' /traces.json shape; the spans and the drop count
        are read under one lock hold."""
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
        return {"process": self.process, "dropped": dropped,
                "spans": [s.to_dict() for s in spans]}

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON, one row per trace id."""
        pid = os.getpid()
        events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"name": self.process}}]
        for s in self.spans():
            args = {"trace_id": s.trace_id, "span_id": s.span_id,
                    "parent_id": s.parent_id}
            args.update(s.attrs)
            events.append({"name": s.name, "cat": self.process, "ph": "X",
                           "ts": s.start_us, "dur": s.dur_us, "pid": pid,
                           "tid": _chrome_tid(s.trace_id), "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        """Write ``to_chrome()`` to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def _chrome_tid(trace_id: str) -> int:
    if not trace_id:
        return 0
    # Stable across processes (str hashes are salted per process).
    return zlib.crc32(trace_id.encode()) & 0x7FFFFFFF


_tracer = Tracer()
_tls = threading.local()
_root_id: str | None = None


def tracer() -> Tracer:
    return _tracer


def root_trace_id() -> str:
    """The trace id spans root under: the propagated TPUBC_TRACE_ID, else
    a per-process random id."""
    global _root_id
    if _root_id is None:
        _root_id = os.environ.get(TRACE_ID_ENV, "") or new_trace_id()
    return _root_id


def current() -> Span | None:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


_spans: deque = deque(maxlen=4096)


@contextlib.contextmanager
def span(name: str, trace_id: str | None = None, **attrs):
    """Time a block on the host clock. Yields a record dict, whose
    ``dur_ms`` is set when the block exits, kept in a bounded ring
    (``spans()``); the block is also a ``Span`` in the ``tracer()``,
    parented under the enclosing span of this thread and sharing its trace
    id. A root span joins ``trace_id`` (default: ``root_trace_id()``, the
    propagated one). The caller synchronises the device inside the block
    where the span must cover device work."""
    rec = {"name": name, **attrs}
    parent = current()
    if parent is not None:
        tid, pid = parent.trace_id, parent.span_id
    else:
        tid, pid = trace_id or root_trace_id(), ""
    s = Span(tid, new_span_id(), pid, name, now_us(),
             attrs={k: str(v) for k, v in attrs.items()})
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(s)
    t0 = time.perf_counter()
    t0_ns = time.monotonic_ns()
    try:
        yield rec
    finally:
        rec["dur_ms"] = (time.perf_counter() - t0) * 1e3
        _spans.append(rec)
        s.dur_us = (time.monotonic_ns() - t0_ns) // 1000
        stack.pop()
        _tracer.record(s)


def spans() -> list:
    return list(_spans)


def merge_chrome_traces(out_path: str, sources: list) -> dict:
    """Merge Chrome trace files (or already-parsed dicts) into one timeline
    at ``out_path``. Sources that are missing or unparseable are skipped (a
    daemon that never got its SIGTERM contributes no spans). Returns the
    merged document."""
    events = []
    for src in sources:
        if isinstance(src, dict):
            doc = src
        else:
            try:
                with open(src) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
        events.extend(doc.get("traceEvents",
                              doc if isinstance(doc, list) else []))
    merged = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged


def _dump_at_exit() -> None:
    path = os.environ.get("TPUBC_TRACE_FILE", "")
    if path and _tracer.spans():
        try:
            _tracer.dump(path)
        except OSError:
            pass


atexit.register(_dump_at_exit)


# The denominator of workload_train_mfu, as in the reference: the operator
# sets it with TPUBC_PEAK_TFLOPS; otherwise it follows the card's name.
PEAK_TFLOPS_ENV = "TPUBC_PEAK_TFLOPS"
# Dense bf16 tensor-core peak of the H100 SXM (NVIDIA's data sheet). The
# PCIe and NVL parts run lower and are not assumed.
H100_SXM_BF16_TFLOPS = 989.0


def peak_tflops() -> float | None:
    """bf16 peak TFLOP/s of the card the port runs on: TPUBC_PEAK_TFLOPS
    when set, else the H100 SXM's when CUDA reports one, else None (an
    unknown part, or no card: no MFU is computed)."""
    try:
        return float(os.environ[PEAK_TFLOPS_ENV])
    except (KeyError, ValueError):
        pass
    return H100_SXM_BF16_TFLOPS if _h100_sxm() else None


def _h100_sxm() -> bool:
    """Whether CUDA reports an H100 SXM (the PCIe and NVL parts run lower
    and are not assumed)."""
    import torch

    if not torch.cuda.is_available():
        return False
    name = torch.cuda.get_device_name()
    return "H100" in name and "PCIe" not in name and "NVL" not in name


# The denominator of every HBM roofline share (record_kernel_bandwidth), as
# in the reference: the operator sets it with TPUBC_HBM_GBPS; otherwise it
# follows the card's name, as peak_tflops does.
HBM_PEAK_ENV = "TPUBC_HBM_GBPS"
# HBM3 rate of the H100 SXM, GB/s (NVIDIA's data sheet).
H100_SXM_HBM_GBPS = 3350.0


def hbm_peak_gbps() -> float | None:
    """HBM peak GB/s of the card the port runs on: TPUBC_HBM_GBPS when set,
    else the H100 SXM's when CUDA reports one, else None (an unknown part,
    or no card: no roofline share is computed)."""
    try:
        return float(os.environ[HBM_PEAK_ENV])
    except (KeyError, ValueError):
        pass
    return H100_SXM_HBM_GBPS if _h100_sxm() else None


# Host<->device transfer rate, GB/s: the seed of the paged engine's swap
# arm until it has timed a transfer of its own (the reference's name;
# TPUBC_HOST_XFER_GBPS overrides). The default is not the reference's TPU
# host figure: it is the rate chip_smoke.py's serve_host_tier phase
# measured for one pool block of the decode model (278,528 bytes in 32
# tensors) restored host to device on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (PERF.md section 6).
HOST_XFER_ENV = "TPUBC_HOST_XFER_GBPS"
DEFAULT_HOST_XFER_GBPS = 0.27


def host_xfer_gbps() -> float:
    try:
        return float(os.environ.get(HOST_XFER_ENV, DEFAULT_HOST_XFER_GBPS))
    except ValueError:
        return DEFAULT_HOST_XFER_GBPS


def record_peak_provenance() -> None:
    """Publish the MFU and swap-price denominators and where they came
    from (1: the environment, 0: the built-in default). Without a known
    peak (no card, an unknown part) ``serve_peak_tflops`` is not set."""
    reg = _metrics
    peak = peak_tflops()
    if peak is not None:
        reg.set_gauge("serve_peak_tflops", peak)
    reg.set_gauge("serve_peak_tflops_from_env",
                  int(PEAK_TFLOPS_ENV in os.environ))
    reg.set_gauge("serve_host_xfer_gbps", host_xfer_gbps())
    reg.set_gauge("serve_host_xfer_gbps_from_env",
                  int(HOST_XFER_ENV in os.environ))


def record_kernel_bandwidth(kernel: str, bytes_moved: int, seconds: float,
                            peak_gbps: float | None = None) -> None:
    """Set the per-kernel achieved-bandwidth gauges from one measured
    execution: ``quant_<kernel>_achieved_gbps`` and, when a peak is known
    (``peak_gbps``, else ``hbm_peak_gbps()``),
    ``quant_<kernel>_hbm_roofline_frac``."""
    if seconds <= 0 or bytes_moved <= 0:
        return
    if peak_gbps is None:
        peak_gbps = hbm_peak_gbps()
    gbps = bytes_moved / seconds / 1e9
    _metrics.set_gauge(f"quant_{kernel}_achieved_gbps", round(gbps, 2))
    if peak_gbps is not None:
        _metrics.set_gauge(f"quant_{kernel}_hbm_roofline_frac",
                           round(gbps / peak_gbps, 4))


class RateWindow:
    """A rolling event rate: ``add`` counts events, ``per_sec`` reads
    events a second over the trailing window. Memory is bounded by the
    events in the window."""

    def __init__(self, window_secs: float = 60.0):
        self.window = window_secs
        self._lock = threading.Lock()
        self._events = deque()  # (t, weight)  # guarded-by: _lock

    def add(self, weight: float = 1.0, t: float | None = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._events.append((t, weight))
            self._trim_locked(t)

    def per_sec(self, t: float | None = None) -> float:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._trim_locked(t)
            return sum(w for _, w in self._events) / self.window

    def _trim_locked(self, t: float) -> None:
        cutoff = t - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()


# Train-loop heartbeat: the step loop stamps (step, monotonic time) after
# every step, so a wedged loop can be told from a slow one.
_beat_lock = threading.Lock()
_beat = {"t": None, "step": None}  # guarded-by: _beat_lock


def heartbeat(step: int | None = None) -> None:
    """Stamp liveness (the train step loop)."""
    with _beat_lock:
        _beat["t"] = time.monotonic()
        if step is not None:
            _beat["step"] = step


def heartbeat_snapshot() -> tuple:
    """(last step or None, age in ms or None when never stamped)."""
    with _beat_lock:
        t, step = _beat["t"], _beat["step"]
    if t is None:
        return step, None
    return step, (time.monotonic() - t) * 1e3


def start_metrics_server(port: int, host: str = "0.0.0.0",
                         process: str = "tpu-bootstrap-workload"):
    """Serve the registry on a daemon thread, the reference's worker
    routes: /metrics (text), /metrics.json (instants, or ``?window=N``),
    /healthz and /health (the train loop's heartbeat: a stamp older than
    TPUBC_WATCHDOG_STALL_MS answers 503; never stamped is healthy),
    /statusz and /traces.json. Returns the HTTPServer (port 0: an
    ephemeral port, read from ``server_address[1]``)."""
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            parsed = urlparse(self.path)
            route = parsed.path
            code = 200
            if route == "/metrics":
                body = _metrics.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4"
            elif route == "/metrics.json":
                q = parse_qs(parsed.query)
                if "window" in q:
                    try:
                        w = float(q["window"][0])
                    except ValueError:
                        return self._json(
                            400, {"error": "window must be a number"})
                    doc = _metrics.window_json(w)
                else:
                    doc = _metrics.to_json()
                body = _json.dumps(doc).encode()
                ctype = "application/json"
            elif route in ("/healthz", "/health"):
                step, age_ms = heartbeat_snapshot()
                health: dict = {"ok": True}
                if step is not None:
                    health["last_step"] = step
                if age_ms is not None:
                    health["heartbeat_age_ms"] = round(age_ms, 1)
                    try:
                        stall_ms = float(os.environ.get(
                            "TPUBC_WATCHDOG_STALL_MS", "30000"))
                    except ValueError:
                        stall_ms = 30000.0
                    if stall_ms > 0 and age_ms > stall_ms:
                        health["ok"] = False
                        health["stalled_ms"] = round(age_ms, 1)
                code = 200 if health["ok"] else 503
                body = _json.dumps(health).encode()
                ctype = "application/json"
            elif route == "/statusz":
                step, age_ms = heartbeat_snapshot()
                tj = _tracer.to_json()
                body = _json.dumps({
                    "process": process,
                    "last_step": step,
                    "heartbeat_age_ms": (round(age_ms, 1)
                                         if age_ms is not None else None),
                    "metrics_series": len(_metrics.to_json()),
                    "tracer": {"spans": len(tj["spans"]),
                               "dropped": tj["dropped"]},
                }).encode()
                ctype = "application/json"
            elif route == "/traces.json":
                body = _json.dumps(_tracer.to_json()).encode()
                ctype = "application/json"
            else:
                return self._json(404, {"error": "not found"})
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            body = _json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def record_kv_block_pool(total: int, used: int, free: int,
                         capacity_tokens: int, live_tokens: int,
                         peak_used: int, compactness: float,
                         cached: int = 0) -> None:
    """Block-pool gauges of the paged engine (reference names). ``used``
    counts live blocks; ``cached`` the prefix cache's zero-reference
    blocks (kv_blocks_cached), which ride in ``free``: reclaimable, not
    pressure."""
    reg = _metrics
    reg.set_gauge("kv_blocks_capacity", total)
    reg.set_gauge("kv_blocks_used", used)
    reg.set_gauge("kv_blocks_free", free)
    reg.set_gauge("kv_blocks_cached", cached)
    if total > 0:
        reg.set_gauge("kv_blocks_used_frac", round(used / total, 4))
        reg.set_gauge("kv_blocks_peak_frac", round(peak_used / total, 4))
    if capacity_tokens > 0:
        reg.set_gauge("kv_block_internal_frag",
                      round(1.0 - live_tokens / capacity_tokens, 4))
    reg.set_gauge("kv_blocks_compactness", round(compactness, 4))


def record_scheduler(queue_depth: int, expected_new: float, submitted: int,
                     admitted: int, preemptions: int) -> None:
    """Scheduler gauges (reference names): the waiting queue's depth, the
    expected-generated-length EMA overcommit admission reserves by, the
    admitted-over-submitted ratio and the pool's preemption count."""
    reg = _metrics
    reg.set_gauge("serve_sched_queue_depth", queue_depth)
    reg.set_gauge("serve_expected_new", round(float(expected_new), 2))
    if submitted > 0:
        reg.set_gauge("serve_admitted_ratio", round(admitted / submitted, 4))
    reg.set_gauge("serve_preemptions", preemptions)
