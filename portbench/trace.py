"""A traced slice of the window: ``torch.profiler`` (CPU and CUDA) over a
few seconds of whole rounds or steps, reduced to device intervals, the
benchmark's own spans, the device's busy union, the operations that took
the most time and the longest idle gaps, each named by the benchmark's
span that was open at its middle.

The benchmark's spans are ``record_function`` ranges named
``portbench.<what>`` around its calls into the program (``Scheduler.step``,
``Scheduler.submit``, the wait for the next arrival, the train step, the
data). Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib

SPAN_PREFIX = "portbench."


def span(torch, name: str, on: bool):
    """A benchmark span, recorded only while a slice is traced."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Slice:
    """One profiled stretch. ``start()`` and ``stop()`` at round or step
    boundaries; ``stop`` synchronizes first, so every device operation the
    slice dispatched is inside it."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.wall_s = 0.0
        self.t0 = None

    def start(self) -> None:
        import time

        t = self.torch
        t.cuda.synchronize()
        self.prof = t.profiler.profile(
            activities=[t.profiler.ProfilerActivity.CPU,
                        t.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        import time

        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()
        return reduce_events(self.torch, self.prof.events(), self.wall_s)


def reduce_events(torch, events, wall_s: float) -> dict:
    """Device operations (name, start_us, end_us), the benchmark's spans,
    the busy union and the slice's extent, from profiler events whose
    times are microseconds from the trace's start."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans = [], []
    for e in events:
        a, z = float(e.time_range.start), float(e.time_range.end)
        if e.name.startswith(SPAN_PREFIX):
            # The span's device-side shadow (a user annotation) is no
            # device operation.
            if e.device_type != cuda:
                spans.append((e.name[len(SPAN_PREFIX):], a, z))
        elif e.device_type == cuda and z > a:
            ops.append((e.name, a, z))
    # Times from the slice's first span (the profiler's own start-up comes
    # before it).
    origin = min((a for _, a, _ in spans), default=0.0)
    ops = sorted(((n, a - origin, z - origin) for n, a, z in ops),
                 key=lambda o: o[1])
    spans = sorted(((n, a - origin, z - origin) for n, a, z in spans),
                   key=lambda s: s[1])
    busy = union(ops)
    return {"ops": ops, "spans": spans, "busy_us": sum(z - a for a, z in busy),
            "busy": busy, "wall_s": wall_s}


def union(ops: list) -> list:
    """Disjoint (start, end) intervals covering every operation."""
    out = []
    for _, a, z in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return [(a, z) for a, z in out]


def kernel_seconds(ops: list, match) -> float:
    """Summed device seconds of the operations whose name ``match``es."""
    return sum(z - a for name, a, z in ops if match(name)) / 1e6


def breakdown(red: dict, extent_us: float, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the slice (before the first operation and after the last
    included), each named by the innermost benchmark span open at the
    gap's middle."""
    by_name: dict = {}
    for name, a, z in red["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (z - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, prev = [], 0.0
    for a, z in red["busy"] + [(extent_us, extent_us)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, z)
    spans = red["spans"]
    starts = [s[1] for s in spans]

    def name_at(t):
        best = None
        for name, a, z in spans[:bisect.bisect_right(starts, t)]:
            if a <= t <= z and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "outside the benchmark's spans"

    gaps.sort(key=lambda g: -(g[1] - g[0]))
    idle = [[name_at((a + z) / 2), (z - a) / 1e6] for a, z in gaps[:top]]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": idle}


def fragments(*frags):
    """A name matcher: every fragment must occur in the kernel's name."""
    return lambda name: all(f in name for f in frags)
