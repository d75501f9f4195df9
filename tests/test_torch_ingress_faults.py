"""The front door's failure paths on the port's paged engine: mirrors of
the reference's tests/test_faults.py:439-583 (graceful drain, the engine
watchdog's stall flag and dead-engine restart, a client socket dying
mid-stream, a failed scrape) and :679 (a real SIGTERM to a
``serve_forever`` process mid-stream), plus the 504 a request gets when
its deadline passes while it waits, and an engine that raises outside
the round's scheduling (in ``_profile_tick``, or while it publishes the
round's events) and serves on. On the f32 bridged int8 weights of
tests/test_torch_scheduler.py, every stream held to the port's solo greedy
``generate`` (the reference's streams on the same weights are held to it
in tests/test_torch_ingress.py).

The reference slows its engine with sleeps; here a gate (a wrapped
``Scheduler.step`` waiting on an event) holds the engine at a round
boundary while the test polls, against a deadline, for the state it
checks. The subprocess of :679 slows each of its rounds instead (it has
no gate a test can reach), so that the drain window expires with the
stream still open."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from tests.test_torch_ingress import (
    HTTP_TIMEOUT,
    get,
    post,
    solo,
    tokens_of,
    wait_until,
)
from tests.test_torch_scheduler import TCFG, TPARAMS
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import faults
from tpu_bootstrap_torch.workload import ingress as tingress

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_lingering_faults():
    yield
    faults.install(None)


def _paged_server(**kw):
    return tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=2,
                                  paged=True, kv_quant=True, kv_blocks=24,
                                  block_size=8, host="127.0.0.1",
                                  device="cpu", **kw).start()


def _stream_lines(port, body, out):
    """Stream ``body``'s answer into ``out`` line by line (a client error
    is appended as ``client_error``)."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
            for ln in resp:
                if ln.strip():
                    out.append(json.loads(ln))
    except Exception as e:  # noqa: BLE001 - surfaced to the test
        out.append({"client_error": repr(e)})


class _Gate:
    """Wraps ``srv.sched.step``: once armed, the next round waits (after
    running) until ``release()``; ``held`` is set while it waits."""

    def __init__(self, srv):
        self.real = srv.sched.step
        self.armed = False
        self.held = threading.Event()
        self.go = threading.Event()
        srv.sched.step = self.step

    def step(self):
        out = self.real()
        if self.armed:
            self.armed = False
            self.held.set()
            assert self.go.wait(HTTP_TIMEOUT), "gate never released"
        return out

    def release(self):
        self.go.set()


class _Stepper:
    """Wraps ``srv.sched.step``: while ``hold`` is on, each round waits after
    running until ``advance()`` (or ``release()``) lets it go; ``held`` is
    set while a round waits."""

    def __init__(self, srv):
        self.real = srv.sched.step
        self.hold = True
        self.held = threading.Event()
        self.go = threading.Event()
        srv.sched.step = self.step

    def step(self):
        out = self.real()
        if self.hold:
            self.held.set()
            assert self.go.wait(HTTP_TIMEOUT), "the round was never let go"
            self.go.clear()
        return out

    def advance(self):
        """Let the held round publish, and wait for the next to hold."""
        self.held.clear()
        self.go.set()
        assert self.held.wait(HTTP_TIMEOUT), "no next round"

    def release(self):
        self.hold = False
        self.go.set()


def _boom():
    raise RuntimeError("injected profiler failure")


def _boom_once(window):
    """Make ``window.add`` (a round's publish calls it for each event with
    tokens) raise once, then be itself again."""
    def add(*a, **kw):
        del window.add
        raise RuntimeError("injected publish failure")
    window.add = add


def _held_pair(srv, handed_over, port=None):
    """Request 1 (56 tokens, four rounds of 16) decoding on a batch-1
    engine held at a round boundary by a ``_Stepper``; request 2 in
    ``_pending``, or, with ``handed_over``, taken into the next round
    (queued behind request 1) and held there. Clients post to ``port`` (a router in front) or to
    the server. Returns (stepper, lines 1, lines 2, threads)."""
    port = port or srv.port
    stepper = _Stepper(srv)
    first: list = []
    second: list = []
    t1 = threading.Thread(target=_stream_lines, args=(
        port, {"tokens": [1, 2, 3], "max_new": 56}, first))
    t1.start()
    assert stepper.held.wait(HTTP_TIMEOUT)
    stepper.advance()
    wait_until(lambda: tokens_of(first), what="the first tokens")
    t2 = threading.Thread(target=_stream_lines, args=(
        port, {"tokens": [4, 5, 6], "max_new": 8}, second))
    t2.start()
    wait_until(lambda: srv._pending, what="the second request waiting")
    if handed_over:
        stepper.advance()
        assert not srv._pending
    return stepper, first, second, (t1, t2)


def _ended(threads, *streams):
    """Both clients return, each stream with one final chunk."""
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
        assert not t.is_alive()
    for lines in streams:
        assert not any("client_error" in ln for ln in lines), lines
        assert sum(1 for ln in lines if ln.get("done")) == 1, lines
        assert lines[-1].get("done") is True, lines


def test_engine_exit_outside_the_round_ends_every_open_stream(monkeypatch):
    """An exception in ``_profile_tick``, which once ended the engine
    thread with clients waiting on their queues (the request handed over
    in that round had not reached the scheduler), now fails only the
    /profilez capture in flight: its handler answers 504, /healthz keeps
    the cause and stays 200 on the same engine thread, and every open
    stream, mid-decode or still queued, ends with one final chunk and
    the oracle's tokens."""
    monkeypatch.setenv("TPUBC_PROFILEZ", "1")
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=1,
                                 paged=True, kv_quant=True, kv_blocks=24,
                                 block_size=8, host="127.0.0.1",
                                 device="cpu").start()
    restarts = telemetry.metrics().to_json().get(
        "serve_engine_restarts_total", 0)
    try:
        engine = srv._engine
        stepper, first, second, threads = _held_pair(srv, False)
        srv._profile_tick = _boom
        capture: list = []
        tp = threading.Thread(target=lambda: capture.append(post(
            srv.port, None, path="/profilez?ms=50")))
        tp.start()
        wait_until(lambda: srv._profile is not None, what="a parked capture")
        stepper.release()
        _ended(threads, first, second)
        tp.join(timeout=HTTP_TIMEOUT)
        assert capture and capture[0][0] == 504, capture
        assert not first[-1].get("error") and not second[-1].get("error")
        assert tokens_of(first) == solo([1, 2, 3], 56)
        assert tokens_of(second) == solo([4, 5, 6], 8)
        assert srv._engine is engine and engine.is_alive()
        code, h = get(srv.port, "/healthz")
        assert code == 200 and h["ok"], h
        assert h["last_error"] == \
            "profilez: RuntimeError: injected profiler failure"
        assert h["served"] == 2
        assert telemetry.metrics().to_json().get(
            "serve_engine_restarts_total", 0) == restarts
    finally:
        srv.stop()


def test_publish_failure_fails_the_round_streams_and_serves_on():
    """An exception while a round's events are published (outside the
    round's guarded ``try`` until then) takes the abort-all path: every
    stream the engine holds, the one mid-decode (its tokens a prefix of
    the oracle's) and the one queued in that round (no token), ends with
    one error chunk, and the same engine thread serves the next request
    exactly."""
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=1,
                                 paged=True, kv_quant=True, kv_blocks=24,
                                 block_size=8, host="127.0.0.1",
                                 device="cpu").start()
    try:
        engine = srv._engine
        stepper, first, second, threads = _held_pair(srv, True)
        _boom_once(srv._tps_window)
        stepper.release()
        _ended(threads, first, second)
        for lines in (first, second):
            assert lines[-1]["error"] == \
                "RuntimeError: injected publish failure", lines
        got = tokens_of(first)
        assert 0 < len(got) < 56 and got == solo([1, 2, 3], 56)[:len(got)]
        assert tokens_of(second) == []
        assert srv._engine is engine and engine.is_alive()
        code, h = get(srv.port, "/healthz")
        assert code == 200 and h["ok"], h
        code, _, out = post(srv.port, {"tokens": [7, 8], "max_new": 6,
                                       "stream": False})
        assert code == 200 and not out.get("error")
        assert out["tokens"] == solo([7, 8], 6)
    finally:
        srv.stop()


def test_drain_flushes_streams_with_final_draining_chunk():
    """drain() mid-stream ends the open response with {"done": true,
    "draining": true} and its committed prefix, while the front door
    answers 503 with a Retry-After and /healthz shows draining."""
    srv = _paged_server()
    try:
        gate = _Gate(srv)
        gate.armed = True
        lines: list = []
        t = threading.Thread(target=_stream_lines, args=(
            srv.port, {"tokens": [1, 2, 3], "max_new": 56}, lines))
        t.start()
        assert gate.held.wait(HTTP_TIMEOUT)
        done = {"ms": None}
        dt = threading.Thread(
            target=lambda: done.update(ms=srv.drain(timeout_ms=250)))
        dt.start()
        wait_until(lambda: get(srv.port, "/healthz")[0] == 503,
                   what="/healthz draining")
        code, h = get(srv.port, "/healthz")
        assert h.get("draining") is True
        code, headers, body = post(srv.port, {"tokens": [9], "max_new": 2})
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert body.get("draining") is True
        # Past the drain window, let the engine reach its next boundary.
        wait_until(lambda: telemetry.monotonic() > srv._drain_deadline,
                   what="the drain window's end")
        gate.release()
        dt.join(timeout=HTTP_TIMEOUT)
        t.join(timeout=HTTP_TIMEOUT)
        assert done["ms"] is not None and done["ms"] < 40_000
        final = lines[-1]
        assert final.get("done") is True and final.get("draining") is True
        assert "draining" in final["error"]
        got = tokens_of(lines)
        assert 0 < len(got) < 56 and got == solo([1, 2, 3], 56)[:len(got)]
        rz = get(srv.port, "/requestz")[1]
        assert any(ev.get("reason") == "drain"
                   for req in rz["requests"] for ev in req["events"]), rz
        assert telemetry.metrics().to_json().get("serve_drain_ms", -1) >= 0
    finally:
        srv.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_flags_stall_and_restarts_dead_engine():
    """A wedged round flips /healthz to 503 (stalled_ms, last_error) and
    clears when rounds resume; a dead engine thread is recovered on a
    fresh thread (graphs and pools kept) with the in-flight stream
    completing exactly."""
    mj0 = telemetry.metrics().to_json()
    srv = _paged_server(watchdog_stall_ms=300)
    try:
        gate = _Gate(srv)
        gate.armed = True
        lines: list = []
        t = threading.Thread(target=_stream_lines, args=(
            srv.port, {"tokens": [1, 2, 3], "max_new": 50}, lines))
        t.start()
        assert gate.held.wait(HTTP_TIMEOUT)
        wait_until(lambda: get(srv.port, "/healthz")[0] == 503,
                   what="the stall flag")
        code, h = get(srv.port, "/healthz")
        assert "stalled_ms" in h and "stall" in h["last_error"]
        gate.release()
        t.join(timeout=HTTP_TIMEOUT)
        assert lines[-1].get("done") and not lines[-1].get("error")
        assert tokens_of(lines) == solo([1, 2, 3], 50)
        wait_until(lambda: get(srv.port, "/healthz")[0] == 200,
                   what="the stall clearing")
        real_step = gate.real
        mode = {"die": True}

        def dying_step():
            if mode.pop("die", False):
                raise SystemExit("injected engine-thread death")
            return real_step()

        srv.sched.step = dying_step
        lines = []
        _stream_lines(srv.port, {"tokens": [1, 2, 3], "max_new": 50}, lines)
        assert lines[-1].get("done") and not lines[-1].get("error"), lines
        assert tokens_of(lines) == solo([1, 2, 3], 50)
        mj = telemetry.metrics().to_json()
        assert (mj["serve_engine_stalls_total"]
                > mj0.get("serve_engine_stalls_total", 0))
        assert (mj["serve_engine_restarts_total"]
                > mj0.get("serve_engine_restarts_total", 0))
    finally:
        srv.stop()


def test_ingress_write_fault_kills_one_stream_not_the_server():
    srv = _paged_server()
    try:
        faults.install("ingress.write:1:1")  # the 2nd write to any stream
        lines: list = []
        _stream_lines(srv.port, {"tokens": [1, 2], "max_new": 30}, lines)
        faults.install(None)
        assert len(tokens_of(lines)) < 30, "the stream was cut short"
        assert not any(ln.get("done") for ln in lines)
        code, _, out = post(srv.port, {"tokens": [5, 6], "max_new": 6})
        assert out[-1]["done"] and not out[-1].get("error")
        assert tokens_of(out) == solo([5, 6], 6)
        code, h = get(srv.port, "/healthz")
        assert code == 200 and h["ok"] is True
    finally:
        srv.stop()


def test_scrape_fault_returns_500_not_a_crash():
    srv = _paged_server()
    try:
        faults.install("scrape")
        code, body = get(srv.port, "/metrics.json")
        assert code == 500 and "injected fault at scrape" in body["error"]
        faults.install(None)
        assert get(srv.port, "/metrics.json")[0] == 200
    finally:
        srv.stop()


def test_deadline_while_queued_is_a_504_with_no_token():
    """A request whose deadline passes while it waits behind a running one
    (batch 1) is shed at the next round boundary: 504, deadline_exceeded,
    no token; the running request completes exactly."""
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=1,
                                 paged=True, kv_quant=True, block_size=8,
                                 host="127.0.0.1", device="cpu").start()
    try:
        gate = _Gate(srv)
        gate.armed = True
        first: list = []
        t = threading.Thread(target=_stream_lines, args=(
            srv.port, {"tokens": [1, 2, 3], "max_new": 40}, first))
        t.start()
        assert gate.held.wait(HTTP_TIMEOUT)
        answer = {}
        late = threading.Thread(target=lambda: answer.update(r=post(
            srv.port, {"tokens": [4, 5], "max_new": 4, "stream": False,
                       "deadline_ms": 50})))
        late.start()
        wait_until(lambda: srv._pending or srv.sched.queue_depth(),
                   what="the late request queued")
        start = telemetry.monotonic()
        wait_until(lambda: telemetry.monotonic() > start + 0.1,
                   what="its deadline")
        gate.release()
        late.join(timeout=HTTP_TIMEOUT)
        t.join(timeout=HTTP_TIMEOUT)
        code, _, body = answer["r"]
        assert code == 504 and body["deadline_exceeded"] is True
        assert body["tokens"] == [] and body["done"] is True
        assert tokens_of(first) == solo([1, 2, 3], 40)
    finally:
        srv.stop()


_SIGTERM_CHILD = r"""
import sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from tpu_bootstrap_torch.workload import model, quant
from tpu_bootstrap_torch.workload.ingress import IngressServer
cfg = model.ModelConfig(vocab_size=32, num_layers=1, num_heads=2,
                        head_dim=16, embed_dim=16, mlp_dim=32,
                        max_seq_len=64)
params = quant.quantize_params(model.init_params(cfg, seed=1, device="cpu"))
srv = IngressServer(params, cfg, port=0, batch_size=2, paged=True,
                    kv_quant=True, kv_blocks=24, block_size=8,
                    host="127.0.0.1", device="cpu")
step = srv.sched.step
def slow_step():  # a slow device: the drain window ends mid-stream
    out = step()
    time.sleep(0.4)
    return out
srv.sched.step = slow_step
srv.serve_forever()
"""


def test_chaos_sigterm_mid_burst():
    """A real SIGTERM to a serve_forever process mid-stream: the drain
    window expires, the resident is checkpoint-preempted, the client's
    last chunk is {"done": true, "draining": true}, and the process exits
    0."""
    env = {**os.environ, "TPUBC_DRAIN_TIMEOUT_MS": "300"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHILD.format(root=str(ROOT))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True)
    try:
        port = None
        deadline = time.monotonic() + HTTP_TIMEOUT
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if "ingress: serving on :" in line:
                port = int(line.split(":")[-1].split()[0].rstrip(")"))
                break
        assert port, "child never came up"
        lines: list = []
        t = threading.Thread(target=_stream_lines, args=(
            port, {"tokens": [1, 2, 3], "max_new": 56}, lines))
        t.start()
        wait_until(lambda: any(ln.get("tokens") for ln in lines)
                   or proc.poll() is not None, timeout=HTTP_TIMEOUT,
                   what="the stream's first tokens")
        assert proc.poll() is None, "child died before the burst"
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=HTTP_TIMEOUT)
        final = lines[-1]
        assert final.get("done") is True, final
        assert final.get("draining") is True, final
        assert 0 < len(tokens_of(lines)) < 56
        assert proc.wait(timeout=HTTP_TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
