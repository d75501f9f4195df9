"""Mirrors of the reference's tests/test_lock_regressions.py:31-208 on the
port: the Tracer's spans and drop count read under one lock hold, the
Scheduler's snapshot safe from a second thread while the engine runs, the
ingress's /poolz published by the engine at round boundaries (coherent
under load, the allocator's numbers exactly once idle) and the locked
cached-tokens harvest, on the f32 bridged int8 weights of
tests/test_torch_scheduler.py (the paged engine, K2's and K1's plain
versions on the CPU). Hammer-style: a reader thread spins against the
engine under a real burst, and every observable must hold every time it
is read."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_ingress import wait_until
from tests.test_torch_scheduler import POOL, TCFG, TPARAMS
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload.ingress import IngressServer
from tpu_bootstrap_torch.workload.serving import PagedPool, Request, Scheduler

torch.set_num_threads(2)


def test_tracer_to_json_pairs_spans_with_drop_count():
    """to_json captures spans and the drop counter under ONE lock hold
    (the counter was read bare before): a full buffer must report
    exactly its overflow, never a torn mix."""
    tr = telemetry.Tracer(process="t", capacity=4)
    for i in range(7):
        tr.add_span(f"s{i}", 1000 + i, 10)
    doc = tr.to_json()
    assert doc["dropped"] == 3
    assert len(doc["spans"]) == 4
    assert [s["name"] for s in doc["spans"]] == ["s3", "s4", "s5", "s6"]


def test_tracer_to_json_consistent_under_concurrent_records():
    tr = telemetry.Tracer(process="t", capacity=16)
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            tr.add_span(f"w{i}", 1, 1)
            i += 1

    def reader():
        try:
            while not stop.is_set():
                doc = tr.to_json()
                # Invariant at every read: the buffer never exceeds
                # capacity and dropped only counts past-capacity spans.
                assert len(doc["spans"]) <= 16
                assert doc["dropped"] >= 0
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer),
               threading.Thread(target=reader)]
    for t in threads:
        t.start()
    # Until the writer has overflowed the buffer many times over.
    wait_until(lambda: tr.to_json()["dropped"] > 200,
               what="the writer's progress")
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors


def test_scheduler_snapshot_safe_while_engine_runs():
    """Scheduler.snapshot()/queue_depth() from a second thread while
    the driving thread submits and steps a burst: before the Scheduler
    grew its lock, snapshot sorted the live heap mid-push."""
    pool = PagedPool(TPARAMS, TCFG, batch_size=4, block_size=8,
                     kv_blocks=24, **POOL)
    sched = Scheduler(pool, expected_new=2)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i,
                    tokens=rng.integers(1, 32, int(rng.integers(2, 8)))
                    .tolist(),
                    max_new=int(rng.integers(4, 12)), priority=i % 3)
            for i in range(12)]
    errors = []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set():
                snap = sched.snapshot()
                assert snap["queue_depth"] == len(snap["waiting"])
                # Queue order invariant must hold in every snapshot:
                # priority classes descend.
                prios = [w["priority"] for w in snap["waiting"]]
                assert prios == sorted(prios, reverse=True)
                assert sched.queue_depth() >= 0
                assert sched.queue_wait_p50_ms() >= 0
                # Hand the GIL over: the engine's eager ops queue behind a
                # thread that never blocks.
                time.sleep(0)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    try:
        retired = {}
        for r in reqs:
            sched.submit(r)
        while sched.pending() or pool.has_active():
            for rid, ev in sched.step().items():
                if ev["done"]:
                    retired[rid] = ev["generated"]
    finally:
        done.set()
        t.join(timeout=30)
    assert not errors, errors
    assert len(retired) == len(reqs)


@pytest.fixture(scope="module")
def server():
    srv = IngressServer(TPARAMS, TCFG, port=0, batch_size=4, paged=True,
                        kv_quant=True, block_size=8, kv_blocks=16,
                        prefill_budget=8, host="127.0.0.1",
                        device="cpu").start()
    yield srv
    srv.stop()


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_poolz_is_published_and_coherent_under_load(server):
    """/poolz while a burst runs: every response must be a coherent
    round-boundary view — the block-state arithmetic (total = live +
    cached + free) can only hold if the snapshot was never torn by a
    mid-round mutation, which is exactly what the engine-published
    _poolz guarantees (the old handler walked live pool state)."""
    errors = []
    stop = threading.Event()

    def prober():
        try:
            while not stop.is_set():
                pz = _get(server.port, "/poolz")
                assert "as_of_us" in pz and pz["as_of_us"] > 0
                b = pz["pool"]["blocks"]
                assert b["free"] >= 0 and b["live"] >= 0
                assert b["total"] == b["live"] + b["cached"] + b["free"]
                assert b["available"] == b["free"] + b["cached"]
                h = _get(server.port, "/healthz")
                assert h["active"] >= 0 and h["queued"] >= 0
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    prober_t = threading.Thread(target=prober)
    prober_t.start()
    try:
        rng = np.random.default_rng(7)
        posts = [threading.Thread(target=_post, args=(server.port, {
            "tokens": rng.integers(1, 32, int(rng.integers(2, 8))).tolist(),
            "max_new": int(rng.integers(4, 12)), "stream": False}))
            for _ in range(10)]
        for p in posts:
            p.start()
        for p in posts:
            p.join(timeout=60)
    finally:
        stop.set()
        prober_t.join(timeout=30)
    assert not errors, errors
    # Idle again: the published snapshot must equal the allocator
    # exactly (same pin as test_requestz's poolz test — publication
    # changed the transport, not the numbers).
    pz = _get(server.port, "/poolz")
    assert pz["pool"]["blocks"]["live"] == server.pool.allocator.used()
    assert pz["pool"]["blocks"]["cached"] == server.pool.allocator.cached()
    h = _get(server.port, "/healthz")
    assert h["active"] == 0


def test_cached_tokens_still_reach_responses(server):
    """The _cached_toks harvest moved under the ingress lock; the
    surface it feeds (cached_tokens on the final response, after a
    prefix-cache hit) must be intact."""
    prompt = list(range(1, 17))   # two full 8-token blocks
    first = _post(server.port, {"tokens": prompt, "max_new": 4,
                                "stream": False})
    again = _post(server.port, {"tokens": prompt, "max_new": 4,
                                "stream": False})
    assert first["done"] and again["done"]
    assert again.get("cached_tokens", 0) > 0
    assert again["tokens"] == first["tokens"]
