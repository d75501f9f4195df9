"""The front door on the paged engine (int8 KV pool, K2's and K1's plain
versions on the CPU), on the f32 bridged int8 weights of
tests/test_torch_scheduler.py: mirrors of the reference's ingress tests
that ride the paged engine.

* tests/test_paged.py:225 (a never-fitting request is a 400 naming KV
  blocks, against the reference's server too) and :328 (concurrent clients
  through the paged ingress, every stream equal to solo ``generate``);
* tests/test_prefix_cache.py:370 (``cached_tokens`` on the final object,
  the cached/cold TTFT split);
* tests/test_scheduler.py:450-480 (priority, deadline and queue position
  end to end; the 429 half is tests/test_torch_ingress.py's, against the
  reference);
* tests/test_requestz.py:233's Prometheus half and :255-end (the timing
  block and trace echo, /requestz's ring, filter and trace join, /poolz
  equal to the allocator);
* tests/test_ledger.py:286-end (/profilez: 403, 400, a capture's ledger
  summary on torch.profiler with its Chrome trace, MFU under
  TPUBC_PEAK_TFLOPS and null without a peak; the unchanged
  ``fleetz.flatten_window`` over the port's registry; a FleetAggregator's
  ``?window=`` pass-through to a port replica);
* tests/test_fleetz.py:589 (/cachez and the windowed /metrics.json).

These run on the port's server alone and hold the streams to the port's
solo greedy ``generate``: each reference server compiles a program a
shape, which this file's 60 s budget does not hold; the reference's
answers on the same requests are compared exactly in
tests/test_torch_ingress.py's differential."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_ingress import (
    HTTP_TIMEOUT,
    check_keys,
    get,
    post,
    solo,
    tokens_of,
    wait_until,
)
from tests.test_torch_scheduler import (
    JCFG,
    JPARAMS,
    POOL,
    TCFG,
    TPARAMS,
    _drive,
)
from tpu_bootstrap.workload import fleetz
from tpu_bootstrap.workload import ingress as jingress
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import ingress as tingress
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def server():
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=4,
                                 paged=True, kv_quant=True, block_size=8,
                                 device="cpu", host="127.0.0.1").start()
    yield srv
    srv.stop()


def _requests(n, seed, vocab=32, max_prompt=9, max_budget=13):
    """tests/test_paged.py:39's traffic at the port's vocab."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, int(rng.integers(2, max_prompt)))
             .tolist(), int(rng.integers(1, max_budget))) for _ in range(n)]


# ---- test_paged.py ---------------------------------------------------------


def test_ingress_front_door_rejects_never_fits_paged_request():
    answers = []
    for cls, params, cfg, kw in (
            (jingress.IngressServer, JPARAMS, JCFG, {}),
            (tingress.IngressServer, TPARAMS, TCFG, {"device": "cpu"})):
        srv = cls(params, cfg, port=0, batch_size=2, paged=True,
                  kv_quant=True, kv_blocks=4, block_size=8,
                  host="127.0.0.1", **kw).start()
        try:
            answers.append(post(srv.port, {"tokens": [1] * 8,
                                           "max_new": 40})[::2])
        finally:
            srv.stop()
    assert answers[1] == answers[0]
    assert answers[1][0] == 400 and "KV blocks" in answers[1][1]["error"]


def test_paged_through_the_ingress_concurrent_clients(server):
    jobs = _requests(5, seed=9)
    results = [None] * len(jobs)
    errors: list = []

    def client(i):
        try:
            tokens, max_new = jobs[i]
            code, _, out = post(server.port, {"tokens": tokens,
                                              "max_new": max_new,
                                              "stream": False})
            assert code == 200
            results[i] = out["tokens"]
        except Exception as e:  # noqa: BLE001
            errors.append(f"{i}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    assert not errors, errors
    for i, (tokens, max_new) in enumerate(jobs):
        assert results[i] == solo(tokens, max_new), i


# ---- test_prefix_cache.py:370 ---------------------------------------------


def test_ingress_surfaces_cached_tokens(server):
    prompt = [int(t) for t in np.random.default_rng(13).integers(1, 32, 17)]
    first = post(server.port, {"tokens": prompt, "max_new": 6,
                               "stream": False})[2]
    assert first["cached_tokens"] == 0
    second = post(server.port, {"tokens": prompt, "max_new": 6,
                                "stream": False})[2]
    assert second["cached_tokens"] == 16  # two full blocks
    assert second["tokens"] == first["tokens"] == solo(prompt, 6)
    js = telemetry.metrics().to_json()
    assert js.get("serve_cached_ttft_ms_count", 0) >= 1
    assert js.get("serve_cold_ttft_ms_count", 0) >= 1
    assert js.get("kv_prefix_hit_tokens_total", 0) >= 16


# ---- test_scheduler.py:450-480 --------------------------------------------


def test_ingress_priority_deadline_and_position_end_to_end():
    srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=2,
                                 paged=True, kv_quant=True, block_size=8,
                                 device="cpu", host="127.0.0.1").start()
    try:
        code, _, out = post(srv.port, {"tokens": [3, 4], "max_new": 3,
                                       "stream": False, "priority": 2,
                                       "deadline_ms": 60000})
        assert code == 200 and out["done"] is True
        assert out["queue_position"] == 0
        assert out["tokens"] == solo([3, 4], 3)
        for bad in ({"priority": "high"}, {"deadline_ms": -5}):
            assert post(srv.port, {"tokens": [1], "max_new": 1,
                                   **bad})[0] == 400
    finally:
        srv.stop()


# ---- test_requestz.py:233 (Prometheus half) and :255-end ------------------


def test_per_class_histogram_labels_in_the_prometheus_text():
    from prometheus_client.parser import text_string_to_metric_families

    reqs = [tserving.Request(rid=i, tokens=[1 + i, 2, 3], max_new=4,
                             priority=i % 3) for i in range(6)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8, **POOL)
    _drive(pool, tserving.Scheduler(pool), reqs)
    fams = {f.name: f for f in text_string_to_metric_families(
        telemetry.metrics().to_prometheus())}
    hist = fams["serve_queue_wait_ms"]
    assert hist.type == "histogram"
    classes = {s.labels["priority"] for s in hist.samples
               if "priority" in s.labels}
    assert {"0", "1", "2"} <= classes


def test_ingress_timing_block_and_trace_echo(server):
    out = post(server.port, {"tokens": [1, 2, 3], "max_new": 4,
                             "stream": False, "priority": 1,
                             "trace_id": "cafe0123deadbeef"})[2]
    assert out["done"] and out["trace_id"] == "cafe0123deadbeef"
    t = out["timing"]
    assert t["total_ms"] >= 0 and t["legs"] >= 1
    assert (t["queue_ms"] + t["prefill_ms"] + t["decode_ms"]
            + t["recompute_ms"]) <= t["total_ms"] + 0.01
    out2 = post(server.port, {"tokens": [4, 5], "max_new": 3,
                              "stream": False},
                headers={"X-Tpubc-Trace": "feedface00112233"})[2]
    assert out2["trace_id"] == "feedface00112233"
    lines = post(server.port, {"tokens": [7, 8], "max_new": 3,
                               "stream": True})[2]
    assert lines[-1]["done"] and "timing" in lines[-1]
    assert "trace_id" in lines[-1]


def test_requestz_ring_filter_and_trace_join(server):
    post(server.port, {"tokens": [9, 10, 11], "max_new": 4, "stream": False,
                       "trace_id": "0123456789abcdef"})
    rz = get(server.port, "/requestz")[1]
    assert rz["enabled"] is True
    rec = next(r for r in rz["requests"]
               if r["trace_id"] == "0123456789abcdef")
    kinds = [e["kind"] for e in rec["events"]]
    assert kinds[0] == "enqueued" and "admitted" in kinds
    assert rec["state"] == "retired"
    one = get(server.port, f"/requestz?rid={rec['rid']}")[1]
    assert [r["rid"] for r in one["requests"]] == [rec["rid"]]
    assert get(server.port, "/requestz?rid=zzz")[0] == 400
    tj = get(server.port, "/traces.json")[1]
    joined = [s for s in tj["spans"] if s["trace_id"] == "0123456789abcdef"]
    assert any(s["name"] == "serve.request" for s in joined)
    assert any(s["name"].startswith("serve.phase.") for s in joined)


def test_poolz_matches_allocator_exactly(server):
    post(server.port, {"tokens": [1, 2, 3, 4], "max_new": 4,
                       "stream": False})
    pz = get(server.port, "/poolz")[1]
    pool = server.pool
    blocks = pz["pool"]["blocks"]
    assert blocks["live"] == pool.allocator.used()
    assert blocks["cached"] == pool.allocator.cached()
    assert blocks["available"] == pool.allocator.available()
    assert blocks["free"] == blocks["available"] - blocks["cached"]
    assert blocks["total"] == pool.allocator.num_blocks
    assert pz["pool"]["block_size"] == pool.block_size
    assert pz["scheduler"]["queue_depth"] == 0
    assert "expected_new_ema" in pz["scheduler"]
    mj = get(server.port, "/metrics.json")[1]
    assert mj.get('serve_ttft_ms{priority="1"}_count', 0) >= 1


# ---- test_ledger.py:286-end -----------------------------------------------


def test_profilez_disabled_is_403_and_bad_ms_is_400(server, monkeypatch):
    monkeypatch.delenv("TPUBC_PROFILEZ", raising=False)
    assert post(server.port, None, path="/profilez")[0] == 403
    monkeypatch.setenv("TPUBC_PROFILEZ", "1")
    for bad in ("0", "-5", "999999", "zzz"):
        assert post(server.port, None,
                    path=f"/profilez?ms={bad}")[0] == 400, bad


def _profilez_under_traffic(server, ms: int) -> dict:
    """POST /profilez?ms= while a client keeps the engine busy."""
    stop = threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            i += 1
            post(server.port, {"tokens": [1 + i % 7, 2, 3], "max_new": 6,
                               "stream": False})

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        code, _, out = post(server.port, None, path=f"/profilez?ms={ms}")
    finally:
        stop.set()
        t.join(timeout=HTTP_TIMEOUT)
    assert code == 200, out
    return out


def test_profilez_capture_summarizes_ledger(server, monkeypatch, tmp_path):
    monkeypatch.setenv("TPUBC_PROFILEZ", str(tmp_path))
    monkeypatch.setenv("TPUBC_PEAK_TFLOPS", "989")
    out = _profilez_under_traffic(server, 300)
    assert out["requested_ms"] == 300
    assert out["measured_ms"] >= 300
    led = out["ledger"]
    assert led["rounds"] > 0 and led["busy_ms"] > 0
    assert led["busy_ms"] + led["idle_ms"] == pytest.approx(
        led["wall_ms"], abs=0.01)
    assert 0 < out["busy_frac"] <= 1.0
    assert out["mfu"] >= 0
    # The port's profiler is torch.profiler: it opens on the CPU too, and
    # its Chrome trace lands in the artifact directory.
    assert out["mode"] == "profiler" and "profiler_error" not in out
    assert out["artifact_dir"] == str(tmp_path)
    traces = [p for p in os.listdir(tmp_path) if p.startswith("profilez-")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    check_keys("/profilez", out, out)
    ok = post(server.port, {"tokens": [4, 5], "max_new": 3,
                            "stream": False})[2]
    assert ok["done"] and "device_ms" in ok["timing"]


def test_profilez_mfu_is_null_without_a_peak(server, monkeypatch, tmp_path):
    monkeypatch.setenv("TPUBC_PROFILEZ", str(tmp_path))
    monkeypatch.delenv("TPUBC_PEAK_TFLOPS", raising=False)
    out = _profilez_under_traffic(server, 100)
    assert "mfu" in out and out["mfu"] is None
    assert 0 < out["busy_frac"] <= 1.0


def test_flatten_window_over_the_port_registry():
    reg = telemetry.metrics()
    reg.inc("ledgertest_total", 3.0)
    reg.observe("ledgertest_ms", 40.0)
    live = fleetz.flatten_window(reg.window_json(60))
    assert live["ledgertest_total"] == reg.to_json()["ledgertest_total"]
    assert live["ledgertest_total_window_delta"] >= 3.0
    assert live["ledgertest_ms_window_count_delta"] >= 1
    assert 25 < live["ledgertest_ms_window_p50"] <= 50


def test_fleetz_window_passthrough_to_a_port_replica(server):
    post(server.port, {"tokens": [2, 4, 6], "max_new": 3, "stream": False})
    addr = f"127.0.0.1:{server.port}"
    agg = fleetz.FleetAggregator([addr], port=0, host="127.0.0.1",
                                 poll_s=3600.0, stale_after_s=1e9)
    try:
        agg.poll_once(now=100.0)
        doc = agg.fleetz_json(now=100.0)
        assert doc["window_secs"] is None
        entry = doc["replicas"][addr]
        assert "window" not in entry
        assert entry["busy_frac"] == telemetry.metrics().to_json()[
            "serve_engine_busy_frac"]
        doc = agg.fleetz_json(now=100.0, window=60)
        assert doc["window_secs"] == 60.0
        win = doc["replicas"][addr]["window"]
        assert win["series"]["serve_ttft_ms"]["count"] >= 1
        wtext = agg.federated_metrics(window=60)
        assert f'serve_ttft_ms_window_p99{{replica="{addr}"}}' in wtext
    finally:
        agg.httpd.server_close()


# ---- test_fleetz.py:589 -----------------------------------------------------


def test_ingress_cachez_and_windowed_metrics(server):
    from tpu_bootstrap_torch.workload.serving import digest_match_len

    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 32, 24).tolist() + rng.integers(1, 32,
                                                             4).tolist()
    assert post(server.port, {"tokens": prompt, "max_new": 4,
                              "stream": False})[2]["done"] is True
    cz = get(server.port, "/cachez")[1]
    assert cz["digest"]["block_size"] == 8
    assert cz["digest"]["blocks"] >= 1
    assert digest_match_len(prompt, cz["digest"]) >= 1
    wait_until(lambda: get(server.port, "/poolz")[1]["pool"][
        "cache_digest"] == get(server.port, "/cachez")[1]["digest"],
        what="/poolz and /cachez publishing one digest")
    wj = get(server.port, "/metrics.json?window=30")[1]
    assert wj["window_secs"] == 30.0 and wj["ring"] > 0
    assert any("delta" in e for e in wj["series"].values())
    plain = get(server.port, "/metrics.json")[1]
    assert plain["serve_qps_window_secs"] > 0
    assert plain["serve_tokens_per_sec_window_secs"] > 0
    assert tokens_of(post(server.port, {"tokens": prompt, "max_new": 4})[
        2]) == solo(prompt, 4)
