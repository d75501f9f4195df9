"""The port's workload metrics (tpu_bootstrap_torch/telemetry.py) held to
the reference's registry, and the serve-mode entry: mirrors of the
reference's tests/test_workload_metrics.py.

* :42-112, the registry: the same observations fed to both packages'
  ``MetricsRegistry`` give the same ``to_json``, the same ``to_prometheus``
  text (which the official parser reads) and, on a pinned clock, the same
  ``window_json`` for every window, with rings whole, saturated and off;
  the port's worker server (``start_metrics_server``) answers the
  reference worker's routes with its key sets (and the endpoint
  catalog's).
* :113-231, the workload: the port's train loop and checkpoints export
  the reference's step metrics; its ingress accounts TTFT, inter-token,
  total latency and the rates as the reference's does on the same
  requests (both servers, the slot engine); eos retirements are counted.
* :233-end, where the reference's own fixtures run here: the native
  controller's workload summary over the port's registry, and the
  controller daemon scraping the port's worker server into
  status.slice.workload. (:297's dead-endpoint case scrapes nothing of the
  port.)
* The entry: ``serving.serve_demo_from_env(device="cpu")`` with
  WORKLOAD_PAGED=1 and WORKLOAD_KV_QUANT=1 (the main path) and the slot
  engine, and ``train.worker_main`` with WORKLOAD_MODE=serve and
  WORKLOAD_METRICS_PORT, whose server is scraped."""

from __future__ import annotations

import time
import types

import pytest
import torch

from tests.test_integration_daemons import (
    KEY_JS,
    SYNCED,
    Daemon,
    controller_env,
    fake,  # noqa: F401 - a fixture
    free_port,
    full_spec,
    wait_for,
)
from tests.test_torch_ingress import get, post
from tests.test_torch_scheduler import JCFG, JPARAMS, TCFG, TPARAMS
from tools.lint.endpoint_catalog import CATALOG
from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import ingress as jingress
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import ingress as tingress
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import serving as tserving
from tpu_bootstrap_torch.workload import train as ttrain

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_registry():
    telemetry.metrics().reset()
    jtelemetry.metrics().reset()
    yield
    telemetry.metrics().reset()
    jtelemetry.metrics().reset()


# ---- the registry, held to the reference's ---------------------------------


def _both(script, ring=None) -> tuple:
    """Run ``script(registry)`` on a reference and a port registry."""
    regs = (jtelemetry.MetricsRegistry(ring=ring),
            telemetry.MetricsRegistry(ring=ring))
    for reg in regs:
        script(reg)
    return regs


def _same(regs) -> dict:
    ref, port = regs
    assert port.to_json() == ref.to_json()
    assert port.to_prometheus() == ref.to_prometheus()
    return port.to_json()


def test_histogram_buckets_and_quantiles():
    def script(reg):
        for v in (3, 3, 3, 40, 40, 900):
            reg.observe("lat_ms", v)

    out = _same(_both(script))
    assert out["lat_ms_count"] == 6
    assert out["lat_ms_sum"] == pytest.approx(989)
    assert 25 < out["lat_ms_p50"] <= 50
    assert out["lat_ms_p99"] <= 1000
    assert "lat_ms_overflow" not in out


def test_histogram_overflow_clamps_not_extrapolates():
    def script(reg):
        for _ in range(10):
            reg.observe("lat_ms", 99_999)

    out = _same(_both(script))
    assert out["lat_ms_p50"] == telemetry.DEFAULT_BUCKETS[-1]
    assert out["lat_ms_p99"] == telemetry.DEFAULT_BUCKETS[-1]
    assert out["lat_ms_overflow"] == 10
    regs = _both(script)
    assert regs[1].quantile("lat_ms", 0.5) == regs[0].quantile("lat_ms", 0.5)
    assert regs[1].quantile("nothing", 0.5) == -1.0


def test_custom_buckets_fixed_on_first_observation():
    def script(reg):
        reg.observe("committed", 2.0, buckets=(1, 2, 3, 4, 5))
        reg.observe("committed", 5.0)

    out = _same(_both(script))
    assert out["committed_count"] == 2
    assert out["committed_p99"] <= 5


def _mixed(reg):
    reg.inc("serve_requests_total", 3)
    reg.set_gauge("serve_queue_depth", 2)
    reg.set_gauge("serve_qps", 0.125)
    for v in (1, 10, 100):
        reg.observe("serve_ttft_ms", v)
    for c in ("0", "1"):
        reg.observe("serve_ttft_ms", 7.5, labels={"priority": c})
        reg.inc("serve_device_ms_total", 2.5, labels={"priority": c})


def test_prometheus_exposition_parses():
    from prometheus_client.parser import text_string_to_metric_families

    regs = _both(_mixed)
    _same(regs)
    families = {f.name: f for f in
                text_string_to_metric_families(regs[1].to_prometheus())}
    assert families["serve_requests"].type == "counter"
    assert families["serve_queue_depth"].type == "gauge"
    hist = families["serve_ttft_ms"]
    assert hist.type == "histogram"
    samples = {s.name: s for s in hist.samples if not s.labels}
    assert samples["serve_ttft_ms_count"].value == 3
    infs = [s for s in hist.samples if s.labels.get("le") == "+Inf"
            and "priority" not in s.labels]
    assert infs and infs[0].value == 3
    assert {s.labels["priority"] for s in hist.samples
            if "priority" in s.labels} == {"0", "1"}


def test_rate_window_rolls_off():
    win = telemetry.RateWindow(window_secs=10)
    win.add(5, t=100.0)
    assert win.per_sec(t=100.0) == pytest.approx(0.5)
    assert win.per_sec(t=111.0) == 0.0


@pytest.mark.parametrize("ring", [None, 4, 0])
def test_window_json_equals_reference_on_a_pinned_clock(monkeypatch, ring):
    """The rings sample at record time: both modules' clocks pinned to
    one virtual clock, the same recordings at the same times give the
    same windowed view for every window (whole rings, a saturated ring of
    4, no rings)."""
    clock = {"t": 50.0}
    fake_time = types.SimpleNamespace(monotonic=lambda: clock["t"],
                                      monotonic_ns=time.monotonic_ns,
                                      perf_counter=time.perf_counter,
                                      time=time.time)
    for tel in (jtelemetry, telemetry):
        monkeypatch.setattr(tel, "time", fake_time)
        tel.set_clock(lambda: clock["t"])
    try:
        regs = (jtelemetry.MetricsRegistry(ring=ring),
                telemetry.MetricsRegistry(ring=ring))
        for step in range(12):
            for reg in regs:
                reg.inc("serve_tokens_total", 1 + step % 3)
                reg.set_gauge("serve_queue_depth", step % 4)
                reg.observe("serve_ttft_ms", 3.0 * step,
                            labels={"priority": str(step % 2)})
                reg.observe("serve_request_ms", 40.0 + step)
            clock["t"] += 1.5
        for window in (0, 2, 5, 10, 60):
            got = regs[1].window_json(window)
            assert got == regs[0].window_json(window), window
            assert got["as_of_us"] == int(clock["t"] * 1e6)
        assert regs[1].window_json(5, now=60.0) == regs[0].window_json(
            5, now=60.0)
        assert _same(regs)["serve_tokens_total"] == 24
    finally:
        jtelemetry.set_clock(None)
        telemetry.set_clock(None)


def test_ring_capacity_knob(monkeypatch):
    monkeypatch.setenv("TPUBC_TS_RING", "7")
    assert telemetry.ring_capacity() == jtelemetry.ring_capacity() == 7
    assert telemetry.MetricsRegistry().ring == 7
    monkeypatch.setenv("TPUBC_TS_RING", "junk")
    assert telemetry.ring_capacity() == jtelemetry.ring_capacity() == 256


def _worker_keys(path: str) -> set:
    return set(CATALOG[("worker", path)].keys)


def test_metrics_server_serves_both_expositions():
    for tel in (jtelemetry, telemetry):
        tel.metrics().inc("workload_train_steps_total", 4)
        tel.metrics().set_gauge("workload_last_step", 4)
        tel.heartbeat(step=4)
    servers = [tel.start_metrics_server(0, host="127.0.0.1")
               for tel in (jtelemetry, telemetry)]
    try:
        ref, port = (s.server_address[1] for s in servers)
        m = get(port, "/metrics.json")[1]
        assert m["workload_last_step"] == 4
        assert m == get(ref, "/metrics.json")[1]
        text = get(port, "/metrics", raw=True)[1]
        assert b"workload_train_steps_total 4" in text
        assert text == get(ref, "/metrics", raw=True)[1]
        w = get(port, "/metrics.json?window=30")[1]
        assert w["series"]["workload_last_step"]["now"] == 4
        assert get(port, "/metrics.json?window=x")[0] == 400
        for path in ("/healthz", "/statusz", "/traces.json"):
            code, got = get(port, path)
            want_code, want = get(ref, path)
            assert code == want_code == 200, path
            assert set(got) == set(want), path
            assert set(got) <= _worker_keys(path) | {"attrs", "dur_us"}
        h = get(port, "/healthz")[1]
        assert h["ok"] is True and h["last_step"] == 4
        assert get(port, "/nope")[0] == get(ref, "/nope")[0] == 404
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


def test_metrics_server_healthz_flags_a_stalled_step_loop(monkeypatch):
    monkeypatch.setenv("TPUBC_WATCHDOG_STALL_MS", "1")
    telemetry.heartbeat(step=9)
    age0 = telemetry.heartbeat_snapshot()[1]
    httpd = telemetry.start_metrics_server(0, host="127.0.0.1")
    try:
        port = httpd.server_address[1]
        time_left = 5.0
        t0 = time.monotonic()
        while telemetry.heartbeat_snapshot()[1] <= 1.0:
            assert time.monotonic() - t0 < time_left
        code, h = get(port, "/healthz")
        assert code == 503 and h["ok"] is False and h["last_step"] == 9
        assert h["stalled_ms"] >= age0
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---- workload instrumentation ----------------------------------------------

TRAIN_MODEL = tmodel.ModelConfig(vocab_size=64, num_layers=1, num_heads=2,
                                 head_dim=16, embed_dim=32, mlp_dim=48,
                                 max_seq_len=16)


def test_train_loop_exports_step_metrics():
    cfg = ttrain.TrainConfig(model=TRAIN_MODEL)
    ttrain.train_loop(cfg, 3, log_every=0, device="cpu")
    m = telemetry.metrics().to_json()
    assert m["workload_train_steps_total"] == 3
    assert m["workload_last_step"] == 3
    assert m["workload_train_step_ms_count"] == 3
    assert m["workload_train_step_ms_p50"] > 0
    assert m["workload_tokens_per_sec"] > 0
    assert m["workload_train_loss"] > 0
    assert 0 < m["workload_goodput_frac"] <= 1


def test_checkpoint_save_restore_metrics(tmp_path):
    cfg = ttrain.TrainConfig(model=TRAIN_MODEL)
    ttrain.train_loop(cfg, 2, checkpoint_dir=str(tmp_path), save_every=2,
                      device="cpu")
    m = telemetry.metrics().to_json()
    assert m["workload_checkpoint_save_ms_count"] >= 1
    assert "workload_restarts_total" not in m
    telemetry.metrics().reset()
    ttrain.train_loop(cfg, 4, checkpoint_dir=str(tmp_path), save_every=2,
                      device="cpu")
    m = telemetry.metrics().to_json()
    assert m["workload_restarts_total"] == 1
    assert m["workload_resumed_from_step"] == 2
    assert m["workload_checkpoint_restore_ms_count"] == 1


def test_ingress_ttft_accounting():
    """TTFT is first-token latency, total is retirement latency; a
    two-round stream records inter-token cadence; the rates feed the
    scrape summary. Both packages' slot-engine servers on the same
    request account the same counts."""
    counts = []
    for cls, params, cfg, kw, tel in (
            (jingress.IngressServer, JPARAMS, JCFG, {}, jtelemetry),
            (tingress.IngressServer, TPARAMS, TCFG, {"device": "cpu"},
             telemetry)):
        srv = cls(params, cfg, port=0, batch_size=2, host="127.0.0.1",
                  **kw).start()
        try:
            # max_new 5 decodes as a chunk of 4 and one of 1: two rounds.
            code, _, out = post(srv.port, {"tokens": [1, 2, 3],
                                           "max_new": 5, "stream": False})
            assert code == 200 and len(out["tokens"]) == 5
            m = get(srv.port, "/metrics.json")[1]
            assert m["serve_requests_total"] == 1
            assert m["serve_tokens_total"] == 5
            assert m["serve_ttft_ms_count"] == 1
            assert m["serve_request_ms_count"] == 1
            assert m["serve_ttft_ms_sum"] <= m["serve_request_ms_sum"]
            assert m["serve_inter_token_ms_count"] >= 1
            assert m["serve_qps"] > 0
            assert m["serve_tokens_per_sec"] > 0
            assert 0 < m["serve_slot_utilization"] <= 1
            assert b"serve_ttft_ms_bucket" in get(srv.port, "/metrics",
                                                  raw=True)[1]
            counts.append({k: m[k] for k in sorted(m)
                           if k.endswith("_count") or k.endswith("_total")
                           and not k.startswith("quant_")})
        finally:
            srv.stop()
    assert counts[1] == counts[0]


def test_eos_retires_counted():
    reqs = [tserving.Request(rid=i, tokens=[1 + i], max_new=8)
            for i in range(4)]
    out = tserving.serve(TPARAMS, TCFG, reqs, 2, eos_id=0, device="cpu")
    retired = telemetry.metrics().to_json().get("serve_eos_retired_total", 0)
    assert retired == sum(1 for toks in out.values() if len(toks) < 8)


# ---- the native controller over the port's worker server -------------------


def test_workload_summary_core_over_the_port_registry(lib):
    reg = telemetry.metrics()
    reg.set_gauge("workload_last_step", 7)
    reg.set_gauge("workload_tokens_per_sec", 123.5)
    reg.set_gauge("serve_qps", 0.25)
    s = lib.workload_summary(reg.to_json(), "2026-08-04T00:00:00Z")
    assert s == {"last_step": 7, "tokens_per_sec": 123.5, "serve_qps": 0.25,
                 "last_scrape": "2026-08-04T00:00:00Z"}
    reg.reset()
    reg.set_gauge("serve_tokens_per_sec", 9.0)
    reg.set_gauge("serve_qps", 1.0)
    assert lib.workload_summary(reg.to_json(), "t")["tokens_per_sec"] == 9.0
    reg.reset()
    reg.set_gauge("unrelated", 1)
    assert lib.workload_summary(reg.to_json(), "t") is None


def test_controller_scrapes_port_worker_metrics_into_status(fake):  # noqa: F811
    telemetry.metrics().set_gauge("workload_last_step", 41)
    telemetry.metrics().set_gauge("workload_tokens_per_sec", 1234.5)
    telemetry.metrics().set_gauge("serve_qps", 0.5)
    worker = telemetry.start_metrics_server(0, host="127.0.0.1")
    fake.create_ub("alice", spec=full_spec(), status=dict(SYNCED))
    port = free_port()
    d = Daemon(
        "tpubc-controller",
        controller_env(fake, port, conf_workload_scrape="1",
                       conf_workload_scrape_addr=(
                           f"127.0.0.1:{worker.server_address[1]}"),
                       conf_workload_scrape_interval_secs="1"),
        port).wait_healthy()
    try:
        js = wait_for(lambda: fake.get(KEY_JS("alice"), "alice-slice"),
                      desc="jobset")
        js["status"] = {"replicatedJobsStatus": [
            {"name": "workers", "ready": 1}]}
        fake.store.upsert(KEY_JS("alice"), "alice-slice", js,
                          preserve_status=False)

        def workload_block():
            ub = fake.get(fake.KEY_UB, "alice") or {}
            return ub.get("status", {}).get("slice", {}).get("workload")

        block = wait_for(workload_block, timeout=20,
                         desc="status.slice.workload merged")
        assert block["last_step"] == 41
        assert block["tokens_per_sec"] == 1234.5
        assert block["serve_qps"] == 0.5
        assert block["last_scrape"]
        m = wait_for(lambda: (lambda m: m if m.get(
            "workload_scrapes_total", 0) >= 1 else None)(d.metrics()),
            timeout=20, desc="a counted scrape")
        assert m.get("workload_scrape_errors_total", 0) == 0
    finally:
        code, err = d.stop()
        assert code == 0, err
        worker.shutdown()
        worker.server_close()


# ---- the serve-mode entry --------------------------------------------------

TINY_MODEL_ENV = ("vocab_size=32,num_layers=1,num_heads=2,head_dim=16,"
                  "embed_dim=16,mlp_dim=32,max_seq_len=64")


@pytest.mark.parametrize("paged", [True, False])
def test_serve_demo_from_env_on_the_cpu(monkeypatch, capsys, paged):
    monkeypatch.setenv("WORKLOAD_MODEL", TINY_MODEL_ENV)
    monkeypatch.setenv("WORKLOAD_QUANT", "int8")
    monkeypatch.setenv("WORKLOAD_KV_QUANT", "1")
    monkeypatch.setenv("WORKLOAD_REQUESTS", "6")
    monkeypatch.setenv("WORKLOAD_SERVE_BATCH", "4")
    monkeypatch.setenv("WORKLOAD_PAGED", "1" if paged else "0")
    tserving.serve_demo_from_env(device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("serve done: 6 requests, ")
    assert "slot utilization" in line
    if paged:
        assert telemetry.metrics().to_json()["kv_blocks_capacity"] > 0


def test_serve_demo_restores_the_latest_checkpoint(monkeypatch, capsys,
                                                   tmp_path):
    """WORKLOAD_CHECKPOINT_DIR: the demo serves the params of the latest
    step the train loop saved (the optimizer state left behind)."""
    model = tmodel.ModelConfig(vocab_size=32, num_layers=1, num_heads=2,
                               head_dim=16, embed_dim=16, mlp_dim=32,
                               max_seq_len=64)
    ttrain.train_loop(ttrain.TrainConfig(model=model), 2,
                      checkpoint_dir=str(tmp_path), save_every=2,
                      device="cpu")
    monkeypatch.setenv("WORKLOAD_MODEL", TINY_MODEL_ENV)
    monkeypatch.setenv("WORKLOAD_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("WORKLOAD_REQUESTS", "3")
    tserving.serve_demo_from_env(device="cpu")
    out = capsys.readouterr().out
    assert f"serve: restored checkpoint step 2 from {tmp_path}" in out
    assert "serve done: 3 requests" in out


@pytest.mark.parametrize("env, exc, match", [
    ({"WORKLOAD_PAGED": "1"}, NotImplementedError, "item 8"),
    ({"WORKLOAD_RESIDENT": "1"}, NotImplementedError, "item 8"),
    ({"WORKLOAD_TEMPERATURE": "0.7"}, NotImplementedError, "item 5"),
    ({"WORKLOAD_TOP_K": "4"}, ValueError, "WORKLOAD_TEMPERATURE > 0"),
    ({"WORKLOAD_QUANT": "int3"}, ValueError, "int8|int4"),
    ({"WORKLOAD_QUANT": "int8", "WORKLOAD_SPECULATIVE": "1"}, ValueError,
     "UNQUANTIZED"),
])
def test_serve_demo_from_env_refusals(monkeypatch, env, exc, match):
    monkeypatch.setenv("WORKLOAD_MODEL", TINY_MODEL_ENV)
    monkeypatch.setenv("WORKLOAD_REQUESTS", "2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(exc, match=match):
        tserving.serve_demo_from_env(device="cpu")


def test_worker_main_serves_and_exposes_metrics(monkeypatch, capsys):
    """WORKLOAD_MODE=serve through worker_main (the card mapped to the
    CPU) with WORKLOAD_METRICS_PORT: the demo runs, and the metrics server
    it started answers a scrape of what the demo recorded."""
    monkeypatch.setenv("WORKLOAD_MODE", "serve")
    monkeypatch.setenv("WORKLOAD_MODEL", TINY_MODEL_ENV)
    monkeypatch.setenv("WORKLOAD_QUANT", "int8")
    monkeypatch.setenv("WORKLOAD_KV_QUANT", "1")
    monkeypatch.setenv("WORKLOAD_PAGED", "1")
    monkeypatch.setenv("WORKLOAD_REQUESTS", "4")
    monkeypatch.setenv("WORKLOAD_METRICS_PORT", str(free_port()))
    monkeypatch.setattr(tserving, "resolve_device",
                        lambda device=None: tmodel.resolve_device(
                            "cpu" if device is None else device))
    started = []
    real = telemetry.start_metrics_server

    def start(port, host="0.0.0.0", **kw):
        httpd = real(port, host="127.0.0.1", **kw)
        started.append(httpd)
        return httpd

    monkeypatch.setattr(telemetry, "start_metrics_server", start)
    try:
        ttrain.worker_main()
        out = capsys.readouterr().out
        assert "workload: metrics on :" in out
        assert "serve done: 4 requests" in out
        port = started[0].server_address[1]
        m = get(port, "/metrics.json")[1]
        assert m["kv_blocks_capacity"] > 0
        assert m["serve_queue_wait_ms_count"] == 4
        assert get(port, "/healthz")[1]["ok"] is True
        text = get(port, "/metrics", raw=True)[1].decode()
        assert "# TYPE serve_queue_wait_ms histogram" in text
    finally:
        for httpd in started:
            httpd.shutdown()
            httpd.server_close()
