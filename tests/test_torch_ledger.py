"""The paged engine's device ledger (tpu_bootstrap_torch/workload/serving.py:
Scheduler._ledger_fold, the pool's ledger token sites) held to the JAX
reference: differential runs on pinned clocks (tests/test_torch_requestz.py's
``differential``) compare, after every step and exactly (f32), each round's
ledger token dict, the ledger, device_ms_by_rid and each record's billed
device ms, on plain, deadline-bearing, preempting and ledger-off runs. Then
the mirrors of the reference's tests/test_ledger.py:111-264 on the port's
pool (device="cpu", K2's plain version): the ledger conserves (busy + idle
== wall, attributed + unattributed == busy, the per-request device ms summing
to the attributed time), under churn too, and only observes.

Not mirrored: the Prometheus-text halves of :181 (the text exposition is the
ingress's, queue 1 item 6) and :286-end (/profilez and the fleetz window,
item 6). The port's ``peak_tflops`` is None on a CPU, where no
``serve_mfu`` is set; the gauge tests name the H100's peak through
``TPUBC_PEAK_TFLOPS``."""

import time

import pytest
import torch

from tests.test_torch_requestz import STEP_S, T0, clocks  # noqa: F401
from tests.test_torch_requestz import differential
from tests.test_torch_scheduler import (
    POOL,
    TCFG,
    TPARAMS,
    _drive,
    _reqs,
    _solo,
    _specs,
    pinned_cost,  # noqa: F401 - a fixture
)
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import faults
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_lingering_faults():
    yield
    faults.install(None)


def _assert_conserved(sched):
    led = sched.ledger
    assert led["rounds"] > 0
    assert led["busy_ms"] + led["idle_ms"] == pytest.approx(
        led["wall_ms"], abs=1e-6)
    assert led["attributed_ms"] + led["unattributed_ms"] == pytest.approx(
        led["busy_ms"], abs=0.05)
    assert sched.device_ms_by_rid == {}
    assert led["retired_device_ms"] == pytest.approx(
        led["attributed_ms"], abs=0.05)
    recs = sched.log.snapshot()["requests"]
    total = sum(r["phases"].get("device_ms", 0.0) for r in recs)
    assert total == pytest.approx(led["attributed_ms"], abs=0.1)
    return led


# ---- against the reference --------------------------------------------------


LEDGER_CASES = {
    "plain": (_specs(6, seed=1), dict(batch_size=4, block_size=8,
                                      prefill_budget=4), {}, None),
    # Tight and overcommitted, with two waiting requests whose deadline
    # passes before they are admitted and one cancelled mid-decode.
    "deadlines_preempting": (
        _specs(8, seed=5) + [(100, [1, 2, 3], 8, 0), (101, [2, 3, 4], 8, 0),
                             (102, [5, 6, 7, 8], 20, 0)],
        dict(batch_size=8, block_size=8, kv_blocks=8, prefill_budget=4,
             host_blocks=64), dict(overcommit=True, expected_new=2),
        {100: 3, 101: 3, 102: 0}),
}
# Virtual deadlines: 100 and 101 arrive at step 3 already a step late;
# 102 runs from step 0 and is cancelled at step 6's boundary.
LEDGER_DEADLINES = {100: T0 + 2.5 * STEP_S, 101: T0 + 2.5 * STEP_S,
                    102: T0 + 5.5 * STEP_S}


@pytest.mark.parametrize("name", sorted(LEDGER_CASES))
def test_ledger_differential_against_reference(name, clocks):  # noqa: F811
    specs, pool_kw, sched_kw, submit_at = LEDGER_CASES[name]
    done, pool, sched, _ = differential(
        specs, pool_kw, sched_kw, clocks, submit_at=submit_at,
        deadlines=LEDGER_DEADLINES if name != "plain" else None)
    _assert_conserved(sched)
    assert sched.ledger["flops"] > 0
    for i, t, m, _p in specs:
        if i < 100:
            assert done[i] == _solo(t, m), i
    if name != "plain":
        assert sched.stats["deadline_shed"] == 3
        assert done[100] == done[101] == []
        assert 0 < len(done[102]) < 20
        assert done[102] == _solo([5, 6, 7, 8], 20)[:len(done[102])]
        assert pool.stats["preemptions"] > 0


def test_ledger_off_differential_against_reference(clocks,  # noqa: F811
                                                   monkeypatch):
    """TPUBC_DEVICE_LEDGER=0 in both packages: no fold, no attribution,
    the pool never carries a token dict; everything else as with it on."""
    monkeypatch.setenv("TPUBC_DEVICE_LEDGER", "0")
    specs = _specs(6, seed=3)
    done, pool, sched, _ = differential(
        specs, dict(batch_size=4, block_size=8, prefill_budget=4), {},
        clocks)
    assert sched.ledger["rounds"] == 0 and sched.device_ms_by_rid == {}
    assert pool.ledger_tokens is None
    for i, t, m, _p in specs:
        assert done[i] == _solo(t, m), i


# ---- mirrors of tests/test_ledger.py --------------------------------------


def test_ledger_conserves_on_a_plain_run():
    """test_ledger.py:111."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    assert sched.ledger_enabled is tserving.device_ledger_enabled() is True
    reqs = _reqs(tserving, _specs(4, seed=1))
    done = _drive(pool, sched, reqs)
    led = _assert_conserved(sched)
    assert led["busy_ms"] > 0 and led["flops"] > 0
    for r in reqs:
        assert done[r.rid] == _solo(r.tokens, r.max_new), r.rid


def test_ledger_conserves_under_churn():
    """test_ledger.py:125: preemptions, deadline sheds and a recovery in
    one burst; conservation holds and the streams are unchanged."""
    reqs = _reqs(tserving, _specs(8, seed=5))
    past = telemetry.monotonic() - 1.0
    reqs += [tserving.Request(rid=100 + i, tokens=[1 + i, 2, 3], max_new=8,
                              deadline=past) for i in range(2)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 8, block_size=8, kv_blocks=8,
                              prefill_budget=4, **POOL)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    faults.install("pool.device:1:3")
    done = _drive(pool, sched, reqs)
    faults.install(None)
    assert pool.stats["preemptions"] > 0, "pool was not actually tight"
    assert sched.stats["deadline_shed"] == 2
    assert sched.stats["recoveries"] == 1
    _assert_conserved(sched)
    for r in reqs:
        if r.deadline is not None:
            assert done[r.rid] == []
        else:
            assert done[r.rid] == _solo(r.tokens, r.max_new), r.rid


def test_streams_byte_identical_ledger_on_and_off(monkeypatch):
    """test_ledger.py:159."""
    reqs = _reqs(tserving, _specs(6, seed=3))
    kw = dict(paged=True, block_size=8, prefill_budget=4, **POOL)
    on = tserving.serve(TPARAMS, TCFG, reqs, 4, **kw)
    monkeypatch.setenv("TPUBC_DEVICE_LEDGER", "0")
    assert tserving.device_ledger_enabled() is False
    off = tserving.serve(TPARAMS, TCFG, reqs, 4, **kw)
    monkeypatch.setenv("TPUBC_REQUEST_EVENTS", "0")
    dark = tserving.serve(TPARAMS, TCFG, reqs, 4, **kw)
    assert on == off == dark
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    assert sched.ledger_enabled is False
    _drive(pool, sched, [tserving.Request(rid=0, tokens=[1, 2], max_new=2)])
    assert sched.ledger["rounds"] == 0
    assert sched.device_ms_by_rid == {}
    assert pool.ledger_tokens is None


def test_per_class_device_ms_and_gauges(monkeypatch):
    """test_ledger.py:181, its registry half, at the H100's peak."""
    monkeypatch.setenv("TPUBC_PEAK_TFLOPS", "989")
    mj0 = telemetry.metrics().to_json()

    def cls(c, snap):
        return snap.get(f'serve_device_ms_total{{priority="{c}"}}', 0.0)

    reqs = [tserving.Request(rid=i, tokens=[1 + i, 2, 3], max_new=4,
                             priority=i % 2) for i in range(6)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    _drive(pool, sched, reqs)
    mj = telemetry.metrics().to_json()
    deltas = {c: cls(c, mj) - cls(c, mj0) for c in ("0", "1")}
    assert deltas["0"] > 0 and deltas["1"] > 0
    assert sum(deltas.values()) == pytest.approx(
        sched.ledger["attributed_ms"], abs=0.1)
    assert 0 < mj["serve_engine_busy_frac"] <= 1.0
    assert mj["serve_mfu"] > 0
    assert (mj.get("serve_model_flops_total", 0)
            - mj0.get("serve_model_flops_total", 0)) == pytest.approx(
        sched.ledger["flops"], rel=1e-6)
    assert mj["serve_peak_tflops"] == telemetry.peak_tflops() == 989.0
    assert mj["serve_peak_tflops_from_env"] == 1
    assert mj["serve_host_xfer_gbps"] == telemetry.host_xfer_gbps()


def test_no_peak_skips_mfu_and_folds_the_rest(monkeypatch):
    """Without a card or TPUBC_PEAK_TFLOPS there is no peak: the fold sets
    no serve_mfu and divides by nothing, and the rest of the ledger folds."""
    monkeypatch.delenv("TPUBC_PEAK_TFLOPS", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: it names a peak")
    assert telemetry.peak_tflops() is None
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    real = telemetry.metrics().set_gauge
    names = []
    monkeypatch.setattr(telemetry.metrics(), "set_gauge",
                        lambda n, v, labels=None: (names.append(n),
                                                   real(n, v, labels)))
    _drive(pool, sched, _reqs(tserving, _specs(2, seed=4)))
    _assert_conserved(sched)
    assert "serve_engine_busy_frac" in names and "serve_mfu" not in names
    assert "serve_peak_tflops" not in names


def test_flops_model_is_the_shared_price_list():
    """test_ledger.py:222."""
    f = tmodel.flops_model(TCFG)
    assert set(f) == {"prefill", "decode", "verify", "train", "params"}
    assert all(v > 0 for v in f.values())
    assert f["prefill"] < f["decode"] == f["verify"]
    assert f["train"] == pytest.approx(3 * f["decode"])
    assert f["decode"] > 2 * f["params"] * 0.5


def test_preempt_cost_publishes_both_arms(monkeypatch):
    """test_ledger.py:234."""
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")
    mj0 = telemetry.metrics().to_json()

    def cnt(snap, arm):
        return snap.get(f'serve_preempt_cost{{arm="{arm}"}}_count', 0)

    pool = tserving.PagedPool(TPARAMS, TCFG, 8, block_size=8, kv_blocks=8,
                              prefill_budget=4, **POOL)
    assert pool.host is None
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    _drive(pool, sched, _reqs(tserving, _specs(8, seed=7)))
    assert pool.stats["preemptions"] > 0
    mj = telemetry.metrics().to_json()
    assert cnt(mj, "swap_est") - cnt(mj0, "swap_est") > 0
    assert cnt(mj, "recompute") - cnt(mj0, "recompute") > 0
    assert cnt(mj, "swap") == cnt(mj0, "swap")


def test_preempt_to_swap_measures_the_taken_arm(monkeypatch):
    """test_ledger.py:264."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    mj0 = telemetry.metrics().to_json()
    pool = tserving.PagedPool(TPARAMS, TCFG, 8, block_size=8, kv_blocks=8,
                              prefill_budget=4, host_blocks=64, **POOL)
    assert pool.host is not None
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    _drive(pool, sched, _reqs(tserving, _specs(8, seed=7)))
    assert pool.stats["preemptions"] > 0
    assert pool.stats.get("swap_preempts", 0) > 0
    mj = telemetry.metrics().to_json()
    d = {k: mj.get(k, 0) - mj0.get(k, 0)
         for k in ('serve_preempt_cost{arm="swap"}_count',
                   "serve_swap_out_bytes_total", "serve_swap_in_bytes_total",
                   "serve_host_hit_tokens_total")}
    assert all(v > 0 for v in d.values()), d
    assert mj.get("serve_swap_bandwidth_gbps", 0) > 0


def test_busy_is_the_work_section_and_idle_the_gap():
    """The fold's clocks: busy is the step's own section, the gap since
    the previous step ends is idle, so a pause between steps shows up as
    idle and not as busy."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    sched = tserving.Scheduler(pool)
    sched.submit(tserving.Request(rid=0, tokens=[1, 2, 3], max_new=6))
    sched.step()
    busy0 = sched.ledger["busy_ms"]
    time.sleep(0.05)
    sched.step()
    led = sched.ledger
    assert led["idle_ms"] >= 45.0
    assert led["busy_ms"] - busy0 < led["idle_ms"]
    assert led["busy_ms"] + led["idle_ms"] == pytest.approx(
        led["wall_ms"], abs=1e-6)
