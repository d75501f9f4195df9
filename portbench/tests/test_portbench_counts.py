"""Each roofline and MFU reader against a count made by hand for one
shape, and the device-trace reduction."""

from __future__ import annotations

import json

import pytest

from portbench import common, trace
from portbench.tests.conftest import REPO

PF, PB = 989e12, 3.35e12
OLMO = json.loads((REPO / "portbench/configs/olmo2-1b.json").read_text())["port"]
K1 = "void quant_matmul_sm90_kernel<8, 128, false, true>(CUtensorMap)"
K2 = "void paged_attention_kernel<128, 64>(Args, int const*)"


def _read(name, ctx, monkeypatch):
    monkeypatch.chdir(REPO)
    return common.load_reader(name)(ctx)


def _serve_ctx(p, ops, steps, prefill, slice_s=1.0):
    busy = trace.union(ops)
    return {"kind": "serve", "config": p, "slice_s": slice_s, "chips": 1,
            "red": {"ops": ops, "busy": busy,
                    "busy_us": sum(z - a for a, z in busy), "spans": [],
                    "wall_s": slice_s},
            "work": {"decode_steps": steps, "prefill_rounds": prefill}}


def test_k1_dense_by_hand(monkeypatch):
    # One decode step of 2 live rows, one prefill round of 100 tokens; K1
    # ran 10 ms in all.
    ctx = _serve_ctx(OLMO, [(K1, 0.0, 10_000.0)], [[50, 70]], [[(0, 100)]])
    e, f, v, L = 2048, 8192, 100352, 16
    layer = [(e, e), (e, e), (e, e), (e, e), (e, f), (e, f), (f, e)]
    dec = layer * L + [(e, v)]
    pre = layer * L
    w_dec = sum(k * n + 4 * n for k, n in dec)
    w_pre = sum(k * n + 4 * n for k, n in pre)
    io_dec = 2 * sum(2 * k + 2 * n for k, n in dec) + 2 * 2 * v
    io_pre = 100 * sum(2 * k + 2 * n for k, n in pre)
    t_dec = max(2 * 2 * sum(k * n for k, n in dec) / PF, (w_dec + io_dec) / PB)
    t_pre = max(2 * 100 * sum(k * n for k, n in pre) / PF, (w_pre + io_pre) / PB)
    want = 100 * (t_dec + t_pre) / 0.010
    assert _read("k1_roofline.chat", ctx, monkeypatch) == pytest.approx(want)
    # Decode streams 1.28 GB of int8 weights: memory-bound, 0.38 ms.
    assert t_dec == pytest.approx(w_dec / PB + io_dec / PB)
    assert 0.37e-3 < t_dec < 0.40e-3


def test_k2_by_hand(monkeypatch):
    ctx = _serve_ctx(OLMO, [(K2, 0.0, 100.0)], [[1000, 3000], [1001]], [])
    per_pos = 16 * 2 * 16 * (128 + 4)
    qo = 2 * 2 * 16 * 128 * 16
    step1 = max(4 * 16 * 128 * 4000 * 16 / PF, (4000 * per_pos + 2 * qo) / PB)
    step2 = max(4 * 16 * 128 * 1001 * 16 / PF, (1001 * per_pos + qo) / PB)
    want = 100 * (step1 + step2) / 100e-6
    assert _read("k2_roofline.chat", ctx, monkeypatch) == pytest.approx(want)


def test_mfu_chat_by_hand(monkeypatch):
    ctx = _serve_ctx(OLMO, [], [[10, 20]], [[(4, 3)]], slice_s=0.5)
    params = 16 * (4 * 2048 * 2048 + 3 * 2048 * 8192)
    head = 2048 * 100352
    attn = 4 * 16 * 128 * 16
    flops = (2 * (2 * (params + head)) + attn * 30
             + 3 * 2 * params + attn * (5 + 6 + 7))
    want = 100 * flops / (0.5 * PF)
    assert _read("mfu.chat", ctx, monkeypatch) == pytest.approx(want)


def test_idle_share(monkeypatch):
    ops = [("a", 0.0, 100_000.0), ("b", 50_000.0, 200_000.0),
           ("c", 600_000.0, 700_000.0)]
    ctx = _serve_ctx(OLMO, ops, [], [], slice_s=1.0)
    assert _read("idle_share.chat", ctx, monkeypatch) == pytest.approx(70.0)
    assert _read("idle_share.train", ctx, monkeypatch) is None


def _train_ctx(ops, steps=2, slice_s=1.0):
    busy = trace.union(ops)
    return {"kind": "train", "config": OLMO, "slice_s": slice_s, "chips": 1,
            "red": {"ops": ops, "busy": busy, "spans": [], "wall_s": slice_s,
                    "busy_us": sum(z - a for a, z in busy)},
            "work": {"steps": steps, "rows": 4, "seq": 4096}}


def test_train_readers_by_hand(monkeypatch):
    ops = [("void flash_fwd_sm90_kernel<128>()", 0.0, 20_000.0),
           ("void flash_dq_sm90_kernel<128>()", 20_000.0, 50_000.0),
           ("void flash_dkv_sm90_kernel<128>()", 50_000.0, 90_000.0)]
    ctx = _train_ctx(ops)
    b, s, h, d, L = 4, 4096, 16, 128, 16
    fwd = max(2 * b * h * s * s * d / PF,
              (2 * b * s * d * 4 * h + 4 * b * h * s) / PB)
    bwd = max(5 * b * h * s * s * d / PF,
              (2 * b * s * d * 8 * h + 8 * b * h * s) / PB)
    assert _read("k3_roofline.train", ctx, monkeypatch) == pytest.approx(
        100 * fwd * L * 2 / 0.020)
    assert _read("k4_roofline.train", ctx, monkeypatch) == pytest.approx(
        100 * bwd * L * 2 / 0.070)
    n = 16 * (4 * 2048 * 2048 + 3 * 2048 * 8192) + 2048 * 100352
    flops = 2 * (6 * n * b * s + 6 * b * h * s * s * d * L)
    assert _read("mfu.train", ctx, monkeypatch) == pytest.approx(
        100 * flops / (1.0 * PF))
    assert _read("idle_share.train", ctx, monkeypatch) == pytest.approx(91.0)
    assert _read("k1_roofline.chat", ctx, monkeypatch) is None


def test_reader_without_its_kernel_reads_nothing(monkeypatch):
    ctx = _serve_ctx(OLMO, [("other", 0.0, 5.0)], [[1]], [])
    for name in ("k1_roofline.chat", "k2_roofline.chat"):
        assert _read(name, ctx, monkeypatch) is None


def test_breakdown_names_gaps_by_the_open_span():
    red = {"ops": [("k", 100.0, 200.0), ("k", 500.0, 600.0),
                   ("j", 550.0, 900.0)],
           "spans": [("step", 0.0, 450.0), ("wait", 450.0, 1000.0)]}
    red["busy"] = trace.union(red["ops"])
    out = trace.breakdown(red, 1000.0)
    assert out["device_ops"][0] == ["j", pytest.approx(350e-6)]
    assert out["idle_gaps"][0] == ["step", pytest.approx(300e-6)]
    assert [g[0] for g in out["idle_gaps"]] == ["step", "step", "wait"]
