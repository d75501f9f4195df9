"""The port's trace plane and roofline gauges (tpu_bootstrap_torch/
telemetry.py) held to the reference's (tpu_bootstrap/telemetry.py):
``merge_chrome_traces`` on the same sources gives equal documents,
``Tracer.dump`` writes ``to_chrome()`` as the reference's does, a root
``span(trace_id=...)`` joins that trace and its children follow, the
at-exit dump to TPUBC_TRACE_FILE (a subprocess of each package) writes the
same events, and ``record_kernel_bandwidth`` sets the reference's gauge
names. The port's one difference: without TPUBC_HBM_GBPS and without an
H100 its HBM peak is unknown, so the roofline share is not set."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap_torch import telemetry

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = (jtelemetry, telemetry)


@pytest.fixture(autouse=True)
def fresh_state():
    for pkg in PACKAGES:
        pkg.metrics().reset()
        pkg.tracer().reset()
    yield
    for pkg in PACKAGES:
        pkg.metrics().reset()
        pkg.tracer().reset()


def _top_names(module) -> set:
    import inspect

    out = set()
    for name, obj in vars(module).items():
        if getattr(obj, "__module__", module.__name__) != module.__name__:
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            out.add(name)
            if inspect.isclass(obj):
                out |= {f"{name}.{m}" for m, f in vars(obj).items()
                        if inspect.isfunction(f)}
        elif name.isupper():
            out.add(name)
    return out


def test_every_reference_name_is_in_the_port():
    """Every function, class, Tracer method and constant of the
    reference's telemetry, but the TPU's default peaks (the port follows
    the card)."""
    missing = _top_names(jtelemetry) - _top_names(telemetry)
    assert missing == {"DEFAULT_PEAK_TFLOPS", "DEFAULT_HBM_PEAK_GBPS"}
    for name in ("TRACE_ANNOTATION", "TRACE_ID_ENV", "HBM_PEAK_ENV",
                 "PEAK_TFLOPS_ENV", "HOST_XFER_ENV"):
        assert getattr(telemetry, name) == getattr(jtelemetry, name), name


def _same_spans(pkg):
    """The same three spans recorded in ``pkg``'s tracer."""
    tr = pkg.tracer()
    tr.record(pkg.Span("t-1", "s-1", "", "controller.reconcile", 1_000, 50,
                       {"cr": "alice"}))
    tr.record(pkg.Span("t-1", "s-2", "s-1", "serve.request", 1_010, 20))
    tr.record(pkg.Span("", "s-3", "", "orphan", 2_000, 1))
    return tr


def test_dump_writes_to_chrome(tmp_path):
    docs = []
    for i, pkg in enumerate(PACKAGES):
        tr = _same_spans(pkg)
        path = tmp_path / f"{i}.json"
        tr.dump(str(path))
        doc = json.loads(path.read_text())
        assert doc == json.loads(json.dumps(tr.to_chrome()))
        docs.append(doc)
    assert docs[1] == docs[0]


def test_merge_chrome_traces_matches_reference(tmp_path):
    for i, pkg in enumerate(PACKAGES):
        _same_spans(pkg).dump(str(tmp_path / f"trace{i}.json"))
    (tmp_path / "broken.json").write_text("{not json")
    sources = [str(tmp_path / "trace0.json"), str(tmp_path / "missing.json"),
               str(tmp_path / "broken.json"),
               {"traceEvents": [{"name": "dict", "ph": "X", "ts": 7}]},
               str(tmp_path / "trace1.json")]
    merged = [pkg.merge_chrome_traces(str(tmp_path / f"out{i}.json"),
                                      sources)
              for i, pkg in enumerate(PACKAGES)]
    assert merged[1] == merged[0]
    assert (json.loads((tmp_path / "out1.json").read_text())
            == json.loads((tmp_path / "out0.json").read_text()))
    names = [e["name"] for e in merged[1]["traceEvents"]]
    assert names.count("controller.reconcile") == 2
    assert "dict" in names


def _span_tree(pkg):
    with pkg.span("root", trace_id="wanted", k=1):
        with pkg.span("child"):
            pass
    with pkg.span("default_root"):
        pass
    spans = {s.name: s for s in pkg.tracer().spans()}
    return {"root": (spans["root"].trace_id, spans["root"].parent_id,
                     spans["root"].attrs),
            "child": (spans["child"].trace_id,
                      spans["child"].parent_id == spans["root"].span_id),
            "default_root": spans["default_root"].trace_id
            == pkg.root_trace_id()}


def test_span_joins_trace_id():
    want, got = (_span_tree(pkg) for pkg in PACKAGES)
    assert got == want
    assert got == {"root": ("wanted", "", {"k": "1"}),
                   "child": ("wanted", True), "default_root": True}


AT_EXIT = """
import sys
sys.path.insert(0, {root!r})
from {pkg} import telemetry
with telemetry.span("worker.step", step=1):
    with telemetry.span("worker.inner"):
        pass
telemetry.tracer().add_span("serve.request", 5, 7, rid=3)
"""


def _at_exit_events(pkg: str, tmp_path, env_extra: dict):
    path = tmp_path / f"{pkg}.json"
    env = {"PATH": "/usr/bin:/bin", "TPUBC_TRACE_FILE": str(path),
           **env_extra}
    subprocess.run([sys.executable, "-c",
                    AT_EXIT.format(root=str(ROOT), pkg=pkg)], env=env,
                   check=True, timeout=120, capture_output=True)
    if not path.exists():
        return None
    events = json.loads(path.read_text())["traceEvents"]
    ids = {}
    for e in events:  # random span ids and clocks masked, links kept
        args = e.get("args", {})
        for k in ("span_id", "parent_id"):
            if args.get(k):
                args[k] = ids.setdefault(args[k], f"id{len(ids)}")
        for k in ("pid", "ts", "dur"):
            e.pop(k, None)
    return events


def test_at_exit_dump_matches_reference(tmp_path):
    env = {"TPUBC_TRACE_ID": "propagated-1"}
    want, got = (_at_exit_events(pkg, tmp_path, env)
                 for pkg in ("tpu_bootstrap", "tpu_bootstrap_torch"))
    assert got == want
    names = {e["name"]: e for e in got}
    assert set(names) == {"process_name", "worker.step", "worker.inner",
                          "serve.request"}
    assert all(e["args"]["trace_id"] == "propagated-1"
               for e in got if e["ph"] == "X")


def test_no_spans_no_dump(tmp_path):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "from tpu_bootstrap_torch import telemetry")
    path = tmp_path / "none.json"
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PATH": "/usr/bin:/bin",
                        "TPUBC_TRACE_FILE": str(path)})
    assert not path.exists()


def test_record_kernel_bandwidth_gauge_names(monkeypatch):
    monkeypatch.setenv("TPUBC_HBM_GBPS", "2000")
    for pkg in PACKAGES:
        assert pkg.hbm_peak_gbps() == 2000.0
        pkg.record_kernel_bandwidth("int8_matmul", 30_000_000, 0.002)
        pkg.record_kernel_bandwidth("int4_matmul", 1_000, 1e-6,
                                    peak_gbps=4.0)
        pkg.record_kernel_bandwidth("skipped", 0, 1.0)
        pkg.record_kernel_bandwidth("skipped", 10, 0.0)
    got, want = (pkg.metrics().to_json() for pkg in (telemetry, jtelemetry))
    assert got == want == {
        "quant_int4_matmul_achieved_gbps": 1.0,
        "quant_int4_matmul_hbm_roofline_frac": 0.25,
        "quant_int8_matmul_achieved_gbps": 15.0,
        "quant_int8_matmul_hbm_roofline_frac": 0.0075}


def test_hbm_peak_follows_the_card(monkeypatch):
    """The port's rule (peak_tflops'): the environment, else the H100
    SXM's rate when CUDA reports one, else unknown: achieved bandwidth
    without a roofline share."""
    monkeypatch.delenv("TPUBC_HBM_GBPS", raising=False)
    monkeypatch.setattr(telemetry, "_h100_sxm", lambda: False)
    assert telemetry.hbm_peak_gbps() is None
    telemetry.record_kernel_bandwidth("int8_matmul", 3_000_000, 0.002)
    assert telemetry.metrics().to_json() == {
        "quant_int8_matmul_achieved_gbps": 1.5}
    monkeypatch.setattr(telemetry, "_h100_sxm", lambda: True)
    assert telemetry.hbm_peak_gbps() == telemetry.H100_SXM_HBM_GBPS == 3350.0
    assert telemetry.peak_tflops() == telemetry.H100_SXM_BF16_TFLOPS
    monkeypatch.setenv("TPUBC_HBM_GBPS", "not-a-number")
    assert telemetry.hbm_peak_gbps() == 3350.0
