"""What every part of the benchmark shares: finding a cell's files by
name, pinning the program's settings, the device check, the peaks, the
result line and the check that no JAX module was loaded.

Everything a cell needs is found from its name in ``BENCHMARK.json``:
the configuration's file (``configs/<config>.json``), the traffic mix's
data file (``traffic/<traffic>.json``), the cell's own settings
(``cells/<cell>.json``) and one reader per per-layer metric
(``metrics/<metric>.py``). Adding a cell, a mix or a metric adds files
and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak and HBM3 rate.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Modules that may not be loaded in the process that prints a result,
# compared by their whole top-level name (the port's package name starts
# with the JAX package's, and is allowed).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_bootstrap")


def root() -> Path:
    """The checkout the benchmark runs from: the working directory, which
    holds ``BENCHMARK.json``."""
    return Path.cwd()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir() -> Path:
    """The benchmark's own files in the checkout."""
    return root() / "portbench"


def benchmark() -> dict:
    return load_json(root() / "BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with everything found by its
    names: ``entry`` (the workloads entry), ``config`` (the configuration
    file's contents), ``traffic`` (the mix's data), ``settings`` (the
    cell's own file), ``end_to_end`` and ``per_layer`` (the metric
    entries that this cell reports)."""

    def __init__(self, bench: dict, name: str):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root() / configs[self.entry["config"]]["file"])
        self.traffic = load_json(bench_dir() / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.settings = load_json(bench_dir() / "cells" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(metric_name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
    path = bench_dir() / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pin_environment(settings: dict) -> None:
    """Drop every ``TPUBC_*`` knob the caller's environment carries and set
    the cell's own, so a changed default or a stray variable cannot move
    the yardstick. Build and kernel caches live at fixed paths inside the
    checkout."""
    for key in [k for k in os.environ if k.startswith("TPUBC_")]:
        del os.environ[key]
    for key, value in settings.get("env", {}).items():
        os.environ[key] = str(value)
    build = root() / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def pin_torch(torch) -> None:
    """Float32 matmuls in full float32 (no TF32) and a few host threads:
    the program's defaults written down, so a change to them shows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(4)


def require_cards(torch, chips: int) -> None:
    """Exit without a result unless CUDA shows at least ``chips`` cards."""
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available; no result", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, CUDA shows "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        raise SystemExit(2)


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the result's process may not
    hold."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def device_info(torch, chips: int) -> dict:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def emit(result: dict, checks: dict) -> None:
    """The check lines last on standard error, then the result line last
    on standard output, with the checks under their own key, last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    out = dict(result)
    out["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                     for name, c in checks.items()}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
