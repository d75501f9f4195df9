"""Shared fixtures of the benchmark's tests.

``card`` tests need an NVIDIA card and run only where CUDA shows one: the
``card`` fixture decides inside the test run, never at import. Every
other test runs on the CPU at a tiny size: ``tiny_root`` makes a checkout
of its own (``BENCHMARK.json``, a copy of ``portbench/`` with tiny
configurations, mixes and cells) and works from it.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"num_layers": 2, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
        "embed_dim": 128, "vocab_size": 512, "max_seq_len": 256}
TINY_MODELS = {
    "olmo2-1b": {"mlp_dim": 256, "mlp_gated": True, "num_experts": 0},
    "olmoe-1b-7b": {"mlp_dim": 64, "mlp_gated": False, "num_experts": 8,
                    "expert_top_k": 2, "expert_capacity_factor": 1.25},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped where CUDA shows none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda", 0)


def make_tiny_root(dest: Path, compute_dtype: str = "bfloat16") -> Path:
    """A checkout at ``dest``: the repo's benchmark with every configuration
    cut to a tiny size, the chat mix to short requests, the train mix to
    rows of 64, the serve pool to 8 rows of blocks of 16."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = dest / "portbench"
    for path in sorted((pb / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        cfg["port"].update({**TINY, **TINY_MODELS[cfg["name"]]})
        cfg["serve"]["compute_dtype"] = compute_dtype
        cfg["train"]["compute_dtype"] = compute_dtype
        path.write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in sorted((pb / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        if mix["kind"] == "serve":
            mix["prompt_tokens"].update({"median": 24, "min": 8, "max": 96})
            mix["output_tokens"].update({"median": 8, "min": 4, "max": 32})
            path.write_text(json.dumps(mix))
    tr = json.loads((pb / "traffic/train.json").read_text())
    tr["seq_len"] = 64
    (pb / "traffic/train.json").write_text(json.dumps(tr))
    for path in sorted((pb / "cells").glob("*.json")):
        cell = json.loads(path.read_text())
        if "engine" in cell:
            cell["engine"].update({"rows": 8, "block_size": 16,
                                   "kv_blocks": 128, "prefill_budget": 32})
            cell["env"].update({"TPUBC_KV_BLOCK": "16",
                                "TPUBC_PREFILL_BUDGET": "32"})
            cell["rate_rps"] = 100.0
        else:
            cell["rows"] = 2
        path.write_text(json.dumps(cell))
    return dest


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    root = make_tiny_root(tmp_path)
    monkeypatch.chdir(root)
    import os

    saved = dict(os.environ)
    yield root
    os.environ.clear()
    os.environ.update(saved)


def with_moe_cell(bench: dict) -> dict:
    """``bench`` with the MoE chat cell the benchmark keeps files for but
    does not run (PERF.md, Open questions), for the CPU tests."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "olmoe-1b-7b",
                             "file": "portbench/configs/olmoe-1b-7b.json"})
    bench["workloads"].append({"name": "olmoe-1b-7b.chat",
                               "config": "olmoe-1b-7b", "traffic": "chat",
                               "chips": 1})
    return bench


def run_cpu(capsys, workload: str, seed: int = 1, seconds: float = 2.0,
            **kw) -> dict:
    """One run of a cell in the working checkout on the CPU; its result
    line."""
    import torch

    from portbench import run

    assert run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", "0"],
                    device=torch.device("cpu"), **kw) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
