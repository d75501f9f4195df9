"""A cell, a traffic mix and a per-layer metric added as files and entries
are found by name, with no file of the benchmark edited."""

from __future__ import annotations

import hashlib
import json

from portbench import common, run
from portbench.tests.conftest import run_cpu

READER = '''
def read(ctx):
    steps = ctx["work"].get("decode_steps")
    return float(len(steps)) if steps else None
'''


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted((root / "portbench").rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_added_cell_mix_and_metric_are_found(tiny_root, capsys):
    before = _digests(tiny_root)
    pb = tiny_root / "portbench"
    chat = json.loads((pb / "traffic/chat.json").read_text())
    chat["output_tokens"].update({"median": 5, "min": 4, "max": 6})
    # A new shape of traffic is data alone: bursts of 3 sharing prefixes.
    chat["arrivals"]["burst"] = 3
    chat["shared_prefix"] = {"tokens": 32, "groups": 2}
    (pb / "traffic/chat-short.json").write_text(json.dumps(chat))
    cell = json.loads((pb / "cells/olmo2-1b.chat.json").read_text())
    cell["rate_rps"] = 6.0
    (pb / "cells/olmo2-1b.chat-short.json").write_text(json.dumps(cell))
    (pb / "metrics/decode_steps.chat-short.py").write_text(READER)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "olmo2-1b.chat-short", "config": "olmo2-1b",
        "traffic": "chat-short", "chips": 1, "why": "short outputs"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "olmo2-1b.chat" in m["workloads"]:
            m["workloads"].append("olmo2-1b.chat-short")
    bench["per_layer"].append({
        "name": "decode_steps.chat-short", "unit": "steps",
        "better": "lower", "source": "program_counter", "layer": "device",
        "moves": "out_tok_s", "workloads": ["olmo2-1b.chat-short"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    found = common.Cell(common.benchmark(), "olmo2-1b.chat-short")
    assert found.traffic["output_tokens"]["max"] == 6
    assert found.traffic["shared_prefix"]["groups"] == 2
    assert found.settings["rate_rps"] == 6.0
    assert [m["name"] for m in found.per_layer] == [
        "k1_roofline.chat", "k2_roofline.chat", "mfu.chat",
        "idle_share.chat", "decode_steps.chat-short"]
    got = run_cpu(capsys, "olmo2-1b.chat-short", seed=21)
    assert got["correct"] and got["attempted"] == 12
    assert set(got["metrics"]) == {"out_tok_s", "setup_s"}
    red = {"ops": [], "busy": [], "busy_us": 0.0, "spans": [], "wall_s": 1.0}
    out = {"red": red, "work": {"decode_steps": [[3], [4]],
                                "prefill_rounds": []}}
    layer = run.per_layer(found, out, 1)
    assert layer["decode_steps.chat-short"] == {"value": 2.0, "unit": "steps"}
    after = _digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
