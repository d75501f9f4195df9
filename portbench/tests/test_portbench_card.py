"""The control on the card at each cell's own size: the reference put in
the program's place one precision below the configuration's (float8 e4m3
activations, and in training weights too) must fail the cell's check,
while the program's own run passes it. Run on the chip with

    python3 -m pytest portbench/tests/test_portbench_card.py -q
"""

from __future__ import annotations

import json

import pytest

from portbench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    from portbench import calibrate, common

    assert calibrate.main(["--workload", name, "--seconds", "10",
                           "--seeds", "4000000007", "--control", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    limits = common.Cell(common.benchmark(), name).settings["check"]["limits"]
    prog = next(x for x in lines if x["kind"] == "program")["values"]
    ctl = next(x for x in lines if x["kind"] == "control")["values"]
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctl[k] > v for k, v in limits.items()), ctl
