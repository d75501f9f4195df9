"""The generator: inputs fixed by the seed, every seed the same work in
another order, sizes, rates, bursts and shared prefixes as each mix and
cell state them."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import generator
from portbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SERVE = [w for w in BENCH["workloads"]
         if json.loads((REPO / f"portbench/traffic/{w['traffic']}.json")
                       .read_text())["kind"] == "serve"]
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def _mix(name):
    return json.loads((REPO / f"portbench/traffic/{name}.json").read_text())


def _cell(name):
    return json.loads((REPO / f"portbench/cells/{name}.json").read_text())


def _arrivals(w, seed, seconds=30.0):
    return generator.serve_arrivals(_mix(w["traffic"]), _cell(w["name"]),
                                    seed, seconds, 100352)


@pytest.mark.parametrize("w", SERVE, ids=lambda w: w["name"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(w, seed):
    a, b = _arrivals(w, seed), _arrivals(w, seed)
    assert [(x.due_s, x.prompt, x.max_new) for x in a] == [
        (x.due_s, x.prompt, x.max_new) for x in b]


@pytest.mark.parametrize("w", SERVE, ids=lambda w: w["name"])
def test_every_seed_the_same_sizes_in_another_order(w):
    runs = [_arrivals(w, s) for s in SEEDS]
    assert len({tuple(sorted(len(x.prompt) for x in r)) for r in runs}) == 1
    assert len({tuple(sorted(x.max_new for x in r)) for r in runs}) == 1
    assert len({tuple(len(x.prompt) for x in r) for r in runs}) == len(SEEDS)
    assert runs[0][0].prompt != runs[1][0].prompt


@pytest.mark.parametrize("w", SERVE, ids=lambda w: w["name"])
def test_requests_meet_the_mix_and_cell(w):
    mix, cell = _mix(w["traffic"]), _cell(w["name"])
    arr = _arrivals(w, 5)
    assert len(arr) == round(cell["rate_rps"] * 30.0)
    due = [a.due_s for a in arr]
    assert due[0] == 0.0 and due == sorted(due) and due[-1] < 30.0
    p, o = mix["prompt_tokens"], mix["output_tokens"]
    lens = np.array([len(a.prompt) for a in arr])
    outs = np.array([a.max_new for a in arr])
    assert lens.min() >= p["min"] and lens.max() <= p["max"]
    assert outs.min() >= o["min"] and outs.max() <= o["max"]
    assert abs(np.median(lens) - p["median"]) <= 0.1 * p["median"]
    assert abs(np.median(outs) - o["median"]) <= 0.1 * o["median"]
    assert all(0 <= t < 100352 for a in arr for t in a.prompt)
    assert all(len(a.prompt) + a.max_new <= 4096 for a in arr)


def test_open_loop_gaps_are_poisson_quantiles():
    mix = _mix("chat")
    arr = generator.serve_arrivals(mix, {"rate_rps": 2.0}, 3, 100.0, 1000)
    gaps = np.diff([a.due_s for a in arr])
    assert len(arr) == 200
    # Exponential gaps: the mean at 1/rate, the coefficient of variation
    # near 1.
    assert abs(gaps.mean() - 0.5) < 0.02
    assert 0.85 < gaps.std() / gaps.mean() < 1.15


def test_bursts_keep_the_mean_rate():
    mix = {**_mix("chat"), "arrivals": {"process": "poisson", "burst": 8}}
    arr = generator.serve_arrivals(mix, {"rate_rps": 4.0}, 9, 100.0, 1000)
    due = [a.due_s for a in arr]
    assert len(arr) == 400 and due == sorted(due) and due[-1] < 100.0
    # 50 events of 8 requests each, due at once.
    assert len(set(due)) == 50
    assert all(due.count(t) == 8 for t in set(due))


def test_shared_prefixes_lead_every_prompt():
    mix = {**_mix("chat"), "shared_prefix": {"tokens": 96, "groups": 3},
           "prompt_tokens": {"dist": "uniform", "min": 8, "max": 40},
           "output_tokens": {"dist": "uniform", "min": 12, "max": 12}}
    a = generator.serve_arrivals(mix, {"rate_rps": 3.0}, 4, 20.0, 1000)
    b = generator.serve_arrivals(mix, {"rate_rps": 3.0}, 4, 20.0, 1000)
    assert [x.prompt for x in a] == [x.prompt for x in b]
    heads = {tuple(x.prompt[:96]) for x in a}
    assert len(heads) == 3
    assert sorted(len(x.prompt) - 96 for x in a) == sorted(
        generator._quantiles(mix["prompt_tokens"], 60).tolist())
    assert all(8 <= len(x.prompt) - 96 <= 40 for x in a)
    assert {x.max_new for x in a} == {12}


def test_train_rows_fixed_by_seed_and_step_and_all_different():
    a = generator.train_batch(torch, 2**33 + 5, 0, 4, 64, 1000, "cpu")
    b = generator.train_batch(torch, 2**33 + 5, 0, 4, 64, 1000, "cpu")
    c = generator.train_batch(torch, 2**33 + 5, 1, 4, 64, 1000, "cpu")
    assert a.shape == (4, 65) and torch.equal(a, b)
    rows = {tuple(r.tolist()) for r in torch.cat([a, c])}
    assert len(rows) == 8
    assert int(a.min()) >= 0 and int(a.max()) < 1000
