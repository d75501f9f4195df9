"""The plain reference against the program's plain CPU path at a tiny size
of each configuration.

Serving: the program in float32 differs from the reference in one place
only, the int8 kernels' rounding of their activations to bf16 (K1/K1e's
arithmetic), so the reference is given the same rounding here; what is
left is float order, which can flip an int8 rounding of a key or value by
one level, a logit gap under 5e-3. Training: the program in float32
against the reference in float32, within 1e-4."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import common, serve, train
from portbench.reference import model as ref
from portbench.tests.conftest import make_tiny_root, with_moe_cell

CPU = torch.device("cpu")


def _bf16(x):
    return x.to(torch.bfloat16).float()


@pytest.fixture
def f32_root(tmp_path, monkeypatch):
    import os

    saved = dict(os.environ)
    monkeypatch.chdir(make_tiny_root(tmp_path, compute_dtype="float32"))
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.mark.parametrize("name", ["olmo2-1b.chat", "olmoe-1b-7b.chat"])
def test_served_tokens_are_the_references_best(f32_root, name):
    cell = common.Cell(with_moe_cell(common.benchmark()), name)
    common.pin_environment(cell.settings)
    out = serve.run(torch, cell, 5, 4.0, False, CPU, time.perf_counter())
    book = out["book"]
    rids = sorted(book.done)
    assert out["failed"] == 0 and out["attempted"] > 10
    assert len(rids) >= 3 and len(book.submitted) <= out["attempted"]
    # Every prompt token but the last was prefilled, in chunks.
    for rid in rids:
        chunks = out["chunks"][rid]
        assert sum(w for _, w in chunks) == len(book.req[rid].prompt) - 1
    seqs, spans, served = [], [], []
    for rid in rids:
        prompt, gen = book.req[rid].prompt, book.generated[rid]
        assert len(gen) == book.req[rid].max_new
        seqs.append(torch.tensor(prompt + gen[:-1]))
        spans.append((len(prompt) - 1, len(prompt) - 1 + len(gen)))
        served.append(torch.tensor(gen))
    logits = ref.serve_logits(cell.config["port"], 5, CPU, seqs, spans,
                              act=_bf16,
                              segments=[out["chunks"][r] for r in rids])
    gaps = [float((lg.max(-1).values - lg.gather(1, s[:, None])[:, 0]).max())
            for lg, s in zip(logits, served)]
    assert max(gaps) < 5e-3
    if name.startswith("olmoe"):
        # Chunks overflow experts at capacity factor 1.25: routing the
        # whole sequence without capacity is a different model.
        free = ref.serve_logits(cell.config["port"], 5, CPU, seqs, spans,
                                act=_bf16)
        assert max(float((a - b).abs().max())
                   for a, b in zip(free, logits)) > 1e-2


def test_train_steps_match_the_reference(f32_root):
    cell = common.Cell(common.benchmark(), "olmo2-1b.train")
    common.pin_environment(cell.settings)
    out = train.run(torch, cell, 5, 0.5, False, CPU, time.perf_counter())
    refn = train.reference_numbers(torch, cell, 5, CPU)
    got = train.compare(out["checked"], refn, 1e-3)
    assert got["loss_gap"] < 1e-4
    assert got["grad1_gap"] < 1e-4
    assert got["change_gap"] < 1e-4
    assert got["skipped_leaves"] == 0
