"""A run with the timed path broken underneath comes out not correct.

Each test skips only the look for a card: the whole run, its check and
the cell's own limits (``cells/<cell>.json``) as committed, at a tiny size
on the CPU. The faults a one-card cell can have: a step that leaves its
state unchanged, half of the batch left out, and a token or an answer
altered where it is produced (a served token; a train step's gradient
as the optimizer receives it). The exchange between cards is absent on
one card."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.tests.conftest import REPO, run_cpu

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KIND = {w["name"]: json.loads(
    (REPO / f"portbench/traffic/{w['traffic']}.json").read_text())["kind"]
    for w in BENCH["workloads"]}
CHAT = [n for n, k in KIND.items() if k == "serve"]
TRAIN = [n for n, k in KIND.items() if k == "train"]


@pytest.mark.parametrize("name", CHAT + TRAIN)
def test_sound_runs_are_correct(tiny_root, capsys, name):
    got = run_cpu(capsys, name, seed=11)
    assert got["correct"], got["checks"]


@pytest.mark.parametrize("name", CHAT)
def test_serve_token_altered(tiny_root, capsys, monkeypatch, name):
    from tpu_bootstrap_torch.workload import serving

    emit = serving.PagedPool._emit_events
    vocab = 512

    def altered(self, out, counts, kind="decode"):
        out = [list(o) for o in out]
        for i, s in enumerate(self.slots):
            if s is not None and counts[i] and not s.generated:
                out[i][0] = (out[i][0] + vocab // 2) % vocab
        return emit(self, out, counts, kind)

    monkeypatch.setattr(serving.PagedPool, "_emit_events", altered)
    assert not run_cpu(capsys, name, seed=12)["correct"]


def _wrap_step(monkeypatch, fn):
    from tpu_bootstrap_torch.workload import serving

    monkeypatch.setattr(serving, "paged_decode_step",
                        fn(serving.paged_decode_step))


@pytest.mark.parametrize("name", CHAT)
def test_serve_state_left_unchanged(tiny_root, capsys, monkeypatch, name):
    def fn(step):
        def unchanged(params, tok, pos, pools, bt, cfg):
            copy = [{k: v.clone() for k, v in layer.items()}
                    for layer in pools]
            return step(params, tok, pos, copy, bt, cfg)[0], pools
        return unchanged

    _wrap_step(monkeypatch, fn)
    assert not run_cpu(capsys, name, seed=13)["correct"]


@pytest.mark.parametrize("name", CHAT)
def test_serve_half_batch_left_out(tiny_root, capsys, monkeypatch, name):
    def fn(step):
        def half(params, tok, pos, pools, bt, cfg):
            logits, pools = step(params, tok, pos, pools, bt, cfg)
            h = logits.shape[0] // 2
            return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), pools
        return half

    _wrap_step(monkeypatch, fn)
    assert not run_cpu(capsys, name, seed=14)["correct"]


def _train_fault(kind):
    def make(cfg):
        import copy

        from tpu_bootstrap_torch.workload import train

        real = train.make_train_step(cfg)

        def step(params, opt_state, tokens):
            if kind == "unchanged":
                p2, o2 = copy.deepcopy(params), copy.deepcopy(opt_state)
                return params, opt_state, real(p2, o2, tokens)[2]
            if kind == "half":
                return real(params, opt_state, tokens[:tokens.shape[0] // 2])
            # The gradient the optimizer received, altered where it was
            # produced: one leaf's first moment doubled after its first step.
            first = opt_state["count"] == 0
            params, opt_state, loss = real(params, opt_state, tokens)
            if first:
                opt_state["mu"][2].mul_(2.0)
            return params, opt_state, loss
        return step
    return make


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("kind", ["unchanged", "half", "gradient_altered"])
def test_train_faults(tiny_root, capsys, kind, name):
    got = run_cpu(capsys, name, seed=15, make_step=_train_fault(kind))
    assert not got["correct"], got["checks"]
