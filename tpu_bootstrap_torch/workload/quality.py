"""Quantization quality on a trained model, the counterpart of
``tpu_bootstrap/workload/quality.py``.

A model trained on a learnable synthetic task predicts confidently, which
is where the int8/int4 serving claims live: this module measures what
quantization does to its perplexity, its argmax agreement and its
speculative acceptance. The task is a noisy permutation Markov chain:
token t+1 is perm[t] with probability ``p`` and uniform otherwise, so a
bigram lookup learns it and its cross-entropy has a known floor.

``score`` runs the port's ``decode.prefill`` (einsum attention,
``kv_kernel=False``), so an int8 tree's projections launch kernel K1 and
an int4 tree's kernel K6, T = batch x (S - 1) rows each. ``distill_draft``
runs ``distill.make_distill_step`` and ``spec_acceptance`` the port's
``speculative.speculative_generate``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bootstrap_torch.workload.decode import init_cache, prefill
from tpu_bootstrap_torch.workload.distill import make_distill_step
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    Params,
    init_params,
    resolve_device,
)
from tpu_bootstrap_torch.workload.speculative import speculative_generate
from tpu_bootstrap_torch.workload.train import MeshConfig


def markov_batch(step: int, batch: int, seq_len: int, vocab: int,
                 *, p: float = 0.85, seed: int = 0) -> np.ndarray:
    """(batch, seq_len) int32 tokens from the noisy-permutation chain,
    deterministic in (step, seed), bit for bit the reference's. The
    permutation is fixed by ``seed`` alone (the task), the noise varies
    per step (the data): next = perm[cur] with probability p, else
    uniform. Cross-entropy floor per token: -p log p - (1 - p) log((1 -
    p) / vocab), ignoring the chance that the noise lands on perm[cur]."""
    rng_task = np.random.default_rng(seed)
    perm = rng_task.permutation(vocab)
    rng = np.random.default_rng((seed + 1) * 1_000_003 + step)
    toks = np.empty((batch, seq_len), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    for t in range(1, seq_len):
        follow = rng.random(batch) < p
        toks[:, t] = np.where(follow, perm[toks[:, t - 1]],
                              rng.integers(0, vocab, batch))
    return toks.astype(np.int32)


@torch.no_grad()
def score(params: Params, tokens, cfg: ModelConfig) -> tuple:
    """Teacher-forced scoring on the device of ``params``: (mean
    next-token xent (nats), 0-d f32 tensor; per-position argmax (B, S-1)
    int32) of tokens[:, 1:] given tokens[:, :-1]. Einsum attention
    (``kv_kernel=False``), so the numbers do not depend on K5."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    b, s = tokens.shape
    logits, _ = prefill(params, tokens[:, :-1],
                        init_cache(cfg, b, s - 1, device=tokens.device),
                        cfg, kv_kernel=False, all_logits=True)
    lp = torch.log_softmax(logits.float(), dim=-1)
    xent = -torch.mean(torch.gather(lp, -1, tokens[:, 1:, None]))
    return xent, torch.argmax(logits, dim=-1).to(torch.int32)


def eval_quality(base_params: Params, quant_params: Params,
                 cfg: ModelConfig, tokens) -> dict:
    """Quantization deltas of ``quant_params`` against ``base_params`` on
    held-out ``tokens`` (B, S): ``ppl_base`` / ``ppl_quant`` (exp of the
    mean next-token xent), ``ppl_delta`` (quant - base, positive = worse)
    and ``argmax_agreement_pct`` (% of positions where the two argmaxes
    agree: what greedy decoding and speculative acceptance live by)."""
    base_xent, base_argmax = score(base_params, tokens, cfg)
    quant_xent, quant_argmax = score(quant_params, tokens, cfg)
    ppl_base = float(np.exp(float(base_xent)))
    ppl_quant = float(np.exp(float(quant_xent)))
    agree = float(np.mean(base_argmax.cpu().numpy()
                          == quant_argmax.cpu().numpy()))
    return {
        "ppl_base": round(ppl_base, 4),
        "ppl_quant": round(ppl_quant, 4),
        "ppl_delta": round(ppl_quant - ppl_base, 4),
        "argmax_agreement_pct": round(100 * agree, 2),
    }


def distill_draft(teacher_params: Params, teacher_cfg: ModelConfig,
                  student_cfg: ModelConfig, *, steps: int, batch_fn,
                  learning_rate: float = 1e-3, temperature: float = 1.0,
                  seed: int | None = None, device=None) -> tuple:
    """Train a small draft against the frozen teacher on ``device``
    (None: the card), the teacher passed to each step
    (``make_distill_step(teacher_as_arg=True)``). The student starts
    from ``model.init_params(student_cfg, seed)`` (seed 1 by default).
    ``batch_fn(i)`` supplies step i's (B, S) tokens: the teacher's
    training distribution, which acceptance is measured on. Returns
    (student_params, final_loss)."""
    device = resolve_device(device)
    student = init_params(student_cfg, seed=1 if seed is None else seed,
                          device=device)
    step, opt = make_distill_step(student_cfg, teacher_params, teacher_cfg,
                                  MeshConfig(), learning_rate=learning_rate,
                                  temperature=temperature,
                                  teacher_as_arg=True)
    opt_state = opt.init(student)
    loss = None
    for i in range(steps):
        student, opt_state, loss = step(
            student, teacher_params, opt_state,
            torch.as_tensor(batch_fn(i), device=device).long())
    return student, float(loss)


def spec_acceptance(target_params: Params, draft_params: Params,
                    cfg: ModelConfig, prompt, *, steps: int = 64,
                    gamma: int = 4, draft_cfg: ModelConfig | None = None,
                    device=None) -> dict:
    """Measured greedy speculative acceptance of ``draft_params``
    proposing for ``target_params`` on ``prompt``, on ``device`` (None:
    the card): {"mean_committed", "gamma"}, committed tokens per verify
    round (gamma + 1 when the draft's argmaxes are the target's).
    ``draft_cfg`` for a draft of another shape (a distilled student);
    the target's by default."""
    _, stats = speculative_generate(target_params, draft_params, prompt,
                                    cfg, draft_cfg or cfg, steps,
                                    gamma=gamma, with_stats=True,
                                    device=device)
    return {"mean_committed": round(float(stats["mean_committed"]), 3),
            "gamma": gamma}


__all__ = ["markov_batch", "score", "eval_quality", "distill_draft",
           "spec_acceptance"]
