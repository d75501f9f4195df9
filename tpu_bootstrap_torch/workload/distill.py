"""Draft distillation, the counterpart of
``tpu_bootstrap/workload/distill.py``: train a small student to mimic a
frozen teacher, the high-acceptance draft speculative decoding wants.

The loss is the soft-target cross-entropy H(p_T, p_S) at a temperature
(equal to KL(p_T || p_S) up to the teacher's entropy, so its gradients are
the KL's), scaled by T^2, plus an optional hard-label next-token term. The
teacher's forward runs under ``torch.no_grad()`` (the reference's
``stop_gradient``); gradients and optimizer state exist for the student
only. Both forwards are ``model.forward`` with the dense attention core,
as in the reference.

The step is eager PyTorch and updates the student in place. On a mesh
the student and the teacher (captured or passed) are placed by
``sharding.param_shardings`` and gathered for each step's compute, each
rank distils on its rows of the batch (whole rows on every ``seq`` rank,
as the reference's step cuts the batch only), and the student's gradients
are summed over ``sharding.GRAD_AXES`` onto its shards
(``train.descend``). The frozen teacher is gathered whole, an MoE
teacher's experts included. A ``pipe`` axis is plain replication here, as
in the reference: the student's blocks are not stacked, so no spec names
``pipe`` and every pipe rank computes the same step.
"""

from __future__ import annotations

import torch

from tpu_bootstrap_torch.workload import sharding
from tpu_bootstrap_torch.workload.model import ModelConfig, Params, forward
from tpu_bootstrap_torch.workload.train import (
    AdamW,
    descend,
    local_rows,
    place_state,
    resolve_mesh,
    tree_leaves,
)


def distill_loss(student_params: Params, teacher_params: Params,
                 tokens: torch.Tensor, student_cfg: ModelConfig,
                 teacher_cfg: ModelConfig, temperature: float = 1.0,
                 hard_weight: float = 0.0) -> torch.Tensor:
    """Soft-target cross-entropy at ``temperature``, times T^2, plus
    ``hard_weight`` times the ordinary next-token cross-entropy on the
    data labels."""
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    with torch.no_grad():
        t_logits = forward(teacher_params, inputs, teacher_cfg)
    s_logits = forward(student_params, inputs, student_cfg)
    p_t = torch.softmax(t_logits / temperature, dim=-1)
    log_s = torch.log_softmax(s_logits / temperature, dim=-1)
    soft = -torch.mean(torch.sum(p_t * log_s, dim=-1)) * temperature ** 2
    if hard_weight > 0.0:
        logprobs = torch.log_softmax(s_logits, dim=-1)
        nll = -torch.gather(logprobs, -1, targets[..., None].long())[..., 0]
        soft = soft + hard_weight * torch.mean(nll)
    return soft


def make_distill_step(student_cfg: ModelConfig, teacher_params: Params,
                      teacher_cfg: ModelConfig, mesh, *,
                      learning_rate: float = 1e-3, temperature: float = 1.0,
                      hard_weight: float = 0.0, weight_decay: float = 1e-4,
                      teacher_as_arg: bool = False):
    """Returns (step, optimizer). The optimizer is optax's plain
    ``adamw(learning_rate, weight_decay)``: a constant rate, no clipping,
    no warm-up. ``teacher_as_arg`` False: step(student, opt_state, tokens)
    with the teacher closed over; True: step(student, teacher, opt_state,
    tokens). Either returns (student, opt_state, loss), the student
    updated in place. ``mesh`` is a built mesh (``sharding.build_mesh``)
    or a ``MeshConfig`` (built when it spans several devices); on a mesh a
    student or teacher not placed yet is placed by ``param_shardings``
    (use the returned student). Student and teacher must share a
    vocabulary; depth and widths are free."""
    if student_cfg.vocab_size != teacher_cfg.vocab_size:
        raise ValueError(
            f"student and teacher must share a vocab: "
            f"{student_cfg.vocab_size} vs {teacher_cfg.vocab_size}")
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if student_cfg.num_experts > 0:
        # distill_loss carries no MoE load-balancing aux (router collapse);
        # an MoE teacher is fine.
        raise ValueError(
            "MoE students are not supported (the distillation loss "
            "carries no load-balancing aux); use a dense student_cfg")
    if isinstance(mesh, sharding.MeshConfig):
        mesh = resolve_mesh(mesh)
    else:
        mesh = resolve_mesh(sharding.mesh_config(mesh), mesh)
    opt = AdamW(lambda count: learning_rate, weight_decay, clip=0.0)

    def placed(tree, opt_state=None):
        if mesh is None:
            return tree
        return place_state(tree, sharding.param_shardings(mesh, tree),
                           opt_state)

    def update(student, teacher, opt_state, tokens):
        if mesh is not None:
            student = placed(student, opt_state)
            teacher = placed(teacher)
            tokens = local_rows(tokens, mesh)
        loss_value = descend(opt, opt_state, tree_leaves(student),
                             lambda view: distill_loss(
                                 view(student), sharding.gather_tree(teacher),
                                 tokens, student_cfg, teacher_cfg,
                                 temperature, hard_weight), mesh)
        return student, opt_state, loss_value

    if teacher_as_arg:
        return update, opt
    teacher_params = placed(teacher_params)

    def step(student, opt_state, tokens):
        return update(student, teacher_params, opt_state, tokens)

    return step, opt


__all__ = ["distill_loss", "make_distill_step"]
