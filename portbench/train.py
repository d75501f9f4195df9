"""Train cells: the program's training step (``train.make_train_step``:
the bf16 model on float32 master weights, K3/K4 attention, the float32
tied head, AdamW) on rows of uniform tokens made from the seed.

Set-up builds the one step object and its state from the seed's weights
and drives it through the first ``CHECKED`` steps with the window's own
feed; those steps warm every kernel and shape, and their losses, the
first gradient (read back from AdamW's first moment) and the change of
every leaf after them are kept for the check. The same object then runs
the window, one step after another, each ending when its loss is read
(a synchronize), until the window's time has passed.
"""

from __future__ import annotations

import gc
import sys
import time

from portbench import generator, trace, weights
from portbench.serve import model_config

CHECKED = 3  # steps the reference follows


def train_config(torch, ptrain, model, cell):
    p, st = cell.config["port"], cell.settings
    cfg = model_config(model, p, getattr(torch, cell.config["train"]
                                         ["compute_dtype"]))
    import dataclasses

    cfg = dataclasses.replace(cfg, vocab_chunk=int(st.get("vocab_chunk", 0)))
    opt = st["optimizer"]
    return ptrain.TrainConfig(
        model=cfg, learning_rate=opt["learning_rate"],
        weight_decay=opt["weight_decay"],
        grad_clip_norm=opt["grad_clip_norm"], remat=bool(st["remat"]),
        attention=st["attention"])


def leaf_norms(ts: list) -> list:
    return [float(t.float().norm()) for t in ts]


def run(torch, cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, make_step=None) -> dict:
    """One run of a train cell. ``make_step`` replaces
    ``train.make_train_step`` (the fault tests break the step with it)."""
    from tpu_bootstrap_torch.workload import model
    from tpu_bootstrap_torch.workload import train as ptrain

    t_import = time.perf_counter()
    p, st = cell.config["port"], cell.settings
    tcfg = train_config(torch, ptrain, model, cell)
    rows, seq = int(st["rows"]), int(cell.traffic["seq_len"])
    params = weights.float_params(torch, p, seed, device)
    opt_state = ptrain.make_optimizer(tcfg).init(params)
    step = (make_step or ptrain.make_train_step)(tcfg)
    if device.type == "cuda":
        torch.cuda.synchronize()

    def feed(i):
        return generator.train_batch(torch, seed, i, rows, seq,
                                     p["vocab_size"], device)

    t_built = time.perf_counter()
    losses, grad1 = [], None
    for i in range(CHECKED):
        params, opt_state, loss = step(params, opt_state, feed(i))
        losses.append(float(loss))
        if i == 0:
            b1 = ptrain.AdamW.b1
            grad1 = [n / (1 - b1) for n in leaf_norms(opt_state["mu"])]
    start = weights.float_params(torch, p, seed, device)
    change = [float((a - b).norm()) for a, b in
              zip(ptrain.tree_leaves(params), ptrain.tree_leaves(start))]
    del start
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {t_import - t_start:.2f} s to the program's "
          f"import, {t_built - t_import:.2f} s weights, state and step, "
          f"{setup_s - (t_built - t_start):.2f} s the {CHECKED} checked "
          f"steps", file=sys.stderr)

    tr = st.get("trace", {})
    slice_at = seconds * float(tr.get("start_frac", 0.4))
    slice_len = float(tr.get("slice_s", 3.0))
    sl, red, slice_steps = None, None, 0
    i, done = CHECKED, 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        if traced and device.type == "cuda" and red is None:
            if sl is None and now >= slice_at:
                sl = trace.Slice(torch)
                sl.start()
                slice_t = time.perf_counter() - t0
            elif sl is not None and now >= slice_t + slice_len:
                red = sl.stop()
        tracing = sl is not None and red is None
        with trace.span(torch, "data", tracing):
            tokens = feed(i)
        with trace.span(torch, "train_step", tracing):
            params, opt_state, loss = step(params, opt_state, tokens)
            float(loss)
        i += 1
        done += 1
        slice_steps += int(tracing)
    window = time.perf_counter() - t0
    if sl is not None and red is None:
        red = sl.stop()
    out = {"setup_s": setup_s, "train_tok_s": done * rows * seq / window,
           "attempted": done, "failed": 0, "window_s": window,
           "checked": {"losses": losses, "grad1": grad1, "change": change}}
    if red is not None:
        out["red"] = red
        out["work"] = {"steps": slice_steps, "rows": rows, "seq": seq}
    del params, opt_state, step
    gc.collect()
    return out


def reference_numbers(torch, cell, seed: int, device, act=None,
                      wround=None) -> dict:
    """The reference's ``CHECKED`` steps from the same weights and rows."""
    from portbench.reference import model as ref

    p, st = cell.config["port"], cell.settings
    rows, seq = int(st["rows"]), int(cell.traffic["seq_len"])
    params = weights.float_params(torch, p, seed, device)
    batches = [generator.train_batch(torch, seed, i, rows, seq,
                                     p["vocab_size"], device)
               for i in range(CHECKED)]
    return ref.train_steps(p, params, batches, st["optimizer"], act=act,
                           wround=wround)


def compare(prog: dict, refn: dict, skip_below: float) -> dict:
    """The check's numbers: ``loss_gap``, the largest gap of a step's loss;
    ``grad1_gap`` and ``change_gap``, the largest gap between the
    program's and the reference's norm of a leaf (its first gradient; its
    change after the checked steps) over the larger of that leaf's and
    the median leaf's reference norm. Leaves whose reference gradient is
    under ``skip_below`` times the median leaf's are left out of the
    change (Adam moves them by rounding alone)."""
    import statistics

    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"],
                                               refn["losses"]))
    g_med = statistics.median(refn["grad1"])
    grad1_gap = max(abs(a - b) / max(b, g_med)
                    for a, b in zip(prog["grad1"], refn["grad1"]))
    keep = [j for j, g in enumerate(refn["grad1"]) if g >= skip_below * g_med]
    c_med = statistics.median(refn["change"][j] for j in keep)
    change_gap = max(abs(prog["change"][j] - refn["change"][j])
                     / max(refn["change"][j], c_med) for j in keep)
    return {"loss_gap": loss_gap, "grad1_gap": grad1_gap,
            "change_gap": change_gap,
            "skipped_leaves": len(refn["grad1"]) - len(keep)}
