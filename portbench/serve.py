"""Serve cells: the program's paged int8 engine (``serving.PagedPool``
behind ``serving.Scheduler``) under an open loop of requests offered at
the cell's fixed rate.

Set-up draws the weights from the seed on the device (each block float32,
then int8 through the program's ``quant``), builds the pool with the
cell's settings, and runs one request per decode table width the mix can
reach, one after the other, so every captured decode step and the prefill
chunk shapes exist before the window. The window submits each request
when it is due and steps the Scheduler; a round's tokens are delivered
when it returns. The window closes at the first round boundary past
``--seconds``, and the tokens delivered are taken over its real length.
A cell whose rate lies above what the engine sustains leaves a backlog
there, which is not drained.
"""

from __future__ import annotations

import gc
import sys
import time

from portbench import generator, trace, weights
from portbench.common import percentile


def model_config(model, p: dict, dtype):
    return model.ModelConfig(
        vocab_size=p["vocab_size"], num_layers=p["num_layers"],
        num_heads=p["num_heads"], head_dim=p["head_dim"],
        embed_dim=p["embed_dim"], mlp_dim=p["mlp_dim"],
        max_seq_len=p["max_seq_len"], compute_dtype=dtype,
        num_kv_heads=p["num_kv_heads"],
        num_experts=p.get("num_experts", 0),
        expert_top_k=p.get("expert_top_k", 2),
        expert_capacity_factor=p.get("expert_capacity_factor", 2.0),
        moe_aux_coef=p.get("moe_aux_coef", 0.01),
        mlp_gated=p.get("mlp_gated", False))


def build_pool(torch, cell, seed: int, device):
    from tpu_bootstrap_torch.workload import model, quant, serving

    p, eng = cell.config["port"], cell.settings["engine"]
    cfg = model_config(model, p, getattr(torch, cell.config["serve"]
                                         ["compute_dtype"]))
    params = weights.serve_params(torch, quant, p, seed, device)
    pool = serving.PagedPool(
        params, cfg, eng["rows"], kv_blocks=eng["kv_blocks"],
        block_size=eng["block_size"], prefill_budget=eng["prefill_budget"],
        kv_quant=eng["kv_quant"], prefix_cache=eng["prefix_cache"],
        host_blocks=eng["host_blocks"], spec_lookup=eng["spec_lookup"],
        paged_kernel=eng["paged_kernel"], device=device)
    return cfg, pool


def _drain(serving, sched, pool, requests) -> None:
    for r in requests:
        sched.submit(serving.Request(rid=r.rid, tokens=r.prompt,
                                     max_new=r.max_new))
        while sched.pending() or pool.has_active():
            sched.step()


def warm_up(torch, cell, cfg, pool) -> None:
    """Set-up's requests through a Scheduler of their own, one at a
    time (see ``generator.warm_arrivals``)."""
    from tpu_bootstrap_torch.workload import serving

    eng = cell.settings["engine"]
    sched = serving.Scheduler(pool, overcommit=eng["overcommit"])
    _drain(serving, sched, pool, generator.warm_arrivals(
        cell.traffic, cell.settings, cfg.vocab_size, eng["block_size"],
        cfg.max_seq_len))
    if pool.device.type == "cuda":
        torch.cuda.synchronize()


class Book:
    """The harness's own record of every request: due, submitted, token
    deliveries (time, count), finished, and shed by the Scheduler."""

    def __init__(self, arrivals):
        self.req = {a.rid: a for a in arrivals}
        self.due = {a.rid: a.due_s for a in arrivals}
        self.submitted = {}
        self.deliveries = {a.rid: [] for a in arrivals}
        self.generated = {a.rid: [] for a in arrivals}
        self.done = set()
        self.shed = set()

    def submit(self, sched, a, now: float) -> None:
        sched.submit(_request(a))
        self.submitted[a.rid] = now

    def fold(self, events: dict, t: float) -> list:
        """Record a round's events at time t; returns (rid, context
        before, tokens) of each row that advanced."""
        adv = []
        for rid, ev in events.items():
            new = ev["new"]
            if rid not in self.req:
                continue
            if new:
                ctx = len(self.req[rid].prompt) + len(self.generated[rid])
                adv.append((rid, ctx, len(new)))
                self.deliveries[rid].append((t, len(new)))
                self.generated[rid].extend(new)
            if ev["done"]:
                self.done.add(rid)
                if ev.get("deadline"):
                    self.shed.add(rid)
        return adv


def _decode_steps(rounds: list) -> list:
    """Per decode step of the slice, the live rows' attention lengths."""
    steps = []
    for chunk, adv in rounds:
        for j in range(chunk):
            steps.append([ctx + j for _rid, ctx, n in adv if j < n])
    return steps


class _Slice:
    """The traced slice of a window: started at the first round boundary
    past ``start_frac`` of the window, stopped at the first past
    ``slice_s`` more; the rounds between are recorded for the counts."""

    def __init__(self, torch, cell, seconds: float, traced: bool, on_card):
        tr = cell.settings.get("trace", {})
        self.torch, self.on = torch, traced and on_card
        self.at = seconds * float(tr.get("start_frac", 0.4))
        self.len = float(tr.get("slice_s", 3.0))
        self.sl, self.red, self.us, self.rounds = None, None, None, []

    def boundary(self, now: float, t0: float) -> None:
        from tpu_bootstrap_torch import telemetry

        if not self.on or self.red is not None:
            return
        if self.sl is None and now >= self.at:
            self.sl = trace.Slice(self.torch)
            self.sl.start()
            self.us = [telemetry.now_us(), None]
            self.t = time.perf_counter() - t0
        elif self.sl is not None and now >= self.t + self.len:
            self.close()

    def close(self) -> None:
        from tpu_bootstrap_torch import telemetry

        if self.sl is not None and self.red is None:
            self.red = self.sl.stop()
            self.us[1] = telemetry.now_us()

    @property
    def tracing(self) -> bool:
        return self.sl is not None and self.red is None


def _step(torch, sched, pool, book, sl: _Slice, t0: float) -> None:
    """One Scheduler round, its events folded into the book at the time it
    returned."""
    before = pool.stats["slot_steps"]
    with trace.span(torch, "step", sl.tracing):
        events = sched.step()
    adv = book.fold(events, time.perf_counter() - t0)
    if sl.tracing:
        sl.rounds.append(((pool.stats["slot_steps"] - before)
                          // pool.batch_size, adv))


def run_window(torch, cell, pool, sched, arrivals, seconds: float,
               traced: bool) -> dict:
    """The window: each of ``arrivals`` submitted at its due time, the
    Scheduler stepped while it has work, until the first round boundary
    past ``seconds``. Requests still queued or running then are the
    backlog; nothing is drained. With ``traced``, one slice of whole
    rounds is profiled."""
    book = Book(arrivals)
    sl = _Slice(torch, cell, seconds, traced, pool.device.type == "cuda")
    i, n = 0, len(arrivals)
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        sl.boundary(now, t0)
        with trace.span(torch, "submit", sl.tracing):
            while i < n and arrivals[i].due_s <= now:
                book.submit(sched, arrivals[i], now)
                i += 1
        if sched.pending() or pool.has_active():
            _step(torch, sched, pool, book, sl, t0)
        else:
            nxt = arrivals[i].due_s if i < n else seconds
            with trace.span(torch, "wait", sl.tracing):
                time.sleep(max(0.0, min(nxt - now, 0.05)))
    t_end = time.perf_counter() - t0
    sl.close()
    out = {"book": book, "t_end": t_end, "opened": t0,
           "chunks": prefill_chunks(sched, book)}
    if sl.red is not None:
        out["red"] = sl.red
        out["work"] = _attach_log(sched, sl.rounds, sl.us, book)
    return out


def prefill_chunks(sched, book: Book) -> dict:
    """rid -> the (start, width) of each prefill chunk the program ran for
    it, from its request log."""
    out = {}
    for rec in sched.log.snapshot()["requests"]:
        if rec["rid"] in book.req:
            out[rec["rid"]] = [(e["prefilled"] - e["tokens"], e["tokens"])
                               for e in rec["events"]
                               if e["kind"] == "prefill_chunk"]
    return out


def _attach_log(sched, rounds: list, slice_us: list, book: Book) -> dict:
    """The slice's work: decode steps from the harness's own record, and
    prefill chunks (start, width) by round from the program's request
    log."""
    a, z = slice_us
    by_round = {}
    for rec in sched.log.snapshot()["requests"]:
        if rec["rid"] not in book.req:
            continue
        for e in rec["events"]:
            if e["kind"] == "prefill_chunk" and a <= e["t_us"] <= z:
                by_round.setdefault(e["round"], []).append(
                    (e["prefilled"] - e["tokens"], e["tokens"]))
    return {"decode_steps": _decode_steps(rounds),
            "prefill_rounds": [by_round[k] for k in sorted(by_round)]}


def _request(a):
    from tpu_bootstrap_torch.workload import serving

    return serving.Request(rid=a.rid, tokens=a.prompt, max_new=a.max_new)


def end_to_end(book: Book, t_end: float) -> dict:
    """out_tok_s: every token delivered in the window over the window's
    real length (to the first round boundary past ``--seconds``).
    Every request due in the window is attempted; one the Scheduler shed
    has failed."""
    delivered = sum(k for d in book.deliveries.values() for _t, k in d)
    return {"out_tok_s": delivered / t_end, "attempted": len(book.req),
            "failed": len(book.shed)}


def stats(book: Book, t_end: float) -> dict:
    """What the window left, for standard error and the sweep: requests
    finished and left over, and the first-token times of those served."""
    ttft = [(d[0][0] - book.due[r]) * 1e3
            for r, d in book.deliveries.items() if d]
    return {"window_s": t_end, "submitted": len(book.submitted),
            "finished": len(book.done),
            "backlog": len(book.req) - len(book.done),
            "ttft_p50_ms": percentile(ttft, 50),
            "ttft_p95_ms_served": percentile(ttft, 95)}


def sample(book: Book, seed: int, want_tokens: int, most: int) -> list:
    """Finished requests to check: the longest (prompt plus output) first,
    then others in an order the seed draws, until ``want_tokens`` served
    tokens or ``most`` requests."""
    import numpy as np

    done = sorted(book.done - book.shed)
    if not done:
        return []
    total = {rid: len(book.req[rid].prompt) + len(book.generated[rid])
             for rid in done}
    first = max(done, key=lambda r: (total[r], -r))
    rest = [r for r in done if r != first]
    rng = np.random.default_rng((seed * 7919 + 17) & ((1 << 63) - 1))
    rest = [rest[j] for j in rng.permutation(len(rest))]
    out, tokens = [first], len(book.generated[first])
    for rid in rest:
        if tokens >= want_tokens or len(out) >= most:
            break
        out.append(rid)
        tokens += len(book.generated[rid])
    return out


def served_gaps(torch, p: dict, seed: int, device, book: Book, rids: list,
                chunks: dict, act=None) -> dict:
    """The reference over each sampled prompt with its served tokens:
    ``max_gap``, the widest amount by which a served token's reference
    logit lies below the reference's best at its position, and
    ``mean_gap``, the mean of those amounts over every served token; with
    ``act`` (the control) the gaps of the tokens the lower precision puts
    first.
    A MoE reference routes each prefill chunk the program ran (``chunks``,
    from its request log) with the configuration's capacity, and every
    later token alone."""
    from portbench.reference import model as ref

    seqs, spans, served = [], [], []
    for rid in rids:
        prompt, gen = book.req[rid].prompt, book.generated[rid]
        seqs.append(torch.tensor(prompt + gen[:-1], dtype=torch.long))
        spans.append((len(prompt) - 1, len(prompt) - 1 + len(gen)))
        served.append(torch.tensor(gen, dtype=torch.long, device=device))
    segs = [chunks.get(rid, []) for rid in rids]
    logits = ref.serve_logits(p, seed, device, seqs, spans, segments=segs)
    ctl = (ref.serve_logits(p, seed, device, seqs, spans, act=act,
                            segments=segs) if act is not None else None)
    gaps = []
    for i, lg in enumerate(logits):
        pick = served[i] if ctl is None else ctl[i].argmax(dim=-1)
        gaps.append(lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0])
    g = torch.cat(gaps)
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "tokens": int(g.numel()), "requests": len(rids)}


def run(torch, cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    """One run of a serve cell: set-up, the window, the end-to-end numbers
    (or, traced, the slice), and what the check needs."""
    from tpu_bootstrap_torch.workload import serving

    t = time.perf_counter()
    cfg, pool = build_pool(torch, cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_pool = time.perf_counter()
    warm_up(torch, cell, cfg, pool)
    t_warm = time.perf_counter()
    print(f"portbench: set-up {t - t_start:.2f} s to the build, "
          f"{t_pool - t:.2f} s weights and pool, {t_warm - t_pool:.2f} s "
          f"warm-up", file=sys.stderr)
    eng = cell.settings["engine"]
    sched = serving.Scheduler(pool, overcommit=eng["overcommit"])
    arrivals = generator.serve_arrivals(cell.traffic, cell.settings, seed,
                                        seconds, cfg.vocab_size)
    if device.type == "cuda":
        torch.cuda.synchronize()
    win = run_window(torch, cell, pool, sched, arrivals, seconds, traced)
    book = win["book"]
    busy = sum(s is not None for s in pool.slots)
    print(f"portbench: window {stats(book, win['t_end'])}, rows busy at "
          f"its close {busy} of {pool.batch_size}", file=sys.stderr)
    out = {"setup_s": win["opened"] - t_start,
           **end_to_end(book, win["t_end"]),
           "book": book, "chunks": win["chunks"]}
    if "red" in win:
        out["red"], out["work"] = win["red"], win["work"]
    del pool, sched
    gc.collect()
    return out
