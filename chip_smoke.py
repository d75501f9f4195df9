#!/usr/bin/env python3
"""Build and drive the PyTorch port (``tpu_bootstrap_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. device  -- the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build   -- nvcc builds every kernel under tpu_bootstrap_torch/workload/csrc.
3. k1      -- int8_matmul (kernel K1) against its plain version at every
              (K, N) of the decode model, T in {1, 8, 64}, x in bf16 and f32;
              each row of a T=8 launch must equal, bitwise, the row alone.
4. k2      -- paged int8 decode attention (kernel K2) against its plain
              version over ragged lengths, an aliased table and garbage in
              every block a row does not own; widening the table must not
              change a bit.
5. serve   -- the slice end to end: serve(paged=True, kv_quant=True) of 32
              requests on the decode model at full width (8 layers, int8
              weights from a seed), the launch counts of both kernels over
              that run (both must be > 0), and every stream held to the
              port's solo greedy generate, in bf16 and again in f32: any
              divergence must be a near-tie.

Then one ``{"kernels": [...]}`` line and, last, the device line the caller
reads. Times are medians of CUDA-event timings after warm-up, with the 50 MB
L2 cache flushed before every timed launch (the serving path streams more
than L2 holds between two launches of one weight). ``bound_ms`` is the larger
of the bytes the function must move (each input read once, each output
written once) over the H100 SXM's 3.35 TB/s and its operations over the
card's peak for their type. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; bf16 tensor-core
# FLOP/s (K1's products are of bf16-rounded activations and int8 weights);
# f32 FLOP/s outside the tensor cores (K2 computes in f32).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
K1_SHAPES = {  # (K, N) of the decode model's int8 projections
    "wqkv": (1024, 3072), "wo": (1024, 1024), "w_up": (1024, 4096),
    "w_down": (4096, 1024), "lm_head": (1024, 32768)}
K2_LENGTHS = (1, 63, 64, 65, 512, 200, 130, 7)
# Top-2 logit margins under which two greedy runs may fairly pick different
# tokens. bf16: the gap that bf16 rounding (of the int8 matmul's activations,
# and of the oracle's dequantized K/V and probabilities) can open between the
# two paths' logits over 8 layers. f32: twice the largest logit gap the int8
# matmul's bf16 activation rounding leaves between two f32 paths that sum in
# another order (5e-3, tests/test_torch_decode.py).
NEAR_TIE = {"bfloat16": 0.05, "float32": 0.01}
PROFILED_REQUESTS = 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float) -> tuple:
    """The least time the card could take (ms), and what sets it: the
    bytes over the memory rate or the operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each. The
    device spins (about half a millisecond) after the flush, so the host
    has enqueued the whole call before its start event fires: the time is
    the device's, not the host's dispatch of a few-microsecond kernel."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch, device, reps: int = 25, warmup: int = 3):
        self.torch, self.reps, self.warmup = torch, reps, warmup
        self.flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.reps)]
        for start, end in pairs:
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_device(torch) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    path = kernels.build(verbose=True)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": str(path.name)})


def phase_k1(torch, kernels, quant, timer, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows, failures, max_err = [], [], 0.0
    for name, (k, n) in K1_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device=device) / math.sqrt(k)
        qw = quant.quantize_weight(w)
        w_bf16 = quant.dequantize_weight(qw).to(torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32):
            for t in (1, 8, 64):
                x = torch.randn(t, k, generator=gen, device=device).to(dtype)
                got = kernels.int8_matmul(x, qw.q, qw.s)
                want = quant.int8_matmul_plain(x, qw.q, qw.s)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                close = torch.allclose(got.float(), want.float(),
                                       rtol=8e-3, atol=1e-3)
                invariant = None
                if t == 8:
                    alone = torch.cat([kernels.int8_matmul(
                        x[i:i + 1].contiguous(), qw.q, qw.s)
                        for i in range(t)])
                    invariant = bool(torch.equal(alone, got))
                e = x.element_size()
                bound_ms, bound_by = bound(
                    k * n + 4 * n + t * k * e + t * n * e, 2 * t * k * n,
                    BF16_FLOPS)
                row = {"shape": name, "K": k, "N": n, "T": t,
                       "x": str(dtype).removeprefix("torch."),
                       "max_abs_err": err, "close": close,
                       "batch_invariant": invariant,
                       "kernel_ms": timer(
                           lambda: kernels.int8_matmul(x, qw.q, qw.s)),
                       "plain_ms": timer(
                           lambda: quant.int8_matmul_plain(x, qw.q, qw.s)),
                       "library_ms": timer(
                           lambda: torch.matmul(x.to(torch.bfloat16),
                                                w_bf16)),
                       "bound_ms": bound_ms, "bound_by": bound_by}
                rows.append(row)
                if not close or invariant is False:
                    failures.append(row)
    emit({"phase": "k1", "tolerance": {"rtol": 8e-3, "atol": 1e-3},
          "max_abs_err": max_err, "rows": rows})
    if failures:
        raise SystemExit(f"k1 failed: {failures}")
    return {"rows": rows, "max_abs_err": max_err}


def _k2_inputs(torch, decode, device, hk: int, gen):
    """B=8, H=16, D=64, bs=64, nb=8 over a 65-block pool (block 0 is the
    null block): ragged lengths, row 7's first block aliases row 4's, and
    every position no row may read holds int8 extremes with NaN scales."""
    b, h, d, bs, nb, n = 8, 16, 64, 64, 8, 65
    lengths = torch.tensor(K2_LENGTHS, dtype=torch.int32)
    tables = torch.zeros(b, nb, dtype=torch.int32)
    nxt = 1
    for r, length in enumerate(K2_LENGTHS):
        for j in range(-(-length // bs)):
            tables[r, j] = nxt
            nxt += 1
    tables[7, 0] = tables[4, 0]
    readable = torch.zeros(n, bs, dtype=torch.bool)
    for r, length in enumerate(K2_LENGTHS):
        for p in range(length):
            readable[tables[r, p // bs], p % bs] = True
    k = torch.randn(n, bs, hk, d, generator=gen, device=device)
    v = torch.randn(n, bs, hk, d, generator=gen, device=device)
    kq, ks = decode._quantize_kv(k)
    vq, vs = decode._quantize_kv(v)
    hidden = ~readable.to(device)
    kq[hidden] = 127
    vq[hidden] = -128
    ks[hidden] = float("nan")
    vs[hidden] = float("nan")
    q = torch.randn(b, h, d, generator=gen, device=device)
    return (q, kq, ks, vq, vs, tables.to(device), lengths.to(device))


def phase_k2(torch, kernels, decode, decode_attention, timer, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows, failures, max_err = [], [], 0.0
    tol = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
    for g in (1, 4):  # the wrapper's smem rule is the kernel's own layout
        if (kernels.lib().tpubc_paged_attention_smem_bytes(64, 64, g)
                != kernels.paged_attention_smem_bytes(64, 64, g)):
            raise SystemExit(f"k2: smem layout mismatch at group {g}")
    for hk in (16, 4):
        q32, kq, ks, vq, vs, bt, lengths = _k2_inputs(torch, decode, device,
                                                      hk, gen)
        b, h, d = q32.shape
        bs = kq.shape[1]
        for dtype in (torch.bfloat16, torch.float32):
            q = q32.to(dtype)
            args = (kq, ks, vq, vs)
            got = kernels.paged_attention(q, *args, bt, lengths)
            want = decode_attention.paged_decode_attention_int8_plain(
                q, *args, bt, lengths)
            wide = torch.cat([bt, torch.zeros_like(bt)], dim=1)
            got_wide = kernels.paged_attention(q, *args, wide, lengths)
            torch.cuda.synchronize()
            rtol, atol = tol[dtype]
            finite = bool(torch.isfinite(got.float()).all())
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            close = finite and torch.allclose(got.float(), want.float(),
                                              rtol=rtol, atol=atol)
            width_invariant = bool(torch.equal(got, got_wide))
            # The yardstick: SDPA over the window gathered and dequantized
            # beforehand (masked to each row's length).
            g = h // hk
            L = bt.shape[1] * bs
            kd = (kq[bt.long()].float() * ks[bt.long()][..., None]).nan_to_num(0)
            vd = (vq[bt.long()].float() * vs[bt.long()][..., None]).nan_to_num(0)
            kd = kd.reshape(b, L, hk, d).repeat_interleave(g, 2).transpose(1, 2)
            vd = vd.reshape(b, L, hk, d).repeat_interleave(g, 2).transpose(1, 2)
            kd, vd = kd.to(dtype).contiguous(), vd.to(dtype).contiguous()
            mask = (torch.arange(L, device=device)[None, :]
                    < lengths[:, None])[:, None, None, :]
            qs = q[:, :, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            e = q.element_size()
            bound_ms, bound_by = bound(
                sum(K2_LENGTHS) * hk * (2 * d + 8) + 2 * b * h * d * e,
                4 * sum(K2_LENGTHS) * h * d, F32_FLOPS)
            row = {"Hk": hk, "q": str(dtype).removeprefix("torch."),
                   "B": b, "H": h, "D": d, "bs": bs, "nb": bt.shape[1],
                   "lengths": list(K2_LENGTHS), "max_abs_err": err,
                   "close": close, "width_invariant": width_invariant,
                   "kernel_ms": timer(lambda: kernels.paged_attention(
                       q, *args, bt, lengths)),
                   "plain_ms": timer(
                       lambda: decode_attention
                       .paged_decode_attention_int8_plain(q, *args, bt,
                                                          lengths)),
                   "library_ms": timer(lambda: sdpa(qs, kd, vd,
                                                    attn_mask=mask)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows.append(row)
            if not close or not width_invariant:
                failures.append(row)
    emit({"phase": "k2", "tolerance": {"bfloat16": [1e-2, 1e-2],
                                       "float32": [1e-4, 1e-5]},
          "max_abs_err": max_err, "rows": rows})
    if failures:
        raise SystemExit(f"k2 failed: {failures}")
    return {"rows": rows, "max_abs_err": max_err}


def _serve_requests(serving, vocab: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [serving.Request(
        rid=i, tokens=rng.integers(1, vocab, int(rng.integers(16, 193)))
        .tolist(), max_new=int(rng.integers(8, 65))) for i in range(n)]


def _diverged(decode, params, cfg, reqs, done) -> list:
    """Requests whose stream differs from the port's solo greedy generate
    (einsum attention over a contiguous int8 cache), each with the solo
    run's top-2 logit margin at the first divergent step."""
    out = []
    for r in reqs:
        solo = decode.generate(params, [r.tokens], cfg, r.max_new,
                               kv_quant=True)[0].tolist()
        got = done[r.rid]
        if got != solo:
            j = next(i for i, (a, b) in enumerate(zip(got, solo)) if a != b)
            margin = decode.greedy_margins(params, r.tokens, solo[:j + 1],
                                           cfg, kv_quant=True)[j]
            out.append({"rid": r.rid, "step": j, "margin": margin})
    return out


def _profile_serve(torch, run) -> dict:
    """One more bf16 serve, of the first PROFILED_REQUESTS requests,
    under torch.profiler (device activity only: a full run records some
    600k kernels, which takes the profiler minutes to fold): device busy
    time (the sum of kernel times, one stream) against the run's wall
    time, and the kernels that take it. Profiling slows the host, so the
    idle share is an upper bound for the unprofiled run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in gpu) / 1e3
    top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:8]

    def share(tag):
        return sum(e.self_device_time_total for e in gpu if tag in e.key) / 1e3

    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "k1_ms": share("int8_matmul_kernel"),
            "k2_ms": share("paged_attention_kernel"),
            "kernel_launches": sum(e.count for e in gpu),
            "top": [{"kernel": e.key[:80], "ms": e.self_device_time_total
                     / 1e3, "count": e.count} for e in top]}


def phase_serve(torch, kernels, device) -> dict:
    """The slice end to end: the repo's decode model at full width (bf16,
    8 layers, random int8 weights from a seed), 32 requests through the
    paged engine, launches of both kernels counted over exactly that run.
    Every stream is held to the port's solo greedy generate, in bf16 and
    again in f32: a divergence is accepted only at a near-tie (NEAR_TIE).
    The two paths cannot agree bit for bit: the oracle attends with
    einsums (in bf16 it rounds dequantized K/V and the probabilities to
    bf16, where K2, like the Pallas kernel it replaces, keeps f32), and
    the int8 matmul rounds its activations to bf16, which turns any f32
    difference into a logit difference of about 1e-3."""
    import dataclasses

    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(vocab_size=32768, num_layers=8, num_heads=16,
                            head_dim=64, embed_dim=1024, mlp_dim=4096,
                            max_seq_len=512, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    kw = dict(paged=True, kv_quant=True, prefix_cache=False,
              overcommit=False)
    # Warm-up: first-call costs (allocator, library handles) stay out of
    # the measured run.
    serving.serve(params, cfg, _serve_requests(serving, cfg.vocab_size, 2,
                                               seed=1), 8, **kw)
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    stats: dict = {}
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = serving.serve(params, cfg, reqs, 8, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    tokens = sum(len(v) for v in done.values())
    shape_ok = (sorted(done) == [r.rid for r in reqs] and all(
        len(done[r.rid]) == r.max_new
        and all(0 <= t < cfg.vocab_size for t in done[r.rid])
        for r in reqs))
    t1 = time.perf_counter()
    diverged = _diverged(decode, params, cfg, reqs, done)
    solo_s = time.perf_counter() - t1
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    done32 = serving.serve(params, cfg32, reqs, 8, **kw)
    diverged32 = _diverged(decode, params, cfg32, reqs, done32)
    profile = _profile_serve(torch, lambda: serving.serve(
        params, cfg, reqs[:PROFILED_REQUESTS], 8, **kw))
    result = {"phase": "serve", "requests": len(reqs), "tokens": tokens,
              "wall_s": wall, "tokens_per_s": tokens / wall,
              "rounds": stats["rounds"], "blocks_peak": stats["blocks_peak"],
              "blocks_total": stats["blocks_total"],
              "prefill_tokens": stats["prefill_tokens"],
              "prefill_chunks": stats["prefill_chunks"],
              "slot_steps": stats["slot_steps"],
              "active_slot_steps": stats["active_slot_steps"],
              "launches": launches, "shape_ok": shape_ok,
              "near_tie": NEAR_TIE, "solo_check_s": solo_s,
              "diverged": {"bfloat16": diverged, "float32": diverged32},
              "profile": profile}
    emit(result)
    bad = [d for dt in NEAR_TIE for d in result["diverged"][dt]
           if d["margin"] >= NEAR_TIE[dt]]
    if not shape_ok or bad or min(launches.values()) < 1:
        raise SystemExit(f"serve failed: shape_ok={shape_ok} bad={bad} "
                         f"launches={launches}")
    return result


def k1_step_totals(k1: dict, layers: int = 8) -> dict:
    """K1's numbers for one decode step at batch 8: four bf16 launches
    per layer (wqkv, wo, w_up, w_down) plus the f32 lm_head launch."""
    pick = {(r["shape"], r["x"]): r for r in k1["rows"] if r["T"] == 8}
    step = [(layers, pick[(s, "bfloat16")])
            for s in ("wqkv", "wo", "w_up", "w_down")]
    step.append((1, pick[("lm_head", "float32")]))
    out = {key: sum(m * r[key] for m, r in step)
           for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                      for _, r in step) else "operations")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tpu_bootstrap_torch.workload import (decode, decode_attention,
                                              kernels, quant)

    device = torch.device("cuda")
    info = phase_device(torch)
    phase_build(kernels)
    timer = Timer(torch, device)
    k1 = phase_k1(torch, kernels, quant, timer, device)
    k2 = phase_k2(torch, kernels, decode, decode_attention, timer, device)
    del timer  # frees the L2-flush buffer
    launches = phase_serve(torch, kernels, device)["launches"]

    k1_step = k1_step_totals(k1)
    k2_main = next(r for r in k2["rows"] if r["Hk"] == 16
                   and r["q"] == "bfloat16")
    emit({"kernels": [
        {"name": "int8_matmul", "route": "cuda",
         "source": "tpu_bootstrap_torch/workload/csrc/int8_matmul.cu",
         "replaces": "tpu_bootstrap/workload/quant.py:246",
         "launches": launches["int8_matmul"],
         "max_abs_err": k1["max_abs_err"],
         "ms": k1_step["kernel_ms"], "plain_ms": k1_step["plain_ms"],
         "bound_ms": k1_step["bound_ms"], "bound_by": k1_step["bound_by"],
         "library_ms": k1_step["library_ms"],
         "at": "one decode step, T=8: 8 x (wqkv, wo, w_up, w_down) bf16 "
               "+ lm_head f32"},
        {"name": "paged_decode_attention_int8", "route": "cuda",
         "source": "tpu_bootstrap_torch/workload/csrc/paged_attention.cu",
         "replaces": "tpu_bootstrap/workload/decode_attention.py:151",
         "launches": launches["paged_attention"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2_main["kernel_ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": k2_main["library_ms"],
         "at": "one launch, B=8 H=Hk=16 D=64 bs=64 nb=8, bf16 q, lengths "
               + ",".join(map(str, K2_LENGTHS))},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
