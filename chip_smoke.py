#!/usr/bin/env python3
"""Build and drive the PyTorch port (``tpu_bootstrap_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. device  -- the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build   -- nvcc builds every kernel under tpu_bootstrap_torch/workload/csrc;
              the registers and spills (-Xptxas -v) and the HGMMA count
              (cuobjdump -sass) of each tensor-core kernel: the 9 bf16
              flash kernels and the 16 quantized-matmul instantiations (8
              int8, 8 int4); no count may be 0, no quantized one may spill
              or have its wgmmas serialized (ptxas C7520), and each
              format's shared memory must equal kernels.quant_smem_bytes;
              the registers and spills of the six decode-attention
              kernels (K2 with the decode model's head dim and block
              compiled in and general, K5; each in bf16 and f32), none of
              which may spill.
3. k1      -- int8_matmul (kernel K1) against its plain version at every
              (K, N) of the decode model, T in {1, 8, 64}, plus a K tail
              (K=1000), x in bf16 and f32 (MATMUL_TOL); each row launched
              alone must equal, bitwise, its row of the launch at T = 8 and
              64; each row's split and CTAs printed, timed beside
              torch.matmul on the bf16-dequantized weight; then each decode
              shape at T = 8 launched with every split of SWEEP_SPLITS and
              the plan's, each held to the plain version and timed.
4. k2      -- paged int8 decode attention (kernel K2) against its plain
              version over ragged lengths and, in bf16, a full-length batch
              (every row at 512), Hk 16 and 4, an aliased table and garbage
              with NaN scales in every block a row does not own, then at
              the geometries of K2_OTHER (D 128 and 16, blocks of 16 and
              32); widening the table must not change a bit, nor launching
              each row alone; each row's plan (chunk, ranks), timed beside
              scaled_dot_product_attention on the gathered window; then, in
              bf16, every split of the sweep held to the plain version and
              bitwise to the plan's, each timed.
5. k1e     -- int8_expert_matmul (kernel K1e) against its plain version at
              the MoE decode model's expert stacks (E=8; (K, N) = (1024,
              4096) and (4096, 1024)), T in {1, 8, 32, 256}, x in bf16 and
              f32, plus a ragged case; each row launched alone must equal,
              bitwise, its row of the launch at T = 8 and 32 (per expert);
              timed beside torch.bmm.
6. k6      -- int4_matmul (kernel K6, group 64) at every (K, N) of the
              decode model (lm_head as under head="int4"), T in {1, 8, 64},
              plus a K tail (K=1000) and an odd small group (6) with N=1000;
              and int4_expert_matmul (kernel K6e) at the two expert stacks,
              T in {1, 8, 32}; the same checks, each row launched alone
              equal bitwise to its row of the launch at T = 8 and 64
              (dense) and 8 and 32 (expert), each row's split and CTAs
              printed, timed beside torch.matmul / torch.bmm on the
              bf16-dequantized weight; then the split sweep, as k1's.
7. k5      -- contiguous int8 decode attention (kernel K5) against its plain
              version at the decode model's caches (B=8, H=16, D=64, Hk 16
              and 4, L in {128, 256, 261, 512}) and at the geometries of
              K5_OTHER (D 576 and 32, L 261), q in bf16 and f32, prefix
              masks and a mask with holes: garbage at masked positions must
              change no bit, and each row of a B=8 launch must equal, bitwise,
              the row launched alone; each row's plan; the full-mask bf16
              rows at L 256 and 512 and of K5_OTHER timed beside
              scaled_dot_product_attention on the bf16-dequantized cache
              with the boolean mask, and swept over every split as in k2.
8. serve   -- the serving slice end to end: serve(paged=True, kv_quant=True)
              of 32 requests on the decode model at full width (8 layers,
              int8 weights from a seed), the launch counts of both kernels
              over that run (both must be > 0), and every stream held to the
              port's solo greedy generate (kv_kernel=False, the einsum
              oracle), in bf16 and again in f32: any divergence must be a
              near-tie. Then the replay-slot engine, serve(paged=False), on
              the first 8 requests, with and without the int8 self-draft
              (the speculative rounds), its streams held to the same solo
              runs. Then the flash prefill: generate(prefill_flash=True),
              whose prompt attention runs through K3, against generate()
              with the einsum prefill.
9. serve_int4 -- the serve phase's workload on the same model with int4
              weights (quantize_params4, group 64, int8 head): K6, K1 and K2
              launched, every stream held to solo generate as in serve, in
              bf16 and in f32.
10. serve_moe -- the MoE decode model (the same widths with 8 experts,
              top-2, capacity factor 2) served with int8 (K1, K1e, K2) and
              int4 (K6, K6e, K1 head, K2) weights on 16 of the requests:
              every stream complete, every decode logit finite, a second
              serve bitwise the same; of the first 8 streams, those that
              differ from solo generate are counted, not failed (capacity
              is contested over each chunk, so chunked serving routes
              otherwise).
11. generate_int8kv -- bench.py's int8-KV decode workload: generate on the
              decode model with int8 weights and an int8 KV cache, prompts
              (8, 64), 64 and 192 steps, with K5 (AUTO) and without it
              (kv_kernel=False); K5 launched exactly (steps - 1) x 8 times a
              call; every stream of the kernel path held to the einsum
              path's (near-ties allowed); two-point tokens/s of both; one
              profiled call of each.
12. speculative -- bench.py's self-speculation: the bf16 target drafted by
              its own int8 copy, gamma 4, int8 KV caches (the draft's steps
              on K5), prompts (8, 64), 64 steps; streams held to the
              target's generate(kv_kernel=False) (near-ties allowed),
              mean_committed, verify_rounds, tokens/s and K5's launches.
13. k3     -- flash_fwd (kernel K3: bf16 on the tensor cores, f32 on the
              CUDA cores) against its plain version (out and lse, each
              element to its own limit) at the train shapes (B=8 S=1023
              and B=2 S=8191, H=16 D=64) in bf16 and f32, causal and not,
              plus a GQA and small head-dim cases (D 32 in both dtypes, 128
              in bf16); in bf16 a control (one KV tile skipped) must land
              outside the limits; the kernels' shared memory against
              kernels.flash_smem_bytes; timed beside
              scaled_dot_product_attention.
14. k4     -- flash_dq and flash_dkv (kernel K4) through the autograd
              function against the plain backward, at the same cases (some
              with an lse cotangent); two backward runs must be bitwise
              equal; in bf16 the controls (a skipped KV tile, delta'
              dropped, the lse cotangent ignored) must land outside the
              limit; timed beside SDPA's backward.
15. train  -- the training slice end to end: make_train_step on the
              reference's 134M train benchmark model (seq 1024, batch 8,
              attention="flash", a fixed token batch from a seed), one
              warm-up step then 5 timed; every loss finite, the loss falling,
              the first step's loss equal to the dense core's within
              FLASH_DENSE_TOL, the attention weights' gradients equal to the
              dense core's within ATTN_GRAD_TOL while a broken attention's
              land outside it, 8 launches of each flash kernel per step; one
              profiled step, in which each flash role's device time must
              be above 0; then two steps of train_loop.
16. train_long -- the reference's long-context configuration (seq 8192,
              batch 2, remat, vocab_chunk 4096): one warm-up and two timed
              steps; with remat the forward kernel runs twice per layer;
              the same profiled-step check.

Then one ``{"phase_seconds": {...}}`` line (each phase's wall time), one
``{"kernels": [...]}`` line and, last, the device line the caller reads.
Times are medians of CUDA-event timings after warm-up, with the 50 MB L2
cache flushed before every timed launch (the serving path streams more than
L2 holds between two launches of one weight). ``bound_ms`` is the larger of
the bytes the function must move (each input read once, each output written
once) over the H100 SXM's 3.35 TB/s and its operations over the card's peak
for their type. The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
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
# The decode model of bench.py:470-472 and its MoE variant (the expert
# stack shape (8, 1024, 4096) bench.py:583-587 measures the expert kernel
# at).
DECODE_MODEL = dict(vocab_size=32768, num_layers=8, num_heads=16,
                    head_dim=64, embed_dim=1024, mlp_dim=4096,
                    max_seq_len=512)
MOE_MODEL = dict(num_experts=8, expert_top_k=2, expert_capacity_factor=2.0)
MOE_SHAPES = {"moe_up": (1024, 4096), "moe_down": (4096, 1024)}
MOE_REQUESTS = 16
MOE_SOLO = 8  # of them, compared with solo generate
INT4_GROUP = 64
# T of an expert launch is rows x capacity: 8 is a decode step at batch 8
# (capacity 1 per expert per row), 32 the serve phases' 64-token prefill
# chunk of one row (capacity 32), 256 64-token chunks of 4 rows.
EXPERT_T = (1, 8, 32, 256)
# K1, K1e, K6 and K6e against their plain versions, |got - want| <= rtol *
# |want| + atol. Both sides multiply the same bf16-rounded operands (each
# product exact in f32) and sum in f32 in other orders: bf16 outputs may
# differ by one bf16 rounding (2^-8 relative), f32 outputs by the order of
# the f32 sums.
MATMUL_TOL = {"bfloat16": (8e-3, 1e-3), "float32": (1e-4, 1e-4)}
# Top-2 logit margins under which two greedy runs may fairly pick different
# tokens. bf16: the gap that bf16 rounding (of the int8 matmul's activations,
# and of the oracle's dequantized K/V and probabilities) can open between the
# two paths' logits over 8 layers. f32: twice the largest logit gap the int8
# matmul's bf16 activation rounding leaves between two f32 paths that sum in
# another order (5e-3, tests/test_torch_decode.py).
NEAR_TIE = {"bfloat16": 0.05, "float32": 0.01}
PROFILED_REQUESTS = 8
# The slot engine's share of the serve phase: its first requests (each
# round replays every active history, so it is the slower engine).
SLOT_REQUESTS = 8
GAMMA = 4  # draft proposals per verify round (bench.py:1666)
# K5 at the decode model's caches: a 64-token prompt reaches 128 slots
# after 64 steps and 256 after 192 (generate_int8kv), 261 has a partial
# last tile, 512 is the model's max_seq_len.
K5_LENGTHS = (128, 256, 261, 512)
K5_TIMED_L = 256  # timed, with all slots valid: a 192-step call's last step
# K5 against its plain version, as K2: both compute in f32 from the same
# int8 values and sum in other orders; bf16 outputs may land one bf16 step
# apart.
K5_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-5)}
# generate_int8kv and speculative: bench.py:481-483's batch and prompt
# width and its two-point step counts.
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 8, 64, (64, 192)


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


SM90_KERNEL = re.compile(r"flash_(fwd|dq|dkv)_sm90_kernelILi(\d+)E")
QUANT_KERNEL = re.compile(
    r"quant_matmul_sm90_kernelILi([48])E(13__nv_bfloat16|f)Lb([01])ELb([01])E")
# The tensor-core kernels the build must hold: 3 flash roles x 3 head dims,
# and the quantized matmul's format (int8: K1/K1e, int4: K6/K6e) x x dtype
# x (dense, expert) x (TMA, plain loads).
SM90_KERNELS = 9 + 16


def _sm90_name(line: str):
    """The short name of a tensor-core kernel whose mangled name is in
    ``line``, else None."""
    found = SM90_KERNEL.search(line)
    if found:
        return f"flash_{found[1]}_sm90<{found[2]}>"
    found = QUANT_KERNEL.search(line)
    if found:
        return (f"int{found[1]}_sm90<{'bf16' if found[2] != 'f' else 'f32'}, "
                f"{('dense', 'expert')[int(found[3])]}, "
                f"{('ldg', 'tma')[int(found[4])]}>")
    return None


# The decode-attention kernels, per q dtype: K2 with the head dim and
# block of 64 compiled in and general (0, 0), K5.
DECODE_KERNEL = re.compile(
    r"(paged|decode)_attention_kernelI(13__nv_bfloat16|f)((?:Li\d+E)*)E")
DECODE_KERNELS = 6


def _decode_name(line: str):
    found = DECODE_KERNEL.search(line)
    if found:
        consts = "".join(f", {c}" for c in re.findall(r"Li(\d+)E", found[3]))
        return (f"{found[1]}_attention<"
                f"{'bf16' if found[2] != 'f' else 'f32'}{consts}>")
    return None


def _ptxas_report(log: str, namer) -> dict:
    """Per kernel that ``namer`` names: registers and spill bytes from the
    build's ``-Xptxas -v`` lines, and whether ptxas serialized its wgmmas
    (C7520, named with the function)."""
    report, name = {}, None
    for line in log.splitlines():
        found = namer(line)
        if found and "C7520" in line:
            report.setdefault(found, {})["serialized"] = True
        elif found and "Compiling entry function" in line:
            name = found
            report.setdefault(name, {})
        elif name and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            report[name].update({f"spill_{k}": int(v) for v, k in nums})
        elif name and "registers" in line:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            name = None
    return report


def _sm90_report(log: str, sass: str) -> dict:
    """Per tensor-core kernel (bf16 flash, int8, int4): the ptxas report
    and its HGMMA (wgmma) instructions from ``cuobjdump -sass`` of the
    library."""
    report = {k: {"hgmma": 0, **v}
              for k, v in _ptxas_report(log, _sm90_name).items()}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _sm90_name(line)
            if name:
                report.setdefault(name, {"hgmma": 0})
        elif name and "HGMMA" in line:
            report[name]["hgmma"] += 1
    return report


def phase_build(kernels) -> None:
    """Builds every kernel (``-Xptxas -v``, shown on stderr) and checks that
    each bf16 flash kernel and each int8 and int4 instantiation computes on
    the tensor cores (HGMMA in its SASS), that no quantized instantiation
    spills or has its wgmmas serialized, and that kernels.quant_smem_bytes
    mirrors the CUDA layout; prints the registers and spills of the six
    decode-attention kernels, none of which may spill (their 64-register
    budget keeps eight CTAs on an SM)."""
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        path = kernels.build(verbose=True)
    print(log.getvalue(), file=sys.stderr, flush=True)
    seconds = round(time.perf_counter() - t0, 3)
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    sm90 = _sm90_report(log.getvalue(), sass)
    smem = {bits: (kernels.quant_smem_bytes(bits),
                   kernels.lib().tpubc_quant_smem_bytes(bits))
            for bits in (4, 8)}
    decode = _ptxas_report(log.getvalue(), _decode_name)
    emit({"phase": "build", "seconds": seconds, "library": str(path.name),
          "sm90": sm90, "quant_smem_bytes": smem, "decode_attention": decode})
    quant = [r for name, r in sm90.items() if name.startswith("int")]
    if len(decode) != DECODE_KERNELS or any(
            "registers" not in r or r.get("spill_stores")
            or r.get("spill_loads") for r in decode.values()):
        raise SystemExit(f"build: the decode-attention kernels: {decode}")
    if (len(sm90) != SM90_KERNELS
            or any(r["hgmma"] == 0 for r in sm90.values())
            or any(r.get("spill_stores", 0) or r.get("spill_loads", 0)
                   or r.get("serialized") for r in quant)
            or any(mine != theirs for mine, theirs in smem.values())):
        raise SystemExit(f"build: the tensor-core kernels: {sm90}; "
                         f"quant smem (Python, CUDA): {smem}")


def phase_k1(torch, kernels, quant, timer, device) -> dict:
    """K1 at every (K, N) of the decode model and a K tail; each row shows
    the split and CTAs of its plan. Then the split sweep."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cases = [(name, k, n, t) for name, (k, n) in K1_SHAPES.items()
             for t in (1, 8, 64)]
    cases += [("tail", 1000, 1024, t) for t in (5, 8)]
    sms = kernels.sm_count(device)
    rows = []
    for name, k, n, t in cases:
        w = torch.randn(k, n, generator=gen, device=device) / math.sqrt(k)
        qw = quant.quantize_weight(w)
        w_bf16 = quant.dequantize_weight(qw).to(torch.bfloat16)
        plan = kernels.int8_plan(1, k, n, sms)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(t, k, generator=gen, device=device).to(dtype)
            rows.append(_matmul_case(
                torch, timer, lambda x: kernels.int8_matmul(x, qw.q, qw.s),
                lambda x: quant.int8_matmul_plain(x, qw.q, qw.s),
                lambda x: torch.matmul(x.to(torch.bfloat16), w_bf16), x,
                quant.weight_stream_bytes(qw),
                {"shape": name, "K": k, "N": n, "T": t, "split": plan.split,
                 "ctas": plan.ctas}, INVARIANT_T["dense"]))
        del w, qw, w_bf16
    out = _matmul_phase("k1", rows)
    out["split_sweep"] = _split_sweep(torch, kernels, quant, timer, device, 8)
    return out


def _k2_inputs(torch, decode, device, hk: int, gen, lengths=K2_LENGTHS,
               h: int = 16, d: int = 64, bs: int = 64):
    """B=8 rows of ``lengths`` (ragged by default) over a pool of blocks of
    ``bs`` positions, block 0 the null block: at the decode model's H=16,
    D=64, bs=64, a table of nb=8 blocks over 65; row 7's first block
    aliases row 4's, and every position no row may read holds int8
    extremes with NaN scales."""
    blocks = [-(-length // bs) for length in lengths]
    b, nb, n = len(lengths), max(8, *blocks), max(65, 1 + sum(blocks))
    lengths = torch.tensor(lengths, dtype=torch.int32)
    tables = torch.zeros(b, nb, dtype=torch.int32)
    nxt = 1
    for r, length in enumerate(lengths.tolist()):
        for j in range(-(-length // bs)):
            tables[r, j] = nxt
            nxt += 1
    tables[7, 0] = tables[4, 0]
    readable = torch.zeros(n, bs, dtype=torch.bool)
    for r, length in enumerate(lengths.tolist()):
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


# K2 and K5 against their plain versions: both compute in f32 from the same
# int8 values and sum in other orders; bf16 outputs may land one bf16 step
# apart.
K2_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-5)}
# The full-length rows: every row of the batch at the decode model's
# max_seq_len.
FULL_LENGTHS = (512,) * 8
# The splits the sweeps launch beside the plan's: ranks of the cluster.
DECODE_SWEEP_RANKS = (1, 2, 4, 8)
# Geometries off the decode model's, for the body's other branches (lanes a
# position d / 16, lanes a softmax row from the chunk): D 128 at blocks of
# 16 with a group of 4 (8 lanes a position, 4 a row), D 16 at blocks of 32
# with a group of 8 (one lane a position, 8 a row).
K2_OTHER = ({"H": 16, "Hk": 4, "D": 128, "bs": 16},
            {"H": 16, "Hk": 2, "D": 16, "bs": 32})
# K5's: D 576 with a group of 4 (a warp a position, each lane taking every
# 32nd 16-byte segment, past one segment a lane), D 32 with a group of 2
# (2 lanes a position); both at L=261, five chunks, the last partial.
K5_OTHER = ({"H": 8, "Hk": 2, "D": 576, "L": 261},
            {"H": 16, "Hk": 8, "D": 32, "L": 261})


def _plan_dict(plan) -> dict:
    return {"chunk": plan.chunk, "ranks": plan.ranks}


def _decode_sweep(torch, kernels, timer, launch, want, plan, hk: int,
                  g: int, d: int, tol: tuple) -> tuple:
    """``launch(plan)`` (K2 or K5 on one case) with every split of
    DECODE_SWEEP_RANKS the kernel takes: each held to the plain version
    ``want`` and bitwise to the plan's split, each timed. Returns ({ranks:
    ms}, the splits that failed)."""
    base = launch(plan)
    ms, failed = {}, []
    for ranks in DECODE_SWEEP_RANKS:
        split = plan._replace(ranks=ranks)
        if not kernels.decode_split_ok(hk, g, d, split):
            continue
        got = launch(split)
        torch.cuda.synchronize()
        if not (torch.allclose(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1]) and torch.equal(got, base)):
            failed.append(_plan_dict(split))
        ms[str(ranks)] = timer(lambda: launch(split))
    return ms, failed


def phase_k2(torch, kernels, decode, decode_attention, timer, device) -> dict:
    """K2 against its plain version at the serving shape (B=8, H=16, D=64,
    bs=64, nb=8) with Hk 16 and 4, q in bf16 and f32, over ragged lengths
    (K2_LENGTHS) and, in bf16, a full-length batch (FULL_LENGTHS), then at
    the geometries of K2_OTHER over the ragged lengths: garbage and NaN
    scales wherever no row may read, an aliased table; widening the table
    must not change a bit, nor launching each row alone. Each row shows its
    plan and is timed beside SDPA; then, in bf16, every split of the sweep,
    held to the plain version and bitwise to the plan's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows, failures, max_err, sweeps = [], [], 0.0, {}
    for bs, d, g in ((64, 64, 1), (64, 64, 4),
                     *((o["bs"], o["D"], o["H"] // o["Hk"])
                       for o in K2_OTHER)):
        # The wrapper's smem rule is the kernel's own layout.
        if (kernels.lib().tpubc_paged_attention_smem_bytes(bs, d, g)
                != kernels.paged_attention_smem_bytes(bs, d, g)):
            raise SystemExit(f"k2: smem layout mismatch at bs {bs}, D {d}, "
                             f"group {g}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    model = {"H": 16, "D": 64, "bs": 64}
    cases = [(model | {"Hk": hk}, dtype, "ragged") for hk in (16, 4)
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(model | {"Hk": hk}, torch.bfloat16, "full") for hk in (16, 4)]
    cases += [(o, dtype, "ragged") for o in K2_OTHER
              for dtype in (torch.bfloat16, torch.float32)]
    inputs = {}
    for geom, dtype, name in cases:
        hk = geom["Hk"]
        key = (name, *sorted(geom.items()))
        if key not in inputs:
            inputs[key] = _k2_inputs(
                torch, decode, device, hk, gen,
                K2_LENGTHS if name == "ragged" else FULL_LENGTHS,
                geom["H"], geom["D"], geom["bs"])
        q32, kq, ks, vq, vs, bt, lengths = inputs[key]
        b, h, d = q32.shape
        bs = kq.shape[1]
        g = h // hk
        q = q32.to(dtype)
        args = (kq, ks, vq, vs)
        plan = kernels.paged_plan(bs, hk, g, d)
        got = kernels.paged_attention(q, *args, bt, lengths)
        want = decode_attention.paged_decode_attention_int8_plain(
            q, *args, bt, lengths)
        wide = torch.cat([bt, torch.zeros_like(bt)], dim=1)
        got_wide = kernels.paged_attention(q, *args, wide, lengths)
        alone = torch.cat([kernels.paged_attention(
            q[r:r + 1].contiguous(), *args, bt[r:r + 1].contiguous(),
            lengths[r:r + 1].contiguous()) for r in range(b)])
        torch.cuda.synchronize()
        rtol, atol = K2_TOL[str(dtype).removeprefix("torch.")]
        finite = bool(torch.isfinite(got.float()).all())
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        close = finite and torch.allclose(got.float(), want.float(),
                                          rtol=rtol, atol=atol)
        # The yardstick: SDPA over the window gathered and dequantized
        # beforehand (masked to each row's length).
        L = bt.shape[1] * bs
        kd = (kq[bt.long()].float() * ks[bt.long()][..., None]).nan_to_num(0)
        vd = (vq[bt.long()].float() * vs[bt.long()][..., None]).nan_to_num(0)
        kd = kd.reshape(b, L, hk, d).repeat_interleave(g, 2).transpose(1, 2)
        vd = vd.reshape(b, L, hk, d).repeat_interleave(g, 2).transpose(1, 2)
        kd, vd = kd.to(dtype).contiguous(), vd.to(dtype).contiguous()
        mask = (torch.arange(L, device=device)[None, :]
                < lengths[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        total = int(lengths.sum())
        bound_ms, bound_by = bound(
            total * hk * (2 * d + 8) + 2 * b * h * d * q.element_size(),
            4 * total * h * d, F32_FLOPS)
        row = {"Hk": hk, "q": str(dtype).removeprefix("torch."),
               "lengths_name": name, "B": b, "H": h, "D": d, "bs": bs,
               "nb": bt.shape[1], "lengths": lengths.tolist(),
               "plan": _plan_dict(plan), "max_abs_err": err, "close": close,
               "width_invariant": bool(torch.equal(got, got_wide)),
               "batch_invariant": bool(torch.equal(alone, got)),
               "kernel_ms": timer(lambda: kernels.paged_attention(
                   q, *args, bt, lengths)),
               "plain_ms": timer(
                   lambda: decode_attention.paged_decode_attention_int8_plain(
                       q, *args, bt, lengths)),
               "library_ms": timer(lambda: sdpa(qs, kd, vd, attn_mask=mask)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        if not (close and row["width_invariant"] and row["batch_invariant"]):
            failures.append(row)
        if dtype == torch.bfloat16:
            ms, failed = _decode_sweep(
                torch, kernels, timer, lambda split: kernels.paged_attention(
                    q, *args, bt, lengths, plan=split), want, plan, hk, g, d,
                (rtol, atol))
            key = f"Hk{hk}_{name}" + (
                "" if (d, bs) == (64, 64) else f"_D{d}_bs{bs}")
            sweeps[key] = {"plan": _plan_dict(plan), "ms": ms,
                           "best": min(ms, key=ms.get)}
            failures += [{"sweep": key, "split": s} for s in failed]
    emit({"phase": "k2", "tolerance": K2_TOL, "max_abs_err": max_err,
          "rows": rows})
    emit({"phase": "k2_split_sweep", "sweep": sweeps})
    if failures:
        raise SystemExit(f"k2 failed: {failures}")
    return {"rows": rows, "max_abs_err": max_err, "split_sweep": sweeps}


def _k5_masks(torch, length: int, device) -> dict:
    """Validity rows for one cache length: the frontier of a decode step
    three quarters in, all slots (the last step of a call), and at
    K5_TIMED_L a mask with holes (slot 0 and the last slot valid, a masked run
    across a chunk boundary)."""
    cols = torch.arange(length, device=device)
    masks = {"prefix": cols <= (3 * length) // 4, "full": cols < length}
    if length == K5_TIMED_L:
        gen = torch.Generator(device=device)
        gen.manual_seed(6)
        holes = torch.rand(length, generator=gen, device=device) < 0.6
        holes[0] = holes[-1] = True
        holes[100:160] = False
        masks["holes"] = holes
    return masks


# K5's timed rows (all slots valid, bf16): the last step of a 192-step
# generate and the decode model's max_seq_len (the full-length row).
K5_TIMED = (K5_TIMED_L, 512)


def phase_k5(torch, kernels, decode, decode_attention, timer, device) -> dict:
    """K5 at the decode model's caches (B=8, H=16, D=64, Hk 16 and 4,
    K5_LENGTHS), then at the geometries of K5_OTHER; q in bf16 and f32,
    prefix, full and holed masks: garbage and NaN scales at masked
    positions must change no bit, nor launching each row alone. Each row
    shows its plan; the full-mask bf16 rows at K5_TIMED, and of K5_OTHER,
    are timed beside SDPA, and swept over every split (held to the plain
    version and bitwise to the plan's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    for d, g in ((64, 1), (64, 4), *((o["D"], o["H"] // o["Hk"])
                                     for o in K5_OTHER)):
        # The wrapper's smem rule is the kernel's own layout.
        if (kernels.lib().tpubc_decode_attention_smem_bytes(d, g)
                != kernels.decode_attention_smem_bytes(d, g)):
            raise SystemExit(f"k5: smem layout mismatch at D {d}, group {g}")
    b = 8
    rows, failures, max_err, sweeps = [], [], 0.0, {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(16, hk, 64, K5_LENGTHS) for hk in (16, 4)]
    cases += [(o["H"], o["Hk"], o["D"], (o["L"],)) for o in K5_OTHER]
    for h, hk, d, lengths in cases:
        g = h // hk
        for length in lengths:
            kq, ks = decode._quantize_kv(torch.randn(
                b, length, hk, d, generator=gen, device=device))
            vq, vs = decode._quantize_kv(torch.randn(
                b, length, hk, d, generator=gen, device=device))
            q32 = torch.randn(b, h, d, generator=gen, device=device)
            plan = kernels.decode_plan(length, hk, g, d)
            for mask_name, valid in _k5_masks(torch, length, device).items():
                hidden = ~valid
                kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
                kq2[:, hidden] = 127
                vq2[:, hidden] = -128
                ks2[:, hidden] = float("nan")
                vs2[:, hidden] = float("nan")
                for dtype in (torch.bfloat16, torch.float32):
                    q = q32.to(dtype)
                    args = (kq, ks, vq, vs, valid)
                    got = kernels.decode_attention(q, *args)
                    want = decode_attention.decode_attention_int8_plain(
                        q, *args)
                    got_garbage = kernels.decode_attention(
                        q, kq2, ks2, vq2, vs2, valid)
                    alone = torch.cat([kernels.decode_attention(
                        q[r:r + 1].contiguous(), kq[r:r + 1].contiguous(),
                        ks[r:r + 1].contiguous(), vq[r:r + 1].contiguous(),
                        vs[r:r + 1].contiguous(), valid) for r in range(b)])
                    torch.cuda.synchronize()
                    name = str(dtype).removeprefix("torch.")
                    rtol, atol = K5_TOL[name]
                    err = (got.float() - want.float()).abs().max().item()
                    max_err = max(max_err, err)
                    close = bool(torch.isfinite(got.float()).all()) and (
                        torch.allclose(got.float(), want.float(), rtol=rtol,
                                       atol=atol))
                    row = {"Hk": hk, "L": length, "mask": mask_name,
                           "q": name, "B": b, "H": h, "D": d,
                           "valid": int(valid.sum()),
                           "plan": _plan_dict(plan), "max_abs_err": err,
                           "close": close,
                           "garbage_invariant": bool(torch.equal(
                               got_garbage, got)),
                           "batch_invariant": bool(torch.equal(alone, got))}
                    if mask_name == "full" and dtype == torch.bfloat16 and (
                            length in K5_TIMED or d != 64):
                        # The yardstick: SDPA over the cache dequantized to
                        # bf16 beforehand, with the boolean mask.
                        kd = (kq.float() * ks[..., None]).to(dtype)
                        vd = (vq.float() * vs[..., None]).to(dtype)
                        kd = kd.repeat_interleave(g, 2).transpose(1, 2)
                        vd = vd.repeat_interleave(g, 2).transpose(1, 2)
                        kd, vd = kd.contiguous(), vd.contiguous()
                        qs = q[:, :, None, :]
                        mask = valid[None, None, None, :]
                        n = int(valid.sum())
                        e = q.element_size()
                        bound_ms, bound_by = bound(
                            b * n * hk * (2 * d + 8) + 2 * b * h * d * e
                            + length, 4 * b * n * h * d, F32_FLOPS)
                        row.update({
                            "kernel_ms": timer(lambda: kernels.decode_attention(
                                q, *args)),
                            "plain_ms": timer(
                                lambda: decode_attention
                                .decode_attention_int8_plain(q, *args)),
                            "library_ms": timer(lambda: sdpa(
                                qs, kd, vd, attn_mask=mask)),
                            "bound_ms": bound_ms, "bound_by": bound_by})
                        ms, failed = _decode_sweep(
                            torch, kernels, timer,
                            lambda split: kernels.decode_attention(
                                q, *args, plan=split), want, plan, hk, g, d,
                            (rtol, atol))
                        key = f"Hk{hk}_L{length}" + (
                            "" if d == 64 else f"_D{d}")
                        sweeps[key] = {"plan": _plan_dict(plan), "ms": ms,
                                       "best": min(ms, key=ms.get)}
                        failures += [{"sweep": key, "split": s}
                                     for s in failed]
                    rows.append(row)
                    if not (close and row["garbage_invariant"]
                            and row["batch_invariant"]):
                        failures.append(row)
    emit({"phase": "k5", "tolerance": K5_TOL, "max_abs_err": max_err,
          "rows": rows})
    emit({"phase": "k5_split_sweep", "sweep": sweeps})
    if failures:
        raise SystemExit(f"k5 failed: {failures}")
    return {"rows": rows, "max_abs_err": max_err, "split_sweep": sweeps}


def _matmul_case(torch, timer, kernel, plain, library, x, weight_bytes: int,
                 meta: dict, invariant_t: tuple = (8,)) -> dict:
    """One quantized-matmul launch ``kernel(x)`` held to ``plain(x)``; at
    each T of ``invariant_t`` every row (of every expert) launched alone
    must equal its row of the batch bitwise. Timed beside the plain
    version and one PyTorch call (``library``) on the bf16-dequantized
    weight, with the bound of the weight, x and out bytes and 2 * K
    operations per output."""
    got = kernel(x)
    want = plain(x)
    torch.cuda.synchronize()
    dtype = str(x.dtype).removeprefix("torch.")
    rtol, atol = MATMUL_TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    close = bool(torch.isfinite(got.float()).all()) and torch.allclose(
        got.float(), want.float(), rtol=rtol, atol=atol)
    invariant = None
    if x.shape[-2] in invariant_t:
        alone = torch.cat([kernel(x[..., i:i + 1, :].contiguous())
                           for i in range(x.shape[-2])], dim=-2)
        invariant = bool(torch.equal(alone, got))
    e = x.element_size()
    bound_ms, bound_by = bound(weight_bytes + (x.numel() + got.numel()) * e,
                               2 * got.numel() * x.shape[-1], BF16_FLOPS)
    return {**meta, "x": dtype, "max_abs_err": err, "close": close,
            "batch_invariant": invariant,
            "kernel_ms": timer(lambda: kernel(x)),
            "plain_ms": timer(lambda: plain(x)),
            "library_ms": timer(lambda: library(x)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _matmul_phase(name: str, rows: list) -> dict:
    failures = [r for r in rows
                if not r["close"] or r["batch_invariant"] is False]
    max_err = max(r["max_abs_err"] for r in rows)
    emit({"phase": name, "tolerance": MATMUL_TOL, "max_abs_err": max_err,
          "rows": rows})
    if failures:
        raise SystemExit(f"{name} failed: {failures}")
    return {"rows": rows, "max_abs_err": max_err}


def phase_k1e(torch, kernels, quant, timer, device) -> dict:
    """K1e at the MoE decode model's expert stacks, and a ragged case (odd
    T, N not a multiple of 16: the plain-load path); each row shows the
    split and CTAs of its plan."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    cases = [(name, MOE_MODEL["num_experts"], k, n, t)
             for name, (k, n) in MOE_SHAPES.items() for t in EXPERT_T]
    cases.append(("ragged", 3, 1000, 1001, 5))
    sms = kernels.sm_count(device)
    rows = []
    for name, e, k, n, t in cases:
        w = torch.randn(e, k, n, generator=gen, device=device) / math.sqrt(k)
        qw = quant.quantize_expert_weight(w)
        w_bf16 = quant.dequantize_weight(qw).to(torch.bfloat16)
        plan = kernels.int8_plan(e, k, n, sms)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(e, t, k, generator=gen, device=device).to(dtype)
            rows.append(_matmul_case(
                torch, timer,
                lambda x: kernels.int8_expert_matmul(x, qw.q, qw.s),
                lambda x: quant.int8_expert_matmul_plain(x, qw.q, qw.s),
                lambda x: torch.bmm(x.to(torch.bfloat16), w_bf16), x,
                quant.weight_stream_bytes(qw),
                {"shape": name, "E": e, "K": k, "N": n, "T": t,
                 "split": plan.split, "ctas": plan.ctas},
                INVARIANT_T["expert"]))
        del w, qw, w_bf16
    return _matmul_phase("k1e", rows)


# T at which the quantized matmuls' dense (K1, K6) and expert (K1e, K6e)
# rows must be bitwise batch invariant: a decode step, and the serve
# phases' prefill chunks (64 tokens of one row; 32 per expert at capacity
# 32).
INVARIANT_T = {"dense": (8, 64), "expert": (8, 32)}


def phase_k6(torch, kernels, quant, timer, device) -> dict:
    """K6 at every (K, N) of the decode model with group 64 (lm_head as
    head="int4" stores it), a K tail and an odd small group; K6e at the
    two expert stacks. Each row shows the split and CTAs of its plan."""
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    cases = [(name, 0, k, n, INT4_GROUP, t)
             for name, (k, n) in K1_SHAPES.items() for t in (1, 8, 64)]
    cases += [("tail", 0, 1000, 1024, INT4_GROUP, t) for t in (5, 8)]
    cases += [("group6", 0, 1024, 1000, 6, t) for t in (5, 8)]
    cases += [(name, MOE_MODEL["num_experts"], k, n, INT4_GROUP, t)
              for name, (k, n) in MOE_SHAPES.items() for t in (1, 8, 32)]
    sms = kernels.sm_count(device)
    rows = []
    for name, e, k, n, group, t in cases:
        lead = (e,) if e else ()
        w = torch.randn(*lead, k, n, generator=gen, device=device) / math.sqrt(k)
        if e:
            qw = quant.quantize_expert_weight4(w, group=group)
            kernel, plain = kernels.int4_expert_matmul, quant.int4_expert_matmul_plain
            library = torch.bmm
        else:
            qw = quant.quantize_weight4(w, group=group)
            kernel, plain = kernels.int4_matmul, quant.int4_matmul_plain
            library = torch.matmul
        plan = kernels.int4_plan(e or 1, qw.q.shape[-2] * 2, n, group, sms)
        w_bf16 = quant.dequantize_weight4(qw).to(torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(*lead, t, k, generator=gen, device=device).to(dtype)
            rows.append(_matmul_case(
                torch, timer,
                lambda x: kernel(x, qw.q, qw.s, group, k),
                lambda x: plain(x, qw.q, qw.s, group, k),
                lambda x: library(x.to(torch.bfloat16), w_bf16), x,
                quant.weight_stream_bytes(qw),
                {"shape": name, "E": e or None, "K": k, "N": n, "group": group,
                 "T": t, "split": plan.split, "ctas": plan.ctas},
                INVARIANT_T["expert" if e else "dense"]))
        del w, qw, w_bf16
    out = _matmul_phase("k6", rows)
    out["split_sweep"] = _split_sweep(torch, kernels, quant, timer, device, 4)
    return out


# Splits timed at every decode shape (T = 8, bf16), and the plan's.
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def _split_sweep(torch, kernels, quant, timer, device, bits: int) -> dict:
    """K1/K1e (bits 8) or K6/K6e (bits 4, group 64) at each decode shape (T
    = 8, bf16 x) launched through the C entry with each split of
    SWEEP_SPLITS the shape takes: every result held to the plain version
    (MATMUL_TOL), each timed; the plan's split beside them. The evidence
    behind kernels.INT8_CTAS_PER_SM / INT4_CTAS_PER_SM."""
    gen = torch.Generator(device=device)
    gen.manual_seed(6 if bits == 4 else 7)
    sms = kernels.sm_count(device)
    rtol, atol = MATMUL_TOL["bfloat16"]
    phase = "k6_split_sweep" if bits == 4 else "k1_split_sweep"
    sweep, failures = {}, []
    for name, (k, n) in {**K1_SHAPES, **MOE_SHAPES}.items():
        e = MOE_MODEL["num_experts"] if name in MOE_SHAPES else 1
        w = torch.randn(e, k, n, generator=gen, device=device) / math.sqrt(k)
        x = torch.randn(e, 8, k, generator=gen, device=device).to(
            torch.bfloat16)
        if bits == 4:
            qw = quant.quantize_expert_weight4(w, group=INT4_GROUP)
            want = quant.int4_expert_matmul_plain(x, qw.q, qw.s, INT4_GROUP, k)
            plan = kernels.int4_plan(e, k, n, INT4_GROUP, sms).split
            units = kernels.int4_units(k, INT4_GROUP)
        else:
            qw = quant.quantize_expert_weight(w)
            want = quant.int8_expert_matmul_plain(x, qw.q, qw.s)
            plan = kernels.int8_plan(e, k, n, sms).split
            units = kernels.int8_units(k)
        out = torch.empty_like(want)

        def launch(split):
            ptrs = (x.data_ptr(), qw.q.data_ptr(), qw.s.data_ptr(),
                    out.data_ptr(), e, 8, k)
            if bits == 4:
                rc = kernels.lib().tpubc_int4_matmul(
                    *ptrs, k // 2, n, INT4_GROUP, 1, split, kernels._stream())
            else:
                rc = kernels.lib().tpubc_int8_matmul(
                    *ptrs, n, 1, split, kernels._stream())
            if rc:
                raise SystemExit(f"{phase}: {name} split {split}: CUDA "
                                 f"error {rc}")

        ms = {}
        for split in sorted({*SWEEP_SPLITS, plan}):
            if split > units:
                continue
            launch(split)
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), want.float(), rtol=rtol,
                                  atol=atol):
                failures.append((name, split))
            ms[split] = timer(lambda: launch(split))
        sweep[name] = {"plan": plan, "ms": ms,
                       "best": min(ms, key=ms.get)}
        del w, qw
    emit({"phase": phase, "sweep": sweep})
    if failures:
        raise SystemExit(f"{phase}: wrong results at {failures}")
    return sweep


def _serve_requests(serving, vocab: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [serving.Request(
        rid=i, tokens=rng.integers(1, vocab, int(rng.integers(16, 193)))
        .tolist(), max_new=int(rng.integers(8, 65))) for i in range(n)]


def _solo_streams(decode, params, cfg, reqs) -> dict:
    """Each request's solo greedy generate on the einsum path
    (kv_kernel=False) over a contiguous int8 cache: the oracle the
    serving engines are held to."""
    return {r.rid: decode.generate(params, [r.tokens], cfg, r.max_new,
                                   kv_quant=True,
                                   kv_kernel=False)[0].tolist()
            for r in reqs}


def _first_divergence(decode, params, cfg, prompt: list, got: list,
                      want: list):
    """(step, the oracle's top-2 logit margin there) of the first token
    where ``got`` leaves ``want``, or None when they are equal."""
    if got == want:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:  # one stream is a prefix of the other: never a near-tie
        return min(len(got), len(want)), float("inf")
    margin = decode.greedy_margins(params, prompt, want[:j + 1], cfg,
                                   kv_quant=True)[j]
    return j, margin


def _diverged(decode, params, cfg, reqs, done, solo: dict) -> list:
    """Requests whose stream differs from its solo greedy generate
    (``solo``), each with the solo run's top-2 logit margin at the first
    divergent step."""
    out = []
    for r in reqs:
        first = _first_divergence(decode, params, cfg, r.tokens,
                                  done[r.rid], solo[r.rid])
        if first is not None:
            out.append({"rid": r.rid, "step": first[0], "margin": first[1]})
    return out


# The device names of the quantized matmuls: one kernel, whose <bits, X,
# expert, tma> instantiations are K1 (<8, X, false, tma>), K1e (<8, X,
# true, tma>), K6 and K6e (<4, ...>).
K1_KERNEL = ("quant_matmul_sm90_kernel<8, ", ", false, ")
K1E_KERNEL = ("quant_matmul_sm90_kernel<8, ", ", true, ")
K6_KERNEL = ("quant_matmul_sm90_kernel<4, ", ", false, ")
K6E_KERNEL = ("quant_matmul_sm90_kernel<4, ", ", true, ")
# The launch counters (kernels.LAUNCHES) of the kernels each profile tag
# times: a tag whose kernel was launched in the profiled run must find
# device time under its names.
TAG_LAUNCHES = {"k1_ms": ("int8_matmul",), "k1e_ms": ("int8_expert_matmul",),
                "k2_ms": ("paged_attention",), "k5_ms": ("decode_attention",),
                "k6_ms": ("int4_matmul",), "k6e_ms": ("int4_expert_matmul",),
                "flash_fwd_ms": ("flash_fwd",), "flash_dq_ms": ("flash_dq",),
                "flash_dkv_ms": ("flash_dkv",)}


def _profile(torch, run, tags: dict) -> dict:
    """``run()`` once under torch.profiler (device activity only: a full
    serve records some 600k kernels, which takes the profiler minutes to
    fold): device busy time (the sum of kernel times, one stream) against
    the run's wall time, the device time of the kernels named in ``tags``
    ({key: kernel-name fragment, or a tuple of fragments that must all be
    in the name, or a list of those, summed}), and the kernels that take
    most. A tagged kernel that was launched in the run (TAG_LAUNCHES) but
    shows no device time fails the phase: its name no longer matches.
    Profiling slows the host, so the idle share is an upper bound for the
    unprofiled run."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_bootstrap_torch.workload import kernels

    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in gpu) / 1e3
    top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:8]

    def share(tag):
        alts = tag if isinstance(tag, list) else [tag]
        alts = [(a,) if isinstance(a, str) else a for a in alts]
        return sum(e.self_device_time_total for e in gpu
                   if any(all(f in e.key for f in frags)
                          for frags in alts)) / 1e3

    shares = {key: share(tag) for key, tag in tags.items()}
    unnamed = [key for key in tags if shares[key] == 0
               and any(launched[n] for n in TAG_LAUNCHES[key])]
    if unnamed:
        raise SystemExit(f"profile: {unnamed} launched in the profiled run "
                         f"but no device time under {[tags[k] for k in unnamed]}"
                         f": a kernel was renamed")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, **shares,
            "kernel_launches": sum(e.count for e in gpu),
            "top": [{"kernel": e.key[:80], "ms": e.self_device_time_total
                     / 1e3, "count": e.count} for e in top]}


# The flash prefill check: a batch of equal-length prompts, as generate's
# prefill_flash takes them (no per-row pads), on the bf16 KV cache so that
# the two prefills differ only in how they attend.
PREFILL_BATCH, PREFILL_LEN, PREFILL_NEW = 4, 448, 16


def _prefill_flash(torch, kernels, decode, params, cfg) -> dict:
    """generate(prefill_flash=True), whose prompt attention runs through K3
    (one launch per layer), against generate() with the einsum prefill:
    the streams must be equal except at a near-tie (NEAR_TIE in bf16: the
    einsum core rounds scores and probabilities to bf16, K3 keeps f32)."""
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(
        1, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN)))
    kernels.reset_launches()
    got = decode.generate(params, prompt, cfg, PREFILL_NEW,
                          prefill_flash=True)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["flash_fwd"]
    want = decode.generate(params, prompt, cfg, PREFILL_NEW)
    diverged = []
    for r in range(PREFILL_BATCH):
        g, w = got[r].tolist(), want[r].tolist()
        if g != w:
            j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
            margin = decode.greedy_margins(params, prompt[r].tolist(),
                                           w[:j + 1], cfg)[j]
            diverged.append({"row": r, "step": j, "margin": margin})
    out = {"phase": "prefill_flash", "batch": PREFILL_BATCH,
           "prompt_len": PREFILL_LEN, "new": PREFILL_NEW,
           "flash_fwd_launches": launches,
           "finite_shape_ok": bool(got.shape == want.shape and (
               (got >= 0) & (got < cfg.vocab_size)).all()),
           "near_tie": NEAR_TIE["bfloat16"], "diverged": diverged}
    emit(out)
    bad = [d for d in diverged if d["margin"] >= NEAR_TIE["bfloat16"]]
    if bad or launches != cfg.num_layers or not out["finite_shape_ok"]:
        raise SystemExit(f"prefill_flash failed: bad={bad} "
                         f"launches={launches}")
    return out


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

    cfg = model.ModelConfig(**DECODE_MODEL, compute_dtype=torch.bfloat16)
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
    solo = _solo_streams(decode, params, cfg, reqs)
    diverged = _diverged(decode, params, cfg, reqs, done, solo)
    solo_s = time.perf_counter() - t1
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    done32 = serving.serve(params, cfg32, reqs, 8, **kw)
    diverged32 = _diverged(decode, params, cfg32, reqs, done32,
                           _solo_streams(decode, params, cfg32, reqs))
    profile = _profile(torch, lambda: serving.serve(
        params, cfg, reqs[:PROFILED_REQUESTS], 8, **kw),
        {"k1_ms": K1_KERNEL, "k2_ms": "paged_attention_kernel"})
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
    if (not shape_ok or bad or launches["int8_matmul"] < 1
            or launches["paged_attention"] < 1):
        raise SystemExit(f"serve failed: shape_ok={shape_ok} bad={bad} "
                         f"launches={launches}")
    result["slot"] = _slot_serve(torch, kernels, decode, serving, params, cfg,
                                 reqs[:SLOT_REQUESTS], solo)
    _prefill_flash(torch, kernels, decode, params, cfg)
    return result


def _slot_serve(torch, kernels, decode, serving, params, cfg, reqs,
                solo: dict) -> dict:
    """The replay-slot engine, serve(paged=False), on ``reqs`` at batch 8:
    plain rounds (generate over the replayed histories, K1 and the einsum
    attention of per-row masks), then speculative rounds drafted by the
    int8 model itself. Every stream held to solo generate (near-ties
    allowed); the speculative streams also compared with the plain ones
    (equal wherever the two paths agree bitwise)."""
    out, bad = {"phase": "serve_slot", "requests": len(reqs)}, []
    for mode, kw in (("plain", {}), ("speculative", {
            "draft_params": params, "draft_cfg": cfg, "gamma": GAMMA})):
        stats: dict = {}
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = serving.serve(params, cfg, reqs, 8, kv_quant=True,
                             paged=False, stats=stats, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(v) for v in done.values())
        diverged = _diverged(decode, params, cfg, reqs, done, solo)
        bad += [d for d in diverged if d["margin"] >= NEAR_TIE["bfloat16"]]
        out[mode] = {"tokens": tokens, "wall_s": wall,
                     "tokens_per_s": tokens / wall,
                     "launches": dict(kernels.LAUNCHES),
                     "stats": {k: v for k, v in stats.items()
                               if k != "scheduler"},
                     "diverged": diverged}
        out[mode]["done"] = done
        if mode == "speculative" and stats["verify_rounds"]:
            out[mode]["committed_per_round"] = (stats["committed_tokens"]
                                                / stats["verify_rounds"])
    out["speculative_equals_plain"] = (out["speculative"].pop("done")
                                       == out["plain"].pop("done"))
    emit(out)
    complete = all(out[m]["tokens"] == sum(r.max_new for r in reqs)
                   for m in ("plain", "speculative"))
    if bad or not complete or out["plain"]["launches"]["int8_matmul"] < 1:
        raise SystemExit(f"serve_slot failed: bad={bad} complete={complete}")
    return out


SERVE_KW = dict(paged=True, kv_quant=True, prefix_cache=False,
                overcommit=False)


def _timed_serve(torch, kernels, serving, params, cfg, reqs) -> dict:
    """One warm-up serve of two other requests, then ``reqs`` through
    serve() at batch 8 with the launch counts set to 0 just before and
    read just after; streams checked complete and in the vocabulary."""
    serving.serve(params, cfg, _serve_requests(serving, cfg.vocab_size, 2,
                                               seed=1), 8, **SERVE_KW)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = serving.serve(params, cfg, reqs, 8, **SERVE_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    tokens = sum(len(v) for v in done.values())
    shape_ok = (sorted(done) == sorted(r.rid for r in reqs) and all(
        len(done[r.rid]) == r.max_new
        and all(0 <= t < cfg.vocab_size for t in done[r.rid])
        for r in reqs))
    return {"done": done, "requests": len(reqs), "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "launches": launches, "shape_ok": shape_ok}


def _serve_profile(torch, serving, params, cfg, reqs, tags: dict) -> dict:
    """_profile of serving the first PROFILED_REQUESTS requests, with the
    device kernels per generated token."""
    head = reqs[:PROFILED_REQUESTS]
    out = _profile(torch, lambda: serving.serve(params, cfg, head, 8,
                                                **SERVE_KW), tags)
    out["kernels_per_token"] = (out["kernel_launches"]
                                / sum(r.max_new for r in head))
    return out


def _path_launches_ok(launches: dict, path: tuple) -> bool:
    return all(launches[k] > 0 for k in path)


def phase_serve_int4(torch, kernels, device) -> dict:
    """The serve phase's workload with int4 weights (quantize_params4,
    group 64, int8 head, the reference's WORKLOAD_QUANT=int4): every block
    projection on K6, the head on K1, attention on K2. Every stream is
    held to the port's solo greedy generate, which runs the same K6
    launches and differs only in how it attends, in bf16 and again in
    f32: a divergence is accepted only at a near-tie (NEAR_TIE)."""
    import dataclasses

    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**DECODE_MODEL, compute_dtype=torch.bfloat16)
    params = quant.quantize_params4(
        model.init_params(cfg, seed=0, device=device), group=INT4_GROUP,
        head="int8")
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    run = _timed_serve(torch, kernels, serving, params, cfg, reqs)
    path = ("int4_matmul", "int8_matmul", "paged_attention")
    diverged = _diverged(decode, params, cfg, reqs, run["done"],
                         _solo_streams(decode, params, cfg, reqs))
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    done32 = serving.serve(params, cfg32, reqs, 8, **SERVE_KW)
    diverged32 = _diverged(decode, params, cfg32, reqs, done32,
                           _solo_streams(decode, params, cfg32, reqs))
    profile = _serve_profile(torch, serving, params, cfg, reqs, {
        "k6_ms": K6_KERNEL, "k1_ms": K1_KERNEL,
        "k2_ms": "paged_attention_kernel"})
    result = {"phase": "serve_int4", "group": INT4_GROUP, "head": "int8",
              **{k: v for k, v in run.items() if k != "done"},
              "decode_stream_bytes": quant.decode_stream_bytes(params),
              "near_tie": NEAR_TIE,
              "diverged": {"bfloat16": diverged, "float32": diverged32},
              "profile": profile}
    emit(result)
    bad = [d for dt in NEAR_TIE for d in result["diverged"][dt]
           if d["margin"] >= NEAR_TIE[dt]]
    if not run["shape_ok"] or bad or not _path_launches_ok(run["launches"],
                                                           path):
        raise SystemExit(f"serve_int4 failed: shape_ok={run['shape_ok']} "
                         f"bad={bad} launches={run['launches']}")
    return result


def _watched_serve(torch, kernels, serving, params, cfg, reqs) -> tuple:
    """serve() once more, recording on the device whether every decode
    step's logits were all finite, and the shape of every expert launch."""
    finite = torch.ones((), dtype=torch.bool, device=params["embed"].device)
    shapes = set()
    step = serving.paged_decode_step
    k8, k4 = kernels.int8_expert_matmul, kernels.int4_expert_matmul

    def watched_step(*args, **kw):
        logits, pools = step(*args, **kw)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, pools

    def watch(launch):
        def wrapped(x, *rest):
            shapes.add(tuple(x.shape))
            return launch(x, *rest)
        return wrapped

    serving.paged_decode_step = watched_step
    kernels.int8_expert_matmul, kernels.int4_expert_matmul = watch(k8), watch(k4)
    try:
        done = serving.serve(params, cfg, reqs, 8, **SERVE_KW)
    finally:
        serving.paged_decode_step = step
        kernels.int8_expert_matmul, kernels.int4_expert_matmul = k8, k4
    return done, bool(finite), sorted(shapes)


def phase_serve_moe(torch, kernels, device) -> dict:
    """The MoE decode model (the decode model's widths, 8 experts, top-2,
    capacity factor 2, random weights from a seed) served with int8 and
    with int4 weights on MOE_REQUESTS of the serve phase's requests. The
    reference's MoE streams are not its solo generate's (capacity is
    contested over each prefill chunk), so that is counted on the first
    MOE_SOLO, not held;
    held: every stream complete, every decode logit finite, a second serve
    bitwise the same, and every kernel of the path launched."""
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**DECODE_MODEL, **MOE_MODEL,
                            compute_dtype=torch.bfloat16)
    params = model.init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for b in params["blocks"] for p in b.values())
    n_params += params["embed"].numel() + params["final_norm"].numel()
    formats = {"int8": (quant.quantize_params(params), (
                   "int8_matmul", "int8_expert_matmul", "paged_attention")),
               "int4": (quant.quantize_params4(
                   params, group=INT4_GROUP, head="int8"), (
                   "int4_matmul", "int4_expert_matmul", "int8_matmul",
                   "paged_attention"))}
    del params
    torch.cuda.empty_cache()
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)[:MOE_REQUESTS]
    out, failed = {"phase": "serve_moe", "params": n_params}, []
    for fmt, (qparams, path) in formats.items():
        run = _timed_serve(torch, kernels, serving, qparams, cfg, reqs)
        again, finite, shapes = _watched_serve(torch, kernels, serving,
                                               qparams, cfg, reqs)
        solo = _solo_streams(decode, qparams, cfg, reqs[:MOE_SOLO])
        solo_differ = sum(solo[r.rid] != run["done"][r.rid]
                          for r in reqs[:MOE_SOLO])
        profile = _serve_profile(torch, serving, qparams, cfg, reqs, {
            "k1_ms": K1_KERNEL, "k1e_ms": K1E_KERNEL, "k6_ms": K6_KERNEL,
            "k6e_ms": K6E_KERNEL, "k2_ms": "paged_attention_kernel"})
        profile["expert_share"] = ((profile["k1e_ms"] + profile["k6e_ms"])
                                   / profile["device_busy_ms"])
        deterministic = again == run["done"]
        out[fmt] = {**{k: v for k, v in run.items() if k != "done"},
                    "decode_stream_bytes": quant.decode_stream_bytes(qparams),
                    "logits_finite": finite, "deterministic": deterministic,
                    "expert_launch_shapes": shapes,
                    "differ_from_solo_generate": f"{solo_differ} of "
                                                 f"{MOE_SOLO}",
                    "profile": profile}
        if not (run["shape_ok"] and finite and deterministic
                and _path_launches_ok(run["launches"], path)):
            failed.append(fmt)
    emit(out)
    if failed:
        raise SystemExit(f"serve_moe failed for {failed}: "
                         f"{ {f: out[f] for f in failed} }")
    return out


def _gen_prompt(torch, cfg, device):
    """bench.py:483's decode prompt shape, (8, 64) tokens from a seed."""
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (GEN_BATCH, GEN_PROMPT)),
                           device=device)


def _timed(torch, kernels, fn) -> tuple:
    """fn() once with the launch counts set to 0 just before and read just
    after: (its output, host seconds ending in a synchronize, launches)."""
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def _row_divergences(decode, params, cfg, prompt, got, want) -> list:
    """Rows of ``got`` (B, steps) that leave ``want``, each with the
    oracle's top-2 margin at the first divergent step."""
    out = []
    for r in range(got.shape[0]):
        first = _first_divergence(decode, params, cfg, prompt[r].tolist(),
                                  got[r].tolist(), want[r].tolist())
        if first is not None:
            out.append({"row": r, "step": first[0], "margin": first[1]})
    return out


def phase_generate_int8kv(torch, kernels, device) -> dict:
    """bench.py:470-505 and :664 (decode_int8kv_tokens_per_sec): generate on
    the decode model at full width, int8 weights from seed 0, an int8 KV
    cache, prompts (8, 64), 64 and 192 steps. With kv_kernel AUTO every
    decode step of every layer attends through K5 ((steps - 1) x 8
    launches a call, held exactly); with kv_kernel=False the einsum path.
    Every stream of the kernel path is held to the einsum path's: equal,
    or the first divergence a near-tie. Tokens/s by the two-point rule
    (8 x 128 tokens over the time between the 64- and the 192-step call),
    after one warm-up pair; one profiled 64-step call of each path."""
    from tpu_bootstrap_torch.workload import decode, model, quant

    cfg = model.ModelConfig(**DECODE_MODEL, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    prompt = _gen_prompt(torch, cfg, device)
    paths, failed = {}, []
    for path, kv_kernel in (("kernel", None), ("einsum", False)):
        def run(steps, kv_kernel=kv_kernel):
            return decode.generate(params, prompt, cfg, steps, kv_quant=True,
                                   kv_kernel=kv_kernel)
        for steps in GEN_STEPS:  # warm-up pair
            run(steps)
        calls = {steps: _timed(torch, kernels, lambda: run(steps))
                 for steps in GEN_STEPS}
        d1, d2 = GEN_STEPS
        step_s = (calls[d2][1] - calls[d1][1]) / (d2 - d1)
        paths[path] = {
            "seconds": {str(st): c[1] for st, c in calls.items()},
            "step_ms": step_s * 1e3,
            "tokens_per_s": GEN_BATCH / step_s,
            "k5_launches": {str(st): c[2]["decode_attention"]
                            for st, c in calls.items()},
            "int8_matmul_launches": {str(st): c[2]["int8_matmul"]
                                     for st, c in calls.items()},
            "profile": _profile(torch, lambda: run(d1), {
                "k5_ms": "decode_attention_kernel",
                "k1_ms": K1_KERNEL}),
            "outputs": {st: c[0] for st, c in calls.items()}}
        paths[path]["profile"]["kernels_per_token"] = (
            paths[path]["profile"]["kernel_launches"] / (GEN_BATCH * d1))
        want = {st: (st - 1) * cfg.num_layers if path == "kernel" else 0
                for st in GEN_STEPS}
        if any(calls[st][2]["decode_attention"] != want[st]
               for st in GEN_STEPS):
            failed.append(f"{path} K5 launches {paths[path]['k5_launches']}"
                          f" != {want}")
    diverged = {str(st): _row_divergences(
        decode, params, cfg, prompt, paths["kernel"]["outputs"][st],
        paths["einsum"]["outputs"][st]) for st in GEN_STEPS}
    shape_ok = all(o.shape == (GEN_BATCH, st) and bool(
        ((o >= 0) & (o < cfg.vocab_size)).all())
        for p in paths.values() for st, o in p["outputs"].items())
    for p in paths.values():
        del p["outputs"]
    bad = [d for rows in diverged.values() for d in rows
           if d["margin"] >= NEAR_TIE["bfloat16"]]
    result = {"phase": "generate_int8kv", "batch": GEN_BATCH,
              "prompt": GEN_PROMPT, "steps": list(GEN_STEPS),
              **paths, "near_tie": NEAR_TIE["bfloat16"],
              "diverged": diverged, "shape_ok": shape_ok,
              "speedup": (paths["kernel"]["tokens_per_s"]
                          / paths["einsum"]["tokens_per_s"])}
    emit(result)
    if failed or bad or not shape_ok:
        raise SystemExit(f"generate_int8kv failed: {failed} bad={bad} "
                         f"shape_ok={shape_ok}")
    return result


def phase_speculative(torch, kernels, device) -> dict:
    """bench.py:1654-1680's self-speculation with kv_quant=True: the decode
    model's bf16 target (weights stored in bf16, bench.py:473-480) drafted
    by its own int8 copy, gamma 4, prompts (8, 64), 64 steps; the draft's
    single-query steps attend through K5. Streams held to the target's
    generate(kv_kernel=False): the verify chunk and the single-query steps
    reach torch.matmul and einsum at other shapes, which are not
    batch-invariant, so a divergence is allowed at a near-tie and counted.
    One warm-up call and one timed call of each."""
    from tpu_bootstrap_torch.workload import decode, model, quant, speculative

    cfg = model.ModelConfig(**DECODE_MODEL, compute_dtype=torch.bfloat16)
    master = model.init_params(cfg, seed=0, device=device)
    draft = quant.quantize_params(master)
    target = {"embed": master["embed"].bfloat16(),
              "final_norm": master["final_norm"].bfloat16(),
              "blocks": [{n: w.bfloat16() for n, w in b.items()}
                         for b in master["blocks"]]}
    del master
    prompt = _gen_prompt(torch, cfg, device)
    steps = GEN_STEPS[0]

    def spec():
        return speculative.speculative_generate(
            target, draft, prompt, cfg, cfg, steps, gamma=GAMMA,
            kv_quant=True, with_stats=True)

    def plain():
        return decode.generate(target, prompt, cfg, steps, kv_quant=True,
                               kv_kernel=False)

    spec()
    (got, stats), spec_s, launches = _timed(torch, kernels, spec)
    plain()
    want, plain_s, _ = _timed(torch, kernels, plain)
    diverged = _row_divergences(decode, target, cfg, prompt, got, want)
    bad = [d for d in diverged if d["margin"] >= NEAR_TIE["bfloat16"]]
    tokens = GEN_BATCH * steps
    result = {"phase": "speculative", "gamma": GAMMA, "batch": GEN_BATCH,
              "prompt": GEN_PROMPT, "steps": steps,
              "verify_rounds": stats["verify_rounds"],
              "mean_committed": stats["mean_committed"],
              "seconds": spec_s, "tokens_per_s": tokens / spec_s,
              "plain_seconds": plain_s, "plain_tokens_per_s": tokens / plain_s,
              "k5_launches": launches["decode_attention"],
              "int8_matmul_launches": launches["int8_matmul"],
              "near_tie": NEAR_TIE["bfloat16"], "diverged": diverged,
              "equal_rows": GEN_BATCH - len(diverged)}
    emit(result)
    if bad or launches["decode_attention"] < 1 or got.shape != want.shape:
        raise SystemExit(f"speculative failed: bad={bad} launches={launches}")
    return result


# Flash cases: (name, B, S, H, Hk, D, dtype, causal, dlse). The train shapes
# (B=8, S=1023 and B=2, S=8191, H=16, D=64: the train and train_long phases'
# attention), a GQA and a non-causal case, and small cases for the other
# head dims the kernels instantiate. bf16 runs the tensor-core kernels
# (csrc/flash_attention_sm90.cu), f32 the CUDA-core ones
# (csrc/flash_attention.cu).
FLASH_CASES = (
    ("train", 8, 1023, 16, 16, 64, "bfloat16", True, False),
    ("train", 8, 1023, 16, 16, 64, "float32", True, False),
    ("long", 2, 8191, 16, 16, 64, "bfloat16", True, False),
    ("long", 2, 8191, 16, 16, 64, "float32", True, False),
    ("gqa", 8, 1023, 16, 4, 64, "bfloat16", True, True),
    ("full", 8, 1023, 16, 16, 64, "bfloat16", False, False),
    ("full", 8, 1023, 16, 16, 64, "float32", False, False),
    ("d32", 2, 333, 8, 2, 32, "float32", True, True),
    ("d32", 2, 333, 8, 2, 32, "bfloat16", True, True),
    ("d128", 2, 333, 8, 4, 128, "bfloat16", False, True),
)
# K3 against its plain version, element by element: |got - want| <=
# rtol * |want| + atol. lse is f32 in every dtype and both sides compute it
# in f32 from the same scores, apart in the order of f32 sums (about 1e-6
# here): 1e-5 relative plus 1e-5. out in f32: the same, 1e-5 plus 1e-5.
# out in bf16: the tensor-core kernel rounds P to bf16 (2^-9 relative a
# term) before P V, and the sums stay f32, so out moves by up to 2^-9 *
# sum(p |v|) / l, about 2^-8 where p sits on a few rows of randn v; out
# itself is rounded to bf16, one step (2^-7 relative at most) where the
# two f32 values straddle a rounding boundary: 2^-7 relative plus 2^-7.
# The rounding emulated on the CPU reads at most half of it against the
# reference (tests/test_torch_flash_attention.py); on an NVIDIA H100 80GB
# HBM3 (700 W) the worst element read 0.67 of it, and the control below,
# one KV tile masked out of the plain version, 31 times it or more.
K3_OUT_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -7)}
K3_LSE_TOL = (1e-5, 1e-5)
# K4 against its plain backward, as max |got - want| / max |want|. f32: the
# order of f32 sums. bf16: the kernels round P and dS to bf16 (2^-9
# relative a term) before P^T dO, dS^T Q and dS K, with f32 sums, and dq,
# dk and dv to bf16 (2^-9 of the largest): on an NVIDIA H100 80GB HBM3
# (700 W) the cases read 0.0078 at most (the CPU emulation under 0.007),
# and the controls, a skipped KV tile, a dropped delta' or an ignored lse
# cotangent, 0.12 or more.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The controls' KV tile: keys [64, 128) masked out as well.
CONTROL_SKIP = (64, 128)


def _flash_inputs(torch, device, case, seed: int):
    _, b, s, h, hk, d, dtype, _, dlse = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dt)

    q, k, v = rnd(b, s, h, d), rnd(b, s, hk, d), rnd(b, s, hk, d)
    w = rnd(b, s, h, d)  # the cotangent of out
    wl = (torch.randn(b, s, h, generator=gen, device=device) if dlse
          else torch.zeros(b, s, h, device=device))
    return q, k, v, w, wl


def _tol_ratio(torch, got, want, tol) -> float:
    """max |got - want| / (rtol * |want| + atol): 1 or less is within tol."""
    rtol, atol = tol
    want = want.float()
    return ((got.float() - want).abs() / (rtol * want.abs() + atol)
            ).max().item()


def _rel_err(torch, got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _flash_bound(case, products: int, nbytes: float) -> tuple:
    """Bound of ``products`` (S x S x D) products, halved under causal,
    over the peak for the inputs' type."""
    _, b, s, h, _, d, dtype, causal, _ = case
    flops = products * 2 * b * h * s * s * d / (2 if causal else 1)
    return bound(nbytes, flops, BF16_FLOPS if dtype == "bfloat16"
                 else F32_FLOPS)


def _sdpa_layout(torch, *ts):
    return [t.detach().transpose(1, 2).contiguous() for t in ts]


def _skipped_tile(torch, q, k, v, w, wl, scale: float, causal: bool,
                  grads: bool) -> tuple:
    """A control: the plain attention in f32 with the keys of CONTROL_SKIP
    masked out too, as a kernel that skipped one KV tile would compute;
    (out, lse) and, if ``grads``, the gradients of sum(out * w) + sum(lse *
    wl) with respect to q, k and v."""
    b, s, h, _ = q.shape
    g = h // k.shape[2]
    qf, kf, vf = (t.detach().float().requires_grad_(grads) for t in (q, k, v))
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    keep[:, CONTROL_SKIP[0]:CONTROL_SKIP[1]] = False
    with torch.set_grad_enabled(grads):
        sc = torch.einsum("bqhd,bkhd->bhqk", qf * scale,
                          torch.repeat_interleave(kf, g, dim=2))
        sc = sc.masked_fill(~keep, -1e30)
        lse = torch.logsumexp(sc, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(sc - lse[..., None]),
                           torch.repeat_interleave(vf, g, dim=2))
        lse = lse.transpose(1, 2)
        if not grads:
            return out, lse
        loss = (out * w.float()).sum() + (lse * wl).sum()
        return out, lse, *torch.autograd.grad(loss, (qf, kf, vf))


def phase_k3(torch, fa, kernels, device, cases=FLASH_CASES) -> dict:
    """flash_fwd (kernel K3) against its plain version: out and lse; in
    bf16 (below the long shape) a control, one KV tile skipped, must land
    outside the limits."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for r, role in enumerate(kernels.FLASH_ROLES):
        for d in kernels.FLASH_HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                got = kernels.lib().tpubc_flash_smem_bytes(
                    r, d, int(dt == torch.bfloat16))
                want = kernels.flash_smem_bytes(role, d, dt)
                if got != want:
                    raise SystemExit(f"k3: flash_smem_bytes({role}, {d}, "
                                     f"{dt}) = {want}, the kernels say {got}")
    rows, failures = [], []
    for n, case in enumerate(cases):
        name, b, s, h, hk, d, dtype, causal, _ = case
        q, k, v, _, _ = _flash_inputs(torch, device, case, seed=10 + n)
        scale = d ** -0.5
        out, lse = kernels.flash_fwd(q, k, v, scale, causal)
        want, want_lse = fa.attention_plain(q, k, v, scale, causal)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out.float()).all()
                      and torch.isfinite(lse).all())
        out_ratio = _tol_ratio(torch, out, want, K3_OUT_TOL[dtype])
        lse_ratio = _tol_ratio(torch, lse, want_lse, K3_LSE_TOL)
        row = {"case": name, "B": b, "S": s, "H": h, "Hk": hk, "D": d,
               "dtype": dtype, "causal": causal,
               "rel_err": _rel_err(torch, out, want),
               "max_abs_err": (out.float() - want.float()).abs().max().item(),
               "lse_max_abs_err": (lse - want_lse).abs().max().item(),
               "out_tol_ratio": out_ratio, "lse_tol_ratio": lse_ratio,
               "close": finite and out_ratio <= 1 and lse_ratio <= 1}
        if dtype == "bfloat16" and s < 4096:
            c_out, c_lse = _skipped_tile(torch, q, k, v, None, None, scale,
                                         causal, grads=False)
            row["control_out_tol_ratio"] = _tol_ratio(
                torch, c_out.to(q.dtype), want, K3_OUT_TOL[dtype])
            row["control_lse_tol_ratio"] = _tol_ratio(torch, c_lse, want_lse,
                                                      K3_LSE_TOL)
            row["close"] &= (row["control_out_tol_ratio"] > 1
                             and row["control_lse_tol_ratio"] > 1)
            del c_out, c_lse
        del want, want_lse, out, lse
        if name in ("train", "long", "gqa", "full"):
            timer = Timer(torch, device, reps=10 if s > 4096 else 25)
            e = q.element_size()
            row["bound_ms"], row["bound_by"] = _flash_bound(
                case, 2, (2 * q.numel() + k.numel() + v.numel()) * e
                + 4 * b * s * h)
            row["kernel_ms"] = timer(
                lambda: kernels.flash_fwd(q, k, v, scale, causal))
            row["plain_ms"] = timer(
                lambda: fa.attention_plain(q, k, v, scale, causal))
            row["library_ms"] = None
            if dtype == "bfloat16":
                qt, kt, vt = _sdpa_layout(torch, q, k, v)
                row["library_ms"] = timer(lambda: sdpa(
                    qt, kt, vt, is_causal=causal, enable_gqa=hk < h))
                del qt, kt, vt
            del timer
        rows.append(row)
        if not row["close"]:
            failures.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "k3", "out_tolerance": K3_OUT_TOL,
          "lse_tolerance": K3_LSE_TOL, "rows": rows})
    if failures:
        raise SystemExit(f"k3 failed: {failures}")
    return {"rows": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def phase_k4(torch, fa, kernels, device, cases=FLASH_CASES) -> dict:
    """flash_dq and flash_dkv (kernel K4) through the autograd function,
    against the plain backward of the plain forward, on a weighted sum of
    out plus (where the case says so) of lse; two backward runs must be
    bitwise equal. In bf16 (below the long shape) the controls must land
    outside the limit: one KV tile skipped (dq, dk, dv), delta' dropped (dq,
    dk) and, with an lse cotangent, that cotangent ignored (dq, dk)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, failures = [], []
    for n, case in enumerate(cases):
        name, b, s, h, hk, d, dtype, causal, dlse = case
        q, k, v, w, wl = _flash_inputs(torch, device, case, seed=30 + n)
        scale = d ** -0.5
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def grads():
            out, lse = fa.flash_attention_with_lse(*qkv, causal=causal)
            loss = (out.float() * w.float()).sum() + (lse * wl).sum()
            return torch.autograd.grad(loss, qkv)

        got = grads()
        again = grads()
        out_p, lse_p = fa.attention_plain(q, k, v, scale, causal)
        delta_p = (w.float() * out_p.float()).sum(-1) - wl
        want = fa.attention_bwd_plain(q, k, v, w, lse_p, delta_p, scale,
                                      causal)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        errs = [_rel_err(torch, g, x) for g, x in zip(got, want)]
        row = {"case": name, "B": b, "S": s, "H": h, "Hk": hk, "D": d,
               "dtype": dtype, "causal": causal, "dlse": dlse,
               "rel_err": dict(zip(("dq", "dk", "dv"), errs)),
               "max_abs_err": max((g.float() - x.float()).abs().max().item()
                                  for g, x in zip(got, want)),
               "bitwise_repeat": all(torch.equal(a, c)
                                     for a, c in zip(got, again))}
        row["close"] = finite and max(errs) <= FLASH_TOL[dtype]
        if dtype == "bfloat16" and s < 4096:
            args = (q, k, v, w, lse_p)
            controls = {
                "skipped_tile": _skipped_tile(torch, q, k, v, w, wl, scale,
                                              causal, grads=True)[2:],
                "no_delta": fa.attention_bwd_plain(
                    *args, torch.zeros_like(delta_p), scale, causal)[:2]}
            if dlse:
                controls["no_dlse"] = fa.attention_bwd_plain(
                    *args, delta_p + wl, scale, causal)[:2]
            row["control_rel_err"] = {
                name: [_rel_err(torch, g, x) for g, x in zip(c, want)]
                for name, c in controls.items()}
            row["close"] &= all(min(e) > FLASH_TOL[dtype]
                                for e in row["control_rel_err"].values())
            del controls, args
        del got, again, want, out_p
        if name in ("train", "long", "gqa", "full"):
            timer = Timer(torch, device, reps=10 if s > 4096 else 25)
            e = q.element_size()
            ins = (2 * q.numel() + k.numel() + v.numel()) * e + 8 * b * s * h
            dq_b = _flash_bound(case, 3, ins + q.numel() * e)
            dkv_b = _flash_bound(case, 4, ins + (k.numel() + v.numel()) * e)
            k4_b = _flash_bound(case, 5, ins + (q.numel() + k.numel()
                                                + v.numel()) * e)
            row.update({"dq_bound_ms": dq_b[0], "dq_bound_by": dq_b[1],
                        "dkv_bound_ms": dkv_b[0], "dkv_bound_by": dkv_b[1],
                        "bound_ms": k4_b[0], "bound_by": k4_b[1]})
            args = (q, k, v, w, lse_p, delta_p, scale, causal)
            row["dq_ms"] = timer(lambda: kernels.flash_dq(*args))
            row["dkv_ms"] = timer(lambda: kernels.flash_dkv(*args))
            row["kernel_ms"] = row["dq_ms"] + row["dkv_ms"]
            row["dq_plain_ms"] = timer(lambda: fa.attention_dq_plain(*args))
            row["dkv_plain_ms"] = timer(
                lambda: fa.attention_dkv_plain(*args))
            row["plain_ms"] = row["dq_plain_ms"] + row["dkv_plain_ms"]
            row["library_ms"] = None
            if dtype == "bfloat16":
                qt, kt, vt = [t.requires_grad_(True) for t in
                              _sdpa_layout(torch, q, k, v)]
                ot = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=hk < h)
                wt = w.transpose(1, 2).contiguous()
                row["library_ms"] = timer(lambda: torch.autograd.grad(
                    ot, (qt, kt, vt), wt, retain_graph=True))
                del qt, kt, vt, ot, wt
            del timer
        rows.append(row)
        if not row["close"] or not row["bitwise_repeat"]:
            failures.append(row)
        del q, k, v, w, wl, qkv, lse_p, delta_p
        torch.cuda.empty_cache()
    emit({"phase": "k4", "tolerance_rel": FLASH_TOL, "rows": rows})
    if failures:
        raise SystemExit(f"k4 failed: {failures}")
    return {"rows": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


# The reference's single-chip train benchmark model (bench.py:306-312):
# about 134M params, bf16 activations, f32 master weights.
TRAIN_MODEL = dict(vocab_size=32768, num_layers=8, num_heads=16, head_dim=64,
                   embed_dim=1024, mlp_dim=4096)
# One step's loss with the flash kernels against the dense einsum core, from
# the same params and tokens, in bf16: the dense core rounds scores and
# probabilities to bf16 where the kernels keep f32. On an NVIDIA H100 80GB
# HBM3 (700 W power limit) this phase measured the two 8.2e-5 apart, and
# the control below 3.5e-3 from the dense loss: at initialization the loss
# barely depends on attention, so the gradients below are the real check.
FLASH_DENSE_TOL = 1e-3
# The first step's gradients of every layer's wq, wk, wv and wo with the
# flash kernels against the dense core's, as |g_flash - g_dense| /
# |g_dense| (norms over the layers) for each of the four. The control, an
# attention that returns v (each position attending only to itself), must
# land above the limit for every weight, so that the limit tells a right
# attention from a wrong one. On an NVIDIA H100 80GB HBM3 (700 W) flash
# read 0.009-0.015 and the control 1.0-1.31; the limit sits between.
ATTN_GRAD_TOL = 0.1
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")
# Device time of each flash role: the f32 kernel and the bf16 one summed (a
# list of name fragments sums the kernels that match any of them).
FLASH_TAGS = {"flash_fwd_ms": ["flash_fwd_kernel", "flash_fwd_sm90_kernel"],
              "flash_dq_ms": ["flash_dq_kernel", "flash_dq_sm90_kernel"],
              "flash_dkv_ms": ["flash_dkv_kernel", "flash_dkv_sm90_kernel"]}


def _bench_mfu(cfg, n_params: int, batch: int, step_s: float) -> float:
    """bench.py:336-339: 6 * params * tokens + 12 * B * L * H * S^2 * D
    FLOPs per step (S = max_seq_len - 1), over the step time and the bf16
    peak."""
    m = cfg.model
    s = m.max_seq_len - 1
    attn = 12 * batch * m.num_layers * m.num_heads * s * s * m.head_dim
    return (6 * n_params * batch * s + attn) / step_s / BF16_FLOPS


def _attn_grads(torch, model, params, cfg, tokens, attn_fn) -> tuple:
    """(loss, {name: gradient of that weight over every layer, flat}) of
    loss_fn at ``params``; params themselves are not changed."""
    leaves = [blk[n] for n in ATTN_WEIGHTS for blk in params["blocks"]]
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = model.loss_fn(params, tokens, cfg.model, attn_fn)
            # The control leaves wq and wk out of the graph: zero grads.
            grads = [torch.zeros_like(p) if g is None else g for p, g in
                     zip(leaves, torch.autograd.grad(loss, leaves,
                                                     allow_unused=True))]
    finally:
        for p in leaves:
            p.requires_grad_(False)
    layers = len(params["blocks"])
    return loss.item(), {n: torch.cat([g.flatten() for g in
                                       grads[i * layers:(i + 1) * layers]])
                         for i, n in enumerate(ATTN_WEIGHTS)}


def _dense_check(torch, train, cfg, params, tokens) -> dict:
    """The flash kernels against the dense core, and a broken attention
    against the dense core, from the same params and tokens."""
    from tpu_bootstrap_torch.workload import model
    from tpu_bootstrap_torch.workload.flash_attention import \
        make_flash_attn_fn

    def broken(q, k, v):
        return model.repeat_kv(v, q.shape[-2])

    attn = {"flash": make_flash_attn_fn(block_size=cfg.attention_block),
            "dense": None, "control": broken}
    loss, grads = {}, {}
    for name, fn in attn.items():
        loss[name], grads[name] = _attn_grads(torch, model, params, cfg,
                                              tokens, fn)
    dense = grads.pop("dense")
    err = {name: {n: ((g[n] - dense[n]).norm() / dense[n].norm()).item()
                  for n in ATTN_WEIGHTS} for name, g in grads.items()}
    del grads, dense
    torch.cuda.empty_cache()
    return {"dense_loss": loss["dense"], "control_loss": loss["control"],
            "attn_grad_err": err["flash"],
            "control_attn_grad_err": err["control"]}


def _run_train(torch, kernels, train, cfg, batch: int, timed: int,
               dense_check: bool) -> dict:
    """A fixed token batch from a seed; one warm-up step, then ``timed``
    steps through make_train_step with the launch counts set to 0 just
    before and read just after; then one profiled step."""
    device = torch.device("cuda")
    params, opt_state = train.init_train_state(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in train.tree_leaves(params))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.model.vocab_size,
                           (batch, cfg.model.max_seq_len), generator=gen,
                           device=device)
    out = {"batch": batch, "seq": cfg.model.max_seq_len - 1,
           "remat": cfg.remat, "vocab_chunk": cfg.model.vocab_chunk,
           "params": n_params}
    if dense_check:
        out.update(_dense_check(torch, train, cfg, params, tokens))
    step = train.make_train_step(cfg)
    params, opt_state, loss = step(params, opt_state, tokens)  # warm-up
    losses = [loss.item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(timed):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(loss.item())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    launches = dict(kernels.LAUNCHES)
    out.update({
        "losses": losses, "step_ms": step_s * 1e3,
        "tokens_per_s": batch * out["seq"] / step_s,
        "mfu_bench": _bench_mfu(cfg, n_params, batch, step_s),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "launches_per_step": {k: launches[k] / timed for k in
                              ("flash_fwd", "flash_dq", "flash_dkv")}})

    def one_step():
        nonlocal params, opt_state
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(loss.item())

    out["profile"] = _profile(torch, one_step, FLASH_TAGS)
    del params, opt_state
    torch.cuda.empty_cache()
    return out


def phase_train(torch, kernels, device) -> dict:
    """The slice end to end: make_train_step on the reference's train
    benchmark model (bench.py:306-312: max_seq_len 1024, batch 8,
    attention="flash"), then two steps of train_loop, the user's entry."""
    from tpu_bootstrap_torch.workload import model, train

    cfg = train.TrainConfig(model=model.ModelConfig(
        **TRAIN_MODEL, max_seq_len=1024, compute_dtype=torch.bfloat16),
        attention="flash")
    out = _run_train(torch, kernels, train, cfg, batch=8, timed=5,
                     dense_check=True)
    losses = out["losses"]
    layers = cfg.model.num_layers
    loop = train.train_loop(cfg, 2)
    out.update({"phase": "train", "flash_dense_tol": FLASH_DENSE_TOL,
                "flash_dense_diff": abs(losses[0] - out["dense_loss"]),
                "control_dense_diff": abs(out["control_loss"]
                                          - out["dense_loss"]),
                "attn_grad_tol": ATTN_GRAD_TOL, "train_loop_losses": loop})
    emit(out)
    per_step = out["launches_per_step"]
    ok = (all(math.isfinite(x) for x in losses + loop)
          and losses[5] < losses[0]
          and out["flash_dense_diff"] <= FLASH_DENSE_TOL
          and max(out["attn_grad_err"].values()) <= ATTN_GRAD_TOL
          and min(out["control_attn_grad_err"].values()) > ATTN_GRAD_TOL
          and all(per_step[k] == layers for k in per_step)
          and all(out["profile"][k] > 0 for k in FLASH_TAGS))
    if not ok:
        raise SystemExit(
            f"train failed: losses={losses} loop={loop} "
            f"dense={out['dense_loss']} grads={out['attn_grad_err']} "
            f"control={out['control_attn_grad_err']} launches={per_step} "
            f"profile={[out['profile'][k] for k in FLASH_TAGS]}")
    return out


def phase_train_long(torch, kernels, device) -> dict:
    """The reference's long-context configuration (bench.py:1786-1791):
    max_seq_len 8192, batch 2, remat, vocab_chunk 4096; one warm-up step
    and two timed. With remat the forward runs twice per step."""
    from tpu_bootstrap_torch.workload import model, train

    cfg = train.TrainConfig(model=model.ModelConfig(
        **TRAIN_MODEL, max_seq_len=8192, compute_dtype=torch.bfloat16,
        vocab_chunk=4096), attention="flash", remat=True)
    out = _run_train(torch, kernels, train, cfg, batch=2, timed=2,
                     dense_check=False)
    out["phase"] = "train_long"
    emit(out)
    per_step = out["launches_per_step"]
    layers = cfg.model.num_layers
    if not (all(math.isfinite(x) for x in out["losses"])
            and per_step["flash_fwd"] == 2 * layers
            and per_step["flash_dq"] == per_step["flash_dkv"] == layers
            and all(out["profile"][k] > 0 for k in FLASH_TAGS)):
        raise SystemExit(f"train_long failed: losses={out['losses']} "
                         f"launches={per_step} "
                         f"profile={[out['profile'][k] for k in FLASH_TAGS]}")
    return out


def step_totals(rows: list, per_step: list, layers: int = 8) -> dict:
    """A kernel's numbers for one decode step at batch 8: ``per_step``
    lists (shape, x dtype, launches per layer or None for once a step) of
    the T = 8 rows."""
    pick = {(r["shape"], r["x"]): r for r in rows if r["T"] == 8}
    step = [(layers if per_layer else 1, pick[(shape, x)])
            for shape, x, per_layer in per_step]
    out = {key: sum(m * r[key] for m, r in step)
           for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                      for _, r in step) else "operations")
    return out


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 check: dict, step: dict, at: str) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"tpu_bootstrap_torch/workload/csrc/{source}",
            "replaces": f"tpu_bootstrap/workload/{replaces}",
            "launches": launches, "max_abs_err": check["max_abs_err"],
            "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "library_ms": step["library_ms"], "at": at}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tpu_bootstrap_torch.workload import (decode, decode_attention,
                                              kernels, quant)
    from tpu_bootstrap_torch.workload import flash_attention as fa

    device = torch.device("cuda")
    info = phase_device(torch)
    seconds = {}  # wall time of each phase, printed before the kernels line

    def run(name, phase, *args):
        t0 = time.perf_counter()
        result = phase(*args)
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    run("build", phase_build, kernels)
    timer = Timer(torch, device)
    out = {"k1": run("k1", phase_k1, torch, kernels, quant, timer, device),
           "k2": run("k2", phase_k2, torch, kernels, decode,
                     decode_attention, timer, device),
           "k1e": run("k1e", phase_k1e, torch, kernels, quant, timer,
                      device),
           "k6": run("k6", phase_k6, torch, kernels, quant, timer, device),
           "k5": run("k5", phase_k5, torch, kernels, decode,
                     decode_attention, timer, device)}
    del timer  # frees the L2-flush buffer
    for name, phase in (("serve", phase_serve),
                        ("serve_int4", phase_serve_int4),
                        ("serve_moe", phase_serve_moe),
                        ("generate_int8kv", phase_generate_int8kv),
                        ("speculative", phase_speculative)):
        out[name] = run(name, phase, torch, kernels, device)
    out["k3"] = run("k3", phase_k3, torch, fa, kernels, device)
    out["k4"] = run("k4", phase_k4, torch, fa, kernels, device)
    out["train"] = run("train", phase_train, torch, kernels, device)
    run("train_long", phase_train_long, torch, kernels, device)
    emit({"phase_seconds": seconds})
    emit({"kernels": kernel_lines(out)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


def kernel_lines(out: dict) -> list:
    k1, k2, k3, k4 = out["k1"], out["k2"], out["k3"], out["k4"]
    launches = out["serve"]["launches"]
    train_launches = out["train"]["launches"]
    k1_step = step_totals(k1["rows"], [
        *((shape, "bfloat16", True)
          for shape in ("wqkv", "wo", "w_up", "w_down")),
        ("lm_head", "float32", False)])
    k2_main = next(r for r in k2["rows"] if r["Hk"] == 16 and r["D"] == 64
                   and r["q"] == "bfloat16" and r["lengths_name"] == "ragged")
    k5_main = next(r for r in out["k5"]["rows"] if r["Hk"] == 16
                   and r["D"] == 64 and r["L"] == K5_TIMED_L
                   and r["mask"] == "full" and r["q"] == "bfloat16")
    k3_main, k3_f32 = (next(r for r in k3["rows"] if r["case"] == "train"
                            and r["dtype"] == dt)
                       for dt in ("bfloat16", "float32"))
    k4_main, k4_f32 = (next(r for r in k4["rows"] if r["case"] == "train"
                            and r["dtype"] == dt)
                       for dt in ("bfloat16", "float32"))
    flash_at = ("one launch at the train shape: B=8 S=1023 H=Hk=16 D=64, "
                "bf16, causal")
    # The bf16 route (the train phases' path) is the sm90 source; f32_ms is
    # the f32 route's time at the same shape (csrc/flash_attention.cu).
    src = "tpu_bootstrap_torch/workload/csrc/flash_attention_sm90.cu"
    f32_src = "tpu_bootstrap_torch/workload/csrc/flash_attention.cu"
    ref = "tpu_bootstrap/workload/flash_attention.py"
    moe = [(shape, "bfloat16", True) for shape in MOE_SHAPES]
    moe_at = ("one MoE decode step, T=8: 8 x (moe_up, moe_down) stacks of "
              "E=8 experts, bf16; library: torch.bmm on the bf16-dequantized "
              "stacks")
    return [
        {"name": "int8_matmul", "route": "cuda",
         "source": "tpu_bootstrap_torch/workload/csrc/int8_matmul_sm90.cu",
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
         "library_ms": k2_main["library_ms"], "split": k2_main["plan"],
         "at": "one launch, B=8 H=Hk=16 D=64 bs=64 nb=8, bf16 q, lengths "
               + ",".join(map(str, K2_LENGTHS))},
        {"name": "flash_fwd", "route": "cuda", "source": src,
         "replaces": f"{ref}:110",
         "launches": train_launches["flash_fwd"],
         "max_abs_err": k3["max_abs_err"],
         "ms": k3_main["kernel_ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": k3_main["library_ms"],
         "f32_ms": k3_f32["kernel_ms"], "f32_source": f32_src,
         "at": flash_at + "; library: scaled_dot_product_attention"},
        # No one PyTorch call computes dq alone or dk/dv alone: SDPA's
        # backward (all three) is given beside them, not as library_ms.
        {"name": "flash_dq", "route": "cuda", "source": src,
         "replaces": f"{ref}:233",
         "launches": train_launches["flash_dq"],
         "max_abs_err": k4["max_abs_err"],
         "ms": k4_main["dq_ms"], "plain_ms": k4_main["dq_plain_ms"],
         "bound_ms": k4_main["dq_bound_ms"],
         "bound_by": k4_main["dq_bound_by"],
         "library_ms": None, "sdpa_backward_ms": k4_main["library_ms"],
         "f32_ms": k4_f32["dq_ms"], "f32_source": f32_src, "at": flash_at},
        {"name": "flash_dkv", "route": "cuda", "source": src,
         "replaces": f"{ref}:267",
         "launches": train_launches["flash_dkv"],
         "max_abs_err": k4["max_abs_err"],
         "ms": k4_main["dkv_ms"], "plain_ms": k4_main["dkv_plain_ms"],
         "bound_ms": k4_main["dkv_bound_ms"],
         "bound_by": k4_main["dkv_bound_by"],
         "library_ms": None, "sdpa_backward_ms": k4_main["library_ms"],
         "f32_ms": k4_f32["dkv_ms"], "f32_source": f32_src, "at": flash_at},
        kernel_entry(
            "int8_expert_matmul", "int8_matmul_sm90.cu", "quant.py:246",
            out["serve_moe"]["int8"]["launches"]["int8_expert_matmul"],
            out["k1e"], step_totals(out["k1e"]["rows"], moe), moe_at),
        kernel_entry(
            "int4_matmul", "int4_matmul_sm90.cu", "quant.py:268",
            out["serve_int4"]["launches"]["int4_matmul"], out["k6"],
            step_totals(out["k6"]["rows"], [
                (shape, "bfloat16", True)
                for shape in ("wqkv", "wo", "w_up", "w_down")]),
            "one int4 decode step, T=8: 8 x (wqkv, wo, w_up, w_down), group "
            "64, bf16; library: torch.matmul on the bf16-dequantized "
            "weights"),
        kernel_entry(
            "int4_expert_matmul", "int4_matmul_sm90.cu", "quant.py:268",
            out["serve_moe"]["int4"]["launches"]["int4_expert_matmul"],
            out["k6"], step_totals(out["k6"]["rows"], moe),
            moe_at + ", group 64"),
        kernel_entry(
            "decode_attention_int8", "decode_attention.cu",
            "decode_attention.py:75",
            out["generate_int8kv"]["kernel"]["k5_launches"][
                str(GEN_STEPS[1])],
            out["k5"], k5_main,
            "one launch, B=8 L=256 H=Hk=16 D=64, all slots valid, bf16 q "
            "(the last step of a 192-step generate); launches: that "
            "generate call; library: scaled_dot_product_attention on the "
            "bf16-dequantized cache with the boolean mask")
        | {"split": k5_main["plan"]},
    ]


if __name__ == "__main__":
    sys.exit(main())
