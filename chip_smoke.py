#!/usr/bin/env python3
"""Build and drive the PyTorch port (``tpu_bootstrap_torch``) on one CUDA card.

    python3 chip_smoke.py
    torchrun --nproc-per-node 4 chip_smoke.py --mesh-cards

The second form (several cards) runs only phase_mesh_cards: the train
phase's model on meshes whose collectives cross cards (fsdp x tensor, dcn
x data, the flash ring on seq=4, expert x seq on the decode model's
8-expert stack at the train widths, GPipe on pipe x data and 1F1B on pipe
x tensor), held to one card's plain steps.
Without arguments the script needs one card.

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
              the decode model's D 64 at blocks of 16 (K2_BLOCK16, the
              overcommit and host-tier pools' geometry, Hk 16 and 4) and
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
              int8 weights from a seed), TIMED_RUNS times (tokens/s median
              and spread; the runs' streams and launch counts alike), the
              launch counts of both kernels over each run, replays of the
              captured decode steps included, equal to what the schedule
              implies (_launches_exact), and every stream held to the
              port's solo greedy generate (kv_kernel=False, the einsum
              oracle), in bf16 and again in f32: any divergence must be a
              near-tie. Graph == eager: from a mid-serve pool state, one
              decode chunk through the captured step against the eager
              loop on a clone of the pools, tokens and pool bytes bitwise
              (_paged_graph_check). Then the replay-slot engine,
              serve(paged=False), on the first 8 requests, with and without
              the int8 self-draft (the speculative rounds), its streams held
              to the same solo runs. Then the flash prefill:
              generate(prefill_flash=True), whose prompt attention runs
              through K3, against generate() with the einsum prefill.
9. serve_int4 -- the serve phase's workload on the same widths at half
              the depth (CUT_MODEL, 4 layers) with int4
              weights (quantize_params4, group 64, int8 head): K6, K1 and K2
              launched as the schedule implies, every stream held to solo
              generate as in serve, in bf16 and in f32; graph == eager.
10. serve_moe -- the MoE decode model (the same widths with 8 experts,
              top-2, capacity factor 2, at CUT_MODEL's 4 layers) served with int8 (K1, K1e, K2) and
              int4 (K6, K6e, K1 head, K2) weights on 16 of the requests,
              TIMED_RUNS times: every stream complete, every decode logit
              finite, every run and a watched serve bitwise the same, the
              launches as the schedule implies, graph == eager; of the
              first 8 streams, those that
              differ from solo generate are counted, not failed (capacity
              is contested over each chunk, so chunked serving routes
              otherwise).
11. serve_prefix -- the prefix cache on bench.py:867-889's traffic (24
              requests sharing a 192-token system prompt, 8 unique tokens
              each, max_new 16, batch 8, block 64) on the decode model at
              CUT_MODEL's 4 layers, cached and cold, TIMED_RUNS times
              each: hit rate above 0.5, copy-on-write copies, evictions;
              cached streams held to the cold ones and every stream to
              solo generate (near-ties allowed); the host tier, on with
              the cache, never used (no swap in or out: the pool never
              evicts).
12. serve_overcommit -- overcommit admission and preemption on
              bench.py:1060-1190's traffic (block 16, the attractor token
              as eos): a 24-request burst of 8-token prompts (max_new 64)
              at batch 24 in a third of its whole footprint, admitted by
              expected footprint and by refusal (the admit ratio, above
              1), each served after a warm pass (TTFT p99, queue-wait p50,
              preemptions, grown blocks); a tight pool (12 requests, batch
              16, 16 blocks, expected_new 2), host tier off and on, that
              must preempt, and swap with the tier on (recompute tokens,
              resume gap p50, each arm's resume cost: restore ms plus the
              re-prefilled tokens at the prefill price). Every stream held
              to a roomy refusal serve, and that to solo generate
              (near-ties allowed); K1 and K2 launched as each run's
              schedule implies.
13. serve_host_tier -- the host tier on bench.py:951-1057's traffic
              (block 16): ten 40-token prompts served, demoted and served
              again (the host hit rate, HOST_HIT_RATE exactly; demoted and
              promoted bytes bitwise the device's); the same after a reset
              that zeroes the pool in place, a replayed decode chunk over
              the restored blocks equal to the eager loop; a burst (12
              requests, 12 blocks) with the tier off and on, every stream
              held to solo generate (near-ties allowed; at block 16 it
              never preempts); the swap arm's resume cost against the
              recompute arm's, read from serve_overcommit's tight pair;
              the host link's rate for one block each way; the prefill
              clock.
14. serve_faults -- the request log, the device ledger, crash recovery and
              deadlines on the serve phase's 32 requests (batch 8, block
              64; CUT_MODEL's 4 layers) through an explicit Scheduler: (a) TIMED_RUNS runs with
              the log and ledger on and as many off, interleaved: streams
              bitwise equal, K1 and K2 launches equal and as the schedule
              implies, tokens/s of each side, the ledger's busy, idle and
              wall ms, busy share and MFU (989 TFLOP/s), conserving
              (per-request + unattributed == busy, busy + idle == wall,
              1e-6 relative), and a profiled run's ledger busy share
              beside the profiler's device busy share; (b) FAULT_SCHEDULE
              (pool.device twice, alloc, sched.admit) with the prefix
              cache on: 4 recoveries, no live block left, the recovery ms,
              every stream equal to the unfaulted run's (near-ties
              allowed), then a persistent fault that must raise after
              GIVE_UP_RESTARTS recoveries; (c) deadlines on a virtual
              clock (a second a round): queued requests shed with no
              token, running ones cancelled with a prefix of their
              unfaulted stream (two mid-decode), deadline_shed the number
              that expired, the blocks the cancels freed allocated again.
15. serve_ingress -- the front door (workload/ingress.py) on serve's traffic
              and settings (batch 8, block 64, int8 weights and KV, prefix
              cache and overcommit off), on 127.0.0.1 with urllib client
              threads: (a) one untimed burst of the 32 requests (every
              decode graph captured); (b) INGRESS_RUNS timed bursts,
              streamed: every stream held to the solo oracle up to
              near-ties and counted equal to serve's, K1 and K2 launched as
              the pool's schedule implies, each final object carrying done,
              timing, trace_id and cached_tokens 0, tokens/s from the first
              POST to the last end beside serve's, TTFT, inter-token and
              total latency p50/p99; (c) the same requests at Poisson
              arrivals (numpy default_rng(1)) at half the bursts' median
              rate: client latencies and queue wait beside
              /metrics.json?window's TTFT; then the same arrivals with a
              POST /profilez?ms=1000 (TPUBC_PROFILEZ=1) that must answer
              in profiler mode with a busy share and an MFU, its Chrome
              trace holding K1 and K2 device time;
              (d) a burst whose last 4 requests carry deadline_ms 250: each
              finishes or answers 504 with a prefix of its oracle stream, no
              live block after; (e) /healthz, /poolz (the allocator's
              numbers), /cachez (empty), /requestz, /metrics (parsed),
              /traces.json; (f) drain() once 8 streams have tokens: each
              ends done or draining, a later POST 503 with Retry-After; (g)
              python -m tpu_bootstrap_torch.workload.train with
              WORKLOAD_MODE=serve as a subprocess on WORKLOAD_SERVE_PORT: up
              within 120 s, 4 streams equal to the in-process ingress's up
              to near-ties, SIGTERM drains and exits 0; then
              serve_demo_from_env in process prints its serve done line.
16. sampling -- sampling with threefry parity (prng) on the main path
              (CUT_MODEL's 4 layers):
              prng on the card bit for bit prng on the CPU (keys, a
              fold_in chain, split, per-row fold_in, bits and uniforms of
              (8, 32768); gumbel's largest ulp difference printed); serve's
              first 16 requests through the paged engine sampled at
              temperature 0.8, top_k 50, top_p 0.95 with the pool key
              prng.key(5): twice (equal streams and launches), K1, K2 and
              the graphs' replays as the schedule implies (the sampler
              runs in the captured step), at batch 1, in a tight pool with
              overcommit, the prefix cache and the host tier (preemptions
              > 0), and each request alone through generate(kv_kernel=
              False) with its stream key: every stream equal to the first
              run's up to near-ties of logits + gumbel (sampled_margins
              under NEAR_TIE), the engine and the oracle again in f32
              (NEAR_TIE's f32 limit, each divergence also explained by
              the two paths' logits at its pick, replayed eagerly); then
              sampled speculative_generate
              (the bf16 target, its int8 draft, (8, 64) prompts, 64 steps)
              completes.
17. serve_spec -- the paged engine's greedy speculative rounds, gamma 4,
              at CUT_MODEL's 4 layers (serving its own streams at that
              depth): prompt lookup on the int8 target and serve's 32
              requests (streams held to that serve's), then the bf16
              target plainly and drafted by its own int8 copy on 16 of
              them (streams held to the plain
              run's); near-ties allowed; more than one token committed a
              drafted round; K1 launched as the lookup's verify chunks and
              the draft's steps imply, K2 on the plain run's decode steps;
              tokens/s of each and the serve_spec_* phase times.
18. serve_resident -- the reference's other engines on serve's model (at
              CUT_MODEL's 4 layers, serving its own oracle and its own
              kernel-route streams at that depth) and
              32 requests (batch 8), every stream held to the solo oracle
              up to near-ties: the resident engine (serve(resident=True))
              on the int8 KV cache TIMED_RUNS times (tokens/s median and
              spread beside serve's, the runs alike), K1 launched as its
              schedule implies (decode steps as replays of a captured
              step, one prefill an admission) and K2 never; graph ==
              eager, one resident chunk from a mid-serve state against
              the eager loop on a clone of the caches, tokens and cache
              bytes bitwise; the resident engine on a float cache and the
              paged engine's float pool (serve(paged=True,
              kv_quant=False)), once each, held to the float-cache oracle,
              K2 never; the int8 pool with paged_kernel=False (the
              gathered route), streams held to serve's; prompt lookup on
              the resident engine over 8 requests (committed tokens a
              round, streams held to the resident run's); the resident
              engine in f32 on them, held to the f32 oracle.
19. generate_int8kv -- bench.py's int8-KV decode workload: generate on the
              decode model with int8 weights and an int8 KV cache (CUT_MODEL's
              4 layers), prompts (8, 64), 64 and 192 steps, with K5 (AUTO)
              and without it (kv_kernel=False); K5 launched exactly
              (steps - 1) x layers times a call; every stream of the
              kernel path held to the einsum path's (near-ties allowed);
              the 192-step call's tokens equal
              the eager loop's (its decode steps are replays of one
              captured step; one capture a call); two-point tokens/s of
              both; one profiled call of each.
20. speculative -- bench.py's self-speculation: the bf16 target drafted by
              its own int8 copy, gamma 4, int8 KV caches (the draft's steps
              on K5), prompts (8, 64), 64 steps; streams held to the
              target's generate(kv_kernel=False) (near-ties allowed),
              mean_committed, verify_rounds, tokens/s and K5's launches.
21. k3     -- flash_fwd (kernel K3: bf16 on the tensor cores, f32 on the
              CUDA cores) against its plain version (out and lse, each
              element to its own limit) at the train shapes (B=8 S=1023
              and B=2 S=8191, H=16 D=64) in bf16 and f32, causal and not,
              plus a GQA and small head-dim cases (D 32 in both dtypes, 128
              in bf16); in bf16 a control (one KV tile skipped) must land
              outside the limits; the kernels' shared memory against
              kernels.flash_smem_bytes; timed beside
              scaled_dot_product_attention.
22. k4     -- flash_dq and flash_dkv (kernel K4) through the autograd
              function against the plain backward, at the same cases (some
              with an lse cotangent); two backward runs must be bitwise
              equal; in bf16 the controls (a skipped KV tile, delta'
              dropped, the lse cotangent ignored) must land outside the
              limit; timed beside SDPA's backward.
23. train  -- the training slice end to end: make_train_step on the
              reference's 134M train benchmark model (seq 1024, batch 8,
              attention="flash", a fixed token batch from a seed), one
              warm-up step then 5 timed; every loss finite, the loss falling,
              the first step's loss equal to the dense core's within
              FLASH_DENSE_TOL, the attention weights' gradients equal to the
              dense core's within ATTN_GRAD_TOL while a broken attention's
              land outside it, 8 launches of each flash kernel per step; one
              profiled step, in which each flash role's device time must
              be above 0; then two steps of train_loop.
24. train_mesh -- the train phase's model and batch on a one-rank NCCL
              process group and build_mesh(MeshConfig()) over the seven
              axes (the DTensor mesh path at world 1): 6 steps on the mesh
              against 6 plain steps from the same state, each loss within
              FLASH_DENSE_TOL (bitwise equality and the largest gap
              reported); the first step's attention-weight gradients
              within ATTN_GRAD_TOL of the plain path's; K3 and K4 launched
              8 times a mesh step under local_map, their device time above
              0 in a profiled mesh step; every param and moment a DTensor
              placed by param_shardings; a checkpoint saved on the mesh
              restored bitwise on the plain device and with the same
              placements on the mesh; train_loop(cfg, 2, mesh=mesh); ms a
              step on each path and the NCCL init time.
25. ring   -- ring attention's flash local body (queue 1 item 11b) on
              K3/K4 at train_long's shape (B=2, S=8192, H=16, D=64, bf16,
              causal) in 4 sequence shards, every shard's body in one
              process in lockstep (ring_attention.ring_on_one_device):
              out, dq, dk and dv against one whole-sequence K3/K4 call
              (RING_OUT_TOL, RING_GRAD_TOL), the controls (the diagonal
              block non-causal, one earlier shard's fold dropped, the last
              shard's first fold weighted 1.05 times) outside;
              K3, dq and dk/dv each launched 10 times (n(n+1)/2) in the
              counted run; the f32 route and the dense core at S=1024
              against the plain versions; the ring's forward and forward +
              backward timed beside the whole call's, SDPA's and the bound.
26. pipeline -- the pipeline (queue 1 item 11c): the train phase's model,
              batch and tokens in 2 stages of 4 layers and 4 microbatches,
              both stages in one process (pipeline_on_one_device, in
              lockstep), under GPipe and 1F1B, 3 steps each (the grad
              function and train.apply_update) against 3 plain steps: each
              loss within FLASH_DENSE_TOL of the plain step's, the first
              step's attention-weight gradients within ATTN_GRAD_TOL, a
              control (every cotangent hop zeroed) outside; K3, dq and
              dk/dv launched M L = 32 times a GPipe step, 64, 32, 32 a 1F1B
              step (the recompute), their device time above 0 in a
              profiled step; 1F1B's active ticks 16 of 20; 1F1B's peak
              memory above the train state below GPipe's; ms a step and
              peak memory of each beside the plain step.
27. train_long -- the reference's long-context configuration (seq 8192,
              batch 2, remat, vocab_chunk 4096): one warm-up and two timed
              steps; with remat the forward kernel runs twice per layer;
              the same profiled-step check.
28. quality -- fine-tuning and evaluation on a trained model
              (bench.py:350-458): make_train_step on TRAIN_MODEL (seq
              1024, batch 8, flash, bf16) for 300 steps on
              quality.markov_batch's chain over 4096 tokens; K1 and K6 at
              the score's T = 1,024 against their plain versions; the
              int8 and int4 ladder (eval_quality against the bf16 copy on
              markov_batch(10_000, 8, 129)), K1 and K6 launched as the
              scoring prefill implies; acceptance of the int8 self-draft
              (spec_acceptance, gamma 4, 48 steps); a 2-layer draft
              distilled for 150 steps, its acceptance and tokens/s of
              speculative decoding with it against plain greedy (the
              two-point rule), its streams held to plain greedy up to
              near-ties; sampling's top-k / top-p cutoff gaps on the
              trained weights and on a random init (recorded); QLoRA
              (make_lora_train_step on the int8 model, flash, wq and wv)
              for 20 steps on a second chain: the loss
              falls, the base's bytes unchanged, merge_lora then
              quantize_params served greedy equal to the merged float
              params up to near-ties; the flash kernels launched as
              scheduled in every training step. The limits are
              tests/test_quality.py's (QUALITY_LIMITS).

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
import os
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
# Phases run at half the decode model's depth (its widths unchanged), so
# that every phase fits the script's time limit; the serve, serve_ingress
# and kernel phases keep the full depth.
CUT_MODEL = {**DECODE_MODEL, "num_layers": 4}
DEPTH_CUT = ("serve_int4", "serve_moe", "serve_prefix", "serve_faults",
             "sampling", "generate_int8kv", "serve_resident", "serve_spec")
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
# The decode model's head dim at blocks of 16, as the serve_overcommit and
# serve_host_tier pools run it: the general kernel (only D 64 at blocks of
# 64 is compiled in), groups of 1 and 4.
K2_BLOCK16 = ({"H": 16, "Hk": 16, "D": 64, "bs": 16},
              {"H": 16, "Hk": 4, "D": 64, "bs": 16})
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
    the geometries of K2_BLOCK16 and K2_OTHER over the ragged lengths:
    garbage and NaN scales wherever no row may read, an aliased table;
    widening the table must not change a bit, nor launching each row alone.
    Each row shows its plan and is timed beside SDPA; then, in bf16, every
    split of the sweep, held to the plain version and bitwise to the
    plan's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows, failures, max_err, sweeps = [], [], 0.0, {}
    for bs, d, g in ((64, 64, 1), (64, 64, 4),
                     *((o["bs"], o["D"], o["H"] // o["Hk"])
                       for o in K2_BLOCK16 + K2_OTHER)):
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
    cases += [(o, dtype, "ragged") for o in K2_BLOCK16 + K2_OTHER
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
    # K2 at the decode model's D 64 on blocks of 16 (K2_BLOCK16), bf16: its
    # time beside its bound (the bytes over HBM_BYTES_PER_S) and SDPA's.
    emit({"phase": "k2_block16", "rows": [
        {k: r[k] for k in ("Hk", "D", "bs", "nb", "kernel_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in rows if r["bs"] == 16 and r["D"] == 64
        and r["q"] == "bfloat16"]})
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


def _solo_streams(decode, params, cfg, reqs, eos=None,
                  kv_quant: bool = True) -> dict:
    """Each request's solo greedy generate on the einsum path
    (kv_kernel=False) over a contiguous int8 cache (a float one with
    ``kv_quant`` off): the oracle the serving engines are held to. With
    ``eos``, each stream is cut after its first eos, as the engines cut
    it."""
    out = {}
    for r in reqs:
        got = decode.generate(params, [r.tokens], cfg, r.max_new,
                              kv_quant=kv_quant,
                              kv_kernel=False)[0].tolist()
        if eos in got:
            got = got[:got.index(eos) + 1]
        out[r.rid] = got
    return out


def _first_divergence(decode, params, cfg, prompt: list, got: list,
                      want: list, kv_quant: bool = True):
    """(step, the oracle's top-2 logit margin there, on the int8 or the
    float cache) of the first token where ``got`` leaves ``want``, or None
    when they are equal."""
    if got == want:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:  # one stream is a prefix of the other: never a near-tie
        return min(len(got), len(want)), float("inf")
    margin = decode.greedy_margins(params, prompt, want[:j + 1], cfg,
                                   kv_quant=kv_quant)[j]
    return j, margin


def _diverged(decode, params, cfg, reqs, done, solo: dict,
              kv_quant: bool = True) -> list:
    """Requests whose stream differs from its solo greedy generate
    (``solo``), each with the solo run's top-2 logit margin at the first
    divergent step (its KV cache int8, or float with ``kv_quant`` off)."""
    out = []
    for r in reqs:
        first = _first_divergence(decode, params, cfg, r.tokens,
                                  done[r.rid], solo[r.rid], kv_quant)
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
    paged engine TIMED_RUNS times, launches of both kernels counted over
    each run and held to the schedule (_launches_exact). Every stream is
    held to the port's solo greedy generate, in bf16 and again in f32: a
    divergence is accepted only at a near-tie (NEAR_TIE). The two paths
    cannot agree bit for bit: the oracle attends with einsums (in bf16 it
    rounds dequantized K/V and the probabilities to bf16, where K2, like
    the Pallas kernel it replaces, keeps f32), and the int8 matmul rounds
    its activations to bf16, which turns any f32 difference into a logit
    difference of about 1e-3. Then one decode chunk through the captured
    step against the eager loop (_paged_graph_check)."""
    import dataclasses

    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**DECODE_MODEL, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    run = _serve_runs(torch, kernels, serving, params, cfg, reqs)
    done = run["done"]
    t1 = time.perf_counter()
    solo = _solo_streams(decode, params, cfg, reqs)
    diverged = _diverged(decode, params, cfg, reqs, done, solo)
    solo_s = time.perf_counter() - t1
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    done32 = serving.serve(params, cfg32, reqs, 8, **SERVE_KW)
    diverged32 = _diverged(decode, params, cfg32, reqs, done32,
                           _solo_streams(decode, params, cfg32, reqs))
    profile = _serve_profile(torch, serving, params, cfg, reqs,
                             {"k1_ms": K1_KERNEL,
                              "k2_ms": "paged_attention_kernel"})
    graph = _paged_graph_check(torch, serving, params, cfg, reqs)
    exact = _launches_exact(cfg, run["stats"], run["launches"], PATHS["int8"])
    stats = run["stats"]
    result = {"phase": "serve", **_run_fields(run),
              "rounds": stats["rounds"], "blocks_peak": stats["blocks_peak"],
              "blocks_total": stats["blocks_total"],
              "prefill_tokens": stats["prefill_tokens"],
              "prefill_chunks": stats["prefill_chunks"],
              "slot_steps": stats["slot_steps"],
              "active_slot_steps": stats["active_slot_steps"],
              "launches_exact": exact, "near_tie": NEAR_TIE,
              "solo_check_s": solo_s,
              "diverged": {"bfloat16": diverged, "float32": diverged32},
              "graph_vs_eager": graph, "profile": profile}
    emit(result)
    # serve_ingress holds the front door's streams to these.
    result["streams"], result["solo"] = done, solo
    bad = [d for dt in NEAR_TIE for d in result["diverged"][dt]
           if d["margin"] >= NEAR_TIE[dt]]
    if (not run["ok"] or bad or not exact["ok"] or not graph["ok"]
            or run["launches"]["int8_matmul"] < 1
            or run["launches"]["paged_attention"] < 1):
        raise SystemExit(f"serve failed: run_ok={run['ok']} bad={bad} "
                         f"launches={run['launches']} exact={exact} "
                         f"graph={graph}")
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
# Each timed serve runs this many times in its phase: the median and the
# spread of tokens/s between runs of one call (PERF.md section 7, noise).
TIMED_RUNS = 3


def _serve_runs(torch, kernels, serving, params, cfg, reqs,
                kw=SERVE_KW) -> dict:
    """One warm-up serve of two other requests, then ``reqs`` through
    serve() at batch 8 TIMED_RUNS times, the launch counts set to 0 just
    before each run and read just after. Each run builds its own pool and
    so captures its own graphs. Held: every stream complete and in the
    vocabulary, the runs' streams and launch counts the same. The last
    run's decode chunks (the serve.decode_chunk spans, each ending in the
    chunk's one host read) are summed: the rest of the wall time is the
    eager prefill chunks and the rounds' host work."""
    from tpu_bootstrap_torch import telemetry

    serving.serve(params, cfg, _serve_requests(serving, cfg.vocab_size, 2,
                                               seed=1), 8, **kw)
    runs = []
    for _ in range(TIMED_RUNS):
        stats: dict = {}
        before = telemetry.spans()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = serving.serve(params, cfg, reqs, 8, stats=stats, **kw)
        torch.cuda.synchronize()
        runs.append((done, time.perf_counter() - t0, dict(kernels.LAUNCHES),
                     stats))
        seen = {id(r) for r in before}
        decode_s = sum(r["dur_ms"] for r in telemetry.spans()
                       if id(r) not in seen
                       and r["name"] == "serve.decode_chunk") / 1e3
    done, wall, launches, stats = runs[-1]
    tokens = sum(len(v) for v in done.values())
    tps = [tokens / wall for _, wall, _, _ in runs]
    shape_ok = (sorted(done) == sorted(r.rid for r in reqs) and all(
        len(done[r.rid]) == r.max_new
        and all(0 <= t < cfg.vocab_size for t in done[r.rid])
        for r in reqs))
    agree = {"streams": all(d == done for d, _, _, _ in runs),
             "launches": all(n == launches for _, _, n, _ in runs)}
    return {"done": done, "requests": len(reqs), "tokens": tokens,
            "wall_s": [wall for _, wall, _, _ in runs],
            "tokens_per_s": statistics.median(tps), "tokens_per_s_runs": tps,
            "tokens_per_s_spread": max(tps) - min(tps),
            "decode_chunk_s": decode_s, "decode_chunk_share": decode_s / wall,
            "launches": launches, "runs_agree": agree, "shape_ok": shape_ok,
            "graphs": stats.get("graphs"), "stats": stats,
            "ok": shape_ok and all(agree.values())}


def _run_fields(run: dict) -> dict:
    """What a phase prints of _serve_runs: all but the streams and the
    pool's stats."""
    return {k: v for k, v in run.items() if k not in ("done", "stats")}


# Each weight format's launch counters: (block projections, expert stacks
# or None, the head).
PATHS = {"int8": ("int8_matmul", None, "int8_matmul"),
         "int4": ("int4_matmul", None, "int8_matmul"),
         "moe_int8": ("int8_matmul", "int8_expert_matmul", "int8_matmul"),
         "moe_int4": ("int4_matmul", "int4_expert_matmul", "int8_matmul")}


def _launches_exact(cfg, stats: dict, launches: dict, path: tuple,
                    batch: int = 8) -> dict:
    """The launches a serve must count, from its schedule alone: a decode
    step (slot_steps / batch of them) launches per layer four projections
    (fused wqkv, or wq, wk and wv apart in a MoE block, and wo; w_up and
    w_down, or the two expert stacks), K2, and the head once; a prefill
    chunk the same per layer without K2 and the head (its attention is an
    einsum over the gathered window). Replays count as launches."""
    proj, expert, head = path
    steps = stats["slot_steps"] // batch
    chunks = stats["prefill_chunks"]
    passes = cfg.num_layers * (steps + chunks)
    want = {"paged_attention": cfg.num_layers * steps, proj: 4 * passes}
    if expert:
        want[expert] = 2 * passes
    want[head] = want.get(head, 0) + steps
    got = {k: launches[k] for k in want}
    return {"ok": got == want, "want": want, "got": got,
            "decode_steps": steps, "prefill_chunks": chunks}


def _clone_pools(pools) -> list:
    return [{n: a.clone() for n, a in layer.items()} for layer in pools]


def _paged_graph_check(torch, serving, params, cfg, reqs) -> dict:
    """Graph == eager on the card: a pool driven mid-serve (``reqs`` at
    batch 8) until a decode chunk of at least 2 steps over at least 4 rows
    is due at a table width whose step is already captured, then that
    chunk through the captured step and through the eager loop
    _paged_chunk_kernel on a clone of the pools. The tokens and every byte of blocks 1.. of every
    pool tensor must be equal. The null block 0 is reported beside them:
    dummy and overshooting rows write it with duplicate indices, whose
    order is undefined, and no mask ever admits it."""
    pool = serving.PagedPool(params, cfg, 8, kv_quant=True,
                             prefix_cache=False)
    pending = list(reqs)
    for _ in range(400):
        while pending and pool.admits(pending[0]):
            pool.admit(pending.pop(0))
        pool._prefill_phase()
        dec = pool._decoding()
        if dec:
            chunk = pool._chunk_len(dec)
            bt, last, pos = pool._decode_inputs(dec, chunk)
            if (chunk > 1 and len(dec) >= 4
                    and bt.shape[1] in pool._graphs._graphs):
                break
        pool.step_round()
    else:
        raise SystemExit("graph check: no captured width mid-serve")
    out = _chunk_vs_eager(torch, serving, pool, params, cfg, chunk, bt, last,
                          pos, len(dec))
    del pool
    return out


def _chunk_vs_eager(torch, serving, pool, params, cfg, chunk, bt, last,
                    pos, rows: int) -> dict:
    """One decode chunk of ``pool`` through its captured step (the table's
    width already captured) against the eager loop _paged_chunk_kernel on
    a clone of the pools: the tokens and every byte of blocks 1.. of every
    pool tensor must be equal (the null block, written by dummy and
    overshooting rows with duplicate indices in no defined order, is
    reported beside them)."""
    twin = _clone_pools(pool.pools)
    want = serving._paged_chunk_kernel(params, twin, bt, last.to(bt.device),
                                       pos.to(bt.device), cfg, chunk).tolist()
    replays = pool._graphs.stats["replays"]
    got = pool._decode_chunk(bt, last, pos, chunk)
    torch.cuda.synchronize()
    pairs = [(a, b) for la, lb in zip(pool.pools, twin)
             for a, b in zip(la.values(), lb.values())]
    out = {"chunk": chunk, "nb": bt.shape[1],
           "rows": rows,
           "replays": pool._graphs.stats["replays"] - replays,
           "tokens_equal": got == want,
           "pool_bytes_equal": all(torch.equal(a[1:], b[1:])
                                   for a, b in pairs),
           "null_block_equal": all(torch.equal(a[0], b[0]) for a, b in pairs),
           "graphs": dict(pool._graphs.stats)}
    out["ok"] = (out["tokens_equal"] and out["pool_bytes_equal"]
                 and out["replays"] == chunk)
    return out


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


def phase_serve_int4(torch, kernels, device, model_kw=DECODE_MODEL) -> dict:
    """The serve phase's workload with int4 weights (quantize_params4,
    group 64, int8 head, the reference's WORKLOAD_QUANT=int4): every block
    projection on K6, the head on K1, attention on K2, the launches held
    to the schedule. Every stream is held to the port's solo greedy
    generate, which runs the same K6 launches and differs only in how it
    attends, in bf16 and again in f32: a divergence is accepted only at a
    near-tie (NEAR_TIE). Then graph == eager, as in serve."""
    import dataclasses

    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params4(
        model.init_params(cfg, seed=0, device=device), group=INT4_GROUP,
        head="int8")
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    run = _serve_runs(torch, kernels, serving, params, cfg, reqs)
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
    graph = _paged_graph_check(torch, serving, params, cfg, reqs)
    exact = _launches_exact(cfg, run["stats"], run["launches"], PATHS["int4"])
    result = {"phase": "serve_int4", "group": INT4_GROUP, "head": "int8",
              **_run_fields(run), "launches_exact": exact,
              "decode_stream_bytes": quant.decode_stream_bytes(params),
              "near_tie": NEAR_TIE,
              "diverged": {"bfloat16": diverged, "float32": diverged32},
              "graph_vs_eager": graph, "profile": profile}
    emit(result)
    bad = [d for dt in NEAR_TIE for d in result["diverged"][dt]
           if d["margin"] >= NEAR_TIE[dt]]
    if (not run["ok"] or bad or not exact["ok"] or not graph["ok"]
            or not _path_launches_ok(run["launches"], path)):
        raise SystemExit(f"serve_int4 failed: run_ok={run['ok']} bad={bad} "
                         f"launches={run['launches']} exact={exact} "
                         f"graph={graph}")
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


def phase_serve_moe(torch, kernels, device, model_kw=DECODE_MODEL) -> dict:
    """The MoE decode model (the decode model's widths, 8 experts, top-2,
    capacity factor 2, random weights from a seed) served with int8 and
    with int4 weights on MOE_REQUESTS of the serve phase's requests,
    TIMED_RUNS times each. The reference's MoE streams are not its solo
    generate's (capacity is contested over each prefill chunk), so that is
    counted on the first MOE_SOLO, not held; held: every stream complete,
    every decode logit finite, every run and a watched serve bitwise the
    same, every kernel of the path launched as the schedule says, and
    graph == eager (_paged_graph_check)."""
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, **MOE_MODEL,
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
        run = _serve_runs(torch, kernels, serving, qparams, cfg, reqs)
        exact = _launches_exact(cfg, run["stats"], run["launches"],
                                PATHS["moe_" + fmt])
        graph = _paged_graph_check(torch, serving, qparams, cfg, reqs)
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
        out[fmt] = {**_run_fields(run), "launches_exact": exact,
                    "graph_vs_eager": graph,
                    "decode_stream_bytes": quant.decode_stream_bytes(qparams),
                    "logits_finite": finite, "deterministic": deterministic,
                    "expert_launch_shapes": shapes,
                    "differ_from_solo_generate": f"{solo_differ} of "
                                                 f"{MOE_SOLO}",
                    "profile": profile}
        if not (run["ok"] and finite and deterministic and exact["ok"]
                and graph["ok"] and _path_launches_ok(run["launches"], path)):
            failed.append(fmt)
    emit(out)
    if failed:
        raise SystemExit(f"serve_moe failed for {failed}: "
                         f"{ {f: out[f] for f in failed} }")
    return out


# bench.py:867-889's prefix-cache traffic: 24 requests sharing one
# 192-token system prompt (three full blocks of 64) plus 8 unique tokens
# each, max_new 16, seed 13, batch 8, block 64.
PREFIX_REQUESTS, PREFIX_SYSTEM, PREFIX_TAIL, PREFIX_NEW = 24, 192, 8, 16
PREFIX_KW = dict(paged=True, kv_quant=True, overcommit=False)
PREFIX_HIT_RATE = 0.5  # the reference's gate (tests/test_prefix_cache.py:206)


def _prefix_requests(serving, vocab: int) -> list:
    rng = np.random.default_rng(13)
    sysp = rng.integers(1, vocab, PREFIX_SYSTEM).tolist()
    return [serving.Request(
        rid=i, tokens=sysp + rng.integers(1, vocab, PREFIX_TAIL).tolist(),
        max_new=PREFIX_NEW) for i in range(PREFIX_REQUESTS)]


def phase_serve_prefix(torch, kernels, device,
                       model_kw=DECODE_MODEL) -> dict:
    """The prefix cache on bench.py's shared-system-prompt traffic, on the
    decode model at full width (bf16, int8 weights from seed 0; main runs
    it at CUT_MODEL's depth, DEPTH_CUT): served
    with the cache (the default, with the host tier under it) and cold
    (prefix_cache=False),
    TIMED_RUNS times each. Held: the hit rate above PREFIX_HIT_RATE; the
    cached streams equal the cold ones, and every stream its solo
    generate(kv_kernel=False), except at a near-tie (NEAR_TIE, by the
    solo run's margin): a cached row attends over blocks another row
    prefilled in other chunk widths, whose einsum attention may round
    otherwise; every K2 launch a decode step's, the runs alike; the host
    tier idle (the pool never evicts)."""
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    reqs = _prefix_requests(serving, cfg.vocab_size)
    out = {"phase": "serve_prefix", "requests": len(reqs),
           "system_prompt": PREFIX_SYSTEM, "tail": PREFIX_TAIL,
           "max_new": PREFIX_NEW}
    for mode, cache in (("cached", True), ("cold", False)):
        run = _serve_runs(torch, kernels, serving, params, cfg, reqs,
                          kw={**PREFIX_KW, "prefix_cache": cache})
        st = run["stats"]
        out[mode] = {**_run_fields(run),
                     "launches_exact": _launches_exact(
                         cfg, st, run["launches"], PATHS["int8"]),
                     **{k: st[k] for k in (
                         "prompt_tokens", "prefix_hit_tokens",
                         "prefix_hit_requests", "cow_copies", "blocks_peak",
                         "prefill_tokens", "rounds")},
                     "hit_rate": st["prefix_hit_tokens"] / st["prompt_tokens"],
                     "evictions": st["allocator"]["evictions"],
                     "host": st.get("host")}
        out[mode]["done"] = run["done"]
    cached, cold = out["cached"].pop("done"), out["cold"].pop("done")
    solo = _solo_streams(decode, params, cfg, reqs)
    out["cached_vs_cold"] = _diverged(decode, params, cfg, reqs, cached, cold)
    out["cached_vs_solo"] = _diverged(decode, params, cfg, reqs, cached, solo)
    out["cold_vs_solo"] = _diverged(decode, params, cfg, reqs, cold, solo)
    out["near_tie"] = NEAR_TIE["bfloat16"]
    out["speedup"] = (out["cached"]["tokens_per_s"]
                      / out["cold"]["tokens_per_s"])
    emit(out)
    bad = [d for key in ("cached_vs_cold", "cached_vs_solo", "cold_vs_solo")
           for d in out[key] if d["margin"] >= NEAR_TIE["bfloat16"]]
    runs_ok = all(out[m]["ok"] and out[m]["launches_exact"]["ok"]
                  for m in ("cached", "cold"))
    # The host tier is on with the cache (the default) and must stay idle:
    # the pool never evicts (32 of 64 blocks at peak).
    host = out["cached"]["host"]
    idle = host is not None and host["swap_outs"] == 0 == host["swap_ins"]
    if (bad or not runs_ok or out["cached"]["hit_rate"] <= PREFIX_HIT_RATE
            or out["cold"]["prefix_hit_tokens"] != 0 or not idle):
        raise SystemExit(f"serve_prefix failed: bad={bad} runs_ok={runs_ok} "
                         f"hit_rate={out['cached']['hit_rate']} host={host}")
    return out


# bench.py:1060-1190's overcommit traffic: 8-token prompts under one declared
# budget (64) that the attractor eos makes most rows finish far short of,
# at block 16 (at block 64 an 8 + 64 footprint is 2 blocks and overcommit
# has nothing to save).
OC_BLOCK, OC_PROMPT, OC_NEW = 16, 8, 64
OC_BURST, OC_SEED = 24, 19  # the burst: batch 24, a third of its footprint
OC_TIGHT, OC_TIGHT_SEED, OC_TIGHT_BATCH, OC_TIGHT_BLOCKS = 12, 29, 16, 16
# bench.py:951-1057's host-tier traffic at block 16: a working set of ten
# 40-token prompts (two full blocks each and an 8-token tail), then a burst
# of 12 requests of 8 tokens meant to preempt.
HT_BLOCK, HT_PROMPTS, HT_SEED, HT_LEN, HT_NEW, HT_POOL = 16, 10, 37, 40, 8, 64
HT_BURST, HT_BURST_SEED, HT_BURST_NEW, HT_BURST_BLOCKS = 12, 43, 24, 12
# Phase B's host hits over its prompt tokens: 2 full blocks of 16 in each
# 40-token prompt. It depends on the lengths, the block and the pool sizes
# alone; tests/test_torch_host_tier.py computes it with both packages.
HOST_HIT_RATE = 0.8
# Timed single-block transfers for the host-link rate.
XFER_REPEATS = 20


def _burst(serving, vocab: int, n: int, seed: int, rid0: int = 0,
           max_new: int = OC_NEW) -> list:
    """bench.py:1077-1086's burst_workload (and, with rid0 200 and
    max_new 24, :1001-1008's ht_burst)."""
    rng = np.random.default_rng(seed)
    return [serving.Request(rid=rid0 + i,
                            tokens=rng.integers(1, vocab, OC_PROMPT).tolist(),
                            max_new=max_new) for i in range(n)]


def _attractor_eos(decode, serving, params, cfg, device) -> int:
    """bench.py:1093-1095: the token greedy decoding of this random init
    settles on, the most common last token of 16 steps from 4 burst
    prompts, with the port's generate."""
    prompts = [r.tokens for r in _burst(serving, cfg.vocab_size, 4, OC_SEED)]
    out = decode.generate(params, prompts, cfg, 16, kv_quant=True,
                          device=device)
    return int(np.bincount(out[:, -1].cpu().numpy()).argmax())


def _sched_run(torch, kernels, serving, pool, sched, reqs) -> dict:
    """``reqs`` submitted to ``sched`` at once and stepped to the end, the
    launch counts set to 0 just before and read just after: the streams,
    each request's first-token time from the submission (host clock,
    ms), the wall time and the launches."""
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, done = {}, {}
    for r in reqs:
        sched.submit(r)
    while sched.pending() or pool.has_active():
        for rid, ev in sched.step().items():
            if ev["new"] and rid not in first:
                first[rid] = (time.perf_counter() - t0) * 1e3
            if ev["done"]:
                done[rid] = ev["generated"]
    torch.cuda.synchronize()
    return {"done": done, "first_ms": first,
            "wall_s": time.perf_counter() - t0,
            "launches": dict(kernels.LAUNCHES)}


def _p(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else -1.0


def _graphs_of(pool):
    return None if pool._graphs is None else dict(pool._graphs.stats)


def _path_ok(cfg, pool, run: dict, batch: int, since=None) -> dict:
    """Both kernels of the int8 path launched in the run, and exactly as
    its schedule implies (``since``: the pool's stats before the run)."""
    st = dict(pool.stats)
    if since is not None:
        st = {k: st[k] - since[k] for k in ("slot_steps", "prefill_chunks")}
    exact = _launches_exact(cfg, st, run["launches"], PATHS["int8"], batch)
    exact["ok"] = exact["ok"] and _path_launches_ok(
        run["launches"], ("int8_matmul", "paged_attention"))
    return exact


def _streams_vs(decode, params, cfg, reqs, got: dict, want: dict) -> dict:
    """Streams against a reference run (``want``: a never-preempted run,
    solo generate): the divergent ones, each with the oracle's margin;
    bad ones at or above the near-tie limit."""
    div = _diverged(decode, params, cfg, reqs, got, want)
    return {"differ": div, "bad": [d for d in div
                                   if d["margin"] >= NEAR_TIE["bfloat16"]]}


def phase_serve_overcommit(torch, kernels, device, model_kw=DECODE_MODEL) -> dict:
    """Overcommit admission on bench.py:1060-1190's traffic, on the decode
    model at full width (bf16, int8 weights from seed 0, the int8 KV pool,
    the main path's, where bench.py runs bf16 weights and a float pool).
    At block 16 and equal memory (a
    third of the 24-request burst's whole footprint), batch 24, eos the
    attractor token: the concurrent admissions of overcommit over refusal
    admission (the admit ratio, which must exceed 1), then the burst served
    under each policy after a warm pass, TTFT p99, queue-wait p50,
    preemptions, grown blocks. Then the tight pool (12 requests, batch 16,
    16 blocks, expected_new 2) with the host tier off and on (_tier_pair),
    which must preempt, and swap with the tier on: the recompute tokens,
    the resume gap p50, each arm's resume cost (serve_host_tier reads
    them). Every stream is held to the same request served in a roomy pool
    with overcommit off, and that roomy run to solo generate, up to a
    near-tie; each measured run launches K1 and K2 exactly as its schedule
    implies."""
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    eos = _attractor_eos(decode, serving, params, cfg, device)
    reqs = _burst(serving, cfg.vocab_size, OC_BURST, OC_SEED)
    blocks = max(2, sum(-(-(OC_PROMPT + r.max_new) // OC_BLOCK)
                        for r in reqs) // 3)

    def pool(batch=OC_BURST, kv_blocks=blocks):
        return serving.PagedPool(params, cfg, batch, block_size=OC_BLOCK,
                                 kv_blocks=kv_blocks, eos_id=eos,
                                 kv_quant=True, device=device)

    out = {"phase": "serve_overcommit", "eos_id": eos, "kv_blocks": blocks,
           "block_size": OC_BLOCK, "requests": len(reqs)}
    admits = {}
    for oc in (True, False):
        p = pool()
        sched = serving.Scheduler(p, overcommit=oc)
        admits[oc] = 0
        for r in reqs:
            res = sched.expected_new(r)
            if p.admits(r, reserve_new=res):
                p.admit(r, reserve_new=res)
                admits[oc] += 1
    out["concurrent_admits"] = {"overcommit": admits[True],
                                "refusal": admits[False]}
    out["admit_ratio"] = admits[True] / max(admits[False], 1)
    roomy = serving.serve(params, cfg, reqs, OC_BURST, paged=True,
                          kv_quant=True, block_size=OC_BLOCK, eos_id=eos,
                          overcommit=False, device=device)
    out["roomy_vs_solo"] = _streams_vs(
        decode, params, cfg, reqs, roomy,
        _solo_streams(decode, params, cfg, reqs, eos))
    failed = ["roomy"] if out["roomy_vs_solo"]["bad"] else []
    for name, oc in (("overcommit", True), ("refusal", False)):
        for _warm in (True, False):
            p = pool()
            sched = serving.Scheduler(p, overcommit=oc)
            run = _sched_run(torch, kernels, serving, p, sched, reqs)
        tokens = sum(len(v) for v in run["done"].values())
        out[name] = {
            "ttft_p99_ms": _p(list(run["first_ms"].values()), 0.99),
            "queue_wait_p50_ms": sched.queue_wait_p50_ms(),
            "preemptions": p.stats["preemptions"],
            "grown_blocks": p.stats["grown_blocks"],
            "wall_s": run["wall_s"], "tokens": tokens,
            "tokens_per_s": tokens / run["wall_s"],
            "rounds": p.stats["rounds"], "launches": run["launches"],
            "launches_exact": _path_ok(cfg, p, run, OC_BURST),
            "graphs": _graphs_of(p),
            "vs_roomy": _streams_vs(decode, params, cfg, reqs, run["done"],
                                    roomy)}
        if (out[name]["vs_roomy"]["bad"]
                or not out[name]["launches_exact"]["ok"]
                or sorted(run["done"]) != sorted(r.rid for r in reqs)):
            failed.append(name)
    tight_reqs = _burst(serving, cfg.vocab_size, OC_TIGHT, OC_TIGHT_SEED)
    tight_roomy = serving.serve(params, cfg, tight_reqs, OC_TIGHT_BATCH,
                                paged=True, kv_quant=True,
                                block_size=OC_BLOCK, eos_id=eos,
                                overcommit=False, device=device)
    out["tight"] = _tier_pair(
        torch, kernels, decode, serving, params, cfg, device, tight_reqs,
        OC_TIGHT_BATCH, OC_TIGHT_BLOCKS, eos,
        _solo_streams(decode, params, cfg, tight_reqs, eos), tight_roomy)
    failed += [f"tight:{f}" for f in out["tight"].pop("failed")]
    on = out["tight"]["tier_on"]
    if on["preemptions"] < 1 or on["swap_preempts"] < 1:
        failed.append("tight:no preemption or no swap")
    if out["admit_ratio"] <= 1:
        failed.append("admit_ratio")
    out["near_tie"] = NEAR_TIE["bfloat16"]
    emit(out)
    if failed:
        raise SystemExit(f"serve_overcommit failed: {failed}")
    return out


@contextlib.contextmanager
def _observed(registry, name: str):
    """The values observed into the histogram ``name`` (unlabelled) inside
    the block, exactly (the histogram keeps buckets)."""
    with _observed_many(registry, (name,)) as seen:
        yield seen[name]


@contextlib.contextmanager
def _observed_many(registry, names: tuple):
    """The values observed into each unlabelled histogram of ``names``
    inside the block, by name."""
    values = {n: [] for n in names}
    real = registry.observe

    def observe(metric, value, *args, **kw):
        if metric in values and not kw.get("labels"):
            values[metric].append(value)
        return real(metric, value, *args, **kw)

    registry.observe = observe
    try:
        yield values
    finally:
        del registry.observe


def _ht_drive(pool, reqs) -> dict:
    """bench.py:964-969: admit in order while the pool takes the queue's
    head, one round, again."""
    queue, done = list(reqs), {}
    while queue or pool.has_active():
        while queue and pool.admits(queue[0]):
            pool.admit(queue.pop(0))
        for rid, ev in pool.step_round().items():
            if ev["done"]:
                done[rid] = ev["generated"]
    return done


def _ht_prompts(vocab: int) -> list:
    rng = np.random.default_rng(HT_SEED)
    return [rng.integers(1, vocab, HT_LEN).tolist()
            for _ in range(HT_PROMPTS)]


def _watch_restores(torch, pool, log: list) -> None:
    """Wrap the pool's batched restore: each call's milliseconds (it waits
    for the device), and whether every restored block holds, bitwise, the
    host payload it was promoted from, in every pool tensor."""
    real = pool._host_restore

    def watched(ids, entries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = real(ids, entries)
        ms = (time.perf_counter() - t0) * 1e3
        idx = torch.tensor(ids, device=pool.device)
        equal = all(torch.equal(a[idx].cpu(), torch.stack(
                        [e["t"][li][n] for e in entries]))
                    for li, layer in enumerate(pool.pools)
                    for n, a in layer.items())
        log.append({"ms": ms, "blocks": len(ids), "bytes": moved,
                    "bytes_equal": equal})
        return moved

    pool._host_restore = watched


def _demote_all(torch, pool) -> dict:
    """Demote every cached block, holding each host payload bitwise to the
    block's bytes on the device just before."""
    want = {key: [{n: a[bid].to("cpu", copy=True)
                   for n, a in layer.items()}
                  for layer in pool.pools]
            for bid, key in pool.allocator._cached.items()}
    n = pool.demote_lru(pool.allocator.cached())
    equal = all(torch.equal(pool.host.get(k)["t"][li][n2], t)
                for k, layers in want.items() if k in pool.host
                for li, layer in enumerate(layers)
                for n2, t in layer.items())
    return {"demoted": n, "parked": len(pool.host), "bytes_equal": equal}


def _link_rate(torch, pool) -> dict:
    """The host link for one pool block: an entry of the host tier
    restored into a free block (the batched restore, one block, waiting
    for the device) and a block fetched off it, XFER_REPEATS times each;
    the median rates, GB/s. A free block's bytes are nobody's."""
    key = next(iter(pool.host.keys()))
    entry, bid = pool.host.get(key), pool.allocator._free[0]
    h2d, d2h = [], []
    for _ in range(XFER_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        type(pool)._host_restore(pool, [bid], [entry])
        h2d.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pool._host_fetch(bid)
        d2h.append(time.perf_counter() - t0)
    nbytes = entry["bytes"]
    return {"block_bytes": nbytes, "tensors": sum(len(t) for t in entry["t"]),
            "h2d_gbps": nbytes / statistics.median(h2d) / 1e9,
            "d2h_gbps": nbytes / statistics.median(d2h) / 1e9,
            "h2d_ms": statistics.median(h2d) * 1e3,
            "d2h_ms": statistics.median(d2h) * 1e3}


def _prefill_clock(torch, serving, params, cfg, device) -> dict:
    """The recompute arm's clock: the prefill phase's host time a token
    (what the pool's EMA reads, no sync) against the same phase timed to
    the device's end, for one 40-token prompt, twice (the second after the
    first has warmed the chunk widths)."""
    out = []
    prompt = _ht_prompts(cfg.vocab_size)[0]
    for i in range(2):
        pool = serving.PagedPool(params, cfg, 1, block_size=HT_BLOCK,
                                 kv_quant=True, prefix_cache=False,
                                 device=device)
        pool.admit(serving.Request(rid=i, tokens=prompt, max_new=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool._prefill_phase()
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) * 1e3 / (len(prompt) - 1)
        out.append({"ema_ms_per_tok": pool._prefill_ms_per_tok,
                    "synced_ms_per_tok": synced})
    return {"runs": out}


def phase_serve_host_tier(torch, kernels, device, tight: dict,
                          model_kw=DECODE_MODEL) -> dict:
    """The host tier on bench.py:951-1057's traffic at block 16, on the
    decode model at full width (bf16, int8 weights from seed 0, the int8
    KV pool, the main path's, where bench.py has bf16 weights and a float
    pool). The working set: ten 40-token prompts (max_new 8,
    64 blocks, a host tier of 64), every cached block demoted, the same
    prompts again: the host hit rate over phase B's prompt tokens (must be
    HOST_HIT_RATE), the effective cache blocks; every demoted payload and
    every promoted block bitwise the device bytes they came from. The
    addresses: the same traffic on a pool that captured its steps, demoted
    and reset (zeroed in place), promotes into the zeroed pool, and a
    replayed decode chunk over the restored blocks equals the eager loop
    on a clone. The burst of bench.py:1001-1044 (12 requests of 8 tokens,
    max_new 24, 12 blocks, expected_new 2), tier off and on (_tier_pair),
    every stream held to its solo generate: at block 16 its admission
    watermark holds back every growth, so it never preempts, in the
    reference as in the port (tests/test_torch_host_tier.py). The swap arm
    against the recompute arm is read from ``tight``, serve_overcommit's
    tight pair (bench.py:1160-1172's tight pool, tier off and on, run
    once there, where it must swap). Then the host link's rate for one
    block each way (the port's TPUBC_HOST_XFER_GBPS seed) and the
    prefill clock."""
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    prompts = _ht_prompts(cfg.vocab_size)

    def working_pool():
        return serving.PagedPool(params, cfg, 8, block_size=HT_BLOCK,
                                 kv_blocks=HT_POOL, host_blocks=HT_POOL,
                                 kv_quant=True, device=device)

    def phase_reqs(rid0):
        return [serving.Request(rid=rid0 + i, tokens=t, max_new=HT_NEW)
                for i, t in enumerate(prompts)]

    out, failed = {"phase": "serve_host_tier", "block_size": HT_BLOCK}, []
    pool = working_pool()
    _ht_drive(pool, phase_reqs(0))
    demote = _demote_all(torch, pool)
    link = _link_rate(torch, pool)
    restores: list = []
    _watch_restores(torch, pool, restores)
    hh0 = pool.stats.get("host_hit_tokens", 0)
    pt0 = pool.stats["prompt_tokens"]
    since = dict(pool.stats)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _ht_drive(pool, phase_reqs(100))
    torch.cuda.synchronize()
    run = {"launches": dict(kernels.LAUNCHES),
           "wall_s": time.perf_counter() - t0}
    ws = {"demote": demote,
          "host_hit_rate": (pool.stats.get("host_hit_tokens", 0) - hh0)
          / max(pool.stats["prompt_tokens"] - pt0, 1),
          "effective_cache_blocks": pool.allocator.cached() + len(pool.host),
          "restores": len(restores),
          "restored_blocks": sum(r["blocks"] for r in restores),
          "restore_bytes_equal": all(r["bytes_equal"] for r in restores),
          "restore_ms_p50": _p([r["ms"] for r in restores], 0.5),
          "host": pool.host.snapshot_json(), "wall_s": run["wall_s"],
          "launches": run["launches"],
          "launches_exact": _path_ok(cfg, pool, run, 8, since),
          "graphs": _graphs_of(pool)}
    out["working_set"] = ws
    if (ws["host_hit_rate"] != HOST_HIT_RATE or not demote["bytes_equal"]
            or not ws["restore_bytes_equal"] or not restores
            or not ws["launches_exact"]["ok"]):
        failed.append("working_set")
    out["addresses"] = _restore_addresses(torch, serving, params, cfg,
                                          working_pool, phase_reqs)
    if not out["addresses"]["ok"]:
        failed.append("addresses")
    burst = _burst(serving, cfg.vocab_size, HT_BURST, HT_BURST_SEED, 200,
                   HT_BURST_NEW)
    out["burst"] = _tier_pair(torch, kernels, decode, serving, params, cfg,
                              device, burst, 8, HT_BURST_BLOCKS, None,
                              _solo_streams(decode, params, cfg, burst))
    failed += [f"burst:{f}" for f in out["burst"].pop("failed")]
    # The swap arm against the recompute arm, each resume's whole cost, from
    # serve_overcommit's tight pair (the same traffic, run once).
    out["swap_vs_recompute"] = {
        arm: {k: tight[run][k] for k in (
            "preemptions", "swap_preempts", "swap_out_blocks",
            "swap_in_blocks", "resumes", "resume_redo_tokens",
            "resume_priced_ms_p50", "restore_ms_p50", "prefill_ms_per_tok")}
        for arm, run in (("recompute", "tier_off"), ("swap", "tier_on"))}
    out["link"] = link
    out["prefill_clock"] = _prefill_clock(torch, serving, params, cfg,
                                          device)
    out["near_tie"] = NEAR_TIE["bfloat16"]
    emit(out)
    if failed:
        raise SystemExit(f"serve_host_tier failed: {failed}")
    return out


def _tier_pair(torch, kernels, decode, serving, params, cfg, device, reqs,
               batch: int, kv_blocks: int, eos, solo: dict,
               never=None) -> dict:
    """``reqs`` through an overcommitted pool (expected_new 2) of
    ``kv_blocks`` blocks of HT_BLOCK, tier off and on (HT_POOL blocks),
    each stream held to its solo generate (``solo``), to a never-preempted
    serve (``never``, when given; itself held to ``solo``) and the two
    runs to each other, near-ties allowed. Each run: preemptions, swaps,
    grown blocks, requeues, the recompute tokens and the resume gap p50,
    the restore ms p50 (timed, waiting for the device), and each resume's
    whole cost: its restore's ms plus its re-prefilled tokens at the
    pool's prefill price (the dispatch-timed EMA the recompute arm reads,
    as bench.py:1023-1030 prices them; a price, not a timed prefill)."""
    from tpu_bootstrap_torch import telemetry

    out, failed, done = {}, [], {}
    if never is not None:
        out["never_vs_solo"] = _streams_vs(decode, params, cfg, reqs, never,
                                           solo)
        if out["never_vs_solo"]["bad"]:
            failed.append("never_vs_solo")
    for name, host_blocks in (("tier_off", 0), ("tier_on", HT_POOL)):
        p = serving.PagedPool(params, cfg, batch, block_size=HT_BLOCK,
                              kv_blocks=kv_blocks, host_blocks=host_blocks,
                              eos_id=eos, kv_quant=True, device=device)
        sched = serving.Scheduler(p, overcommit=True, expected_new=2)
        resumes, restores = [], []
        _watch_restores(torch, p, restores)
        real_admit = p.admit

        def admit(r, real_admit=real_admit, p=p, resumes=resumes,
                  restores=restores, **kw):
            before = p.stats["prompt_tokens"] - p.stats["prefix_hit_tokens"]
            n = len(restores)
            real_admit(r, **kw)
            if kw.get("preload") is None:
                return
            redo = (p.stats["prompt_tokens"] - p.stats["prefix_hit_tokens"]
                    - before - 1)
            restore_ms = sum(x["ms"] for x in restores[n:])
            price = p._prefill_ms_per_tok
            resumes.append({
                "redo_tokens": redo, "restore_ms": restore_ms,
                "priced_ms": None if price is None
                else restore_ms + redo * price})

        p.admit = admit
        telemetry.metrics().reset()  # this run's counters alone
        with _observed(telemetry.metrics(), "serve_resume_gap_ms") as gaps:
            run = _sched_run(torch, kernels, serving, p, sched, reqs)
        m = telemetry.metrics().to_json()
        done[name] = run["done"]
        priced = [x["priced_ms"] for x in resumes
                  if x["priced_ms"] is not None]
        out[name] = {
            "preemptions": p.stats["preemptions"],
            "swap_preempts": p.stats.get("swap_preempts", 0),
            "swap_out_blocks": p.stats.get("swap_out_blocks", 0),
            "swap_in_blocks": p.stats.get("swap_in_blocks", 0),
            "grown_blocks": p.stats["grown_blocks"],
            "requeues": sched.stats["requeues"],
            "recompute_tokens": m.get("serve_preempt_recompute_tokens_total",
                                      0),
            "resume_gap_p50_ms": _p(gaps, 0.5), "resumes": len(resumes),
            "resume_redo_tokens": [x["redo_tokens"] for x in resumes],
            "resume_priced_ms_p50": _p(priced, 0.5),
            "restore_ms_p50": _p([r["ms"] for r in restores], 0.5),
            "restores": len(restores),
            "restore_bytes_equal": all(r["bytes_equal"] for r in restores),
            "host_gbps_ema": p._host_gbps_ema,
            "prefill_ms_per_tok": p._prefill_ms_per_tok,
            "wall_s": run["wall_s"], "launches": run["launches"],
            "launches_exact": _path_ok(cfg, p, run, batch),
            "graphs": _graphs_of(p),
            "vs_solo": _streams_vs(decode, params, cfg, reqs, run["done"],
                                   solo)}
        if never is not None:
            out[name]["vs_never_preempted"] = _streams_vs(
                decode, params, cfg, reqs, run["done"], never)
        if (out[name]["vs_solo"]["bad"]
                or out[name].get("vs_never_preempted", {}).get("bad")
                or not out[name]["launches_exact"]["ok"]
                or not out[name]["restore_bytes_equal"]
                or sorted(run["done"]) != sorted(r.rid for r in reqs)):
            failed.append(name)
    out["on_vs_off"] = _streams_vs(decode, params, cfg, reqs,
                                   done["tier_on"], done["tier_off"])
    if out["on_vs_off"]["bad"]:
        failed.append("on_vs_off")
    out["failed"] = failed
    return out


def _restore_addresses(torch, serving, params, cfg, working_pool,
                       phase_reqs) -> dict:
    """A pool that served phase A (its decode steps captured), every
    cached block demoted, then reset: the pool tensors zeroed in place.
    Phase B's first rows promote their prefixes back into the zeroed
    pool; once a decode chunk over at least 4 rows is due at a captured
    width, it runs through the captured step and, on a clone of the pools,
    through the eager loop (_chunk_vs_eager). A restore or a reset that
    rebound a pool tensor would leave the graphs reading other memory.
    Also held: every pool tensor's address unchanged across all of it."""
    pool = working_pool()
    _ht_drive(pool, phase_reqs(0))
    ptrs = [a.data_ptr() for layer in pool.pools for a in layer.values()]
    pool.demote_lru(pool.allocator.cached())
    pool.reset()
    pending = phase_reqs(300)
    for _ in range(100):
        while pending and pool.admits(pending[0]):
            pool.admit(pending.pop(0))
        pool._prefill_phase()
        dec = pool._decoding()
        if dec:
            chunk = pool._chunk_len(dec)
            bt, last, pos = pool._decode_inputs(dec, chunk)
            if (chunk > 1 and len(dec) >= 4
                    and bt.shape[1] in pool._graphs._graphs):
                break
        pool.step_round()
    else:
        raise SystemExit("serve_host_tier: no captured width after restore")
    promoted = pool.stats.get("swap_in_blocks", 0)
    out = _chunk_vs_eager(torch, serving, pool, params, cfg, chunk, bt, last,
                          pos, len(dec))
    out["promoted_blocks"] = promoted
    out["addresses_kept"] = ptrs == [a.data_ptr() for layer in pool.pools
                                     for a in layer.values()]
    out["ok"] = out["ok"] and out["addresses_kept"] and promoted > 0
    return out


# serve_faults: the serve phase's 32 requests through an explicit Scheduler
# (serve()'s settings: batch 8, block 64, prefix cache and overcommit off).
FAULT_BATCH = 8
# pool.device twice, alloc and sched.admit once each, mid-run: the 11th
# and 41st rounds that dispatch, the 13th block allocation (an admission)
# and the 21st admission.
FAULT_SCHEDULE = ("pool.device:1:10,pool.device:1:40,alloc:1:12,"
                  "sched.admit:1:20")
FAULT_FIRED = {"pool.device": 2, "alloc": 1, "sched.admit": 1}
GIVE_UP_RESTARTS = 3
# Deadlines run on a virtual clock that advances one second a round, so
# where they land follows from the schedule alone (the schedule is a
# function of the traffic's lengths). DL_QUEUED wait in priority class 0
# behind the other requests (class 1) and expire at round 3; DL_RUNNING
# (class 1, admitted first by EDF): rids 1 and 2 expire mid-decode (24 of
# 29 and 48 of 57 tokens), rid 0 while it prefills, rid 3 finishes first.
DL_QUEUED = tuple(range(24, 30))
DL_QUEUED_AT = 2.5
DL_RUNNING = {0: 10.5, 1: 1.5, 2: 16.5, 3: 12.5}


@contextlib.contextmanager
def _env(values: dict):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fault_sched(serving, params, cfg, device, observe: bool = True,
                 **pool_kw):
    """A pool with serve()'s settings and its Scheduler, the request log
    and the device ledger on or off (read when the Scheduler is built)."""
    flag = "1" if observe else "0"
    with _env({"TPUBC_REQUEST_EVENTS": flag, "TPUBC_DEVICE_LEDGER": flag}):
        pool = serving.PagedPool(params, cfg, FAULT_BATCH, kv_quant=True,
                                 **{"prefix_cache": False, **pool_kw},
                                 device=device)
        return pool, serving.Scheduler(pool, overcommit=False)


def _ledger_fields(sched, wall_s: float | None = None) -> dict:
    """The ledger of a run and what it implies over the whole run: the
    busy share, the MFU at 989 TFLOP/s, and the conservation checks (the
    per-request device ms plus the unattributed ms equal busy, busy plus
    idle equal wall, each within 1e-6 relative)."""
    led = dict(sched.ledger)
    per_rid = sum(rec.device_ms for rec in sched.log._recs.values())
    busy, wall = led["busy_ms"], led["wall_ms"]
    return {**led, "per_rid_device_ms": per_rid,
            "serve_engine_busy_frac": busy / wall,
            "serve_mfu": led["flops"] / (wall * 1e-3 * BF16_FLOPS),
            "conserves_per_rid": abs(per_rid + led["unattributed_ms"]
                                     - busy) <= 1e-6 * busy,
            "conserves_wall": abs(busy + led["idle_ms"] - wall)
            <= 1e-6 * wall,
            "run_wall_ms": None if wall_s is None else wall_s * 1e3}


def _observe_pair(torch, kernels, serving, params, cfg, device, reqs) -> dict:
    """(a): TIMED_RUNS runs with the request log and the ledger on and as
    many with both off, interleaved (on, off, on, ...), each on a pool of
    its own: the streams bitwise equal and the launch counts equal across
    all runs, tokens/s of each side, the ledger of the last run on; then
    one profiled run of the first PROFILED_REQUESTS requests with both on,
    its ledger's busy share beside the profiler's device busy share."""
    from tpu_bootstrap_torch import telemetry

    serving.serve(params, cfg, _serve_requests(serving, cfg.vocab_size, 2,
                                               seed=1), 8, **SERVE_KW)
    runs = {True: [], False: []}
    for _ in range(TIMED_RUNS):
        for on in (True, False):
            pool, sched = _fault_sched(serving, params, cfg, device, on)
            run = _sched_run(torch, kernels, serving, pool, sched, reqs)
            run.update(sched=sched, pool=pool)
            runs[on].append(run)
    last = runs[True][-1]
    tokens = sum(len(v) for v in last["done"].values())
    out = {}
    for on, name in ((True, "on"), (False, "off")):
        tps = [tokens / r["wall_s"] for r in runs[on]]
        out[name] = {"tokens_per_s": statistics.median(tps),
                     "tokens_per_s_runs": tps,
                     "tokens_per_s_spread": max(tps) - min(tps)}
    every = runs[True] + runs[False]
    out["streams_equal"] = all(r["done"] == last["done"] for r in every)
    out["launches_equal"] = all(r["launches"] == last["launches"]
                                for r in every)
    out["launches"] = last["launches"]
    out["launches_exact"] = _path_ok(cfg, last["pool"], last, FAULT_BATCH)
    out["ledger"] = _ledger_fields(last["sched"], last["wall_s"])
    off = runs[False][-1]["sched"]
    out["off_recorded_nothing"] = (off.ledger["rounds"] == 0
                                   and off.log.snapshot()["requests"] == [])
    gauges = telemetry.metrics().to_json()
    holder = {}

    def profiled():
        pool, sched = _fault_sched(serving, params, cfg, device)
        for r in reqs[:PROFILED_REQUESTS]:
            sched.submit(r)
        while sched.pending() or pool.has_active():
            sched.step()
        holder["sched"] = sched

    prof = _profile(torch, profiled, {"k1_ms": K1_KERNEL,
                                      "k2_ms": "paged_attention_kernel"})
    out["last_round_gauges"] = {k: gauges.get(k) for k in
                                ("serve_engine_busy_frac", "serve_mfu")}
    out["profiled"] = {
        "requests": PROFILED_REQUESTS,
        "ledger": _ledger_fields(holder["sched"]),
        "profiler_device_busy_share": prof["device_busy_ms"]
        / prof["wall_ms"],
        "profiler": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                          "idle_share", "k1_ms", "k2_ms")}}
    out["done"] = last["done"]
    out["ok"] = (out["streams_equal"] and out["launches_equal"]
                 and out["launches_exact"]["ok"]
                 and out["ledger"]["conserves_per_rid"]
                 and out["ledger"]["conserves_wall"]
                 and out["profiled"]["ledger"]["conserves_per_rid"]
                 and out["off_recorded_nothing"])
    return out


def _recovery_run(torch, kernels, decode, serving, params, cfg, device,
                  reqs, want: dict) -> dict:
    """(b): FAULT_SCHEDULE over the traffic, the prefix cache on (so a
    recovery salvages the rows' registered blocks): FAULT_FIRED fired,
    one recovery each, no live block left, every stream equal to the
    unfaulted run's up to a near-tie, K1 and K2 launched as the schedule
    implies; then a persistent fault on a small pool gives up with the
    fault after GIVE_UP_RESTARTS recoveries."""
    from tpu_bootstrap_torch import telemetry
    from tpu_bootstrap_torch.workload import faults

    pool, sched = _fault_sched(serving, params, cfg, device,
                               prefix_cache=True)
    inj = faults.install(FAULT_SCHEDULE)
    try:
        with _observed(telemetry.metrics(), "serve_recovery_ms") as rec_ms:
            run = _sched_run(torch, kernels, serving, pool, sched, reqs)
    finally:
        faults.install(None)
    out = {"schedule": FAULT_SCHEDULE, "fired": inj.stats()["fired"],
           "recoveries": sched.stats["recoveries"],
           "recovery_ms": rec_ms, "recovery_ms_p50": _p(rec_ms, 0.5),
           "crash_preempts": pool.stats.get("crash_preempts", 0),
           "prefix_hit_tokens": pool.stats["prefix_hit_tokens"],
           "live_blocks_after": pool.allocator.used(),
           "launches": run["launches"],
           "launches_exact": _path_ok(cfg, pool, run, FAULT_BATCH),
           "wall_s": run["wall_s"],
           "vs_unfaulted": _streams_vs(decode, params, cfg, reqs,
                                       run["done"], want)}
    with _env({"TPUBC_ENGINE_MAX_RESTARTS": str(GIVE_UP_RESTARTS)}):
        small, persistent = _fault_sched(serving, params, cfg, device)
    faults.install(",".join(f"pool.device:1:{i}" for i in range(12)))
    raised = None
    try:
        for r in reqs[:2]:
            persistent.submit(r)
        for _ in range(20):
            persistent.step()
    except faults.InjectedFault as e:
        raised = str(e)
    finally:
        faults.install(None)
    out["give_up"] = {"raised": raised,
                      "recoveries": persistent.stats["recoveries"]}
    out["ok"] = (out["fired"] == FAULT_FIRED
                 and out["recoveries"] == sum(FAULT_FIRED.values())
                 and out["live_blocks_after"] == 0
                 and sorted(run["done"]) == sorted(r.rid for r in reqs)
                 and not out["vs_unfaulted"]["bad"]
                 and out["launches_exact"]["ok"]
                 and raised is not None
                 and out["give_up"]["recoveries"] == GIVE_UP_RESTARTS)
    return out


def _deadline_run(torch, kernels, decode, serving, params, cfg, device,
                  reqs, want: dict) -> dict:
    """(c): the traffic with DL_QUEUED and DL_RUNNING's deadlines on the
    virtual clock: every queued one shed with no token, the running ones
    cancelled with a prefix of their unfaulted stream (up to a near-tie,
    at least one mid-decode), deadline_shed the number that expired, and
    the blocks a cancel freed allocated again to the cohort."""
    from tpu_bootstrap_torch import telemetry

    dl = [serving.Request(
        rid=r.rid, tokens=r.tokens, max_new=r.max_new,
        priority=0 if r.rid in DL_QUEUED else 1,
        deadline=(DL_QUEUED_AT if r.rid in DL_QUEUED
                  else DL_RUNNING.get(r.rid))) for r in reqs]
    pool, sched = _fault_sched(serving, params, cfg, device)
    freed, later = set(), set()
    cancel, alloc = pool.cancel, pool.allocator.alloc

    def watched_cancel(i, reason="deadline"):
        freed.update(pool.slots[i].blocks)
        return cancel(i, reason)

    def watched_alloc(n):
        ids = alloc(n)
        if freed:
            later.update(ids)
        return ids

    pool.cancel, pool.allocator.alloc = watched_cancel, watched_alloc
    clock = {"t": 0.0}
    telemetry.set_clock(lambda: clock["t"])
    done, expired = {}, {}
    try:
        kernels.reset_launches()
        for r in dl:
            sched.submit(r)
        while sched.pending() or pool.has_active():
            for rid, ev in sched.step().items():
                if ev["done"]:
                    done[rid] = ev["generated"]
                if ev.get("deadline"):
                    expired[rid] = clock["t"]
            clock["t"] += 1.0
        torch.cuda.synchronize()
    finally:
        telemetry.set_clock(None)
    cancelled = sorted(set(expired) - set(DL_QUEUED))
    mid = [rid for rid in cancelled
           if 0 < len(done[rid]) < next(r.max_new for r in dl
                                        if r.rid == rid)]
    prefix = _streams_vs(decode, params, cfg,
                         [r for r in dl if r.rid in cancelled],
                         {rid: done[rid] for rid in cancelled},
                         {rid: want[rid][:len(done[rid])]
                          for rid in cancelled})
    rest = [r for r in dl if r.rid not in expired]
    out = {"queued_shed": {rid: len(done[rid]) for rid in DL_QUEUED},
           "cancelled": {rid: len(done[rid]) for rid in cancelled},
           "cancelled_mid_decode": mid,
           "deadline_shed": sched.stats["deadline_shed"],
           "expired": len(expired), "rounds": pool.stats["rounds"],
           "freed_blocks": len(freed),
           "freed_blocks_reused": len(freed & later),
           "launches": dict(kernels.LAUNCHES),
           "prefix_vs_unfaulted": prefix,
           "rest_vs_unfaulted": _streams_vs(
               decode, params, cfg, rest, {r.rid: done[r.rid] for r in rest},
               want)}
    out["ok"] = (set(DL_QUEUED) <= set(expired)
                 and all(n == 0 for n in out["queued_shed"].values())
                 and mid and not prefix["bad"]
                 and not out["rest_vs_unfaulted"]["bad"]
                 and out["deadline_shed"] == len(expired)
                 and sorted(done) == sorted(r.rid for r in dl)
                 and out["freed_blocks_reused"] > 0
                 and pool.allocator.used() == 0)
    return out


def phase_serve_faults(torch, kernels, device, model_kw=DECODE_MODEL) -> dict:
    """The request log, the device ledger, crash recovery and deadlines on
    the serve phase's traffic (the decode model at full width, int8
    weights from seed 0, the int8 KV pool, block 64, batch 8, the 32
    requests of _serve_requests, seed 0), through an explicit Scheduler:
    (a) _observe_pair, (b) _recovery_run, (c) _deadline_run. The streams
    of (a)'s last run with both on are the unfaulted ones (b) and (c) are
    held to."""
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    out = {"phase": "serve_faults", "requests": len(reqs),
           "batch": FAULT_BATCH}
    out["observe"] = _observe_pair(torch, kernels, serving, params, cfg,
                                   device, reqs)
    want = out["observe"].pop("done")
    out["recovery"] = _recovery_run(torch, kernels, decode, serving, params,
                                    cfg, device, reqs, want)
    out["deadlines"] = _deadline_run(torch, kernels, decode, serving, params,
                                     cfg, device, reqs, want)
    out["near_tie"] = NEAR_TIE["bfloat16"]
    emit(out)
    failed = [k for k in ("observe", "recovery", "deadlines")
              if not out[k]["ok"]]
    if failed:
        raise SystemExit(f"serve_faults failed: {failed}")
    return out


# serve_ingress: the front door (workload/ingress.py) on serve's traffic.
INGRESS_BATCH = 8
INGRESS_KW = dict(paged=True, kv_quant=True, block_size=64,
                  prefix_cache=False, overcommit=False)
INGRESS_RUNS = 3  # timed bursts
OPEN_LOOP_LOAD = 0.5  # of the burst's median request rate
OPEN_LOOP_SEED = 1
PROFILEZ_MS = 1000
DEADLINE_MS, DEADLINE_LAST = 250, 4
DRAIN_REQUESTS, DRAIN_TIMEOUT_MS = 8, 200
ENTRY_REQUESTS, ENTRY_DEMO_REQUESTS = 4, 8
ENTRY_UP_S = 120
HTTP_S = 300  # every HTTP call's timeout


def _http(port: int, path: str, body=None, timeout: float = HTTP_S):
    """(status, headers, body) of one call to the ingress on localhost:
    JSON lines of a stream as a list, other JSON as itself, text as
    text."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            kind = r.headers.get("Content-Type", "")
            if kind == "application/jsonl":
                return r.status, r.headers, [json.loads(ln) for ln in r
                                             if ln.strip()]
            raw = r.read()
            return r.status, r.headers, (
                json.loads(raw) if kind == "application/json"
                else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


CONNECT_RETRIES = 5


def _client(port: int, body: dict, rec: dict) -> None:
    """One client: POST ``body`` streamed (or not), stamping on the host
    clock the POST, every token-bearing line and the end. A connection
    reset or refused before any byte of the answer (the HTTP server's
    listen backlog overflowing under a burst: the request never reached a
    handler) is retried, as a client would, up to CONNECT_RETRIES times;
    ``retries`` counts them."""
    import http.client
    import urllib.error
    import urllib.request

    rec["t_post"] = time.perf_counter()
    rec["lines"], rec["stamps"], rec["retries"] = [], [], 0
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    while True:
        try:
            with urllib.request.urlopen(req, timeout=HTTP_S) as r:
                rec["code"] = r.status
                if body.get("stream", True):
                    for ln in r:
                        if ln.strip():
                            rec["lines"].append(json.loads(ln))
                            rec["stamps"].append(time.perf_counter())
                else:
                    rec["lines"].append(json.loads(r.read()))
                    rec["stamps"].append(time.perf_counter())
        except urllib.error.HTTPError as e:
            rec["code"] = e.code
            rec["lines"].append(json.loads(e.read()))
            rec["stamps"].append(time.perf_counter())
        except Exception as e:  # noqa: BLE001 - counted as a failed stream
            reason = getattr(e, "reason", e)
            if (not rec["lines"] and rec["retries"] < CONNECT_RETRIES
                    and isinstance(reason, (ConnectionResetError,
                                            ConnectionRefusedError,
                                            http.client.RemoteDisconnected))):
                rec["retries"] += 1
                time.sleep(0.05 * 2 ** rec["retries"])
                continue
            rec["error"] = f"{type(e).__name__}: {e}"
        break
    rec["t_done"] = time.perf_counter()


def _ingress_traffic(port: int, bodies: list, offsets=None) -> dict:
    """Every body posted by a thread of its own: all at once, or each at
    its offset (s) from the start. Returns the records and the wall time
    from the first POST to the last end, with the client's TTFT,
    inter-token and total latency (ms) over the streams."""
    import threading

    recs = [{} for _ in bodies]
    t0 = time.perf_counter()

    def run(i):
        if offsets is not None:
            delay = t0 + offsets[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        _client(port, bodies[i], recs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_S)
    ttft, inter, total = [], [], []
    for rec in recs:
        stamps = [s for s, ln in zip(rec.get("stamps", []), rec["lines"])
                  if ln.get("tokens")]
        counts = [len(ln["tokens"]) for ln in rec["lines"] if ln.get("tokens")]
        if stamps:
            ttft.append((stamps[0] - rec["t_post"]) * 1e3)
            inter += [(b - a) * 1e3 / n for a, b, n
                      in zip(stamps, stamps[1:], counts[1:])]
        total.append((rec["t_done"] - rec["t_post"]) * 1e3)
    wall = max(r["t_done"] for r in recs) - min(r["t_post"] for r in recs)
    return {"recs": recs, "wall_s": wall,
            "connect_retries": sum(r.get("retries", 0) for r in recs),
            "tokens": sum(len(_rec_tokens(r)) for r in recs),
            "ttft_ms": {"p50": _p(ttft, 0.5), "p99": _p(ttft, 0.99)},
            "inter_token_ms": {"p50": _p(inter, 0.5), "p99": _p(inter, 0.99)},
            "total_ms": {"p50": _p(total, 0.5), "p99": _p(total, 0.99)}}


def _rec_tokens(rec: dict) -> list:
    return [t for ln in rec["lines"] for t in ln.get("tokens", [])]


def _final(rec: dict) -> dict:
    return rec["lines"][-1] if rec.get("lines") else {}


def _stats_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if isinstance(after[k], int)}


def _ingress_burst(torch, kernels, srv, cfg, reqs) -> dict:
    """One burst of ``reqs``, streamed, the launch counts set to 0 just
    before and read just after, held to the schedule the pool's stats
    imply over the burst."""
    before = dict(srv.pool.stats)
    kernels.reset_launches()
    run = _ingress_traffic(srv.port, [{"tokens": r.tokens,
                                       "max_new": r.max_new} for r in reqs])
    torch.cuda.synchronize()
    run["launches"] = dict(kernels.LAUNCHES)
    run["done"] = {r.rid: _rec_tokens(rec)
                   for r, rec in zip(reqs, run["recs"])}
    run["launches_exact"] = _launches_exact(
        cfg, _stats_delta(srv.pool.stats, before), run["launches"],
        PATHS["int8"], INGRESS_BATCH)
    run["tokens_per_s"] = run["tokens"] / run["wall_s"]
    return run


def _finals_ok(reqs, run: dict) -> bool:
    """Every stream complete, ending in a final object with done, timing,
    trace_id and cached_tokens 0."""
    return all(
        rec.get("code") == 200 and "error" not in rec
        and _final(rec).get("done") is True and "timing" in _final(rec)
        and _final(rec).get("trace_id") and _final(rec).get(
            "cached_tokens") == 0 and len(_rec_tokens(rec)) == r.max_new
        for r, rec in zip(reqs, run["recs"]))


def _trace_kernels(path: str) -> dict:
    """Device time (ms) in a torch.profiler Chrome trace: all kernels, K1's
    and K2's."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kern if all(f in e.get("name", "") for f in K1_KERNEL)]
    k2 = [e for e in kern if "paged_attention_kernel" in e.get("name", "")]
    return {"kernels": len(kern),
            "device_ms": sum(e.get("dur", 0) for e in kern) / 1e3,
            "k1_events": len(k1), "k1_ms": sum(e["dur"] for e in k1) / 1e3,
            "k2_events": len(k2), "k2_ms": sum(e["dur"] for e in k2) / 1e3}


def _open_loop(torch, decode, srv, params, cfg, reqs, rate: float,
               solo: dict, profile: bool) -> dict:
    """(c): ``reqs`` at Poisson arrivals of ``rate`` a second (gaps from
    numpy's default_rng(OPEN_LOOP_SEED)): the client's latencies and
    queue wait beside the server's windowed TTFT quantiles. With
    ``profile``, a /profilez capture of PROFILEZ_MS posted a quarter of
    the way into the arrivals: in profiler mode, with a busy share and an
    MFU, its Chrome trace holding K1 and K2 device time; the profiler's
    device share beside the ledger's busy share, and the capture's wall
    time from the POST to the answer (the engine thread stops the
    profiler and writes its trace between two rounds)."""
    import threading

    gaps = np.random.default_rng(OPEN_LOOP_SEED).exponential(1 / rate,
                                                             len(reqs))
    offsets = np.concatenate([[0.0], np.cumsum(gaps[:-1])]).tolist()
    prof = {}
    started = time.time()

    def capture():
        time.sleep(offsets[len(offsets) // 4])
        t0 = time.perf_counter()
        prof["answer"] = _http(srv.port, f"/profilez?ms={PROFILEZ_MS}", {})
        prof["wall_s"] = time.perf_counter() - t0

    pt = threading.Thread(target=capture)
    if profile:
        pt.start()
    run = _ingress_traffic(srv.port, [{"tokens": r.tokens,
                                       "max_new": r.max_new} for r in reqs],
                           offsets)
    if profile:
        pt.join(HTTP_S)
    torch.cuda.synchronize()
    run["done"] = {r.rid: _rec_tokens(rec)
                   for r, rec in zip(reqs, run["recs"])}
    waits = [_final(rec).get("timing", {}).get("queue_ms", -1.0)
             for rec in run["recs"]]
    window = math.ceil(run["wall_s"]) + 1
    server = {}
    for w in (60, window):
        series = _http(srv.port, f"/metrics.json?window={w}")[2]["series"]
        server[str(w)] = {k: series["serve_ttft_ms"][k]
                          for k in ("count_delta", "p50", "p99")}
    out = {"rate_per_s": rate, "requests": len(reqs),
           **{k: run[k] for k in ("wall_s", "tokens", "ttft_ms",
                                  "total_ms", "inter_token_ms",
                                  "connect_retries")},
           "tokens_per_s": run["tokens"] / run["wall_s"],
           "queue_wait_ms_p50": _p(waits, 0.5), "server_ttft_ms": server,
           "vs_solo": _streams_vs(decode, params, cfg, reqs, run["done"],
                                  solo)}
    out["ok"] = _finals_ok(reqs, run) and not out["vs_solo"]["bad"]
    if not profile:
        return out
    code, _, answer = prof.get("answer", (None, None, {}))
    trace = None
    if answer.get("artifact_dir"):
        files = sorted(
            (os.path.join(answer["artifact_dir"], n)
             for n in os.listdir(answer["artifact_dir"])
             if n.startswith(f"profilez-{os.getpid()}-")),
            key=os.path.getmtime)
        fresh = [p for p in files if os.path.getmtime(p) >= started]
        trace = _trace_kernels(fresh[-1]) if fresh else None
    out["profilez"] = {"code": code, "wall_s": prof.get("wall_s"),
                       **{k: answer.get(k) for k in (
                           "mode", "measured_ms", "busy_frac", "mfu",
                           "profiler_error")}, "trace": trace}
    if trace is not None and answer.get("measured_ms"):
        out["profilez"]["device_share"] = (trace["device_ms"]
                                           / answer["measured_ms"])
    out["ok"] = (out["ok"] and code == 200
                 and answer.get("mode") == "profiler"
                 and answer.get("busy_frac") is not None
                 and answer.get("mfu") is not None and trace is not None
                 and trace["k1_ms"] > 0 and trace["k2_ms"] > 0)
    return out


def _deadline_burst(torch, decode, srv, params, cfg, reqs,
                    solo: dict) -> dict:
    """(d): the burst again, its last DEADLINE_LAST requests posted last,
    not streamed, with deadline_ms DEADLINE_MS: each finishes or ends with
    deadline_exceeded (a 504) and a prefix of its oracle stream; the rest
    held as in the burst; no live block afterwards."""
    import threading

    head, tail = reqs[:-DEADLINE_LAST], reqs[-DEADLINE_LAST:]
    recs = {r.rid: {} for r in reqs}
    threads = [threading.Thread(target=_client, args=(
        srv.port, {"tokens": r.tokens, "max_new": r.max_new}, recs[r.rid]))
        for r in head]
    for t in threads:
        t.start()
    late = [threading.Thread(target=_client, args=(
        srv.port, {"tokens": r.tokens, "max_new": r.max_new,
                   "stream": False, "deadline_ms": DEADLINE_MS},
        recs[r.rid])) for r in tail]
    for t in late:
        t.start()
    for t in threads + late:
        t.join(HTTP_S)
    torch.cuda.synchronize()
    ended = {}
    for r in tail:
        ans = _final(recs[r.rid])
        ended[r.rid] = {"code": recs[r.rid].get("code"),
                        "tokens": len(ans.get("tokens", [])),
                        "deadline_exceeded": bool(ans.get(
                            "deadline_exceeded"))}
    prefix = _streams_vs(decode, params, cfg, tail,
                         {r.rid: _final(recs[r.rid]).get("tokens", [])
                          for r in tail},
                         {r.rid: solo[r.rid][:ended[r.rid]["tokens"]]
                          for r in tail})
    rest = {r.rid: _rec_tokens(recs[r.rid]) for r in head}
    live = _http(srv.port, "/poolz")[2]["pool"]["blocks"]["live"]
    out = {"deadline_ms": DEADLINE_MS, "ended": ended,
           "expired": sum(e["deadline_exceeded"] for e in ended.values()),
           "prefix_vs_solo": prefix,
           "rest_vs_solo": _streams_vs(decode, params, cfg, head, rest,
                                       solo),
           "live_blocks_after": live}
    out["ok"] = (all((e["code"] == 200 and not e["deadline_exceeded"])
                     or (e["code"] == 504 and e["deadline_exceeded"])
                     for e in ended.values())
                 and not prefix["bad"] and not out["rest_vs_solo"]["bad"]
                 and all(recs[r.rid].get("code") == 200
                         and _final(recs[r.rid]).get("done")
                         and len(rest[r.rid]) == r.max_new for r in head)
                 and live == 0)
    return out


def _endpoints(srv, served: int) -> dict:
    """(e): the routes, read with the server idle."""
    pool = srv.pool
    h = _http(srv.port, "/healthz")
    pz = _http(srv.port, "/poolz")[2]
    cz = _http(srv.port, "/cachez")[2]
    code, _, jsonl = _http(srv.port, "/requestz?format=jsonl")
    arrivals = [json.loads(ln) for ln in jsonl.splitlines() if ln.strip()]
    rz = _http(srv.port, "/requestz")[2]
    text = _http(srv.port, "/metrics")[2]
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'[-+0-9.eEinfa]+$')
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    inf = [ln for ln in lines if ln.startswith('serve_ttft_ms_bucket{le="+Inf"}')]
    spans = _http(srv.port, "/traces.json")[2]["spans"]
    blocks = pz["pool"]["blocks"]
    out = {
        "healthz": h[2], "served_expected": served,
        "poolz_blocks": blocks,
        "cachez": cz["digest"],
        "requestz_jsonl_records": len(arrivals),
        "requestz_records": len(rz["requests"]),
        "metrics_lines": len(lines),
        "metrics_unparsed": [ln for ln in lines if not sample.match(ln)][:5],
        "ttft_histogram_count": int(inf[0].split()[-1]) if inf else None,
        "serve_request_spans": sum(s["name"] == "serve.request"
                                   for s in spans)}
    out["ok"] = (h[0] == 200 and h[2]["ok"] is True
                 and h[2]["served"] == served
                 and blocks["live"] == pool.allocator.used()
                 and blocks["cached"] == pool.allocator.cached()
                 and blocks["available"] == pool.allocator.available()
                 and blocks["total"] == pool.allocator.num_blocks
                 and cz["digest"]["blocks"] == 0 and cz["digest"]["fps"] == []
                 and code == 200
                 and len({a["rid"] for a in arrivals}) == len(arrivals)
                 == min(served, rz["capacity"])
                 and all("phases" in r for r in rz["requests"])
                 and "# TYPE serve_ttft_ms histogram" in text
                 and not out["metrics_unparsed"]
                 and out["ttft_histogram_count"] is not None
                 and out["serve_request_spans"] > 0)
    return out


def _drain_run(srv, reqs) -> dict:
    """(f): DRAIN_REQUESTS streams posted, drain(DRAIN_TIMEOUT_MS) once
    their first tokens arrive: every stream ends with done, finished or
    with a final draining chunk; a later POST is a 503 with
    Retry-After."""
    import threading

    recs = [{} for _ in reqs]
    threads = [threading.Thread(target=_client, args=(
        srv.port, {"tokens": r.tokens, "max_new": r.max_new}, rec))
        for r, rec in zip(reqs, recs)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + HTTP_S
    while not any(_rec_tokens(rec) for rec in recs if "lines" in rec):
        if time.perf_counter() > deadline:
            break
        time.sleep(0.005)
    drain_ms = srv.drain(timeout_ms=DRAIN_TIMEOUT_MS)
    for t in threads:
        t.join(HTTP_S)
    code, headers, body = _http(srv.port, "/v1/generate",
                                {"tokens": reqs[0].tokens, "max_new": 1})
    finals = [_final(rec) for rec in recs]
    out = {"drain_ms": drain_ms, "requests": len(reqs),
           "finished": sum(bool(f.get("done")) and not f.get("draining")
                           for f in finals),
           "draining": sum(bool(f.get("draining")) for f in finals),
           "after": {"code": code, "retry_after": headers.get("Retry-After"),
                     "draining": body.get("draining")}}
    out["ok"] = (all(f.get("done") for f in finals)
                 and out["finished"] + out["draining"] == len(reqs)
                 and code == 503 and headers.get("Retry-After")
                 and body.get("draining") is True)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _model_env() -> str:
    """WORKLOAD_MODEL's terms for the decode model in bf16."""
    return ",".join([f"{k}={v}" for k, v in DECODE_MODEL.items()]
                    + ["compute_dtype=bfloat16"])


def _ingress_entry(torch, decode, serving, params, cfg, reqs,
                   want: dict) -> dict:
    """(g): ``python -m tpu_bootstrap_torch.workload.train`` with
    WORKLOAD_MODE=serve as a JobSet runs it (the decode model, int8
    weights and KV, the paged engine, WORKLOAD_SERVE_PORT): /healthz up
    within ENTRY_UP_S, ENTRY_REQUESTS of the burst's requests streamed
    equal to the in-process ingress's (``want``) up to near-ties, a
    SIGTERM that drains and exits 0 within TPUBC_DRAIN_TIMEOUT_MS plus
    30 s; then serve_demo_from_env in this process on
    ENTRY_DEMO_REQUESTS synthetic requests, which must print its serve
    done line."""
    import signal

    port = _free_port()
    env = {**os.environ, "WORKLOAD_MODE": "serve",
           "WORKLOAD_MODEL": _model_env(), "WORKLOAD_QUANT": "int8",
           "WORKLOAD_KV_QUANT": "1", "WORKLOAD_PAGED": "1",
           "WORKLOAD_SERVE_PORT": str(port)}
    env.pop("TPUBC_PROFILEZ", None)
    root = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_bootstrap_torch.workload.train"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    out = {"port": port}
    try:
        up = None
        while time.perf_counter() - t0 < ENTRY_UP_S and proc.poll() is None:
            try:
                if _http(port, "/healthz", timeout=5)[0] == 200:
                    up = time.perf_counter() - t0
                    break
            except OSError:
                pass
            time.sleep(0.5)
        out["up_s"] = up
        if up is not None:
            sub = reqs[:ENTRY_REQUESTS]
            run = _ingress_traffic(port, [{"tokens": r.tokens,
                                           "max_new": r.max_new}
                                          for r in sub])
            got = {r.rid: _rec_tokens(rec) for r, rec in zip(sub,
                                                              run["recs"])}
            out["streams_equal"] = sum(got[r.rid] == want[r.rid]
                                       for r in sub)
            out["vs_in_process"] = _streams_vs(decode, params, cfg, sub, got,
                                               want)
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            limit = float(os.environ.get("TPUBC_DRAIN_TIMEOUT_MS",
                                         "5000")) / 1e3 + 30
            try:
                out["exit_code"] = proc.wait(timeout=limit)
            except subprocess.TimeoutExpired:
                out["exit_code"] = None
            out["exit_s"] = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log = proc.stdout.read()
        proc.stdout.close()
    out["log_tail"] = log.splitlines()[-6:]
    demo = {"WORKLOAD_MODEL": _model_env(), "WORKLOAD_QUANT": "int8",
            "WORKLOAD_KV_QUANT": "1", "WORKLOAD_PAGED": "1",
            "WORKLOAD_REQUESTS": str(ENTRY_DEMO_REQUESTS),
            "WORKLOAD_SERVE_PORT": "0"}
    buf = io.StringIO()
    with _env(demo), contextlib.redirect_stdout(buf):
        serving.serve_demo_from_env(device=params["embed"].device)
    done = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("serve done:")]
    out["demo"] = done[-1] if done else None
    out["ok"] = (out.get("up_s") is not None
                 and not out["vs_in_process"]["bad"]
                 and out.get("exit_code") == 0 and bool(done)
                 and f"serve done: {ENTRY_DEMO_REQUESTS} requests" in done[-1])
    return out


def phase_serve_ingress(torch, kernels, device, serve_out=None,
                        model_kw=DECODE_MODEL) -> dict:
    """The front door end to end: ingress.IngressServer on serve's traffic
    and settings (the decode model at full width, bf16, int8 weights from
    seed 0, the int8 KV pool, batch 8, block 64, prefix cache and
    overcommit off) on 127.0.0.1, its clients urllib threads. (a) one
    untimed burst of the 32 requests, capturing every table width's decode
    graph; (b) INGRESS_RUNS timed bursts: streams held to the solo greedy
    oracle up to near-ties (and counted equal to phase serve's), K1 and K2
    launches to the schedule, each final object's keys, tokens/s from the
    first POST to the last end beside phase serve's, TTFT, inter-token and
    total latency; (c) the open loop (_open_loop) at OPEN_LOOP_LOAD of the
    bursts' median request rate, then the same arrivals again with a
    /profilez capture in them (the capture stalls the engine while the
    profiler writes its trace, so the latencies are the first run's);
    (d) the deadline burst; (e) the
    endpoints; (f) the drain; (g) the serve-mode entry (_ingress_entry).
    ``serve_out`` is phase serve's result: its streams and solo oracle."""
    from tpu_bootstrap_torch.workload import decode, model, quant, serving
    from tpu_bootstrap_torch.workload.ingress import IngressServer

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    if serve_out is not None and "solo" in serve_out:
        solo, serve_streams = serve_out["solo"], serve_out["streams"]
    else:
        solo = _solo_streams(decode, params, cfg, reqs)
        serve_streams = None
    out = {"phase": "serve_ingress", "requests": len(reqs),
           "batch": INGRESS_BATCH}
    with _env({"TPUBC_PROFILEZ": "1"}):
        srv = IngressServer(params, cfg, port=0, host="127.0.0.1",
                            batch_size=INGRESS_BATCH, device=device,
                            **INGRESS_KW).start()
        try:
            t0 = time.perf_counter()
            warm = _ingress_traffic(srv.port, [{"tokens": r.tokens,
                                                "max_new": r.max_new}
                                               for r in reqs])
            out["warm_up"] = {"wall_s": warm["wall_s"],
                              "s": time.perf_counter() - t0,
                              "ok": _finals_ok(reqs, warm),
                              "connect_retries": warm["connect_retries"],
                              "graphs": dict(srv.pool._graphs.stats)
                              if srv.pool._graphs is not None else None}
            runs = [_ingress_burst(torch, kernels, srv, cfg, reqs)
                    for _ in range(INGRESS_RUNS)]
            last = runs[-1]
            tps = [r["tokens_per_s"] for r in runs]
            burst = {
                "tokens": last["tokens"], "wall_s": [r["wall_s"]
                                                     for r in runs],
                "tokens_per_s": statistics.median(tps),
                "tokens_per_s_runs": tps,
                "serve_tokens_per_s": (serve_out or {}).get("tokens_per_s"),
                **{k: last[k] for k in ("ttft_ms", "inter_token_ms",
                                        "total_ms", "launches",
                                        "launches_exact")},
                "connect_retries": [r["connect_retries"] for r in runs],
                "runs_agree": all(r["done"] == last["done"] for r in runs),
                "launches_agree": all(r["launches"] == last["launches"]
                                      for r in runs),
                "finals_ok": all(_finals_ok(reqs, r) for r in runs),
                "vs_solo": _streams_vs(decode, params, cfg, reqs,
                                       last["done"], solo),
                "equal_to_serve": (None if serve_streams is None else sum(
                    last["done"][r.rid] == serve_streams[r.rid]
                    for r in reqs))}
            # Arrivals race the engine's round boundaries, so each run may
            # batch the burst otherwise: its launches are held to its own
            # schedule, its streams to the oracle.
            burst["ok"] = (burst["finals_ok"]
                           and all(r["launches_exact"]["ok"] for r in runs)
                           and not any(_streams_vs(
                               decode, params, cfg, reqs, r["done"],
                               solo)["bad"] for r in runs[:-1])
                           and not burst["vs_solo"]["bad"])
            out["burst"] = burst
            rate = OPEN_LOOP_LOAD * len(reqs) / statistics.median(
                r["wall_s"] for r in runs)
            out["open_loop"] = _open_loop(torch, decode, srv, params, cfg,
                                          reqs, rate, solo, profile=False)
            out["open_loop_profiled"] = _open_loop(
                torch, decode, srv, params, cfg, reqs, rate, solo,
                profile=True)
            out["deadlines"] = _deadline_burst(torch, decode, srv, params,
                                               cfg, reqs, solo)
            served = len(reqs) * (INGRESS_RUNS + 4)
            out["endpoints"] = _endpoints(srv, served)
            out["drain"] = _drain_run(srv, reqs[:DRAIN_REQUESTS])
        finally:
            srv.stop()
    out["entry"] = _ingress_entry(torch, decode, serving, params, cfg, reqs,
                                  last["done"])
    out["near_tie"] = NEAR_TIE["bfloat16"]
    emit(out)
    failed = [k for k in ("warm_up", "burst", "open_loop",
                          "open_loop_profiled", "deadlines", "endpoints",
                          "drain", "entry") if not out[k]["ok"]]
    if failed:
        raise SystemExit(f"serve_ingress failed: {failed}")
    return out


# Sampling (phase sampling): the reference's serve-entry knobs at values a
# chat deployment runs (WORKLOAD_TEMPERATURE 0.8, WORKLOAD_TOP_K 50,
# WORKLOAD_TOP_P 0.95) and a fixed pool key.
SAMPLE_KW = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLE_SEED = 5  # the pool key, prng.key(SAMPLE_SEED)
SAMPLE_REQUESTS = 16  # serve's first 16 requests
# The tight pool: 12 blocks of 64 for 8 rows whose footprints reach 4
# blocks each, overcommit, the prefix cache and the host tier on; the last
# SAMPLE_URGENT requests arrive SAMPLE_URGENT_AT rounds in with priority 1
# and evict running rows (preemptions counted, must be > 0: 3 in a CPU
# rehearsal of the same lengths, the schedule depending on them alone).
SAMPLE_TIGHT_BLOCKS = 12
SAMPLE_URGENT, SAMPLE_URGENT_AT = 4, 2
# The prng parity shapes: a batch of 8 rows over the decode vocabulary.
PRNG_ROWS = 8
# Spec serving (phase serve_spec): requests of serve's traffic drafted by
# the bf16 target's int8 copy; prompt lookup runs all of serve's 32.
SPEC_REQUESTS = 16


def _prng_parity(torch, prng, device) -> dict:
    """prng on the card against prng on the CPU: keys, a fold_in chain,
    split, per-row fold_in, bits and uniforms of (PRNG_ROWS, vocab) bit for
    bit; gumbel's largest difference in f32 ulps of the larger of |x| and
    1 (its logs may round apart between the two devices)."""
    vocab = DECODE_MODEL["vocab_size"]
    cpu = torch.device("cpu")

    def draw(dev):
        k = prng.key(SAMPLE_SEED, dev)
        chain = [k]
        for i in range(64):
            chain.append(prng.fold_in(chain[-1], i))
        rows = prng.split(k, PRNG_ROWS)
        offs = torch.arange(PRNG_ROWS, device=dev) * 7 + 3
        return {"key": k, "fold_in_chain": torch.stack(chain),
                "split": rows, "row_fold_in": prng.fold_in(rows, offs),
                "bits": prng.bits32(k, (PRNG_ROWS, vocab)),
                "uniform": prng.uniform(k, (PRNG_ROWS, vocab)),
                "gumbel": prng.gumbel(k, (PRNG_ROWS, vocab))}

    got, want = draw(device), draw(cpu)
    exact = {n: bool(torch.equal(got[n].cpu(), want[n]))
             for n in got if n != "gumbel"}
    g, w = got["gumbel"].cpu(), want["gumbel"]
    # In ulps of the larger of |x| and 1 (near 0 the logs' absolute error
    # is what an ulp of 1 measures).
    mag = torch.maximum(w.abs(), torch.ones_like(w))
    ulp = torch.nextafter(mag, torch.full_like(w, math.inf)) - mag
    ulps = ((g - w).abs() / ulp).max()
    return {"exact": exact, "gumbel_max_ulps": float(ulps),
            "gumbel_equal_share": float((g == w).float().mean()),
            "ok": all(exact.values())}


def _sampled_divergence(decode, params, cfg, prompt: list, got: list,
                        want: list, row_key):
    """(step, the oracle's sampled margin there) of the first token where
    ``got`` leaves ``want`` (drawn with ``row_key``), or None."""
    if got == want:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        return min(len(got), len(want)), float("inf")
    margin = decode.sampled_margins(params, prompt, want[:j + 1], cfg,
                                    row_key, kv_quant=True,
                                    **SAMPLE_KW)[j]
    return j, margin


def _sampled_diverged(decode, serving, params, cfg, reqs, got: dict,
                      want: dict, key) -> list:
    out = []
    for r in reqs:
        first = _sampled_divergence(decode, params, cfg, r.tokens,
                                    got[r.rid], want[r.rid],
                                    serving._stream_key(key, r.rid))
        if first is not None:
            out.append({"rid": r.rid, "step": first[0], "margin": first[1]})
    return out


def _counted_serve(torch, kernels, serving, params, cfg, reqs, batch: int,
                   **kw) -> dict:
    """serve() once through _timed: streams, wall seconds, launches, the
    pool's stats."""
    stats: dict = {}
    done, wall, launches = _timed(torch, kernels, lambda: serving.serve(
        params, cfg, reqs, batch, stats=stats, **kw))
    tokens = sum(len(v) for v in done.values())
    return {"done": done, "wall_s": wall, "tokens": tokens,
            "tokens_per_s": tokens / wall, "launches": launches,
            "stats": stats}


def _urgent_run(torch, kernels, serving, params, cfg, reqs, **kw) -> dict:
    """``reqs`` through an explicit Scheduler over a PagedPool of
    SAMPLE_TIGHT_BLOCKS blocks with overcommit: all but the last
    SAMPLE_URGENT at once, those SAMPLE_URGENT_AT rounds later with
    priority 1, so they evict running rows (priority preemption); the
    launch counts set to 0 just before and read just after."""
    import dataclasses

    pool = serving.PagedPool(params, cfg, 8, kv_quant=True,
                             kv_blocks=SAMPLE_TIGHT_BLOCKS, **kw)
    sched = serving.Scheduler(pool, overcommit=True)
    urgent = [dataclasses.replace(r, priority=1)
              for r in reqs[-SAMPLE_URGENT:]]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs[:-SAMPLE_URGENT]:
        sched.submit(r)
    done, rounds = {}, 0
    while sched.pending() or pool.has_active() or urgent:
        if rounds == SAMPLE_URGENT_AT:
            for r in urgent:
                sched.submit(r)
            urgent = []
        for rid, ev in sched.step().items():
            if ev["done"]:
                done[rid] = ev["generated"]
        rounds += 1
    torch.cuda.synchronize()
    return {"done": done, "wall_s": time.perf_counter() - t0,
            "launches": dict(kernels.LAUNCHES), "stats": dict(pool.stats)}


def _explained(torch, kernels, decode, serving, params, cfg, reqs, key,
               diverged: list, oracle: dict) -> dict:
    """Each divergence of ``diverged`` gains ``max_logit_diff``: the
    largest difference between the logits the engine drew that pick from
    and the oracle's. The engine's come from serve()'s run of ``reqs``
    again, with the decode chunks eager (graphs off: the same bits, as
    phase serve's graph check holds) and the sampler wrapped to keep the
    rows' logits at the wanted picks. A divergence is explained when its
    margin (twice the smallest shift of every logit that changes the
    draw) is at most twice that difference. Returns the eager run's
    streams."""
    wanted = {d["rid"]: d["step"] for d in diverged}
    pool = serving.PagedPool(params, cfg, 8, kv_quant=True,
                             prefix_cache=False, key=key, **SAMPLE_KW)
    pool._graphs = None
    inner, seen = pool._sampler, {}

    def sampler(logits, i):
        for b, s in enumerate(pool.slots):
            if (s is not None and s.rid in wanted
                    and torch.equal(pool._rkeys[b].cpu(), s.row_key)
                    and int(pool._roff[b]) + i == wanted[s.rid]):
                seen[s.rid] = logits[b].float().clone()
        return inner(logits, i)

    pool._sampler = sampler
    done = _sched_run(torch, kernels, serving, pool,
                      serving.Scheduler(pool, overcommit=False), reqs)["done"]
    prompts = {r.rid: r.tokens for r in reqs}
    for d in diverged:
        rid, j = d["rid"], d["step"]
        want = list(decode._fed_logits(params, prompts[rid],
                                       oracle[rid][:j + 1], cfg, True,
                                       None))[j]
        d["max_logit_diff"] = float((seen[rid].to(want.device) - want)
                                    .abs().max())
    return done


def _sampled_oracle(decode, serving, params, cfg, reqs, key) -> dict:
    """Each request alone through generate(kv_kernel=False) with its
    stream key: the sampled streams' solo oracle."""
    return {r.rid: decode.generate(
        params, [r.tokens], cfg, r.max_new, kv_quant=True, kv_kernel=False,
        row_keys=serving._stream_key(key, r.rid)[None], row_key_offsets=[0],
        **SAMPLE_KW)[0].tolist() for r in reqs}


def phase_sampling(torch, kernels, device, model_kw=DECODE_MODEL) -> dict:
    """Sampling with threefry parity (queue 1 item 5.7) on the main path:
    (a) _prng_parity; (b) serve's first SAMPLE_REQUESTS requests through
    the paged engine (int8 weights and KV, batch 8, block 64, prefix cache
    and overcommit off) sampled at SAMPLE_KW with the pool key
    prng.key(SAMPLE_SEED), twice: the streams equal (reproducible), the
    launches of K1 and K2 and the graphs' replays equal to the schedule's
    (the sampler runs inside the captured step); (c) the same at batch 1
    (batch invariance); (d) the same in a pool of SAMPLE_TIGHT_BLOCKS
    blocks with overcommit, the prefix cache and the host tier on, urgent
    arrivals evicting running rows (_urgent_run): rows preempted, swapped
    or recomputed and resumed keep their streams; (e) each request
    alone through generate(kv_kernel=False) with its stream key (the solo
    oracle). (c)-(e) are held to (b) up to near-ties of logits + gumbel
    (sampled_margins, in logit units, under NEAR_TIE); (b) and (e) again
    in f32, where each divergence must be a near-tie under NEAR_TIE's f32
    limit and explained by the two paths' logits at its pick
    (_explained); (f) sampled speculative_generate (the bf16 target, its
    int8 draft) completes."""
    import dataclasses

    from tpu_bootstrap_torch.workload import (decode, model, prng, quant,
                                              serving, speculative)

    parity = _prng_parity(torch, prng, device)
    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    reqs = _serve_requests(serving, cfg.vocab_size, SAMPLE_REQUESTS, seed=0)
    key = prng.key(SAMPLE_SEED)
    kw = {**SERVE_KW, **SAMPLE_KW, "key": key}
    serving.serve(params, cfg, _serve_requests(serving, cfg.vocab_size, 2,
                                               seed=1), 8, **kw)
    first = _counted_serve(torch, kernels, serving, params, cfg, reqs, 8,
                           **kw)
    second = _counted_serve(torch, kernels, serving, params, cfg, reqs, 8,
                            **kw)
    stats = first["stats"]
    exact = _launches_exact(cfg, stats, first["launches"], PATHS["int8"])
    steps = stats["slot_steps"] // 8
    graphs = stats.get("graphs") or {}
    replays_ok = graphs.get("replays") == steps - graphs.get("captured", -1)
    done = first["done"]
    solo_batch = _counted_serve(torch, kernels, serving, params, cfg, reqs,
                                1, **kw)
    tight = _urgent_run(torch, kernels, serving, params, cfg, reqs,
                        key=key, **SAMPLE_KW)
    t1 = time.perf_counter()
    oracle = _sampled_oracle(decode, serving, params, cfg, reqs, key)
    oracle_s = time.perf_counter() - t1
    diverged = {name: _sampled_diverged(decode, serving, params, cfg, reqs,
                                        run["done"], done if name != "solo"
                                        else oracle, key)
                for name, run in (("batch_1", solo_batch), ("tight", tight),
                                  ("solo", {"done": done}))}
    # The same engine and oracle in f32: each divergence there must be a
    # near-tie that the two paths' logits at its pick explain.
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    done32 = serving.serve(params, cfg32, reqs, 8, **kw)
    oracle32 = _sampled_oracle(decode, serving, params, cfg32, reqs, key)
    diverged32 = _sampled_diverged(decode, serving, params, cfg32, reqs,
                                   done32, oracle32, key)
    eager32 = _explained(torch, kernels, decode, serving, params, cfg32,
                         reqs, key, diverged32, oracle32)
    master = model.init_params(cfg, seed=0, device=device)
    draft = quant.quantize_params(master)
    target = {"embed": master["embed"].bfloat16(),
              "final_norm": master["final_norm"].bfloat16(),
              "blocks": [{n: w.bfloat16() for n, w in b.items()}
                         for b in master["blocks"]]}
    del master
    prompt = _gen_prompt(torch, cfg, device)
    (spec, spec_stats), spec_s, spec_launches = _timed(
        torch, kernels, lambda: speculative.speculative_generate(
            target, draft, prompt, cfg, cfg, GEN_STEPS[0], gamma=GAMMA,
            kv_quant=True, with_stats=True, key=prng.key(SAMPLE_SEED),
            temperature=SAMPLE_KW["temperature"]))
    spec_ok = (tuple(spec.shape) == (GEN_BATCH, GEN_STEPS[0])
               and bool(((spec >= 0) & (spec < cfg.vocab_size)).all()))
    bad = [d for ds in diverged.values() for d in ds
           if d["margin"] >= NEAR_TIE["bfloat16"]]
    bad += [d for d in diverged32 if not (
        d["margin"] < NEAR_TIE["float32"]
        and d["margin"] <= 2 * d["max_logit_diff"])]
    complete = all(len(done[r.rid]) == r.max_new for r in reqs)
    result = {
        "phase": "sampling", **SAMPLE_KW, "key_seed": SAMPLE_SEED,
        "requests": len(reqs), "prng": parity,
        "serve": {k: first[k] for k in ("wall_s", "tokens", "tokens_per_s",
                                        "launches")},
        "reproducible": second["done"] == done,
        "launches_repeat": second["launches"] == first["launches"],
        "launches_exact": exact, "graphs": graphs, "decode_steps": steps,
        "replays_ok": replays_ok,
        "batch_1": {"tokens_per_s": solo_batch["tokens_per_s"],
                    "equal": solo_batch["done"] == done},
        "tight": {"blocks": SAMPLE_TIGHT_BLOCKS,
                  "preemptions": tight["stats"]["preemptions"],
                  "swap_preempts": tight["stats"].get("swap_preempts", 0),
                  "launches": tight["launches"],
                  "equal": tight["done"] == done},
        "oracle_s": oracle_s, "solo_equal": sum(
            oracle[r.rid] == done[r.rid] for r in reqs),
        "near_tie": NEAR_TIE, "diverged": diverged,
        "diverged_f32": diverged32, "f32_eager_equal": eager32 == done32,
        "speculative": {"seconds": spec_s, "shape_ok": spec_ok,
                        "verify_rounds": spec_stats["verify_rounds"],
                        "mean_committed": spec_stats["mean_committed"],
                        "launches": spec_launches}}
    emit(result)
    if (not parity["ok"] or bad or not complete or not result["reproducible"]
            or not result["launches_repeat"] or not exact["ok"]
            or not replays_ok or tight["stats"]["preemptions"] < 1
            or not spec_ok or first["launches"]["int8_matmul"] < 1
            or first["launches"]["paged_attention"] < 1):
        raise SystemExit(f"sampling failed: parity={parity} bad={bad} "
                         f"complete={complete} exact={exact} "
                         f"graphs={graphs} steps={steps} "
                         f"tight={result['tight']}")
    return result


SPEC_METRICS = ("serve_spec_draft_ms", "serve_spec_verify_ms",
                "serve_spec_commit_ms", "serve_spec_committed_per_round")


def _spec_run(torch, kernels, serving, telemetry, params, cfg, reqs,
              engine_kw=SERVE_KW, **kw) -> dict:
    with _observed_many(telemetry.metrics(), SPEC_METRICS) as seen:
        run = _counted_serve(torch, kernels, serving, params, cfg, reqs, 8,
                             **engine_kw, gamma=GAMMA, **kw)
    stats = run["stats"]
    run["spec"] = {k: stats[k] for k in (
        "verify_rounds", "committed_tokens", "draft_steps",
        "draft_proposed", "draft_accepted")}
    run["committed_per_round"] = (
        statistics.fmean(seen["serve_spec_committed_per_round"])
        if seen["serve_spec_committed_per_round"] else None)
    run["phase_ms"] = {n: {"p50": statistics.median(v), "sum": sum(v),
                           "n": len(v)}
                       for n, v in seen.items() if v and n.endswith("_ms")}
    return run


def _spec_k1_want(cfg, stats: dict, draft_steps: int) -> int:
    """K1 launches of a speculative serve from its schedule: four block
    projections a layer in every prefill chunk and every int8 model step,
    and the int8 head once a step: ``draft_steps`` single-token steps
    (the draft's) or verify chunks (an int8 target's)."""
    layers = cfg.num_layers
    return (4 * layers * (stats["prefill_chunks"] + draft_steps)
            + draft_steps)


def phase_serve_spec(torch, kernels, device, serve_out=None,
                     model_kw=DECODE_MODEL) -> dict:
    """The paged engine's speculative rounds (queue 1 item 5.8), greedy,
    at the decode model's full width (batch 8, block 64, prefix cache and
    overcommit off, gamma GAMMA): (a) prompt lookup (spec_lookup) on serve's
    int8 target and serve's 32 requests, streams held to phase serve's
    (``serve_out``) up to near-ties, K1 launched as its schedule implies
    (the verify chunks and the prefill); (b) the bf16 target plainly and
    (c) drafted by its own int8 copy on SPEC_REQUESTS of them: (c)'s
    streams held to (b)'s up to near-ties, more than one token committed a
    round, K1 launched as the draft's steps and prefill imply, K2 on (b)'s
    decode steps. Tokens/s of each run, beside serve's, and the rounds'
    serve_spec_* phase times."""
    from tpu_bootstrap_torch import telemetry
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    master = model.init_params(cfg, seed=0, device=device)
    int8 = quant.quantize_params(master)
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    if serve_out is None:
        serve_out = {"streams": serving.serve(int8, cfg, reqs, 8,
                                              **SERVE_KW),
                     "tokens_per_s": None}
    lookup = _spec_run(torch, kernels, serving, telemetry, int8, cfg, reqs,
                       spec_lookup=True)
    lookup_div = _diverged(decode, int8, cfg, reqs, lookup["done"],
                           serve_out["streams"])
    lookup_k1 = _spec_k1_want(cfg, lookup["stats"],
                              lookup["stats"]["verify_rounds"])
    target = {"embed": master["embed"].bfloat16(),
              "final_norm": master["final_norm"].bfloat16(),
              "blocks": [{n: w.bfloat16() for n, w in b.items()}
                         for b in master["blocks"]]}
    del master
    few = reqs[:SPEC_REQUESTS]
    plain = _counted_serve(torch, kernels, serving, target, cfg, few, 8,
                           **SERVE_KW)
    drafted = _spec_run(torch, kernels, serving, telemetry, target, cfg, few,
                        draft_params=int8, draft_cfg=cfg)
    drafted_div = _diverged(decode, target, cfg, few, drafted["done"],
                            plain["done"])
    drafted_k1 = _spec_k1_want(cfg, drafted["stats"],
                               drafted["stats"]["draft_steps"])
    k2_plain = cfg.num_layers * plain["stats"]["slot_steps"] // 8
    checks = {
        "lookup_k1": lookup["launches"]["int8_matmul"] == lookup_k1,
        "drafted_k1": drafted["launches"]["int8_matmul"] == drafted_k1,
        "plain_k2": plain["launches"]["paged_attention"] == k2_plain > 0,
        "committed_above_1": (drafted["committed_per_round"] or 0) > 1,
        "complete": all(len(run["done"][r.rid]) == r.max_new
                        for run, rs in ((lookup, reqs), (plain, few),
                                        (drafted, few)) for r in rs)}
    bad = [d for d in lookup_div + drafted_div
           if d["margin"] >= NEAR_TIE["bfloat16"]]

    def fields(run):
        return {k: run[k] for k in ("wall_s", "tokens", "tokens_per_s",
                                    "launches", "spec", "committed_per_round",
                                    "phase_ms") if k in run}

    result = {"phase": "serve_spec", "gamma": GAMMA,
              "serve_tokens_per_s": serve_out.get("tokens_per_s"),
              "lookup": {**fields(lookup), "requests": len(reqs),
                         "k1_want": lookup_k1, "diverged": lookup_div},
              "bf16_plain": {**fields(plain), "requests": len(few),
                             "k2_want": k2_plain},
              "bf16_drafted": {**fields(drafted), "requests": len(few),
                               "k1_want": drafted_k1,
                               "diverged": drafted_div},
              "near_tie": NEAR_TIE["bfloat16"], "checks": checks}
    emit(result)
    if bad or not all(checks.values()):
        raise SystemExit(f"serve_spec failed: bad={bad} checks={checks}")
    return result


# The resident engine (serve(resident=True)) on the int8 KV cache, and the
# requests of serve_resident's prompt-lookup and f32 runs.
RESIDENT_KW = dict(resident=True, kv_quant=True)
RESIDENT_FEW = 8


def _einsum_launches_exact(cfg, stats: dict, launches: dict, prefills: int,
                           batch: int = 8) -> dict:
    """The launches of a serve whose decode attends on einsums (the
    resident engine, the paged engine's gathered route), from its schedule
    alone: per layer four K1 projections in every decode step (slot_steps
    / batch of them, replays counted) and in every prefill (an admission
    prefill of the resident engine, a prefill chunk of the paged one),
    the head once a step, and no K2."""
    steps = stats["slot_steps"] // batch
    want = {"int8_matmul": 4 * cfg.num_layers * (steps + prefills) + steps,
            "paged_attention": 0}
    got = {k: launches[k] for k in want}
    return {"ok": got == want and steps > 0, "want": want, "got": got,
            "decode_steps": steps, "prefills": prefills}


def _resident_graph_check(torch, serving, params, cfg, reqs) -> dict:
    """Graph == eager for the resident engine: a pool of batch 8 driven
    mid-serve on ``reqs`` until a decode chunk of at least 2 steps over at
    least 4 rows is due at a slab width whose step is already captured,
    then that chunk through the captured step and through the eager loop
    _resident_chunk on a clone of the caches: the tokens and every cache
    byte must be equal."""
    pool = serving.ResidentPool(params, cfg, 8, kv_quant=True)
    pending = list(reqs)
    for _ in range(400):
        while pending and pool.free_slots():
            pool.admit(pending.pop(0))
        active = [s for s in pool.slots if s is not None]
        chunk = serving._majority_chunk(active, cfg.max_seq_len)
        lb = min(serving._bucket_up(max(len(s.history) for s in active)
                                    + chunk - 1), cfg.max_seq_len)
        if chunk > 1 and len(active) >= 4 and lb in pool._graphs._graphs:
            break
        pool.step_round()
    else:
        raise SystemExit("resident graph check: no captured width mid-serve")
    last, pos = pool._rows()
    twin = _clone_pools(pool.caches)
    dev = twin[0]["k"].device
    want = serving._resident_chunk(params, twin, last.to(dev), pos.to(dev),
                                   cfg, chunk, lb).tolist()
    replays = pool._graphs.stats["replays"]
    got = pool._decode_chunk(lb, last, pos, chunk)
    torch.cuda.synchronize()
    out = {"chunk": chunk, "lb": lb, "rows": len(active),
           "replays": pool._graphs.stats["replays"] - replays,
           "tokens_equal": got == want,
           "cache_bytes_equal": all(
               torch.equal(a, b) for la, lb_ in zip(pool.caches, twin)
               for a, b in zip(la.values(), lb_.values())),
           "graphs": dict(pool._graphs.stats)}
    out["ok"] = (out["tokens_equal"] and out["cache_bytes_equal"]
                 and out["replays"] == chunk)
    del pool
    return out


def phase_serve_resident(torch, kernels, device, serve_out=None,
                         model_kw=DECODE_MODEL) -> dict:
    """The reference's other engines (queue 1 item 8) at the decode
    model's full width (bf16, int8 weights from seed 0) on serve's 32
    requests, batch 8, every stream held to the solo oracle up to
    near-ties (``serve_out``: phase serve's streams and int8-KV oracle):
    (a) the resident engine on the int8 KV cache, TIMED_RUNS times
    (_serve_runs: tokens/s median and spread, the runs alike), K1
    launched as its schedule implies (every decode step a replay of its
    captured step, every admission one prefill) and K2 never; (b) graph
    == eager (_resident_graph_check); (c) the resident engine on a float
    cache and (d) the paged engine's float pool (serve's SERVE_KW with
    kv_quant off), each once, held to the float-cache oracle, K1 as
    scheduled, K2 never; (e) the int8 pool with paged_kernel=False, its
    streams held to serve's kernel route; (f) prompt lookup on the
    resident engine over RESIDENT_FEW requests: committed tokens a round,
    streams held to (a)'s; (g) the resident engine in f32 on them, held
    to the f32 oracle at NEAR_TIE["float32"]. Tokens/s beside serve's."""
    import dataclasses

    from tpu_bootstrap_torch import telemetry
    from tpu_bootstrap_torch.workload import decode, model, quant, serving

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
    params = quant.quantize_params(model.init_params(cfg, seed=0,
                                                     device=device))
    reqs = _serve_requests(serving, cfg.vocab_size, 32, seed=0)
    if serve_out is None:
        serve_out = {"streams": serving.serve(params, cfg, reqs, 8,
                                              **SERVE_KW),
                     "solo": _solo_streams(decode, params, cfg, reqs),
                     "tokens_per_s": None}
    solo = serve_out["solo"]
    runs = {}
    run = _serve_runs(torch, kernels, serving, params, cfg, reqs,
                      kw=RESIDENT_KW)
    runs["resident"] = {
        **_run_fields(run),
        "exact": _einsum_launches_exact(
            cfg, run["stats"], run["launches"],
            run["stats"]["scheduler"]["admitted"]),
        "diverged": _diverged(decode, params, cfg, reqs, run["done"], solo),
        "stats": {k: v for k, v in run["stats"].items()
                  if k != "scheduler"}}
    graph = _resident_graph_check(torch, serving, params, cfg, reqs)
    solo_f = _solo_streams(decode, params, cfg, reqs, kv_quant=False)
    float_runs = {
        "resident_float": dict(resident=True, kv_quant=False),
        "float_pool": {**SERVE_KW, "kv_quant": False}}
    for name, kw in float_runs.items():
        one = _counted_serve(torch, kernels, serving, params, cfg, reqs, 8,
                             **kw)
        st = one["stats"]
        prefills = (st["prefill_chunks"] if kw.get("paged")
                    else st["scheduler"]["admitted"])
        runs[name] = {
            **{k: one[k] for k in ("wall_s", "tokens", "tokens_per_s",
                                   "launches")},
            "exact": _einsum_launches_exact(cfg, st, one["launches"],
                                            prefills),
            "diverged": _diverged(decode, params, cfg, reqs, one["done"],
                                  solo_f, kv_quant=False)}
        runs[name]["done"] = one["done"]
    pool = serving.PagedPool(params, cfg, 8, kv_quant=True,
                             prefix_cache=False, paged_kernel=False)
    gather = _sched_run(torch, kernels, serving, pool,
                        serving.Scheduler(pool, overcommit=False), reqs)
    tokens = sum(len(v) for v in gather["done"].values())
    runs["gather_int8"] = {
        "wall_s": gather["wall_s"], "tokens": tokens,
        "tokens_per_s": tokens / gather["wall_s"],
        "launches": gather["launches"], "paged_kernel": pool.paged_kernel,
        "exact": _einsum_launches_exact(cfg, pool.stats, gather["launches"],
                                        pool.stats["prefill_chunks"]),
        "diverged": _diverged(decode, params, cfg, reqs, gather["done"],
                              serve_out["streams"])}
    runs["gather_int8"]["done"] = gather["done"]
    del pool
    few = reqs[:RESIDENT_FEW]
    lookup = _spec_run(torch, kernels, serving, telemetry, params, cfg, few,
                       engine_kw=RESIDENT_KW, spec_lookup=True)
    st = lookup["stats"]
    k1_want = _spec_k1_want(
        cfg, {"prefill_chunks": st["scheduler"]["admitted"]},
        st["verify_rounds"])
    runs["lookup"] = {
        **{k: lookup[k] for k in ("wall_s", "tokens", "tokens_per_s",
                                  "launches", "spec", "committed_per_round",
                                  "phase_ms")},
        "exact": {"ok": (lookup["launches"]["int8_matmul"] == k1_want
                         and lookup["launches"]["paged_attention"] == 0),
                  "k1_want": k1_want},
        "diverged": _diverged(decode, params, cfg, few, lookup["done"],
                              run["done"])}
    runs["lookup"]["done"] = lookup["done"]
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    done32 = serving.serve(params, cfg32, few, 8, **RESIDENT_KW)
    div32 = _diverged(decode, params, cfg32, few, done32,
                      _solo_streams(decode, params, cfg32, few))
    complete = all(
        len(r_["done"][r.rid]) == r.max_new
        for r_, rs in ((run, reqs), (runs["resident_float"], reqs),
                       (runs["float_pool"], reqs), (runs["gather_int8"], reqs),
                       (runs["lookup"], few)) for r in rs)
    for name in ("resident_float", "float_pool", "gather_int8", "lookup"):
        runs[name].pop("done")
    bad = [d for name in runs for d in runs[name]["diverged"]
           if d["margin"] >= NEAR_TIE["bfloat16"]]
    bad += [d for d in div32 if d["margin"] >= NEAR_TIE["float32"]]
    checks = {"runs_ok": run["ok"], "graph": graph["ok"],
              "complete": complete,
              "gather_route": runs["gather_int8"]["paged_kernel"] is False,
              **{f"{name}_launches": runs[name]["exact"]["ok"]
                 for name in runs}}
    serve_tps = serve_out.get("tokens_per_s")
    result = {"phase": "serve_resident", "requests": len(reqs),
              "serve_tokens_per_s": serve_tps,
              "resident_vs_serve": (run["tokens_per_s"] / serve_tps
                                    if serve_tps else None),
              "float_pool_vs_serve": (runs["float_pool"]["tokens_per_s"]
                                      / serve_tps if serve_tps else None),
              **runs, "graph_vs_eager": graph,
              "float32": {"requests": len(few), "diverged": div32},
              "near_tie": NEAR_TIE, "checks": checks}
    emit(result)
    if bad or not all(checks.values()):
        raise SystemExit(f"serve_resident failed: bad={bad} checks={checks}")
    return result


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


def _eager_generate(torch, decode, params, prompt, cfg, steps: int):
    """generate's greedy loop written out eagerly (the prefill, then
    decode_step at int positions, one launch after the other): what its
    captured step must equal on the card."""
    b, s = prompt.shape
    caches = decode.init_cache(cfg, b, s + steps, quantized=True)
    logits, _ = decode.prefill(params, prompt, caches, cfg)
    toks = [torch.argmax(logits, dim=-1)]
    for i in range(steps - 1):
        logits, _ = decode.decode_step(params, toks[-1], s + i, caches, cfg)
        toks.append(torch.argmax(logits, dim=-1))
    return torch.stack(toks, dim=1).cpu()


@contextlib.contextmanager
def _watched_graphs(graphs):
    """Collects every StepGraphs that graphs.for_device hands out inside
    the block (generate keeps its own out of reach)."""
    made, make = [], graphs.for_device

    def watched(device):
        made.append(make(device))
        return made[-1]

    graphs.for_device = watched
    try:
        yield made
    finally:
        graphs.for_device = make


def _graph_totals(made: list) -> dict:
    return {key: sum(g.stats[key] for g in made if g is not None)
            for key in ("captured", "capture_s", "replays")}


def phase_generate_int8kv(torch, kernels, device,
                          model_kw=DECODE_MODEL) -> dict:
    """bench.py:470-505 and :664 (decode_int8kv_tokens_per_sec): generate on
    the decode model at full width, int8 weights from seed 0, an int8 KV
    cache, prompts (8, 64), 64 and 192 steps. With kv_kernel AUTO every
    decode step of every layer attends through K5 ((steps - 1) x 8
    launches a call, held exactly); with kv_kernel=False the einsum path.
    Every stream of the kernel path is held to the einsum path's: equal,
    or the first divergence a near-tie. Tokens/s by the two-point rule
    (8 x 128 tokens over the time between the 64- and the 192-step call),
    after one warm-up pair; one profiled 64-step call of each path. Each
    call's decode steps are replays of one captured step: the 192-step
    call on the kernel path must equal the eager loop (_eager_generate)
    token for token. In the full script it runs at CUT_MODEL's depth
    (DEPTH_CUT)."""
    from tpu_bootstrap_torch.workload import decode, graphs, model, quant

    cfg = model.ModelConfig(**model_kw, compute_dtype=torch.bfloat16)
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
        with _watched_graphs(graphs) as made:
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
            "graphs": _graph_totals(made),
            "outputs": {st: c[0] for st, c in calls.items()}}
        paths[path]["profile"]["kernels_per_token"] = (
            paths[path]["profile"]["kernel_launches"] / (GEN_BATCH * d1))
        want = {st: (st - 1) * cfg.num_layers if path == "kernel" else 0
                for st in GEN_STEPS}
        if any(calls[st][2]["decode_attention"] != want[st]
               for st in GEN_STEPS):
            failed.append(f"{path} K5 launches {paths[path]['k5_launches']}"
                          f" != {want}")
    eager = _eager_generate(torch, decode, params, prompt, cfg, GEN_STEPS[1])
    graph_equal = bool(torch.equal(eager, paths["kernel"]["outputs"][
        GEN_STEPS[1]]))
    want_graphs = {"captured": len(GEN_STEPS),
                   "replays": sum(st - 2 for st in GEN_STEPS)}
    for path, p in paths.items():
        if {k: p["graphs"][k] for k in want_graphs} != want_graphs:
            failed.append(f"{path} graphs {p['graphs']} != {want_graphs}")
    if not graph_equal:
        failed.append("the captured step's tokens differ from the eager "
                      "loop's")
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
              "graph_equals_eager": graph_equal,
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


# The train phase's model on a one-rank NCCL mesh over the seven axes: the
# step's params and moments are DTensors, its attention runs under
# local_map. Predicted for the whole phase (NVIDIA H100 80GB HBM3, 700 W)
# before its first run on the card: 15-40 s (NCCL init, one init of
# TRAIN_MODEL, 6 steps a path of about 88 ms, a 1.6 GB checkpoint written
# and read).
MESH_PREDICTED_S = (15, 40)
MESH_STEPS = 6  # one warm-up and five timed, on each path


def _clone_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(torch, v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _mesh_attn_grads(torch, model, train, sharding, mesh, params, cfg,
                     tokens, attn) -> tuple:
    """(loss, {name: flat gradient over the layers}) of the mesh path's
    loss at ``params`` (DTensors): gathered through sharding.gather_tree,
    the attention in the local_map region, as descend computes them."""
    leaves = [blk[n] for n in ATTN_WEIGHTS for blk in params["blocks"]]
    held = [sharding.local(p) for p in leaves]
    grads_of = {id(p): t for p, t in zip(leaves, held)}
    for t in held:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            full = sharding.gather_tree(params, grads_of)
            loss = model.loss_fn(full, train.local_rows(tokens, mesh),
                                 cfg.model, attn)
            grads = torch.autograd.grad(loss, held)
    finally:
        for t in held:
            t.requires_grad_(False)
    layers = len(params["blocks"])
    return loss.item(), {n: torch.cat([g.flatten() for g in
                                       grads[i * layers:(i + 1) * layers]])
                         for i, n in enumerate(ATTN_WEIGHTS)}


def _timed_steps(torch, kernels, step, params, opt_state, tokens) -> dict:
    """MESH_STEPS steps from the state given (updated in place): one
    warm-up, then the rest timed with the launch counts set to 0 just
    before and read just after."""
    losses = [step(params, opt_state, tokens)[2].item()]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(MESH_STEPS - 1):
        losses.append(step(params, opt_state, tokens)[2].item())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (MESH_STEPS - 1)
    return {"losses": losses, "step_ms": step_s * 1e3,
            "launches": dict(kernels.LAUNCHES)}


def phase_train_mesh(torch, kernels, device) -> dict:
    """The train phase's model and batch (TRAIN_MODEL, seq 1024, batch 8,
    bf16, flash, seed 0, the tokens of _run_train) on a one-rank NCCL
    process group and build_mesh(MeshConfig()) over the seven axes:
    MESH_STEPS steps on the mesh against as many plain steps from the same
    state, each loss within FLASH_DENSE_TOL (bitwise equality and the
    largest gap reported); the first step's attention-weight gradients on
    the mesh path within ATTN_GRAD_TOL of the plain path's; K3 and K4
    launched num_layers times a timed mesh step, and their device time
    above 0 in a profiled mesh step (the kernels, not their plain
    versions, ran under local_map); every param and moment a DTensor
    placed as param_shardings says; a checkpoint saved on the mesh
    restored on the plain device bitwise, and on the mesh with the same
    placements; train_loop(cfg, 2, mesh=mesh) finite. Reported: ms a step
    on each path, the NCCL init seconds. The process group is destroyed on
    the way out."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from tpu_bootstrap_torch.workload import checkpoint, model, sharding, train
    from tpu_bootstrap_torch.workload.flash_attention import \
        make_flash_attn_fn

    cfg = train.TrainConfig(model=model.ModelConfig(
        **TRAIN_MODEL, max_seq_len=1024, compute_dtype=torch.bfloat16),
        attention="flash")
    layers = cfg.model.num_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1)
    try:
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe)  # NCCL's communicator comes up here
        torch.cuda.synchronize()
        nccl_init_s = time.perf_counter() - t0
        mesh = sharding.build_mesh(sharding.MeshConfig(), "cuda")
        params, opt_state = train.init_train_state(cfg, seed=0, device=device)
        mparams = sharding.shard_params(
            _clone_tree(torch, params),
            sharding.param_shardings(mesh, params))
        mopt = train.make_optimizer(cfg).init(mparams)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        tokens = torch.randint(0, cfg.model.vocab_size,
                               (8, cfg.model.max_seq_len), generator=gen,
                               device=device)
        flash = make_flash_attn_fn(block_size=cfg.attention_block)
        plain_loss, plain_grads = _attn_grads(torch, model, params, cfg,
                                              tokens, flash)
        mesh_loss, mesh_grads = _mesh_attn_grads(
            torch, model, train, sharding, mesh, mparams, cfg, tokens,
            train.mesh_attention(mesh, flash, cfg.model))
        grad_err = {n: ((mesh_grads[n] - plain_grads[n]).norm()
                        / plain_grads[n].norm()).item() for n in ATTN_WEIGHTS}
        del plain_grads, mesh_grads
        plain = _timed_steps(torch, kernels, train.make_train_step(cfg),
                             params, opt_state, tokens)
        del params, opt_state
        torch.cuda.empty_cache()
        mstep = train.make_train_step(cfg, mesh)
        meshed = _timed_steps(torch, kernels, mstep, mparams, mopt, tokens)
        per_step = {k: meshed["launches"][k] / (MESH_STEPS - 1)
                    for k in FLASH_KERNELS}
        profile = _profile(torch, lambda: mstep(mparams, mopt, tokens),
                           FLASH_TAGS)
        want = sharding.param_shardings(mesh, mparams)
        placed = all(
            sharding.is_placed(p) and tuple(p.placements)
            == tuple(sh.placements) and tuple(m.placements)
            == tuple(sh.placements)
            for p, sh, m in zip(train.tree_leaves(mparams),
                                train.tree_leaves(want),
                                mopt["mu"] + mopt["nu"]))
        placed = placed and len(mopt["mu"]) == len(mopt["nu"]) == len(
            train.tree_leaves(mparams))
        mgr = checkpoint.make_manager(f"{tmp}/ckpt")
        t1 = time.perf_counter()
        checkpoint.save(mgr, 1, mparams, mopt)
        save_s = time.perf_counter() - t1
        r_params, r_opt = checkpoint.restore(mgr, 1, device)
        restored_plain = all(
            torch.equal(a, sharding.local(b)) for a, b in zip(
                train.tree_leaves(r_params) + r_opt["mu"] + r_opt["nu"],
                train.tree_leaves(mparams) + mopt["mu"] + mopt["nu"]))
        del r_params, r_opt
        m_params, m_opt = checkpoint.restore(mgr, 1, mesh=mesh)
        restored_mesh = all(
            tuple(a.placements) == tuple(b.placements)
            and torch.equal(sharding.local(a), sharding.local(b))
            for a, b in zip(train.tree_leaves(m_params) + m_opt["mu"],
                            train.tree_leaves(mparams) + mopt["mu"]))
        del m_params, m_opt, mparams, mopt
        torch.cuda.empty_cache()
        loop = train.train_loop(cfg, 2, mesh=mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gaps = [abs(a - b) for a, b in zip(meshed["losses"], plain["losses"])]
    out = {"phase": "train_mesh", "predicted_s": list(MESH_PREDICTED_S),
           "mesh": "dcn,pipe,data,fsdp,expert,seq,tensor = 1 each, NCCL",
           "nccl_init_s": nccl_init_s, "mesh_losses": meshed["losses"],
           "plain_losses": plain["losses"],
           "losses_bitwise_equal": meshed["losses"] == plain["losses"],
           "max_loss_gap": max(gaps), "flash_dense_tol": FLASH_DENSE_TOL,
           "first_loss": {"mesh": mesh_loss, "plain": plain_loss},
           "attn_grad_err": grad_err, "attn_grad_tol": ATTN_GRAD_TOL,
           "step_ms": {"mesh": meshed["step_ms"], "plain": plain["step_ms"]},
           "launches": meshed["launches"], "launches_per_step": per_step,
           "profile": profile, "placed": placed, "checkpoint_save_s": save_s,
           "restored_plain_bitwise": restored_plain,
           "restored_mesh": restored_mesh, "train_loop_losses": loop}
    emit(out)
    ok = (max(gaps) <= FLASH_DENSE_TOL
          and max(grad_err.values()) <= ATTN_GRAD_TOL
          and all(per_step[k] == layers for k in per_step)
          and all(profile[k] > 0 for k in FLASH_TAGS)
          and placed and restored_plain and restored_mesh
          and len(loop) == 2 and all(math.isfinite(x) for x in loop)
          and all(math.isfinite(x) for x in meshed["losses"]))
    if not ok:
        raise SystemExit(
            f"train_mesh failed: gaps={gaps} grads={grad_err} "
            f"launches={per_step} profile={[profile[k] for k in FLASH_TAGS]}"
            f" placed={placed} restored={restored_plain, restored_mesh} "
            f"loop={loop}")
    return out


# The ring phase (queue 1 item 11b): ring attention's flash local body on
# K3/K4 at train_long's widths and length, B=2, S=8192, H=Hk=16, D=64, bf16,
# causal, in RING_SHARDS sequence shards of 2048. One card has no seq group,
# so ring_attention.ring_on_one_device runs every shard's body in one
# process, in lockstep: shard i at forward hop s holds the original KV shard
# (i-s-1) mod n, as the P2P ring would hand it (tests/test_torch_ring_
# attention.py holds the two bit for bit on gloo ranks). The schedule: a
# shard i runs i+1 K3 blocks (its diagonal causal, the earlier shards not),
# i+1 dq blocks and n-i dk/dv blocks, n(n+1)/2 = 10 of each at n = 4.
RING_CASE = ("ring", 2, 8192, 16, 16, 64, "bfloat16", True, False)
RING_SMALL = ("ring_small", 2, 1024, 16, 16, 64, "float32", True, False)
RING_SHARDS = 4
# The ring against one whole-sequence K3/K4 call on the same inputs, out
# elementwise as |got - want| <= rtol |want| + atol. bf16: rtol 2^-7, one
# bf16 ulp of the value (ulp(x) <= 2^-7 |x|): the two sides round their
# f32 results apart and may land an ulp apart; atol 2^-10 for the values
# near 0, where the ring's extra rounding of each block's out to bf16
# (2^-9 of a block's out, which may be larger than the merged value)
# outweighs the relative term. On an NVIDIA H100 80GB HBM3 (700.00 W) the
# ring read 0.64 of this limit (2^-9 where |out| = 0.28 in shard 1, at
# most 2^-10 in shards 2 and 3), and a 5% overweight of shard 3's fold of
# shard 0 (the ``late`` control) 2.9 of it, the other controls 100 or
# more; the former limit, (2^-6, 2^-6), about the size of a median |out|
# in the late shards (0.013-0.02), read that overweight 0.19. dq, dk, dv:
# both sides are the tensor-core kernels', each within FLASH_TOL (max |got
# - want| / max |want|) of the exact f32 values (k4 read at most 0.0078
# on the card), so twice that: the ring only splits the f32 sums into
# blocks and rounds each block's gradients to bf16 once more. f32 and the
# dense core at S=1024 against the plain versions: the order of f32 sums,
# k3's and k4's f32 limits.
RING_OUT_TOL = {"bfloat16": (2 ** -7, 2 ** -10), "float32": (1e-5, 1e-5)}
RING_GRAD_TOL = {"bfloat16": 2 * FLASH_TOL["bfloat16"],
                 "float32": FLASH_TOL["float32"]}
RING_PREDICTED_S = (2, 8)
LATE_WEIGHT = 1.05  # the ``late`` control's weight on shard n-1's first fold


def _ring_check(torch, got_out, got_grads, want_out, want_grads,
                dtype: str) -> dict:
    """The ring's out and gradients against a whole-sequence result."""
    out = {"out_tol_ratio": _tol_ratio(torch, got_out, want_out,
                                       RING_OUT_TOL[dtype]),
           "max_abs_err": (got_out.float() - want_out.float()).abs().max()
           .item()}
    if got_grads is not None:
        out["grad_rel_err"] = {
            name: _rel_err(torch, g, w) for name, g, w in
            zip(("dq", "dk", "dv"), got_grads, want_grads)}
    out["close"] = (out["out_tol_ratio"] <= 1 and bool(
        torch.isfinite(got_out.float()).all()) and all(
        e <= RING_GRAD_TOL[dtype] for e in out.get("grad_rel_err",
                                                    {}).values()))
    return out


def _ring_run(torch, ring, shards, ws, attention: str) -> tuple:
    """(out, (dq, dk, dv)) of the ring over the shards, whole along S."""
    outs, grads = ring.ring_on_one_device(*shards, ws, attention)
    cat = lambda ts: torch.cat(ts, dim=1)  # noqa: E731
    return cat(outs), (None if grads is None else tuple(map(cat, grads)))


def _whole(torch, fa, q, k, v, w, causal: bool = True) -> tuple:
    """One whole-sequence call: K3's (out, lse), then K4's dq and dk/dv on
    delta = rowsum(w * out) (fa's dispatch: the kernels on the card)."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa._fwd(q, k, v, scale, causal)
    delta = (w.float() * out.float()).sum(-1).contiguous()
    return out, (fa._dq(q, k, v, w, lse, delta, scale, causal),
                 *fa._dkv(q, k, v, w, lse, delta, scale, causal))


class _Forced:
    """A control: fa's dispatch with the diagonal run non-causal
    (``causal``), the first non-causal K3 block's fold dropped (``drop``:
    its lse at -1e30, so logaddexp gives it no weight), or the last one's,
    shard n-1's fold of shard 0, weighted LATE_WEIGHT times too much
    (``late``: its lse raised by log LATE_WEIGHT)."""

    def __init__(self, fa, mode: str, n: int = RING_SHARDS):
        self.fa, self.mode, self.n, self.saved = fa, mode, n, None

    def __enter__(self):
        fa, plain = self.fa, (self.fa._fwd, self.fa._dq, self.fa._dkv)
        self.saved, folds = plain, []
        last = self.n * (self.n - 1) // 2

        def fwd(q, k, v, scale, causal):
            if self.mode == "causal":
                return plain[0](q, k, v, scale, False)
            out, lse = plain[0](q, k, v, scale, causal)
            if not causal:
                folds.append(True)
                if self.mode == "drop" and len(folds) == 1:
                    lse = lse.new_full(lse.shape, -1e30)
                elif self.mode == "late" and len(folds) == last:
                    lse = lse + math.log(LATE_WEIGHT)
            return out, lse

        fa._fwd = fwd
        if self.mode == "causal":
            fa._dq = lambda *a: plain[1](*a[:-1], False)
            fa._dkv = lambda *a: plain[2](*a[:-1], False)
        return self

    def __exit__(self, *exc):
        self.fa._fwd, self.fa._dq, self.fa._dkv = self.saved


def phase_ring(torch, fa, kernels, device, case=RING_CASE, small=RING_SMALL,
               n: int = RING_SHARDS, timer=None) -> dict:
    """ring_attention.ring_on_one_device (the flash local body) on the
    card: ``case``'s q, k, v and a cotangent w of out cut into ``n``
    sequence shards; out, dq, dk and dv against one whole-sequence K3/K4
    call within RING_OUT_TOL / RING_GRAD_TOL, and three controls outside
    (the diagonal non-causal: out and every gradient; the first earlier
    fold dropped, and shard n-1's first fold weighted LATE_WEIGHT times
    too much: out);
    K3, K4's dq and its dk/dv each launched n(n+1)/2 times in the counted
    run (counts set to 0 just before); the f32 route and the dense core at
    ``small``'s shape against the plain versions. Timed: the ring forward
    and forward + backward beside the whole-sequence call's, SDPA's
    (forward and backward on the whole sequence) and the bound of the
    same work."""
    from tpu_bootstrap_torch.workload import ring_attention as ring

    def shards_of(*ts):
        return [[t.chunk(n, dim=1)[i].contiguous() for i in range(n)]
                for t in ts]

    q, k, v, w, _ = _flash_inputs(torch, device, case, seed=70)
    whole_out, whole_grads = _whole(torch, fa, q, k, v, w)
    qs, ks, vs, ws = shards_of(q, k, v, w)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out, grads = _ring_run(torch, ring, (qs, ks, vs), ws, "flash")
    torch.cuda.synchronize()
    launches = {k_: kernels.LAUNCHES[k_] for k_ in FLASH_KERNELS}
    want = n * (n + 1) // 2
    dtype = case[6]
    rows = {"bf16": _ring_check(torch, out, grads, whole_out, whole_grads,
                                dtype)}
    del out, grads
    controls = {}
    for mode in ("causal", "drop", "late"):
        with _Forced(fa, mode, n):
            c_out, c_grads = _ring_run(torch, ring, (qs, ks, vs),
                                       ws if mode == "causal" else None,
                                       "flash")
        controls[mode] = _ring_check(torch, c_out, c_grads, whole_out,
                                     whole_grads, dtype)
        del c_out, c_grads
    controls_ok = (all(controls[m]["out_tol_ratio"] > 1
                       for m in ("causal", "drop", "late"))
                   and all(e > RING_GRAD_TOL[dtype] for e in
                           controls["causal"]["grad_rel_err"].values()))
    # The f32 route and the dense core against the plain versions.
    sq, sk, sv, sw, _ = _flash_inputs(torch, device, small, seed=71)
    scale = sq.shape[-1] ** -0.5
    p_out, p_lse = fa.attention_plain(sq, sk, sv, scale, True)
    p_delta = (sw.float() * p_out.float()).sum(-1)
    p_grads = fa.attention_bwd_plain(sq, sk, sv, sw, p_lse, p_delta, scale,
                                     True)
    small_shards = shards_of(sq, sk, sv, sw)
    small_launches = {}
    for attention in ("flash", "dense"):
        kernels.reset_launches()
        s_out, s_grads = _ring_run(torch, ring, small_shards[:3],
                                   small_shards[3], attention)
        torch.cuda.synchronize()
        small_launches[attention] = {k_: kernels.LAUNCHES[k_]
                                     for k_ in FLASH_KERNELS}
        rows[f"f32_{attention}"] = _ring_check(torch, s_out, s_grads, p_out,
                                               p_grads, small[6])
        del s_out, s_grads
    del p_out, p_lse, p_grads, small_shards
    # Times: the ring against the whole call, SDPA and the bound.
    timer = timer or Timer(torch, device, reps=10)
    e = q.element_size()
    _, b, s, h, _, d, _, causal, _ = case
    fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * e + 4 * b * s * h
    all_bytes = fwd_bytes + (2 * q.numel() + k.numel() + v.numel()) * e
    times = {
        "ring_fwd_ms": timer(lambda: ring.ring_on_one_device(
            qs, ks, vs, None, "flash")),
        "ring_ms": timer(lambda: ring.ring_on_one_device(
            qs, ks, vs, ws, "flash")),
        "whole_fwd_ms": timer(lambda: fa._fwd(q, k, v, d ** -0.5, True)),
        "whole_ms": timer(lambda: _whole(torch, fa, q, k, v, w))}
    qt, kt, vt = [t.requires_grad_(True) for t in _sdpa_layout(torch, q, k,
                                                                v)]
    wt = w.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        ot = sdpa(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(ot, (qt, kt, vt), wt)

    times["library_ms"] = timer(library)
    times["bound_fwd_ms"], _ = _flash_bound(case, 2, fwd_bytes)
    times["bound_ms"], times["bound_by"] = _flash_bound(case, 7, all_bytes)
    del qt, kt, vt, wt, timer
    schedule_ok = (all(launches[k_] == want for k_ in FLASH_KERNELS)
                   and all(small_launches["flash"][k_] == want
                           for k_ in FLASH_KERNELS)
                   and not any(small_launches["dense"].values()))
    result = {"phase": "ring", "predicted_s": list(RING_PREDICTED_S),
              "B": b, "S": s, "H": h, "D": d, "dtype": dtype, "shards": n,
              "launches": launches, "launches_want": want,
              "small_launches": small_launches, "rows": rows,
              "controls": controls, "out_tol": RING_OUT_TOL,
              "grad_tol": RING_GRAD_TOL, **times,
              "max_abs_err": rows["bf16"]["max_abs_err"]}
    emit(result)
    del q, k, v, w, whole_out, whole_grads, qs, ks, vs, ws
    torch.cuda.empty_cache()
    if not (all(r["close"] for r in rows.values()) and controls_ok
            and schedule_ok):
        raise SystemExit(f"ring failed: rows={rows} controls={controls} "
                         f"launches={launches} small={small_launches}")
    return result


# The pipeline phase (queue 1 item 11c): the train phase's model, batch and
# tokens in PIPE_STAGES stages of 4 layers and PIPE_MICROBATCHES
# microbatches of 2 rows, every stage in one process
# (pipeline.pipeline_on_one_device: the stages' generators in lockstep, the
# hops handed over in memory), under GPipe and 1F1B. A step launches each
# stage's K3/K4 for every microbatch: GPipe M x L = 32 of K3, dq and dk/dv;
# 1F1B 2 M L = 64 of K3 (the F turn and the B turn's recompute) and 32 of
# dq and dk/dv. Predicted for the whole phase (NVIDIA H100 80GB HBM3, 700 W)
# before its first run on the card: 5-20 s (two inits of TRAIN_MODEL, 3
# plain and 4 pipelined steps a schedule of 100-250 ms, three first-step
# gradient passes and a profiled step each).
PIPE_STAGES = 2
PIPE_MICROBATCHES = 4
PIPE_STEPS = 3  # one warm-up and two timed, on each path
PIPE_PREDICTED_S = (5, 20)


@contextlib.contextmanager
def _zero_cotangents(torch, ring_attention):
    """The control: every cotangent a stage sends back arrives as zeros,
    so stage s < P-1 runs its B turns seeded with nothing (the lockstep of
    pipeline_on_one_device, wrapped)."""
    plain = ring_attention.lockstep

    def zeroed(body):
        try:
            sent = next(body)
            while True:
                fwd, bwd = yield sent
                sent = body.send((fwd, tuple(torch.zeros_like(t)
                                             for t in bwd)))
        except StopIteration as done:
            return done.value

    ring_attention.lockstep = lambda bodies: plain([zeroed(b)
                                                    for b in bodies])
    try:
        yield
    finally:
        ring_attention.lockstep = plain


def _steps_held(torch, kernels, step, timed: int) -> dict:
    """``timed`` calls of ``step`` (-> loss) with the launch counts set to
    0 just before and read just after; ms a step, and the peak memory
    above what was allocated before (the train state)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [step().item() for _ in range(timed)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    return {"losses": losses, "step_ms": step_s * 1e3,
            "launches": {k: kernels.LAUNCHES[k] for k in FLASH_KERNELS},
            "state_bytes": state,
            "peak_above_state": torch.cuda.max_memory_allocated() - state}


def _grad_err(plain: dict, blocks: dict) -> dict:
    return {n: ((blocks[n].flatten() - plain[n]).norm()
                / plain[n].norm()).item() for n in ATTN_WEIGHTS}


def phase_pipeline(torch, kernels, device, model_kw=TRAIN_MODEL,
                   seq: int = 1024, batch: int = 8) -> dict:
    """pipeline_on_one_device under GPipe and 1F1B from the plain path's
    init and tokens (TRAIN_MODEL, seq 1024, batch 8, bf16, flash, the
    tokens of _run_train), PIPE_STEPS steps each (the grad function, then
    train.apply_update) against as many plain steps: every loss within
    FLASH_DENSE_TOL of the plain step's; the first step's attention-weight
    gradients within ATTN_GRAD_TOL of the plain path's, and the control
    (_zero_cotangents) outside; each timed step launching K3/K4 as the
    schedule implies, their device time above 0 in a profiled step; 1F1B's
    active ticks 2M P of (2M + 2(P-1)) P; 1F1B's peak memory above the train
    state below GPipe's. Reported: ms a step and peak memory of each."""
    from tpu_bootstrap_torch.workload import (model, pipeline,
                                              ring_attention, train)
    from tpu_bootstrap_torch.workload.flash_attention import \
        make_flash_attn_fn

    cfg = train.TrainConfig(model=model.ModelConfig(
        **model_kw, max_seq_len=seq, compute_dtype=torch.bfloat16),
        attention="flash", num_microbatches=PIPE_MICROBATCHES)
    layers, M, P = cfg.model.num_layers, PIPE_MICROBATCHES, PIPE_STAGES
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.model.vocab_size, (batch, seq),
                           generator=gen, device=device)
    params, opt_state = train.init_train_state(cfg, seed=0, device=device)
    _, plain_grads = _attn_grads(torch, model, params, cfg, tokens,
                                 make_flash_attn_fn(
                                     block_size=cfg.attention_block))
    step = train.make_train_step(cfg)
    losses = [step(params, opt_state, tokens)[2].item()]
    plain = _steps_held(torch, kernels,
                        lambda: step(params, opt_state, tokens)[2],
                        PIPE_STEPS - 1)
    plain["losses"] = losses + plain["losses"]
    del params, opt_state, step
    torch.cuda.empty_cache()
    runs, want = {}, {"gpipe": {"flash_fwd": M * layers,
                                "flash_dq": M * layers,
                                "flash_dkv": M * layers},
                      "1f1b": {"flash_fwd": 2 * M * layers,
                               "flash_dq": M * layers,
                               "flash_dkv": M * layers}}
    for schedule in pipeline.SCHEDULES:
        params = model.init_params(cfg.model, seed=0, device=device)
        params = {**params, "blocks": pipeline.stack_block_params(
            params["blocks"])}
        opt = train.make_optimizer(cfg)
        opt_state = opt.init(params)
        leaves = train.tree_leaves(params)

        def grads_of():
            return pipeline.pipeline_on_one_device(
                cfg, params, tokens[:, :-1], tokens[:, 1:], stages=P,
                schedule=schedule)

        def one_step():
            loss, grads, _ = grads_of()
            train.apply_update(opt, opt_state, leaves, leaves,
                               train.tree_leaves(grads))
            return loss

        with _zero_cotangents(torch, ring_attention):
            control = _grad_err(plain_grads, grads_of()[1]["blocks"])
        loss, grads, stats = grads_of()
        grad_err = _grad_err(plain_grads, grads["blocks"])
        train.apply_update(opt, opt_state, leaves, leaves,
                           train.tree_leaves(grads))
        del grads
        run = _steps_held(torch, kernels, one_step, PIPE_STEPS - 1)
        run["losses"] = [loss.item()] + run["losses"]
        run.update(
            stats=stats, attn_grad_err=grad_err,
            control_attn_grad_err=control,
            launches_per_step={k: v / (PIPE_STEPS - 1)
                               for k, v in run["launches"].items()},
            profile=_profile(torch, one_step, FLASH_TAGS))
        runs[schedule] = run
        del params, opt_state, leaves
        torch.cuda.empty_cache()
    del plain_grads
    gaps = {s: [abs(a - b) for a, b in zip(r["losses"], plain["losses"])]
            for s, r in runs.items()}
    checks = {
        "losses": all(max(g) <= FLASH_DENSE_TOL for g in gaps.values())
        and all(math.isfinite(x) for r in runs.values()
                for x in r["losses"]),
        "grads": all(max(r["attn_grad_err"].values()) <= ATTN_GRAD_TOL
                     for r in runs.values()),
        "control": all(min(r["control_attn_grad_err"].values())
                       > ATTN_GRAD_TOL for r in runs.values()),
        "launches": all(runs[s]["launches_per_step"] == want[s]
                        for s in runs),
        "profile": all(r["profile"][k] > 0 for r in runs.values()
                       for k in FLASH_TAGS),
        "ticks": runs["1f1b"]["stats"]["active_ticks"] == 2 * M * P
        and runs["1f1b"]["stats"]["total_ticks"] == (2 * M + 2 * (P - 1))
        * P,
        "memory": 0 < runs["1f1b"]["peak_above_state"]
        < runs["gpipe"]["peak_above_state"]}
    out = {"phase": "pipeline", "predicted_s": list(PIPE_PREDICTED_S),
           "stages": P, "microbatches": M, "batch": batch, "seq": seq - 1,
           "plain": plain, **runs, "loss_gaps": gaps,
           "flash_dense_tol": FLASH_DENSE_TOL,
           "attn_grad_tol": ATTN_GRAD_TOL, "launches_want": want,
           "checks": checks}
    emit(out)
    if not all(checks.values()):
        found = {s: (r["attn_grad_err"], r["launches_per_step"])
                 for s, r in runs.items()}
        raise SystemExit(f"pipeline failed: {checks} gaps={gaps} "
                         f"grads, launches={found}")
    return out


# Several cards (``torchrun --nproc-per-node 4 chip_smoke.py
# --mesh-cards``): the train phase's model and batch on meshes whose
# collectives cross cards, each held to the plain path on one card, MESH_STEPS
# steps from the same init: (mesh extents, model keys beside TRAIN_MODEL's,
# compute dtype). A mesh with seq > 1 takes max_seq_len seq + 1, so that the
# shifted 1024 positions cut into the seq shards; the last case is the
# decode model's 8-expert top-2 stack at the train widths, its experts over
# ``expert`` and its rows over seq.
#
# Routing is discontinuous: a token whose second and third gates nearly tie
# takes the other expert under float noise, and every later token of its
# row may then keep other slots. Once the two paths route one token apart
# they compute different functions, and the updates carry the difference
# into every layer's router. So an MoE case records its routing on both
# paths (_watch_routes) and is held to FLASH_DENSE_TOL at every step up to
# and including the first that routes a token apart on some rank; there
# every token routed apart first must have had a plain selection margin
# (top-k gate less the next) under FLIP_MARGIN, and the later steps are
# reported. On four NVIDIA H100 80GB HBM3 (700.00 W), over six steps: f32,
# the first loss bitwise, the second 4.9e-5 off with 2 tokens of one rank
# flipped at margins <= 7.0e-7 (11 more kept other slots), then 410 to
# 3,923 flips a step and gaps to 1.6e-3; bf16, 457-561 flips a rank in the
# first forward (margins to 9.1e-3, the ring's block roundings) and gaps
# from 5.5e-4 to 1.8e-2. So the MoE case computes in f32. FLIP_MARGIN is
# ten times the f32 first flips' margin: a flip above it means the paths
# routed on different numbers, not on f32 noise.
FLIP_MARGIN = 1e-5
# The pipeline cases run the schedule named last, M = 2 x pipe = 4
# microbatches of the batch: a rank launches K3/K4 for its stage's L/P
# layers on every microbatch (K3 twice under 1F1B: the recompute).
MESH_CARDS = ((dict(fsdp=2, tensor=2), {}, "bfloat16", "gpipe"),
              (dict(dcn=2, data=2), {}, "bfloat16", "gpipe"),
              (dict(seq=4), {}, "bfloat16", "gpipe"),
              (dict(expert=2, seq=2), MOE_MODEL, "float32", "gpipe"),
              (dict(pipe=2, data=2), {}, "bfloat16", "gpipe"),
              (dict(pipe=2, tensor=2), {}, "bfloat16", "1f1b"))


@contextlib.contextmanager
def _watch_routes(torch, found: list):
    """Record every MoE layer's routing while the steps run, one entry a
    call of moe._route: each token's chosen (top_k) and kept experts
    (B, S, E) as uint8, its selection margin (its top_k-th gate less the next: near 0, float noise
    can hand the token another expert), the least order margin (largest
    gate less the second) and the kept slots."""
    from tpu_bootstrap_torch.workload import moe

    route = moe._route

    def watched(block, h, cfg, batch_mean=None):
        dispatch, combine, aux = route(block, h, cfg, batch_mean)
        with torch.no_grad():
            gates = torch.softmax(torch.einsum(
                "bsm,me->bse", h.float(), block["router"].float()), -1)
            k = cfg.expert_top_k
            top = gates.topk(min(k + 1, cfg.num_experts), dim=-1).values
            kept = dispatch.sum(dim=-1)
            chosen = torch.zeros_like(gates, dtype=torch.uint8).scatter_(
                -1, gates.topk(k, dim=-1).indices, 1)
            found.append({
                "kept": kept.to(torch.uint8), "chosen": chosen,
                "sel": (top[..., k - 1] - top[..., k] if k < top.shape[-1]
                        else top[..., k - 1]),
                "order": (top[..., 0] - top[..., 1]).min().item(),
                "slots": int(kept.sum().item())})
        return dispatch, combine, aux

    moe._route = watched
    try:
        yield found
    finally:
        moe._route = route


def _route_flips(plain: list, meshed: list, rows: slice,
                 layers: int) -> list:
    """Step by step, the mesh's routing of this rank's rows against the
    plain path's routing of the same rows (both recorded by _watch_routes),
    summed over the layers: the tokens whose chosen experts differ
    (``flips``), the tokens that chose alike but kept other experts
    (``drops``: a flip earlier in the row moved their slots past
    capacity), and the largest plain selection margin among the flips of
    tokens routed alike in every earlier layer of the step (``flip_margin``:
    a later layer's h carries the earlier difference); the least plain
    selection and order margins over the rows and each path's kept
    slots."""
    steps = []
    for t in range(len(plain) // layers):
        step = {"flips": 0, "drops": 0, "flip_margin": None,
                "least_margin": None, "order_margin": None,
                "slots": {"plain": 0, "mesh": 0}}
        before = None  # tokens routed differently in an earlier layer
        for p, m in zip(plain[t * layers:(t + 1) * layers],
                        meshed[t * layers:(t + 1) * layers]):
            sel = p["sel"][rows]
            flip = (p["chosen"][rows] != m["chosen"]).any(dim=-1)
            differ = (p["kept"][rows] != m["kept"]).any(dim=-1) | flip
            step["flips"] += int(flip.sum().item())
            step["drops"] += int((differ & ~flip).sum().item())
            new = flip if before is None else flip & ~before
            if new.any():
                step["flip_margin"] = max(step["flip_margin"] or 0.0,
                                          sel[new].max().item())
            before = differ if before is None else before | differ
            step["least_margin"] = min(step["least_margin"] or 1.0,
                                       sel.min().item())
            step["order_margin"] = min(step["order_margin"] or 1.0,
                                       p["order"])
            step["slots"]["plain"] += int(p["kept"][rows].sum().item())
            step["slots"]["mesh"] += m["slots"]
        steps.append(step)
    return steps


def phase_mesh_cards(torch, kernels, device, model_kw=TRAIN_MODEL,
                     seq: int = 1024, batch: int = 8,
                     cards=MESH_CARDS) -> dict:
    """On every rank of the process group, for each case of ``cards``:
    MESH_STEPS steps of the whole batch on this rank's card (once a model),
    then as many steps on the case's mesh from the same init (each rank
    its rows, positions and shards), the launch counts over the timed
    steps. Each mesh loss must be equal on every rank and within
    FLASH_DENSE_TOL of the plain path's step for step (an MoE case's up to
    the first step that routes a token apart, whose first flips must lie
    under FLIP_MARGIN: _watch_routes, _route_flips), and K3/K4 must launch
    as the schedule says on every rank: num_layers times a step, on a
    ring of n the shard i's (i+1) K3 and dq blocks and (n-i) dk/dv blocks
    a layer, and in a pipeline of P stages M L / P of each a step (2 M L /
    P of K3 under 1F1B). Rank 0 gets every rank's record."""
    import dataclasses

    import torch.distributed as dist

    from tpu_bootstrap_torch.workload import model, sharding, train
    from tpu_bootstrap_torch.workload.data import host_rows

    plains, runs = {}, []
    for extents, extra, dtype, schedule in cards:
        more = 1 if extents.get("seq", 1) > 1 else 0
        cfg0 = train.TrainConfig(model=model.ModelConfig(
            **model_kw, **extra, max_seq_len=seq + more,
            compute_dtype=getattr(torch, dtype)), attention="flash")
        moe_case = cfg0.model.num_experts > 1
        key = (tuple(sorted(extra.items())), more, dtype)
        if key not in plains:
            gen = torch.Generator()
            gen.manual_seed(1)
            tokens = torch.randint(0, cfg0.model.vocab_size,
                                   (batch, seq + more),
                                   generator=gen).to(device)
            params, opt_state = train.init_train_state(cfg0, seed=0,
                                                       device=device)
            with _watch_routes(torch, []) as routes:
                plain = _timed_steps(torch, kernels,
                                     train.make_train_step(cfg0), params,
                                     opt_state, tokens)
            plains[key] = (tokens, plain, routes)
            del params, opt_state
            torch.cuda.empty_cache()
        tokens, plain, plain_routes = plains[key]
        cfg = dataclasses.replace(cfg0, mesh=sharding.MeshConfig(**extents),
                                  pipeline_schedule=schedule)
        mesh = sharding.build_mesh(cfg.mesh, device.type)
        params, opt_state = train.init_train_state(cfg, seed=0, mesh=mesh)
        with _watch_routes(torch, []) as routes:
            run = _timed_steps(torch, kernels,
                               train.make_train_step(cfg, mesh), params,
                               opt_state, tokens)
        run.update(extents=extents, extra=extra, dtype=dtype, plain=plain,
                   dp=sharding.dp_coordinate(mesh),
                   seq_index=mesh.get_coordinate()[
                       sharding.AXES.index("seq")],
                   local_wq=list(sharding.local(
                       params["blocks"]["wq"] if cfg.mesh.pipe > 1
                       else params["blocks"][0]["wq"]).shape))
        if moe_case:
            run["routes"] = _route_flips(
                plain_routes, routes,
                host_rows(batch, *sharding.dp_coordinate(mesh)),
                cfg.model.num_layers)
        runs.append(run)
        del params, opt_state, routes
        torch.cuda.empty_cache()
    mine = {"rank": dist.get_rank(), "meshes": runs}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    failed = []
    layers = model_kw["num_layers"]
    for i, (extents, *_) in enumerate(cards):
        ranks = [r["meshes"][i] for r in everyone]
        plain = ranks[0]["plain"]
        if any(r["losses"] != ranks[0]["losses"] for r in ranks):
            failed.append(f"{extents}: losses differ across ranks")
        gaps = [abs(a - b) for a, b in zip(ranks[0]["losses"],
                                           plain["losses"])]
        held = len(gaps)
        if "routes" in ranks[0]:
            apart = [t for t in range(held) if any(
                r["routes"][t]["flips"] or r["routes"][t]["drops"]
                for r in ranks)]
            if apart:
                held = apart[0] + 1
                first = [r["routes"][apart[0]] for r in ranks]
                margin = max(f["flip_margin"] or 0.0 for f in first)
                if not any(f["flips"] for f in first) or margin > FLIP_MARGIN:
                    failed.append(f"{extents}: step {held} routed apart at "
                                  f"margin {margin} (limit {FLIP_MARGIN})")
        ranks[0]["max_gap_to_plain"] = max(gaps)
        ranks[0]["held_steps"] = held
        if max(gaps[:held]) > FLASH_DENSE_TOL:
            failed.append(f"{extents}: gaps {gaps[:held]} to the plain path")
        n, stages = extents.get("seq", 1), extents.get("pipe", 1)
        for r in ranks:
            j = r["seq_index"]
            want = {"flash_fwd": j + 1, "flash_dq": j + 1,
                    "flash_dkv": n - j}
            if stages > 1:
                m = 2 * stages  # num_microbatches 0: twice the stages
                want = {"flash_fwd": m * (2 if cards[i][3] == "1f1b"
                                          else 1),
                        "flash_dq": m, "flash_dkv": m}
            per = {k: r["launches"][k] / (MESH_STEPS - 1)
                   for k in FLASH_KERNELS}
            here = layers // stages
            if any(per[k] != here * want[k] for k in per):
                failed.append(f"{extents}: launches {per}, want {here} x "
                              f"{want}")
    out = {"phase": "mesh_cards", "world": dist.get_world_size(),
           "flash_dense_tol": FLASH_DENSE_TOL, "ranks": everyone,
           "failed": failed}
    if dist.get_rank() == 0:
        emit(out)
    if failed:
        raise SystemExit(f"mesh_cards failed: {failed}")
    return out


def mesh_cards_main(torch) -> int:
    """``--mesh-cards``, under torchrun: join the group as the train
    worker does (``train.rendezvous``), build the kernels once (rank 0
    first), run phase_mesh_cards, and print the device line on rank 0."""
    import torch.distributed as dist

    from tpu_bootstrap_torch.workload import kernels, train

    if not train.rendezvous():
        raise SystemExit("--mesh-cards runs under torchrun (WORLD_SIZE > 1)")
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device
    try:
        info = phase_device(torch) if dist.get_rank() == 0 else None
        if dist.get_rank() == 0:
            kernels.build()
        dist.barrier()
        phase_mesh_cards(torch, kernels, torch.device(
            "cuda", torch.cuda.current_device()))
        if dist.get_rank() == 0:
            emit({"ok": True, "device": {"platform": "gpu",
                                         "kind": info["name"],
                                         "count": info["count"]}})
    finally:
        dist.destroy_process_group()
    return 0


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


# bench.py:350-458: the quantization ladder, speculative acceptance and a
# distilled draft on a model trained in the phase, on quality.markov_batch's
# chain over a 4096-token sub-vocabulary (p 0.85, seed 0), at TRAIN_MODEL's
# widths, max_seq_len 1024, batch 8.
QUALITY_VOCAB, QUALITY_BATCH, QUALITY_SEQ = 4096, 8, 1024
QUALITY_STEPS = 300
QUALITY_HELD_OUT = (10_000, 129)  # markov_batch's (step, seq_len)
QUALITY_PROMPT = (20_000, 16)
QUALITY_SPEC_STEPS = 48
DISTILL_LAYERS, DISTILL_STEPS, DISTILL_STEP0 = 2, 150, 500
TWO_POINT = (32, 96)  # bench.py:445-452's generate lengths
TWO_POINT_PAIRS = 3
# QLoRA: the int8 trained model fine-tuned on a second chain (another
# permutation, seed 1) at LoraConfig's defaults (rank 8, alpha 16, wq and
# wv), then merged, quantized again and served QLORA_NEW greedy tokens.
QLORA_STEPS, QLORA_TASK_SEED, QLORA_NEW = 20, 1, 8


def chain_floor(p: float, vocab: int) -> float:
    """The chain's cross-entropy floor (nats): next = perm[cur] with
    probability p + (1 - p) / vocab, each other token (1 - p) / vocab."""
    hit, miss = p + (1 - p) / vocab, (1 - p) / vocab
    return -hit * math.log(hit) - (vocab - 1) * miss * math.log(miss)


# The phase's limits are tests/test_quality.py:64-147's, on the reference
# test's chain (p 0.9, vocabulary 128). Its "trained, not noise" limit,
# ppl_base < 5, sits 0.805 nats above that chain's floor (2.24); this chain's
# floor (p 0.85, vocabulary 4096) is 5.31, so no model can reach 5 here, and
# the phase holds the same margin above its own floor: 11.9.
QUALITY_LIMITS = {
    "trained_loss_frac": 0.6,
    "int8_agreement_pct": 85.0, "int8_ppl_delta": 0.5,
    "int4_agreement_pct": 60.0, "int4_ppl_delta": 2.0,
    "ppl_base": math.exp(chain_floor(0.85, QUALITY_VOCAB)
                         + math.log(5.0) - chain_floor(0.9, 128)),
    "mean_committed": 1.5,
}


def _bf16_copy(torch, tree):
    """The tree with every f32 tensor cast to bf16 (serving's copy of f32
    masters, as bench.py's _bf16)."""
    if isinstance(tree, dict):
        return {k: _bf16_copy(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_copy(torch, v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16)
    return tree


def _chain(torch, quality, step: int, seq: int, device, seed: int = 0):
    return torch.from_numpy(quality.markov_batch(
        step, QUALITY_BATCH, seq, QUALITY_VOCAB, seed=seed)).to(device)


FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def _counted_steps(kernels, run_step, steps: int) -> tuple:
    """``run_step(i)`` for each step, with the flash kernels' launches of
    each step: (the steps' losses, read after the loop, and the set of
    distinct per-step launch tuples, FLASH_KERNELS' order)."""
    losses, per_step = [], set()
    for i in range(steps):
        before = [kernels.LAUNCHES[k] for k in FLASH_KERNELS]
        losses.append(run_step(i))
        per_step.add(tuple(kernels.LAUNCHES[k] - b
                           for k, b in zip(FLASH_KERNELS, before)))
    return [x.item() for x in losses], per_step


def _trained_t_check(torch, kernels, quant, model, params, q8, q4, cfg,
                     tokens) -> dict:
    """K1 and K6 at T = batch x (S - 1), the rows score's projections
    launch, against their plain versions: the first layer's normed
    activations of the held-out batch against its int8 and int4 wqkv."""
    h = model._rms_norm(params["embed"][tokens[:, :-1]].to(cfg.compute_dtype),
                        params["blocks"][0]["attn_norm"])
    x = h.reshape(-1, h.shape[-1]).contiguous()
    w8, w4 = q8["blocks"][0]["wqkv"], q4["blocks"][0]["wqkv"]
    k4 = quant._k4(w4)
    pairs = {"int8_matmul": (kernels.int8_matmul(x, w8.q, w8.s),
                             quant.int8_matmul_plain(x, w8.q, w8.s)),
             "int4_matmul": (kernels.int4_matmul(x, w4.q, w4.s, w4.group, k4),
                             quant.int4_matmul_plain(x, w4.q, w4.s, w4.group,
                                                     k4))}
    rtol, atol = MATMUL_TOL[str(x.dtype).removeprefix("torch.")]
    out = {"T": x.shape[0], "K": x.shape[1]}
    for name, (got, want) in pairs.items():
        got, want = got.float(), want.float()
        out[name] = {
            "N": got.shape[-1],
            "max_abs_err": (got - want).abs().max().item(),
            "close": bool(torch.isfinite(got).all())
            and torch.allclose(got, want, rtol=rtol, atol=atol)}
    return out


def _cutoff_gaps(torch, decode, params, cfg, tokens) -> dict:
    """Sampling's cutoffs (SAMPLE_KW: top-k, then the nucleus) at the
    held-out positions: how many tokens the filters keep, the gap (in
    logits over the temperature, what the filters compare) between the
    last kept logit and the next, and the share of positions where that
    gap is under NEAR_TIE's bf16 limit (where two bf16 runs may fairly
    keep different sets)."""
    b, s = tokens.shape
    with torch.no_grad():
        logits, _ = decode.prefill(
            params, tokens[:, :-1],
            decode.init_cache(cfg, b, s - 1, device=tokens.device), cfg,
            kv_kernel=False, all_logits=True)
    k = SAMPLE_KW["top_k"]
    z = torch.topk(logits.float().reshape(-1, logits.shape[-1])
                   / SAMPLE_KW["temperature"], k + 1, dim=-1).values
    probs = torch.softmax(z[:, :k], dim=-1)
    kept = ((probs.cumsum(-1) - probs) < SAMPLE_KW["top_p"]).sum(-1)
    gap = z.gather(1, kept[:, None] - 1) - z.gather(1, kept[:, None])
    return {"kept_median": kept.float().median().item(),
            "gap_median": gap.median().item(),
            "gap_under_near_tie": (gap < NEAR_TIE["bfloat16"]).float()
            .mean().item()}


def _merged_greedy(torch, decode, lora, quant, qbase, adapters, lcfg, cfg,
                   prompt) -> dict:
    """merge_lora, then quantize_params, then greedy generate, held to
    generate on the merged float params (the base's int8 head copy
    dropped, so both the head and the blocks are float) up to near-ties."""
    merged = lora.merge_lora(qbase, adapters, lcfg)
    merged = {k: v for k, v in merged.items() if k != "lm_head"}
    served = quant.quantize_params(merged)
    got = decode.generate(served, prompt, cfg, QLORA_NEW)
    want = decode.generate(merged, prompt, cfg, QLORA_NEW)
    diverged = []
    for row, (g, w) in enumerate(zip(got.tolist(), want.tolist())):
        first = _first_divergence(decode, merged, cfg, prompt[row].tolist(),
                                  g, w, kv_quant=False)
        if first is not None:
            diverged.append({"row": row, "step": first[0],
                             "margin": first[1]})
    return {"tokens": QLORA_NEW, "rows": len(got), "diverged": diverged,
            "ok": all(d["margin"] < NEAR_TIE["bfloat16"] for d in diverged)}


def phase_quality(torch, kernels, device, model_kw=TRAIN_MODEL,
                  seq: int = QUALITY_SEQ, steps: int = QUALITY_STEPS,
                  distill_steps: int = DISTILL_STEPS,
                  qlora_steps: int = QLORA_STEPS) -> dict:
    """Fine-tuning and evaluation on the card, modelled on
    bench.py:350-458: train TRAIN_MODEL (flash, bf16) on the chain, then
    the int8 and int4 ladder (quality.eval_quality against the bf16
    copy), the int8 self-draft's acceptance, a distilled 2-layer draft's
    acceptance and tokens/s against plain greedy, and QLoRA on the int8
    trained model."""
    import dataclasses

    from tpu_bootstrap_torch.workload import (decode, lora, model, quality,
                                              quant, speculative, train)
    from tpu_bootstrap_torch.workload.flash_attention import \
        make_flash_attn_fn

    cfg = train.TrainConfig(model=model.ModelConfig(
        **model_kw, max_seq_len=seq, compute_dtype=torch.bfloat16),
        attention="flash")
    mcfg, layers = cfg.model, cfg.model.num_layers
    out = {"phase": "quality", "vocab": QUALITY_VOCAB, "batch": QUALITY_BATCH,
           "seq": seq, "layers": layers, "limits": QUALITY_LIMITS,
           "chain_floor_ppl": math.exp(chain_floor(0.85, QUALITY_VOCAB))}
    t_phase = time.perf_counter()

    # 1. Train on the chain: the host draws batch i + 1 while the card
    # runs step i (the losses are read once, after the loop).
    params, opt_state = train.init_train_state(cfg, seed=0, device=device)
    step = train.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()

    def train_step(i):
        nonlocal params, opt_state
        params, opt_state, loss = step(params, opt_state,
                                       _chain(torch, quality, i, seq, device))
        return loss

    losses, flash = _counted_steps(kernels, train_step, steps)
    torch.cuda.synchronize()
    out["train"] = {"steps": steps, "s": time.perf_counter() - t0,
                    "first_loss": losses[0], "loss": losses[-1],
                    "losses_every_50": losses[::50],
                    "launches": dict(kernels.LAUNCHES),
                    "flash_per_step": sorted(flash),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del opt_state, step

    # 2. The ladder on the held-out batch, after K1 and K6 at its T.
    tbf = _bf16_copy(torch, params)
    q8, q4 = quant.quantize_params(params), quant.quantize_params4(params)
    held = _chain(torch, quality, QUALITY_HELD_OUT[0], QUALITY_HELD_OUT[1],
                  device)
    out["t_check"] = _trained_t_check(torch, kernels, quant, model, params,
                                      q8, q4, mcfg, held)
    for name, qp in (("int8", q8), ("int4", q4)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = quality.eval_quality(tbf, qp, mcfg, held)
        out[name]["s"] = time.perf_counter() - t0
        out[name]["launches"] = dict(kernels.LAUNCHES)
    del q4
    # Sampling's cutoffs on trained weights against a random init's.
    out["cutoffs"] = {"trained": _cutoff_gaps(torch, decode, tbf, mcfg, held),
                      "random": _cutoff_gaps(torch, decode, _bf16_copy(
                          torch, model.init_params(mcfg, seed=0,
                                                   device=device)),
                          mcfg, held)}

    # 3. The int8 self-draft's acceptance on trained weights.
    prompt = _chain(torch, quality, QUALITY_PROMPT[0], QUALITY_PROMPT[1],
                    device)
    kernels.reset_launches()
    out["spec_int8"] = quality.spec_acceptance(
        tbf, q8, mcfg, prompt, steps=QUALITY_SPEC_STEPS, gamma=GAMMA,
        device=device)
    out["spec_int8"]["launches"] = dict(kernels.LAUNCHES)

    # 4. A distilled 2-layer draft: acceptance, then tokens/s of
    # speculative decoding with it against plain greedy (bench.py's
    # two-point rule: batch x 64 tokens over the time between a 32-step
    # and a 96-step call, median of 3 pairs after a warm pair).
    scfg = dataclasses.replace(mcfg, num_layers=DISTILL_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    draft, dloss = quality.distill_draft(
        params, mcfg, scfg, steps=distill_steps,
        batch_fn=lambda i: quality.markov_batch(
            DISTILL_STEP0 + i, QUALITY_BATCH, seq, QUALITY_VOCAB),
        device=device)
    torch.cuda.synchronize()
    out["distill"] = {"steps": distill_steps, "loss": dloss,
                      "s": time.perf_counter() - t0,
                      "launches": dict(kernels.LAUNCHES),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}
    dbf = _bf16_copy(torch, draft)
    del draft
    out["spec_distilled"] = quality.spec_acceptance(
        tbf, dbf, mcfg, prompt, steps=QUALITY_SPEC_STEPS, gamma=GAMMA,
        draft_cfg=scfg, device=device)
    runs = {}

    def plain(n):
        t0 = time.perf_counter()
        runs["plain", n] = decode.generate(tbf, prompt, mcfg, n)
        return time.perf_counter() - t0

    def spec(n):
        t0 = time.perf_counter()
        runs["spec", n] = speculative.speculative_generate(
            tbf, dbf, prompt, mcfg, scfg, n, gamma=GAMMA)
        return time.perf_counter() - t0

    def per_token_s(f):
        f(TWO_POINT[0]), f(TWO_POINT[1])
        samples = sorted((f(TWO_POINT[1]) - f(TWO_POINT[0]))
                         / (TWO_POINT[1] - TWO_POINT[0])
                         for _ in range(TWO_POINT_PAIRS))
        return max(samples[len(samples) // 2], 1e-9)

    plain_s, spec_s = per_token_s(plain), per_token_s(spec)
    n = TWO_POINT[1]
    want = runs["plain", n].tolist()
    diverged = []
    for row, got in enumerate(runs["spec", n].tolist()):
        first = _first_divergence(decode, tbf, mcfg, prompt[row].tolist(),
                                  got, want[row], kv_quant=False)
        if first is not None:
            diverged.append({"row": row, "step": first[0],
                             "margin": first[1]})
    out["spec_distilled"].update({
        "tokens_per_s": QUALITY_BATCH / spec_s,
        "plain_tokens_per_s": QUALITY_BATCH / plain_s,
        "speedup": plain_s / spec_s, "diverged_from_plain": diverged})
    del dbf, runs

    # 5. QLoRA on the int8 trained model, on a second chain.
    lcfg = lora.LoraConfig()
    frozen = [t.clone() for t in _quantized_tensors(quant, q8)]
    lstep, lopt = lora.make_lora_train_step(
        cfg, train.MeshConfig(), q8, lcfg,
        attn_fn=make_flash_attn_fn(block_size=cfg.attention_block))
    adapters = lora.init_lora(q8, lcfg, seed=0, device=device)
    lstate = lopt.init(adapters)
    kernels.reset_launches()
    t0 = time.perf_counter()

    def qlora_step(i):
        nonlocal adapters, lstate
        adapters, lstate, loss = lstep(adapters, lstate, _chain(
            torch, quality, i, seq, device, seed=QLORA_TASK_SEED))
        return loss

    qlosses, flash = _counted_steps(kernels, qlora_step, qlora_steps)
    out["qlora"] = {
        "steps": qlora_steps, "targets": list(lcfg.targets),
        "rank": lcfg.rank, "s": time.perf_counter() - t0,
        "first_loss": qlosses[0], "loss": qlosses[-1], "losses": qlosses,
        "launches": dict(kernels.LAUNCHES),
        "flash_per_step": sorted(flash),
        "base_unchanged": all(torch.equal(a, b) for a, b in zip(
            frozen, _quantized_tensors(quant, q8)))}
    del frozen, lstate
    kernels.reset_launches()
    out["qlora"]["served"] = _merged_greedy(torch, decode, lora, quant, q8,
                                            adapters, lcfg, mcfg, prompt)
    out["qlora"]["served"]["launches"] = dict(kernels.LAUNCHES)
    out["s"] = time.perf_counter() - t_phase
    emit(out)
    _quality_verdict(out, layers)
    del params, tbf, q8, adapters
    torch.cuda.empty_cache()
    return out


def _quantized_tensors(quant, params) -> list:
    """Every tensor of a quantized tree: the values and scales of its
    quantized leaves, the float leaves as they are."""
    from tpu_bootstrap_torch.workload.train import tree_leaves

    return [t for leaf in tree_leaves(params)
            for t in ((leaf.q, leaf.s) if quant.is_quantized(leaf)
                      else (leaf,))]


def _quality_verdict(out: dict, layers: int) -> None:
    """SystemExit with the numbers unless every check of the phase holds."""
    lim = QUALITY_LIMITS
    losses = (out["train"]["losses_every_50"]
              + [out["train"]["loss"], out["distill"]["loss"]]
              + out["qlora"]["losses"])
    scheduled = {"int8": {"int8_matmul": 4 * layers + 1, "int4_matmul": 0},
                 "int4": {"int8_matmul": 1, "int4_matmul": 4 * layers}}
    checks = {
        "losses_finite": all(math.isfinite(x) for x in losses),
        "trained": out["train"]["loss"]
        < lim["trained_loss_frac"] * out["train"]["first_loss"],
        "int8": out["int8"]["argmax_agreement_pct"] > lim["int8_agreement_pct"]
        and abs(out["int8"]["ppl_delta"]) < lim["int8_ppl_delta"]
        and out["int8"]["ppl_base"] < lim["ppl_base"],
        "int4": out["int4"]["argmax_agreement_pct"] > lim["int4_agreement_pct"]
        and abs(out["int4"]["ppl_delta"]) < lim["int4_ppl_delta"],
        "acceptance": min(out["spec_int8"]["mean_committed"],
                          out["spec_distilled"]["mean_committed"])
        > lim["mean_committed"],
        "distilled_exact": all(d["margin"] < NEAR_TIE["bfloat16"] for d in
                               out["spec_distilled"]["diverged_from_plain"]),
        "qlora": out["qlora"]["loss"] < out["qlora"]["first_loss"]
        and out["qlora"]["base_unchanged"] and out["qlora"]["served"]["ok"],
        "flash_scheduled": all(
            out[part]["flash_per_step"] == [(layers,) * len(FLASH_KERNELS)]
            for part in ("train", "qlora")),
        "score_launches": all(
            out[name]["launches"][k] == n
            for name, want in scheduled.items() for k, n in want.items()),
        "t_check": all(out["t_check"][k]["close"]
                       for k in ("int8_matmul", "int4_matmul")),
    }
    out["checks"] = checks
    if not all(checks.values()):
        raise SystemExit(
            f"quality failed: {checks} train={out['train']['first_loss']}->"
            f"{out['train']['loss']} int8={out['int8']} int4={out['int4']} "
            f"spec_int8={out['spec_int8']} "
            f"spec_distilled={out['spec_distilled']} "
            f"qlora_losses={out['qlora']['losses']} "
            f"qlora_base_unchanged={out['qlora']['base_unchanged']} "
            f"qlora_served={out['qlora']['served']} "
            f"t_check={out['t_check']}")


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
    if sys.argv[1:] == ["--mesh-cards"]:
        return mesh_cards_main(torch)
    from tpu_bootstrap_torch.workload import (decode, decode_attention,
                                              kernels, quant)
    from tpu_bootstrap_torch.workload import flash_attention as fa

    device = torch.device("cuda")
    info = phase_device(torch)
    seconds = {}  # wall time of each phase, printed before the kernels line

    def run(name, phase, *args, **kw):
        t0 = time.perf_counter()
        result = phase(*args, **kw)
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
                        ("serve_prefix", phase_serve_prefix),
                        ("serve_overcommit", phase_serve_overcommit),
                        ("serve_host_tier", phase_serve_host_tier),
                        ("serve_faults", phase_serve_faults),
                        ("serve_ingress", phase_serve_ingress),
                        ("sampling", phase_sampling),
                        ("serve_spec", phase_serve_spec),
                        ("serve_resident", phase_serve_resident),
                        ("generate_int8kv", phase_generate_int8kv),
                        ("speculative", phase_speculative)):
        # The host tier's phase reads the tight pool's pair that
        # serve_overcommit ran; serve_ingress, serve_spec and
        # serve_resident, serve's streams (and serve_ingress and
        # serve_resident its oracle).
        # A phase cut in depth serves and takes its own oracle at that
        # depth.
        extra = ()
        if name == "serve_host_tier":
            extra = (out["serve_overcommit"]["tight"],)
        elif (name in ("serve_ingress", "serve_spec", "serve_resident")
              and name not in DEPTH_CUT):
            extra = (out["serve"],)
        kw = {"model_kw": CUT_MODEL} if name in DEPTH_CUT else {}
        out[name] = run(name, phase, torch, kernels, device, *extra, **kw)
    out["k3"] = run("k3", phase_k3, torch, fa, kernels, device)
    out["k4"] = run("k4", phase_k4, torch, fa, kernels, device)
    out["train"] = run("train", phase_train, torch, kernels, device)
    out["train_mesh"] = run("train_mesh", phase_train_mesh, torch, kernels,
                            device)
    out["ring"] = run("ring", phase_ring, torch, fa, kernels, device)
    out["pipeline"] = run("pipeline", phase_pipeline, torch, kernels,
                          device)
    run("train_long", phase_train_long, torch, kernels, device)
    out["quality"] = run("quality", phase_quality, torch, kernels, device)
    emit({"phase_seconds": seconds})
    emit({"kernels": kernel_lines(out)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


def path_launches(out: dict, name: str) -> dict:
    """``name``'s launches in each later path's measured run (the counts
    set to 0 just before it): the overcommit burst, the tight pool with
    the tier off and on (the swapping run), the host tier's phase B,
    serve_faults' last run with the log and ledger on, its faulted run
    and its deadline run, serve_ingress's last timed burst, sampling's
    first sampled serve, serve_spec's three serves (prompt lookup on
    the int8 target, the bf16 target plain and drafted by its int8 copy;
    their speculative rounds attend on einsums, as the reference's do),
    and serve_resident's last resident run, its float-cache resident run,
    the float paged pool and the int8 pool's gathered route (all four
    attend on einsums: K2 0). serve_faults runs at CUT_MODEL's depth."""
    oc, ht, sf, sp, rs = (out["serve_overcommit"], out["serve_host_tier"],
                          out["serve_faults"], out["serve_spec"],
                          out["serve_resident"])
    tight = oc["tight"]
    return {"serve_overcommit": oc["overcommit"]["launches"][name],
            "serve_overcommit_tight": tight["tier_off"]["launches"][name],
            "serve_overcommit_tight_swap": tight["tier_on"]["launches"][name],
            "serve_host_tier": ht["working_set"]["launches"][name],
            "serve_faults": sf["observe"]["launches"][name],
            "serve_faults_recovery": sf["recovery"]["launches"][name],
            "serve_faults_deadlines": sf["deadlines"]["launches"][name],
            "serve_ingress": out["serve_ingress"]["burst"]["launches"][name],
            "sampling": out["sampling"]["serve"]["launches"][name],
            "serve_spec_lookup": sp["lookup"]["launches"][name],
            "serve_spec_bf16_plain": sp["bf16_plain"]["launches"][name],
            "serve_spec_bf16_drafted": sp["bf16_drafted"]["launches"][name],
            "serve_resident": rs["resident"]["launches"][name],
            "serve_resident_float": rs["resident_float"]["launches"][name],
            "serve_float_pool": rs["float_pool"]["launches"][name],
            "serve_gather_int8": rs["gather_int8"]["launches"][name]}


# The quality phase's counted runs, by the keys of its output.
QUALITY_PATHS = {"quality_train": ("train",), "quality_int8_score": ("int8",),
                 "quality_int4_score": ("int4",),
                 "quality_spec_int8": ("spec_int8",),
                 "quality_distill": ("distill",), "quality_qlora": ("qlora",),
                 "quality_qlora_served": ("qlora", "served")}


def quality_launches(out: dict, name: str) -> dict:
    """``name``'s launches in each of the quality phase's counted runs."""
    found = {}
    for path, keys in QUALITY_PATHS.items():
        part = out["quality"]
        for key in keys:
            part = part[key]
        found[path] = part["launches"][name]
    return found


def kernel_lines(out: dict) -> list:
    k1, k2, k3, k4 = out["k1"], out["k2"], out["k3"], out["k4"]
    launches = out["serve"]["launches"]
    train_launches = out["train"]["launches"]
    k1_step = step_totals(k1["rows"], [
        *((shape, "bfloat16", True)
          for shape in ("wqkv", "wo", "w_up", "w_down")),
        ("lm_head", "float32", False)])
    k2_main = next(r for r in k2["rows"] if r["Hk"] == 16 and r["D"] == 64
                   and r["bs"] == 64 and r["q"] == "bfloat16"
                   and r["lengths_name"] == "ragged")
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
         "launches_by_path": path_launches(out, "int8_matmul")
         | quality_launches(out, "int8_matmul"),
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
         "launches_by_path": path_launches(out, "paged_attention")
         | quality_launches(out, "paged_attention"),
         "at": "one launch, B=8 H=Hk=16 D=64 bs=64 nb=8, bf16 q, lengths "
               + ",".join(map(str, K2_LENGTHS))},
        {"name": "flash_fwd", "route": "cuda", "source": src,
         "replaces": f"{ref}:110",
         "launches": train_launches["flash_fwd"],
         "launches_by_path": quality_launches(out, "flash_fwd")
         | {"train_mesh": out["train_mesh"]["launches"]["flash_fwd"],
            "ring": out["ring"]["launches"]["flash_fwd"],
            **{f"pipeline_{s}": out["pipeline"][s]["launches"]["flash_fwd"]
               for s in ("gpipe", "1f1b")}},
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
         "launches_by_path": quality_launches(out, "flash_dq")
         | {"train_mesh": out["train_mesh"]["launches"]["flash_dq"],
            "ring": out["ring"]["launches"]["flash_dq"],
            **{f"pipeline_{s}": out["pipeline"][s]["launches"]["flash_dq"]
               for s in ("gpipe", "1f1b")}},
         "max_abs_err": k4["max_abs_err"],
         "ms": k4_main["dq_ms"], "plain_ms": k4_main["dq_plain_ms"],
         "bound_ms": k4_main["dq_bound_ms"],
         "bound_by": k4_main["dq_bound_by"],
         "library_ms": None, "sdpa_backward_ms": k4_main["library_ms"],
         "f32_ms": k4_f32["dq_ms"], "f32_source": f32_src, "at": flash_at},
        {"name": "flash_dkv", "route": "cuda", "source": src,
         "replaces": f"{ref}:267",
         "launches": train_launches["flash_dkv"],
         "launches_by_path": quality_launches(out, "flash_dkv")
         | {"train_mesh": out["train_mesh"]["launches"]["flash_dkv"],
            "ring": out["ring"]["launches"]["flash_dkv"],
            **{f"pipeline_{s}": out["pipeline"][s]["launches"]["flash_dkv"]
               for s in ("gpipe", "1f1b")}},
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
            "weights")
        | {"launches_by_path": quality_launches(out, "int4_matmul")},
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
            "generate call, at CUT_MODEL's 4 layers; library: "
            "scaled_dot_product_attention on the "
            "bf16-dequantized cache with the boolean mask")
        | {"split": k5_main["plan"]},
    ]


if __name__ == "__main__":
    sys.exit(main())
