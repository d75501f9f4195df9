"""Build, binding and launch counters of the port's CUDA kernels.

The sources are ``csrc/*.cu`` beside this file, with the ``csrc/*.cuh``
headers they share. On first use they are compiled for Hopper, each file
by its own ``nvcc`` process (all started together), and linked into one
shared library with a plain C interface:

    build/kernels/libtpubc_torch_kernels-<sha of the sources>.so

under the repository root, loaded with ``ctypes``. The content hash in
the name means an edited source builds a new library instead of loading
a stale one. Nothing happens at import: the module imports on a machine
without ``nvcc`` or a card, and only a wrapper called with CUDA tensors
builds (and a failed build raises).

Each wrapper validates device, dtype, shape and contiguity, allocates
its output with ``torch.empty``, launches on PyTorch's current stream,
raises if the C entry reports a CUDA error, and adds one to its entry in
``LAUNCHES``. Nothing here falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# Launches per kernel since the last reset_launches(); one tick where the
# kernel is launched and nowhere else.
LAUNCHES = {"int8_matmul": 0, "int8_expert_matmul": 0, "int4_matmul": 0,
            "int4_expert_matmul": 0, "paged_attention": 0,
            "decode_attention": 0, "flash_fwd": 0, "flash_dq": 0,
            "flash_dkv": 0}

_lock = threading.Lock()
_lib = None  # guarded-by: _lock


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    """Hash of every source and the headers they include."""
    h = hashlib.sha256()
    for src in [*sources(), *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtpubc_torch_kernels-{source_digest()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(cmds: list) -> str:
    """Run the commands in parallel; raise with every failure's output,
    else return their combined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(logs[-1])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "\n".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile every source (one nvcc per file, in parallel) and link the
    library; returns its path. A library already built from the same
    sources is reused. ``verbose`` prints each kernel's registers, shared
    memory and spills (``-Xptxas -v``) to stderr."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in sources()]
        log = _run([[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *extra, "-c", str(src),
                     "-o", obj] for src, obj in zip(sources(), objs)])
        if verbose:
            print(log, file=sys.stderr)
        staged = Path(tmp) / out.name
        _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged), *objs]])
        os.replace(staged, out)  # atomic: a reader never sees half a file
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # x, q, s, out, e, t, k, n, x_is_bf16, split, stream (e = 1: dense)
    lib.tpubc_int8_matmul.argtypes = [p, p, p, p] + [i] * 6 + [p]
    lib.tpubc_int8_matmul.restype = i
    # x, q, s, out, e, t, kdim, Ks / 2, n, group, x_is_bf16, split, stream
    lib.tpubc_int4_matmul.argtypes = [p, p, p, p] + [i] * 8 + [p]
    lib.tpubc_int4_matmul.restype = i
    lib.tpubc_quant_smem_bytes.argtypes = [i]  # bits
    lib.tpubc_quant_smem_bytes.restype = i
    # q, kq, ks, vq, vs, tables, lengths, out, ws; b, hk, g, d, bs, nb,
    # ranks; scale, q_is_bf16, stream
    lib.tpubc_paged_attention.argtypes = [p] * 9 + [i] * 7 + [f, i, p]
    lib.tpubc_paged_attention.restype = i
    lib.tpubc_paged_attention_smem_bytes.argtypes = [i] * 3  # bs, d, g
    lib.tpubc_paged_attention_smem_bytes.restype = i
    # q, kq, ks, vq, vs, valid, out, ws; b, len, hk, g, d, ranks; scale,
    # q_is_bf16, stream
    lib.tpubc_decode_attention.argtypes = [p] * 8 + [i] * 6 + [f, i, p]
    lib.tpubc_decode_attention.restype = i
    lib.tpubc_decode_attention_smem_bytes.argtypes = [i] * 2  # d, g
    lib.tpubc_decode_attention_smem_bytes.restype = i
    dims = [i, i, i, i, i, f, i, i, p]  # b, s, h, hk, d, scale, causal, bf16
    lib.tpubc_flash_fwd.argtypes = [p] * 5 + dims
    lib.tpubc_flash_fwd.restype = i
    lib.tpubc_flash_dq.argtypes = [p] * 7 + dims
    lib.tpubc_flash_dq.restype = i
    lib.tpubc_flash_dkv.argtypes = [p] * 8 + dims
    lib.tpubc_flash_dkv.restype = i
    lib.tpubc_flash_smem_bytes.argtypes = [i, i, i]  # role, d, bf16
    lib.tpubc_flash_smem_bytes.restype = i
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _need(t: torch.Tensor, name: str, dtypes: tuple, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_FLOATS = (torch.bfloat16, torch.float32)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# The quantized matmuls' layout (csrc/quant_matmul_sm90.cuh), K1/K1e and
# K6/K6e alike: output columns a CTA owns, K rows a ring slot holds, the
# largest cluster of splits, and the CTAs an SM holds (kCtasPerSm: the
# registers and shared memory a CTA is built for).
QUANT_TILE_N = 64
QUANT_STAGE_K = 64
QUANT_MAX_SPLIT = 16
QUANT_RESIDENT_CTAS = 4
# The CTAs per SM each plan aims for: a CTA has one consumer warpgroup, so
# a second one on an SM hides its latency (PERF.md gives the H100 sweeps
# behind them).
INT4_CTAS_PER_SM = 2
INT8_CTAS_PER_SM = 2
# Each format's ring: slots, storage rows of K a slot holds (int4 packs two
# k a byte) and the scale bytes a slot holds (int4's group rows); and the
# bytes of column scales a CTA stages once (int8's, for the epilogue).
QUANT_RING = {4: (6, QUANT_STAGE_K // 2, 4 * QUANT_TILE_N * 4, 0),
              8: (5, QUANT_STAGE_K, 0, QUANT_TILE_N * 4)}
# Shared memory of an H100 SM, and what each CTA on it reserves.
SM_SMEM_BYTES = 233_472
CTA_RESERVED_SMEM = 1024


def quant_smem_bytes(bits: int) -> int:
    """Dynamic shared memory of a CTA of the int4 (bits 4) or int8 (8)
    kernel: the activation chunk, the ring's weight and scale slots, its
    barriers, int8's column scales, 1024 bytes to align the start (mirrors
    ``Smem`` in csrc/quant_matmul_sm90.cuh; ``chip_smoke.py`` checks it
    against tpubc_quant_smem_bytes)."""
    slots, rows, scale_bytes, col_bytes = QUANT_RING[bits]
    return 32768 + slots * (rows * QUANT_TILE_N + scale_bytes) + (
        2 * slots * 8) + col_bytes + 1024


class QuantPlan(NamedTuple):
    split: int   # CTAs along K: a cluster, summed in rank order
    ctas: int    # CTAs of a launch per group of 32 T rows
    stages: int  # ring slots (QUANT_STAGE_K rows) the longest split streams


def _split_bounds(steps: int, per: int, split: int) -> list:
    """The K range [k0, k1) of each split of ``steps`` k-steps of 16 in
    whole units of ``per`` k-steps (``split_steps``): split r takes units
    [r U / split, (r + 1) U / split)."""
    units = -(-steps // per)
    return [(r * units // split * per * 16,
             min((r + 1) * units // split * per, steps) * 16)
            for r in range(split)]


def _check_split(fmt: str, split: int, units: int, what: str) -> None:
    if not 1 <= split <= min(QUANT_MAX_SPLIT, units):
        raise ValueError(f"{fmt} split {split} for {what}: want "
                         f"1..{min(QUANT_MAX_SPLIT, units)}")


def _plan(e: int, n: int, units: int, ctas_per_sm: int, sms: int,
          bounds) -> QuantPlan:
    """About ``ctas_per_sm`` CTAs per SM (rounded down) and never fewer
    than one; at most one split a unit and QUANT_MAX_SPLIT in all."""
    tiles = e * -(-n // QUANT_TILE_N)
    split = max(-(-sms // tiles), ctas_per_sm * sms // tiles)
    split = max(1, min(split, QUANT_MAX_SPLIT, units))
    longest = max(k1 - k0 for k0, k1 in bounds(split))
    return QuantPlan(split, tiles * split, -(-longest // QUANT_STAGE_K))


def int8_units(k: int) -> int:
    """The units K1/K1e's contraction is split into: ring slots of
    QUANT_STAGE_K rows, so that only K's tail is a partial stage."""
    return -(-k // QUANT_STAGE_K)


def int8_split_bounds(k: int, split: int) -> list:
    """The K range [k0, k1) of each split of K1/K1e: whole slots, the last
    ending at K rounded up to a k-step of 16. Raises for a split the kernel
    does not take (its C entry refuses the same)."""
    _check_split("int8", split, int8_units(k), f"K={k}")
    return _split_bounds(-(-k // 16), QUANT_STAGE_K // 16, split)


@functools.lru_cache(maxsize=4096)
def int8_plan(e: int, k: int, n: int, sms: int) -> QuantPlan:
    """The split of K1/K1e's contraction, from the weight's shape and the
    card's SM count only, never from T (batch invariance)."""
    return _plan(e, n, int8_units(k), INT8_CTAS_PER_SM, sms,
                 lambda split: int8_split_bounds(k, split))


def int4_units(ks: int, group: int) -> int:
    """The units K6/K6e's contraction is split into: groups when a group
    is whole k-steps of 16, else k-steps (``split_units`` in
    csrc/quant_matmul_sm90.cuh)."""
    return ks // group if group % 16 == 0 else -(-ks // 16)


def int4_split_bounds(ks: int, group: int, split: int) -> list:
    """The K range [k0, k1) of each split of K6/K6e: whole groups at
    g % 16 == 0, else whole k-steps. Raises for a split the kernel does
    not take (its C entry refuses the same)."""
    _check_split("int4", split, int4_units(ks, group),
                 f"Ks={ks}, group={group}")
    return _split_bounds(-(-ks // 16), group // 16 if group % 16 == 0 else 1,
                         split)


@functools.lru_cache(maxsize=4096)
def int4_plan(e: int, ks: int, n: int, group: int, sms: int) -> QuantPlan:
    """The split of K6/K6e's contraction, from the weight's shape and the
    card's SM count only, never from T (batch invariance)."""
    return _plan(e, n, int4_units(ks, group), INT4_CTAS_PER_SM, sms,
                 lambda split: int4_split_bounds(ks, group, split))


_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count, the one input of the plans that is not the
    weight's shape; read once per device."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def _launch_int8(x, q, s, name: str, ndim: int) -> torch.Tensor:
    """Validate, plan and launch an int8 product (dense: ndim 2, s (N,);
    expert: ndim 3, s (E, 1, N))."""
    _need(x, "x", _FLOATS, ndim)
    _need(q, "q", (torch.int8,), ndim)
    _need(s, "s", (torch.float32,), 1 if ndim == 2 else 3)
    e = x.shape[0] if ndim == 3 else 1
    t, k = x.shape[-2:]
    n = q.shape[-1]
    if (q.shape[:-1] != (*x.shape[:-2], k)
            or s.shape != ((n,) if ndim == 2 else (e, 1, n))
            or min(t, k, n) < 1):
        raise ValueError(f"{name} shapes: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, s {tuple(s.shape)}")
    if not (x.device == q.device == s.device):
        raise ValueError(f"{name} operands on different devices")
    plan = int8_plan(e, k, n, sm_count(x.device))
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    rc = lib().tpubc_int8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), e, t, k, n,
        int(x.dtype == torch.bfloat16), plan.split, _stream())
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """Kernel K1: x (T, K) bf16/f32 @ q (K, N) int8 * s (N,) f32 -> (T, N)
    in x.dtype."""
    return _launch_int8(x, q, s, "int8_matmul", 2)


def int8_expert_matmul(x: torch.Tensor, q: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Kernel K1e: x (E, T, K) bf16/f32 @ q (E, K, N) int8 * s (E, 1, N)
    f32 -> (E, T, N) in x.dtype."""
    return _launch_int8(x, q, s, "int8_expert_matmul", 3)


def _launch_int4(x, q, s, group: int, kdim: int, name: str,
                 ndim: int) -> torch.Tensor:
    """Validate, plan and launch an int4 product (dense: ndim 2; expert:
    3)."""
    _need(x, "x", _FLOATS, ndim)
    _need(q, "q", (torch.uint8,), ndim)
    _need(s, "s", (torch.float32,), ndim)
    e = x.shape[0] if ndim == 3 else 1
    t = x.shape[-2]
    p, n = q.shape[-2:]
    if (x.shape[-1] != kdim or q.shape[:-2] != x.shape[:-2]
            or group < 2 or group % 2 or (2 * p) % group
            or s.shape != (*q.shape[:-2], 2 * p // group, n)
            or not 1 <= kdim <= 2 * p or min(t, n) < 1):
        raise ValueError(f"{name} shapes: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, s {tuple(s.shape)}, group "
                         f"{group}, kdim {kdim}")
    if not (x.device == q.device == s.device):
        raise ValueError(f"{name} operands on different devices")
    plan = int4_plan(e, 2 * p, n, group, sm_count(x.device))
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    rc = lib().tpubc_int4_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), e, t, kdim,
        p, n, group, int(x.dtype == torch.bfloat16), plan.split, _stream())
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def int4_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                group: int, kdim: int) -> torch.Tensor:
    """Kernel K6: x (T, kdim) bf16/f32 @ nibble-packed q (Ks/2, N) uint8
    with group scales s (Ks/group, N) f32 -> (T, N) in x.dtype."""
    return _launch_int4(x, q, s, group, kdim, "int4_matmul", 2)


def int4_expert_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       group: int, kdim: int) -> torch.Tensor:
    """Kernel K6e: x (E, T, kdim) @ q (E, Ks/2, N) uint8 with s
    (E, Ks/group, N) f32 -> (E, T, N) in x.dtype."""
    return _launch_int4(x, q, s, group, kdim, "int4_expert_matmul", 3)


# The decode-attention kernels' layout (csrc/decode_attention.cuh): warps a
# CTA, ring slots, the largest cluster of ranks, and the dynamic shared
# memory a CTA may opt into on the H100; K5's chunk of positions
# (csrc/decode_attention.cu; K2's chunk is its block).
DECODE_WARPS = 4
DECODE_SLOTS = 2
DECODE_MAX_RANKS = 8
DECODE_SMEM_LIMIT = 232_448
DECODE_CHUNK = 64


class DecodePlan(NamedTuple):
    chunk: int  # positions a chunk holds: K2's block, K5's DECODE_CHUNK
    ranks: int  # CTAs a (row, KV head) is split over: a cluster


def _align16(v: int) -> int:
    return (v + 15) & ~15


def decode_smem_bytes(chunk: int, d: int, g: int) -> int:
    """Dynamic shared memory of a K2 or K5 CTA (one KV head, its query
    group of g heads): q, the chunk's scores, the warps' p . v sums,
    maxima and sums, a chunk's partial (acc, then (m, l) per query head: a
    row of one chunk is finished on chip), and DECODE_SLOTS ring slots of
    K, V, their scales and the admitted flags (mirrors ``make_layout`` in
    csrc/decode_attention.cuh; ``chip_smoke.py`` checks the two agree)."""
    slot = 2 * _align16(chunk * d) + 2 * _align16(chunk * 4) + _align16(chunk)
    return (_align16(g * d * 4) + _align16(g * chunk * 4)
            + _align16(DECODE_WARPS * g * d * 4)
            + _align16(2 * DECODE_WARPS * g * 4)
            + _align16((g * d + 2 * g) * 4)
            + DECODE_SLOTS * slot)


def decode_split_ok(hk: int, g: int, d: int, plan: DecodePlan) -> bool:
    """Whether the kernels take this split (their C entries refuse the
    same): D a multiple of 16, at most DECODE_MAX_RANKS ranks, and the
    CTA's shared memory within DECODE_SMEM_LIMIT."""
    return (min(hk, g, plan.chunk, plan.ranks) >= 1 and hk <= 65535
            and d >= 16 and d % 16 == 0 and plan.ranks <= DECODE_MAX_RANKS
            and decode_smem_bytes(plan.chunk, d, g) <= DECODE_SMEM_LIMIT)


def _decode_plan(chunk: int, chunks: int, hk: int, g: int, d: int):
    """One rank per chunk up to a cluster of DECODE_MAX_RANKS; None when
    the kernels do not take it."""
    plan = DecodePlan(chunk, max(1, min(DECODE_MAX_RANKS, chunks)))
    return plan if decode_split_ok(hk, g, d, plan) else None


@functools.lru_cache(maxsize=4096)
def paged_plan(bs: int, hk: int, g: int, d: int):
    """K2's split, from the pool's geometry only, never from B, the table
    width or the lengths: chunks of one block, and ranks for rows of up to
    DECODE_MAX_RANKS blocks (a longer row's ranks take several chunks each,
    through the ring). None when the kernel does not take the geometry."""
    return _decode_plan(bs, DECODE_MAX_RANKS, hk, g, d)


@functools.lru_cache(maxsize=4096)
def decode_plan(length: int, hk: int, g: int, d: int):
    """K5's split, from the cache's geometry only, never from B: chunks of
    DECODE_CHUNK positions, one rank a chunk up to DECODE_MAX_RANKS. None
    when the kernel does not take the geometry."""
    return _decode_plan(DECODE_CHUNK, -(-length // DECODE_CHUNK), hk, g, d)


def chunk_bounds(length: int, chunk: int, limit: int | None = None) -> list:
    """The positions [start, stop) of each chunk of a row of ``length``
    positions, in order; ``limit`` caps their number (K2: the table
    width)."""
    n = -(-max(length, 0) // chunk)
    if limit is not None:
        n = min(n, limit)
    return [(c * chunk, min(length, (c + 1) * chunk)) for c in range(n)]


def rank_chunks(chunks: int, ranks: int, rank: int) -> list:
    """The chunks rank ``rank`` of ``ranks`` holds: rank, rank + ranks,
    ... (the ring's order)."""
    return list(range(rank, chunks, ranks))


def paged_attention_smem_bytes(bs: int, d: int, g: int) -> int:
    """K2's shared memory: chunks of one block (``chip_smoke.py`` checks it
    against tpubc_paged_attention_smem_bytes)."""
    return decode_smem_bytes(bs, d, g)


def decode_attention_smem_bytes(d: int, g: int) -> int:
    """K5's shared memory: chunks of DECODE_CHUNK positions
    (``chip_smoke.py`` checks it against tpubc_decode_attention_smem_bytes)."""
    return decode_smem_bytes(DECODE_CHUNK, d, g)


def _workspace(b: int, hk: int, chunks: int, g: int, d: int,
               device) -> torch.Tensor:
    """The chunks' partials, f32: acc (B, Hk, chunks, g, D) then (m, l)."""
    return torch.empty(b * hk * chunks * g * (d + 2), dtype=torch.float32,
                       device=device)


def _need_split(name: str, rule: str, hk: int, g: int, d: int, plan,
                what: str) -> None:
    if plan is None or not decode_split_ok(hk, g, d, plan):
        raise ValueError(f"{name} does not take {what}, head_dim={d}, "
                         f"group={g}, split {plan} (see {rule})")


def paged_attention(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                    vq: torch.Tensor, vs: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor, *,
                    plan: DecodePlan | None = None) -> torch.Tensor:
    """Kernel K2: q (B, H, D) over int8 pools (N, bs, Hk, D) with scales
    (N, bs, Hk), tables (B, nb) int32 and lengths (B,) int32 -> (B, H, D)
    in q.dtype. ``plan`` overrides ``paged_plan``'s split (its chunk must
    be bs); every split gives the same bits."""
    _need(q, "q", _FLOATS, 3)
    _need(kq, "kq", (torch.int8,), 4)
    _need(vq, "vq", (torch.int8,), 4)
    _need(ks, "ks", (torch.float32,), 3)
    _need(vs, "vs", (torch.float32,), 3)
    _need(block_tables, "block_tables", (torch.int32,), 2)
    _need(lengths, "lengths", (torch.int32,), 1)
    b, h, d = q.shape
    n, bs, hk, dk = kq.shape
    nb = block_tables.shape[1]
    if (dk != d or vq.shape != kq.shape or ks.shape != (n, bs, hk)
            or vs.shape != ks.shape or block_tables.shape[0] != b
            or lengths.shape != (b,) or h % hk != 0 or nb < 1 or b > 65535):
        raise ValueError(
            f"paged_attention shapes: q {tuple(q.shape)}, kq "
            f"{tuple(kq.shape)}, ks {tuple(ks.shape)}, tables "
            f"{tuple(block_tables.shape)}, lengths {tuple(lengths.shape)}")
    g = h // hk
    plan = plan or paged_plan(bs, hk, g, d)
    if plan is not None and plan.chunk != bs:
        raise ValueError(f"paged_attention: a chunk is one block ({bs}), "
                         f"got {plan}")
    _need_split("paged_attention", "decode_attention.paged_supports", hk, g,
                d, plan, f"block_size={bs}")
    for t in (kq, ks, vq, vs, block_tables, lengths):
        if t.device != q.device:
            raise ValueError("paged_attention operands on different devices")
    for name, t in (("q", q), ("kq", kq), ("vq", vq)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    ws = _workspace(b, hk, nb, g, d, q.device)
    rc = lib().tpubc_paged_attention(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, hk, g, d, bs, nb, plan.ranks,
        float(d) ** -0.5, int(q.dtype == torch.bfloat16), _stream())
    _check(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                     vq: torch.Tensor, vs: torch.Tensor, valid: torch.Tensor,
                     *, plan: DecodePlan | None = None) -> torch.Tensor:
    """Kernel K5: q (B, H, D) over contiguous int8 caches (B, L, Hk, D)
    with scales (B, L, Hk), attending where the shared row valid (L,)
    bool is set -> (B, H, D) in q.dtype. ``plan`` overrides
    ``decode_plan``'s split (its chunk must be DECODE_CHUNK); every split
    gives the same bits."""
    _need(q, "q", _FLOATS, 3)
    _need(kq, "kq", (torch.int8,), 4)
    _need(vq, "vq", (torch.int8,), 4)
    _need(ks, "ks", (torch.float32,), 3)
    _need(vs, "vs", (torch.float32,), 3)
    _need(valid, "valid", (torch.bool,), 1)
    b, h, d = q.shape
    bk, length, hk, dk = kq.shape
    if (bk != b or dk != d or vq.shape != kq.shape
            or ks.shape != (b, length, hk) or vs.shape != ks.shape
            or valid.shape != (length,) or h % hk != 0 or length < 1
            or b > 65535):
        raise ValueError(
            f"decode_attention shapes: q {tuple(q.shape)}, kq "
            f"{tuple(kq.shape)}, ks {tuple(ks.shape)}, vq {tuple(vq.shape)}, "
            f"vs {tuple(vs.shape)}, valid {tuple(valid.shape)}")
    g = h // hk
    plan = plan or decode_plan(length, hk, g, d)
    if plan is not None and plan.chunk != DECODE_CHUNK:
        raise ValueError(f"decode_attention: a chunk is {DECODE_CHUNK} "
                         f"positions, got {plan}")
    _need_split("decode_attention", "decode_attention.supports", hk, g, d,
                plan, f"length={length}")
    for t in (kq, ks, vq, vs, valid):
        if t.device != q.device:
            raise ValueError("decode_attention operands on different devices")
    for name, t in (("q", q), ("kq", kq), ("vq", vq)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    ws = _workspace(b, hk, -(-length // DECODE_CHUNK), g, d, q.device)
    rc = lib().tpubc_decode_attention(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), valid.data_ptr(), out.data_ptr(), ws.data_ptr(), b,
        length, hk, g, d, plan.ranks, float(d) ** -0.5,
        int(q.dtype == torch.bfloat16), _stream())
    _check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out


# The flash kernels' head dims (csrc/flash_attention.cu instantiates these
# for f32, csrc/flash_attention_sm90.cu for bf16).
FLASH_HEAD_DIMS = (32, 64, 128)
# Their roles, numbered as the C entry tpubc_flash_smem_bytes takes them.
FLASH_ROLES = ("fwd", "dq", "dkv")
FLASH_STAGES = 2  # depth of the bf16 kernels' ring of tiles


def flash_tiles(role: str, d: int, dtype: torch.dtype) -> tuple:
    """(rows a CTA owns, rows a step of its inner loop) of a flash kernel:
    query rows for fwd and dq, KV rows for dkv, and the other way round
    for the step. f32 (csrc/flash_attention.cu): 64 x 64. bf16
    (csrc/flash_attention_sm90.cu): 128 rows, two consumer warpgroups of
    64, by steps that keep each warpgroup's accumulators in registers."""
    if role not in FLASH_ROLES or d not in FLASH_HEAD_DIMS:
        raise ValueError(f"no flash kernel {role!r} at head_dim {d}")
    if dtype == torch.float32:
        return 64, 64
    step = {"fwd": 64, "dq": 64 if d == 128 else 32,
            "dkv": 32 if d == 128 else 64}[role]
    return 128, step


def flash_smem_bytes(role: str, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a flash kernel, from its tiles (mirrors
    fwd_smem / dq_smem / dkv_smem of csrc/flash_attention.cu and the
    *Layout structs of csrc/flash_attention_sm90.cu; ``chip_smoke.py``
    checks it against tpubc_flash_smem_bytes)."""
    rows, step = flash_tiles(role, d, dtype)
    if dtype == torch.float32:  # f32 tiles of D + 4 and 72 columns
        tile, p = rows * (d + 4), rows * (rows + 8)
        return 4 * {"fwd": 3 * tile + p, "dq": 4 * tile + p + 2 * rows,
                    "dkv": 4 * tile + 2 * p + 2 * rows}[role]
    own = (1 if role == "fwd" else 2) * rows * d * 2  # Q; Q, dO; K, V
    ring = FLASH_STAGES * 2 * step * d * 2  # K, V; or Q, dO
    row_vals = FLASH_STAGES * 2 * step * 4 if role == "dkv" else 0
    barriers = 8 * (1 + 2 * FLASH_STAGES)
    return own + ring + row_vals + barriers + 1024  # + alignment slack


def _flash_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *rows: torch.Tensor) -> tuple:
    """Validate model-layout q (B, S, H, D), k/v (B, S, Hk, D) and the
    per-row f32 tensors (B, S, H); returns (B, S, H, Hk, D)."""
    _need(q, "q", _FLOATS, 4)
    _need(k, "k", (q.dtype,), 4)
    _need(v, "v", (q.dtype,), 4)
    b, s, h, d = q.shape
    hk = k.shape[2]
    if (k.shape != (b, s, hk, d) or v.shape != k.shape or hk < 1 or h % hk
            or s < 1 or b < 1):
        raise ValueError(f"flash shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in "
                         f"{FLASH_HEAD_DIMS}, got {d}")
    for name, t in zip(("lse", "delta"), rows):
        _need(t, name, (torch.float32,), 3)
        if t.shape != (b, s, h):
            raise ValueError(f"{name} must be {(b, s, h)}, got {tuple(t.shape)}")
    for t in (q, k, v, *rows):
        if t.device != q.device:
            raise ValueError("flash operands on different devices")
        if t.data_ptr() % 16:
            raise ValueError("flash operands must be 16-byte aligned")
    return b, s, h, hk, d


def _flash_tail(b, s, h, hk, d, sm_scale, causal, dtype) -> tuple:
    return (b, s, h, hk, d, float(sm_scale), int(bool(causal)),
            int(dtype == torch.bfloat16), _stream())


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float, causal: bool) -> tuple:
    """Kernel K3: (O (B, S, H, D) in q.dtype, LSE (B, S, H) f32)."""
    b, s, h, hk, d = _flash_dims(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    rc = lib().tpubc_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_flash_tail(b, s, h, hk, d, sm_scale, causal, q.dtype))
    _check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
             sm_scale: float, causal: bool) -> torch.Tensor:
    """Kernel K4, dq half: dq (B, S, H, D) in q.dtype, from dO (q's shape
    and dtype), LSE and delta' = rowsum(dO * O) - dlse, both (B, S, H)
    f32."""
    b, s, h, hk, d = _flash_dims(q, k, v, lse, delta)
    _need(dout, "dout", (q.dtype,), 4)
    if dout.shape != q.shape:
        raise ValueError(f"dout must be {tuple(q.shape)}, got "
                         f"{tuple(dout.shape)}")
    dq = torch.empty_like(q)
    rc = lib().tpubc_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_flash_tail(b, s, h, hk, d, sm_scale, causal, q.dtype))
    _check(rc, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              sm_scale: float, causal: bool) -> tuple:
    """Kernel K4, dk/dv half: (dk, dv) (B, S, Hk, D) in k.dtype, summed
    over each KV head's query group in f32."""
    b, s, h, hk, d = _flash_dims(q, k, v, lse, delta)
    _need(dout, "dout", (q.dtype,), 4)
    if dout.shape != q.shape:
        raise ValueError(f"dout must be {tuple(q.shape)}, got "
                         f"{tuple(dout.shape)}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = lib().tpubc_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_flash_tail(b, s, h, hk, d, sm_scale, causal, q.dtype))
    _check(rc, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv
