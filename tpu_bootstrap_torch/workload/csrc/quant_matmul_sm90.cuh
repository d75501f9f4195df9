// The quantized matmul kernel on Hopper's tensor cores, swap-AB: out^T
// (N x T) = W^T (N x K) x^T (K x T), one wgmma m64n8k16 a k-step and a T
// tile. One kernel serves both weight formats, as a template over the
// format (Format<kBits>): K1/K1e (int8, csrc/int8_matmul_sm90.cu) and
// K6/K6e (int4, csrc/int4_matmul_sm90.cu) are two instantiations of it. A
// format supplies the storage rows a slot of 64 K holds (so its bytes and
// its TMA box), the assembly of the A fragment from the slot, and whether
// its scales enter the loop (int4's group scales, streamed with the
// weight) or the epilogue (int8's per-column scale, applied to the
// cluster's sum).
//
// A CTA owns kTileN = 64 output columns (the wgmma's M) of one expert, up
// to kTilesT tiles of 8 T rows (the wgmma's N) and one split of the
// contraction. It has one consumer warpgroup and one producer warp:
//   * the producer streams the weight tile of each stage (kStageK rows of
//     K, stored as the format stores them, by 64 columns) and, int4, its
//     group scales into a ring of Format::kStages slots, one TMA box each
//     from lane 0, when a tensor map can address the storage; else its 32
//     lanes copy the weight bytes (and int4's consumers read each scale
//     from global memory). Barriers `full` (landed) and `empty` (read by
//     every consumer thread) hand each slot over (sm90.cuh);
//   * the consumers stage the activations once per chunk of K, rounded to
//     bf16, K-major in 128-byte rows swizzled as sm90.cuh says (one
//     1024-byte atom per T tile and 64 K), widen each k-step's weight
//     bytes in registers straight into the A fragment, and issue one wgmma
//     per T tile reading x^T as the B operand;
//   * the splits of one column tile form a thread-block cluster along K.
//     Each CTA leaves its partial (8 kTilesT x 64, f32) in shared memory,
//     and after a cluster barrier every CTA sums a share of the elements
//     over the cluster's CTAs in rank order (distributed shared memory):
//     one launch, no workspace, no atomics, the same order on every run.
//
// The A fragment (sm90.cuh) holds, per thread, two rows of the 64 and two
// k pairs. The fragment's rows are permuted so that a thread's two rows
// are two neighbouring columns c0 and c0 + 1 of the storage: fragment row
// 16w + i is column 16w + 2i and row 16w + 8 + i is column 16w + 2i + 1,
// for i < 8 in warp w. So one 16-bit shared-memory load gives a thread
// both columns of one storage row.
//
// A wgmma reads its A registers and writes its accumulators after it is
// issued, until the wait for its group. The compiler does not know that:
// the fragments are pinned (an empty asm that "uses" them) before each
// wgmma fence and after the wait that ends their read, and every wgmma is
// waited for before the accumulators cross from one loop to the next. A
// fragment write or a wgmma in a branch makes ptxas serialize every wgmma
// (C7520), so the masked steps run the same code with zero weights.
//
// Batch invariance: every output's sum runs over the same k-steps in the
// same order, with the same instruction, and the split (so the cluster's
// sum) depends on the weight's shape and the card only; a T tile is its
// own chain of wgmmas, so the rows that share a launch change no bit.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "sm90.cuh"

namespace quant_sm90 {

using namespace tpubc_sm90;

constexpr int kTileN = 64;        // output columns a CTA owns (wgmma M)
constexpr int kTileT = 8;         // T rows of a wgmma (its N)
constexpr int kTilesT = 4;        // T tiles a CTA carries
constexpr int kStageK = 64;       // K rows a ring slot holds
constexpr int kStepsPerStage = kStageK / 16;
constexpr int kMaxSplit = 16;     // the largest cluster (non-portable > 8)
constexpr int kConsumers = 128;   // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kCtasPerSm = 4;
constexpr int kXBytes = 32768;    // activation chunk; the partials after

static_assert(8 * kTilesT * kTileN * 4 <= kXBytes, "partials fit");

// ------------------------------------------------------------ the formats

template <int kBits>
struct Format;

// int4 (K6/K6e): nibble-packed along K, byte (i, n) holding k = 2i in its
// low nibble and 2i + 1 in its high one, each as value + 8; f32 scales per
// (group of K, column), applied to each weight before its product. A slot
// holds 32 packed rows and up to 4 group rows of scales.
template <>
struct Format<4> {
  static constexpr int kKPerRow = 2;    // k of one storage row
  static constexpr int kStages = 6;     // depth of the ring
  static constexpr int kScaleRows = 4;  // group rows a slot holds at most
  static constexpr int kSlotS = kScaleRows * kTileN * 4;
  static constexpr bool kLoopScales = true;
};

// int8 (K1/K1e): one byte a weight, (K, N) N-contiguous; one f32 scale a
// column, applied once to the sum. A slot holds 64 rows: 4096 bytes, twice
// int4's, so the ring is 5 slots deep, not 6, to keep 4 CTAs on an SM
// (4 x (54,608 + 1,024 reserved) bytes of the SM's 233,472; 6 slots would
// need 238,976): 20 KB of weights in flight a CTA, more than int4's 12.
template <>
struct Format<8> {
  static constexpr int kKPerRow = 1;
  static constexpr int kStages = 5;
  static constexpr int kSlotS = 0;
  static constexpr bool kLoopScales = false;
};

// Shared memory (from a 1024-byte aligned start): the activation chunk,
// the ring's weight and scale slots, the barriers.
template <int kBits>
struct Smem {
  using F = Format<kBits>;
  static constexpr int kBoxRows = kStageK / F::kKPerRow;  // storage rows
  static constexpr int kSlotW = kBoxRows * kTileN;        // 2048 / 4096
  static constexpr int kXOffset = 0;
  static constexpr int kWOffset = kXOffset + kXBytes;
  static constexpr int kSOffset = kWOffset + F::kStages * kSlotW;
  static constexpr int kBarOffset = kSOffset + F::kStages * F::kSlotS;
  // int8: the CTA's column scales, staged once for the epilogue.
  static constexpr int kColOffset = kBarOffset + 2 * F::kStages * 8;
  static constexpr int kColBytes = F::kLoopScales ? 0 : kTileN * 4;
  static constexpr int kBytes = kColOffset + kColBytes + 1024;
};

// An SM holds 233,472 bytes of shared memory for its CTAs, each of which
// also reserves 1,024.
static_assert(kCtasPerSm * (Smem<4>::kBytes + 1024) <= 233472, "int4 fits");
static_assert(kCtasPerSm * (Smem<8>::kBytes + 1024) <= 233472, "int8 fits");

// ------------------------------------------------------------- the splits

// The contraction's k-steps (of 16) are split into whole units of `per`
// k-steps (int4: a group when a group is whole k-steps, else a k-step;
// int8: a ring slot, kStepsPerStage). Split r of `split` takes units
// [r U / split, (r + 1) U / split). kernels.int4_split_bounds /
// int8_split_bounds mirror it.
__host__ __device__ inline int split_units(int steps, int per) {
  return (steps + per - 1) / per;
}

struct Steps {
  int begin, end;  // k-steps [begin, end)
};

__host__ __device__ inline Steps split_steps(int steps, int per, int split,
                                             int r) {
  const int units = split_units(steps, per);
  const int u0 = (int)((long long)r * units / split);
  const int u1 = (int)((long long)(r + 1) * units / split);
  const int end = u1 * per < steps ? u1 * per : steps;
  return {u0 * per, end};
}

// The int4 groups whose scales stream with the weight (a slot holds their
// rows by TMA): 16, 32 and multiples of 64. A slot starts a multiple of 64
// rows of K past a group boundary, so its k-step j (of 4) reads scale row
// j >> scale_shift(group) of the 4 >> scale_shift(group) it holds.
__host__ __device__ inline bool scales_in_slot(int group) {
  return group == 16 || group == 32 || group % 64 == 0;
}

__host__ __device__ inline int scale_shift(int group) {
  return group == 16 ? 0 : group == 32 ? 1 : 2;
}

// K rows of the activation chunk for `tiles` T tiles (a multiple of 64).
__host__ __device__ constexpr int chunk_k(int tiles) {
  return kXBytes / (tiles * kTileT * 2) / 64 * 64;
}

// -------------------------------------------------------------- the tiles

// Byte (r, c) of a weight slot: rows of 64 bytes, 16-byte chunks swizzled
// by 64B mode, as a TMA box with CU_TENSOR_MAP_SWIZZLE_64B writes them.
__device__ __forceinline__ int wslot_offset(int r, int c) {
  return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// Byte of activation (row r of T tile tt, the 8 values from chunk k 8 g8)
// in the chunk: tile tt's atoms of 64 K follow each other, rows of 128
// bytes swizzled by 128B mode.
__device__ __forceinline__ int xchunk_offset(int tt, int nkb, int r, int g8) {
  return (tt * nkb + (g8 >> 3)) * 1024 + r * 128 + (((g8 & 7) ^ r) << 4);
}

// Descriptor of the B operand of local k-step `ks` of T tile `tt`.
__device__ __forceinline__ uint64_t xchunk_desc(uint32_t xs, int tt, int nkb,
                                                int ks) {
  return make_desc<128>(xs + (tt * nkb + (ks >> 2)) * 1024 + (ks & 3) * 32,
                        16, 1024);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// x[t, k .. k + 7] rounded to bf16, zero at t >= t_total or k >= kdim.
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* __restrict__ x,
                                         int t, int k, int t_total, int kdim,
                                         bool vec) {
  const __nv_bfloat16* row = x + (size_t)t * kdim;
  if (vec && t < t_total && k + 8 <= kdim)
    return __ldg(reinterpret_cast<const uint4*>(row + k));
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = t < t_total && k + i < kdim ? __bfloat162float(row[k + i]) : 0.f;
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ uint4 load_x8(const float* __restrict__ x, int t,
                                         int k, int t_total, int kdim,
                                         bool vec) {
  const float* row = x + (size_t)t * kdim;
  float v[8];
  if (vec && t < t_total && k + 8 <= kdim) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + k + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = t < t_total && k + i < kdim ? row[k + i] : 0.f;
  }
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The consumers stage rows [t0, t0 + 8 tiles) and K [k0, k0 + klen) of x
// (klen a multiple of 16) into the chunk; the caller fences and syncs.
// Aligned bf16 rows are copied as they are, every copy of a thread in
// flight at once (cp.async, zeros past the row's end); f32 or unaligned
// rows go through registers to be rounded or assembled.
template <int kTiles, typename X>
__device__ __forceinline__ void stage_x(uint8_t* xs, const X* __restrict__ x,
                                        int t_total, int kdim, int t0,
                                        int k0, int klen, int nkb, bool vec) {
  constexpr int kRows = kTiles * kTileT;
  const int items = kRows * (klen / 8);
  if constexpr (std::is_same_v<X, __nv_bfloat16>) {
    if (vec) {
      for (int it = threadIdx.x; it < items; it += kConsumers) {
        const int r = it % kRows, g8 = it / kRows;
        const int t = t0 + r, k = k0 + 8 * g8;
        const int bytes = t < t_total ? min(16, max(0, 2 * (kdim - k))) : 0;
        cp_async16(smem_addr(xs + xchunk_offset(r / kTileT, nkb,
                                                r % kTileT, g8)),
                   bytes ? x + (size_t)t * kdim + k : x, bytes);
      }
      cp_async_wait_all();
      return;
    }
  }
#pragma unroll 4
  for (int it = threadIdx.x; it < items; it += kConsumers) {
    const int r = it % kRows, g8 = it / kRows;
    const uint4 v = load_x8(x, t0 + r, k0 + 8 * g8, t_total, kdim, vec);
    *reinterpret_cast<uint4*>(
        xs + xchunk_offset(r / kTileT, nkb, r % kTileT, g8)) = v;
  }
}

// ------------------------------------------------------------ the widening

// (w & mask) | bits in one LOP3 (C would take two: SASS has one immediate).
template <uint32_t kMask, uint32_t kBits>
__device__ __forceinline__ uint32_t and_or(uint32_t w) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n"  // (a & b) | c
      : "=r"(r) : "r"(w), "n"(kMask), "n"(kBits));
  return r;
}

// int4: the byte in bits [8 b, 8 b + 8) of w, as the A register (bf16
// pair) of its two weights ((lo - 8) s, (hi - 8) s), lo the lower k: each
// nibble is or-ed into a float's mantissa where its unit is 1, so that the
// float is exactly 2^m + nibble and one subtraction gives nibble - 8; then
// one f32 product and a round to bf16, as the reference's cast. A weight
// whose k is past the contraction (ok_lo, ok_hi false) is 0.
template <int B>
__device__ __forceinline__ uint32_t dequant(uint32_t w, float s, bool ok_lo,
                                            bool ok_hi) {
  // 2^23, 2^19, 2^15, 2^11: the exponents at which bit 8 b, 8 b + 4 is 1.
  constexpr uint32_t kLoExp = B == 0 ? 0x4B000000u : 0x47000000u;
  constexpr uint32_t kHiExp = B == 0 ? 0x49000000u : 0x45000000u;
  constexpr float kLoBias = B == 0 ? 8388616.f : 32776.f;  // 2^m + 8
  constexpr float kHiBias = B == 0 ? 524296.f : 2056.f;
  const float lo =
      __uint_as_float(and_or<0xFu << (8 * B), kLoExp>(w)) - kLoBias;
  const float hi =
      __uint_as_float(and_or<0xF0u << (8 * B), kHiExp>(w)) - kHiBias;
  return pack_bf16(ok_lo ? lo * s : 0.f, ok_hi ? hi * s : 0.f);
}

// Bytes of a and b picked by a `prmt` selector (a bytes 0-3, b 4-7).
template <uint32_t kSel>
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "n"(kSel));
  return r;
}

// int8: byte B of lo and of hi (each a storage row's two bytes, xor-ed
// with 0x80 so that a byte is b + 128), as the A register of the bf16 pair
// (lo's b, hi's b). Each byte is placed in the mantissa of the float 2^23
// (one PRMT), so the float is exactly 2^23 + b + 128, and one subtraction
// gives b. An integer of at most 8 significant bits is a bf16 exactly: its
// float's low 16 bits are 0, so the pair is the two floats' high halves
// (one PRMT; a convert would round nothing). A weight whose k is past the
// contraction (ok_lo, ok_hi false) is 0.
template <int B>
__device__ __forceinline__ uint32_t widen8(uint32_t lo, uint32_t hi,
                                           bool ok_lo, bool ok_hi) {
  constexpr uint32_t kSel = 0x7440u | B;  // byte B, then 0, 0, 0x4B
  constexpr float kBias = 8388736.f;      // 2^23 + 128
  const float a = __uint_as_float(prmt<kSel>(lo, 0x4B000000u)) - kBias;
  const float b = __uint_as_float(prmt<kSel>(hi, 0x4B000000u)) - kBias;
  return prmt<0x7632u>(__float_as_uint(ok_lo ? a : 0.f),
                       __float_as_uint(ok_hi ? b : 0.f));
}

// ------------------------------------------------------------- the kernel

struct Args {
  const void* x;
  const uint8_t* q;
  const float* s;
  void* out;
  int t, kdim, p, n;  // t: rows per expert; p: storage rows of K
  int per, split;     // k-steps a unit of the split; CTAs along K
  int group;          // int4: K rows a scale covers
  int mtiles;       // column tiles: blockIdx.y = tile + mtiles * T group
  int scale_shift;  // int4: a slot's step j reads scale row j >> scale_shift
  int x_vec;        // x rows may be read 16 bytes at a time
};

// Producer: fills slot i % kStages with stage i of this CTA's k-steps
// [ks0, ks1), after the consumers released its previous use; int8, first
// the column scales (s: this expert's).
template <int kBits, bool kTma>
__device__ __forceinline__ void produce(const CUtensorMap* q_map,
                                        const CUtensorMap* s_map,
                                        const Args& a, const uint8_t* q,
                                        const float* s, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int e, int n0, int ks0, int ks1) {
  using F = Format<kBits>;
  using L = Smem<kBits>;
  const int lane = threadIdx.x % 32;
  const int stages = (ks1 - ks0 + kStepsPerStage - 1) / kStepsPerStage;
  if constexpr (!F::kLoopScales) {
    // int8: the tile's column scales for the epilogue, two a lane, copied
    // without waiting (zeros past N); read after the cluster's barrier.
    float* col = reinterpret_cast<float*>(smem + L::kColOffset);
#pragma unroll
    for (int c = lane; c < kTileN; c += 32)
      cp_async4(smem_addr(col + c), n0 + c < a.n ? s + n0 + c : s,
                n0 + c < a.n ? 4 : 0);
  }
  if (kTma && lane != 0) {
    if constexpr (!F::kLoopScales) cp_async_wait_all();
    return;
  }
  for (int i = 0; i < stages; ++i) {
    const int slot = i % F::kStages;
    if (i >= F::kStages) mbar_wait(&empty[slot], (i / F::kStages - 1) & 1);
    const int k0 = 16 * (ks0 + i * kStepsPerStage);
    const int p0 = k0 / F::kKPerRow;  // first storage row of the stage
    uint8_t* w = smem + L::kWOffset + slot * L::kSlotW;
    if constexpr (kTma) {
      if constexpr (F::kLoopScales) {
        mbar_arrive_expect_tx(
            &full[slot],
            L::kSlotW + (F::kScaleRows >> a.scale_shift) * kTileN * 4);
        tma_load_3d(smem_addr(w), q_map, &full[slot], n0, p0, e);
        tma_load_3d(smem_addr(smem + L::kSOffset + slot * F::kSlotS), s_map,
                    &full[slot], n0, k0 / a.group, e);
      } else {
        mbar_arrive_expect_tx(&full[slot], L::kSlotW);
        tma_load_3d(smem_addr(w), q_map, &full[slot], n0, p0, e);
      }
    } else {
#pragma unroll 8
      for (int idx = lane; idx < L::kSlotW; idx += 32) {
        const int r = idx / kTileN, c = idx % kTileN;
        const int p = p0 + r, n = n0 + c;
        w[wslot_offset(r, c)] =
            p < a.p && n < a.n ? __ldg(q + (size_t)p * a.n + n) : 0;
      }
      mbar_arrive(&full[slot]);
    }
  }
  if constexpr (!F::kLoopScales) cp_async_wait_all();  // the scales landed
}

// The consumer warpgroup over this CTA's k-steps [ks0, ks1), for kTiles T
// tiles of 8 rows from t0; its partial sums end in `red`.
//
// Stage i waits for slot i % kStages and goes in two halves of two k-steps:
// each half widens its steps into one of two fragment buffers and issues
// one wgmma per k-step and T tile (one commit group), then waits for the
// group before it, so the other buffer is free again; the slot is released
// once the second half has read it. No wgmma and no fragment write sits in
// a branch (ptxas would serialize every wgmma): the steps past the split
// (a partial last stage) or past kdim are masked to zero weights, their
// wgmmas reading the chunk's first activation step.
template <int kBits, bool kTma, int kTiles, typename X>
struct Consumer {
  using F = Format<kBits>;
  using L = Smem<kBits>;
  const Args& a;
  const X* x;
  const float* s;  // int4: this expert's scales (global)
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  int ks0, ks1, t0, n0, c0, j4;
  int stages;
  int chunk = 0;   // first k-step of the staged activation chunk
  static constexpr int kChunkK = chunk_k(kTiles);
  static constexpr int kNkb = kChunkK / 64;

  // Stages the chunk that starts at k-step `ks` (after the wgmmas that
  // read the last one, if any).
  __device__ __forceinline__ void next_chunk(int ks, bool first) {
    if (!first) {
      wgmma_wait_group<0>();
      named_barrier_sync(1, kConsumers);
    }
    chunk = ks;
    stage_x<kTiles>(smem + L::kXOffset, x, a.t, a.kdim, t0, 16 * ks,
                    min(kChunkK, 16 * (ks1 - ks)), kNkb, a.x_vec != 0);
    fence_proxy_async();
    named_barrier_sync(1, kConsumers);
  }

  // The A fragment of the slot's k-step j (first k kb) whose weights past
  // k = lim are 0: int4, two 16-bit loads (packed rows 8 j + j4, k pairs
  // 2 j4, and 8 j + j4 + 4) and each weight's scale; int8, four (rows
  // 2 j4, 2 j4 + 1, 2 j4 + 8, 2 j4 + 9 of the step). The slot's swizzle
  // repeats every 8 rows.
  template <bool kMasked>
  __device__ __forceinline__ void fragment(uint32_t (&f)[4], int j, int kb,
                                           int lim, const uint8_t* w,
                                           const float* sc) const {
    const int ka = kb + 2 * j4, kc = ka + 8;  // k of the low halves
    const bool a_lo = !kMasked || ka < lim, a_hi = !kMasked || ka + 1 < lim;
    const bool c_lo = !kMasked || kc < lim, c_hi = !kMasked || kc + 1 < lim;
    if constexpr (kBits == 4) {
      const uint32_t w1 = *reinterpret_cast<const uint16_t*>(
          w + 512 * j + wslot_offset(j4, c0));
      const uint32_t w2 = *reinterpret_cast<const uint16_t*>(
          w + 512 * j + wslot_offset(j4 + 4, c0));
      float sa0, sa1, sc0, sc1;  // scales: (k pair, column c0 / c0 + 1)
      if constexpr (kTma) {
        const float2 v = *reinterpret_cast<const float2*>(
            sc + (j >> a.scale_shift) * kTileN + c0);
        sa0 = sc0 = v.x;
        sa1 = sc1 = v.y;
      } else {
        const int n = n0 + c0;
        const float* ra = s + (size_t)(ka / a.group) * a.n + n;
        const float* rc = s + (size_t)(kc / a.group) * a.n + n;
        sa0 = ka < lim && n < a.n ? __ldg(ra) : 0.f;
        sa1 = ka < lim && n + 1 < a.n ? __ldg(ra + 1) : 0.f;
        sc0 = kc < lim && n < a.n ? __ldg(rc) : 0.f;
        sc1 = kc < lim && n + 1 < a.n ? __ldg(rc + 1) : 0.f;
      }
      f[0] = dequant<0>(w1, sa0, a_lo, a_hi);
      f[1] = dequant<1>(w1, sa1, a_lo, a_hi);
      f[2] = dequant<0>(w2, sc0, c_lo, c_hi);
      f[3] = dequant<1>(w2, sc1, c_lo, c_hi);
    } else {
      const uint8_t* rows = w + 1024 * j;
      uint32_t r[4];  // rows 2 j4, + 1, + 8, + 9: columns c0, c0 + 1
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint16_t*>(
                   rows + wslot_offset(2 * j4 + (i & 1) + 8 * (i >> 1), c0)) ^
               0x8080u;
      f[0] = widen8<0>(r[0], r[1], a_lo, a_hi);
      f[1] = widen8<1>(r[0], r[1], a_lo, a_hi);
      f[2] = widen8<0>(r[2], r[3], c_lo, c_hi);
      f[3] = widen8<1>(r[2], r[3], c_lo, c_hi);
    }
  }

  // Steps 2 kHalf, 2 kHalf + 1 of the stage at k-step ks, from its slot's
  // weights w and (int4) scales sc, into frag; then their wgmmas.
  template <bool kMasked, int kHalf>
  __device__ __forceinline__ void half(int ks, const uint8_t* w,
                                       const float* sc,
                                       uint32_t (&frag)[2][4],
                                       float (&acc)[kTiles][4]) {
    int local[2];  // the chunk's k-step each wgmma reads
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kHalf + h;
      // The k past which weights are 0: kdim, or this step's start when
      // the step is past the split.
      const int lim = !kMasked || ks + j < ks1 ? a.kdim : 0;
      local[h] = !kMasked || ks + j < ks1 ? ks + j - chunk : 0;
      fragment<kMasked>(frag[h], j, 16 * (ks + j), lim, w, sc);
    }
    const uint32_t xs = smem_addr(smem + L::kXOffset);
    fence_frag(frag);  // written before the fence that the wgmmas follow
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int tt = 0; tt < kTiles; ++tt)
        wgmma_rs_kmajor<8>(acc[tt], frag[h],
                           xchunk_desc(xs, tt, kNkb, local[h]), 1);
    wgmma_commit();
  }

  template <bool kMasked>
  __device__ __forceinline__ void stage(int i, uint32_t (&frag0)[2][4],
                                        uint32_t (&frag1)[2][4],
                                        float (&acc)[kTiles][4]) {
    const int slot = i % F::kStages;
    const int ks = ks0 + i * kStepsPerStage;
    if (16 * (ks - chunk) == kChunkK) next_chunk(ks, false);
    mbar_wait(&full[slot], (i / F::kStages) & 1);
    const uint8_t* w = smem + L::kWOffset + slot * L::kSlotW;
    const float* sc = reinterpret_cast<const float*>(smem + L::kSOffset +
                                                     slot * F::kSlotS);
    half<kMasked, 0>(ks, w, sc, frag0, acc);
    wgmma_wait_group<1>();  // the last stage's second half: frag1 is free
    fence_frag(frag1);
    half<kMasked, 1>(ks, w, sc, frag1, acc);
    mbar_arrive(&empty[slot]);
    wgmma_wait_group<1>();  // this stage's first half: frag0 is free
    fence_frag(frag0);
  }

  // Waits for every wgmma, then pins the registers they wrote and read: no
  // copy of an accumulator (the compiler's, between two loops) may happen
  // while a wgmma still writes it.
  __device__ __forceinline__ static void drain(uint32_t (&frag1)[2][4],
                                               float (&acc)[kTiles][4]) {
    wgmma_wait_group<0>();
    fence_frag(frag1);
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) fence_regs(acc[tt]);
  }

  // Pins a fragment's registers: before wgmma_fence, so that every write
  // of them precedes it (a write the compiler sank past the fence would
  // race the wgmma's read); after the wait that ends the wgmmas' read, so
  // that they stay live (and unreused) until then.
  __device__ __forceinline__ static void fence_frag(uint32_t (&frag)[2][4]) {
    fence_regs(frag[0]);
    fence_regs(frag[1]);
  }

  // Every stage; the stages whose steps are all in the split and under
  // kdim go through the unmasked widening.
  __device__ __forceinline__ void run(float* red) {
    float acc[kTiles][4];
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[tt][k] = 0.f;
    uint32_t frag0[2][4] = {}, frag1[2][4] = {};
    next_chunk(ks0, true);
    const int whole = min(ks1, a.kdim / 16) - ks0;  // unmasked steps
    const int clean = whole > 0 ? whole / kStepsPerStage : 0;
    int i = 0;
    for (; i < clean; ++i) stage<false>(i, frag0, frag1, acc);
    drain(frag1, acc);  // the loops may hold acc in other registers
    for (; i < stages; ++i) stage<true>(i, frag0, frag1, acc);
    drain(frag1, acc);
    named_barrier_sync(1, kConsumers);  // every wgmma read its chunk
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) {
      float* row = red + (kTileT * tt + 2 * j4) * kTileN + c0;
      row[0] = acc[tt][0];
      row[kTileN] = acc[tt][1];
      row[1] = acc[tt][2];
      row[kTileN + 1] = acc[tt][3];
    }
  }
};

// The int4 plain-load form reads each scale from global memory, which
// costs registers: it is given room for 2 CTAs an SM, so that nothing
// spills.
template <int kBits, typename X, bool kExpert, bool kTma>
__global__ void __launch_bounds__(kThreads, kTma ? kCtasPerSm : 2)
quant_matmul_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap s_map,
                         const __grid_constant__ Args a) {
  using F = Format<kBits>;
  using L = Smem<kBits>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + F::kStages;
  const float* col_scale = reinterpret_cast<const float*>(smem +
                                                          L::kColOffset);

  const int rank = blockIdx.x;  // the cluster is the grid's x extent
  const int mt = blockIdx.y % a.mtiles;
  const int t0 = blockIdx.y / a.mtiles * kTilesT * kTileT;
  const int n0 = mt * kTileN;
  const int e = kExpert ? blockIdx.z : 0;
  const int ks = F::kKPerRow * a.p;  // the stored contraction
  const X* x = static_cast<const X*>(a.x) + (size_t)e * a.t * a.kdim;
  X* out = static_cast<X*>(a.out) + (size_t)e * a.t * a.n;
  const uint8_t* q = a.q + (size_t)e * a.p * a.n;
  const float* s = a.s + (size_t)e * (F::kLoopScales ? ks / a.group : 1) *
                             a.n;
  const int tiles = min(kTilesT, (a.t - t0 + kTileT - 1) / kTileT);
  const Steps st = split_steps((ks + 15) / 16, a.per, a.split, rank);
  const int stages = (st.end - st.begin + kStepsPerStage - 1) /
                     kStepsPerStage;

  if (threadIdx.x == 0) {
    for (int i = 0; i < F::kStages; ++i) {
      mbar_init(&full[i], kTma ? 1 : 32);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem + L::kXOffset);  // [8 tiles][64]
  if (threadIdx.x >= kConsumers) {
    produce<kBits, kTma>(&q_map, &s_map, a, q, s, smem, full, empty, e, n0,
                         st.begin, st.end);
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c0 = 16 * warp + 2 * (lane / 4);
#define TPUBC_QUANT_CONSUME(TILES)                                          \
  Consumer<kBits, kTma, TILES, X>{a, x, s, smem, full, empty, st.begin,     \
                                  st.end, t0, n0, c0, lane % 4, stages}     \
      .run(red)
    // T tiles of this CTA: 1, 2, or up to kTilesT (3 runs as 4: the rows
    // past T are staged as zeros and never reduced), which keeps the
    // build to three bodies an instantiation.
    switch (tiles) {
      case 1: TPUBC_QUANT_CONSUME(1); break;
      case 2: TPUBC_QUANT_CONSUME(2); break;
      default: TPUBC_QUANT_CONSUME(kTilesT); break;
    }
#undef TPUBC_QUANT_CONSUME
  }
  cluster_sync();  // every split's partial is in its shared memory
  if (threadIdx.x < kConsumers) {
    const int rows = min(kTilesT * kTileT, a.t - t0);
    const int total = rows * kTileN;
    const int per = (total + a.split - 1) / a.split;
    const int end = min(total, (rank + 1) * per);
    for (int f = rank * per + threadIdx.x; f < end; f += kConsumers) {
      const uint32_t addr = smem_addr(red + f);
      float part[kMaxSplit];  // every load in flight before the first add
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        part[r] = r < a.split ? ld_cluster(cluster_peer(addr, r)) : 0.f;
      float sum = part[0];
#pragma unroll
      for (int r = 1; r < kMaxSplit; ++r)
        if (r < a.split) sum += part[r];
      const int n = n0 + f % kTileN;
      if constexpr (!F::kLoopScales) sum *= col_scale[f % kTileN];  // int8
      if (n < a.n) store(out + (size_t)(t0 + f / kTileN) * a.n + n, sum);
    }
  }
  cluster_sync_relaxed();  // no CTA leaves while the cluster reads its partial
}

// ------------------------------------------------------------------- host

// cuTensorMapEncodeTiled, fetched from the driver at first use, so the
// library links no libcuda.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor maps, encoded once per (base, shape, box) and kept: the serve
// loop launches the same weights every step.
struct MapKey {
  const void* base;
  int e, rows, n, box_rows;
  bool scales;
  bool operator==(const MapKey& o) const {
    return base == o.base && e == o.e && rows == o.rows && n == o.n &&
           box_rows == o.box_rows && scales == o.scales;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.base);
    for (int v : {k.e, k.rows, k.n, k.box_rows, (int)k.scales})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

inline std::mutex map_mutex;
inline std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;  // guarded-by: map_mutex

// A 3-d view (N, rows, E) of a weight (bytes; box: box_rows rows by 64
// columns, 64B swizzle) or of int4's scales (f32; box: box_rows group rows
// by 64 columns). Rows and columns past the storage read as zeros.
inline bool tensor_map(CUtensorMap* map, const void* base, int e, int rows,
                       int n, int box_rows, bool scales) {
  const MapKey key{base, e, rows, n, box_rows, scales};
  std::lock_guard<std::mutex> lock(map_mutex);
  const auto found = map_cache.find(key);
  if (found != map_cache.end()) {
    *map = found->second;
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elt = scales ? 4 : 1;
  cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)rows, (cuuint64_t)e};
  cuuint64_t strides[2] = {n * elt, (cuuint64_t)rows * n * elt};
  cuuint32_t box[3] = {(cuuint32_t)kTileN, (cuuint32_t)box_rows, 1};
  cuuint32_t step[3] = {1, 1, 1};
  if (encode(map,
             scales ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             3, const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             scales ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (map_cache.size() >= 4096) map_cache.clear();
  map_cache.emplace(key, *map);
  return true;
}

template <int kBits, typename X, bool kExpert, bool kTma>
cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& s_map,
                   const Args& a, dim3 grid, cudaStream_t st) {
  auto kernel = quant_matmul_sm90_kernel<kBits, X, kExpert, kTma>;
  constexpr int kSmem = Smem<kBits>::kBytes;
  static const cudaError_t prepared = [&] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)  // room for kCtasPerSm CTAs on an SM
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }();
  if (prepared != cudaSuccess) return prepared;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q_map, s_map, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};

// Launches the instantiation for x's dtype, the expert axis (e > 1) and
// whether the weight streams by TMA; the grid is (split, column tiles x T
// groups, e).
template <int kBits>
cudaError_t launch_any(bool x_is_bf16, int e, bool tma,
                       const CUtensorMap& q_map, const CUtensorMap& s_map,
                       const Args& a, cudaStream_t st) {
  const int tgroups =
      ((a.t + kTileT - 1) / kTileT + kTilesT - 1) / kTilesT;
  const dim3 grid(a.split, a.mtiles * tgroups, e);
  auto pick = [&](auto x_type, auto expert) {
    using X = typename decltype(x_type)::type;
    constexpr bool kExpert = decltype(expert)::value;
    return tma ? launch<kBits, X, kExpert, true>(q_map, s_map, a, grid, st)
               : launch<kBits, X, kExpert, false>(q_map, s_map, a, grid, st);
  };
  using Bf16 = Type<__nv_bfloat16>;
  using F32 = Type<float>;
  if (x_is_bf16)
    return e > 1 ? pick(Bf16{}, std::true_type{})
                 : pick(Bf16{}, std::false_type{});
  return e > 1 ? pick(F32{}, std::true_type{})
               : pick(F32{}, std::false_type{});
}

// Whether T and N fit the grid (column tiles x T groups <= 65535).
inline bool grid_fits(int t, int n) {
  const long long mtiles = (n + kTileN - 1) / kTileN;
  const long long tgroups = ((t + kTileT - 1) / kTileT + kTilesT - 1) /
                            kTilesT;
  return mtiles * tgroups <= 65535;
}

}  // namespace quant_sm90
