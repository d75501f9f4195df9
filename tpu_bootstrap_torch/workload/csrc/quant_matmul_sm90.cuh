// The Hopper layout of the quantized matmul kernels, swap-AB on the tensor
// cores: out^T (N x T) = W^T (N x K) x^T (K x T), one wgmma m64n8k16 a
// k-step and a T tile. Used by K6/K6e (csrc/int4_matmul_sm90.cu); written
// so that K1/K1e can adopt it.
//
// A CTA owns kTileN = 64 output columns (the wgmma's M) of one expert, up
// to kTilesT tiles of 8 T rows (the wgmma's N) and one split of the
// contraction. It has one consumer warpgroup and one producer warp:
//   * the producer streams the weight tile of each stage (kStageK rows of
//     K, packed as the storage is, by 64 columns) and its group scales into
//     a ring of kStages slots, one TMA box each from lane 0, when a tensor
//     map can address the storage; else its 32 lanes copy the weight bytes
//     and the consumers read each scale from global memory. Barriers
//     `full` (landed) and `empty` (read by every consumer thread) hand
//     each slot over (sm90.cuh);
//   * the consumers stage the activations once per chunk of K, rounded to
//     bf16, K-major in 128-byte rows swizzled as sm90.cuh says (one
//     1024-byte atom per T tile and 64 K), dequantize each k-step's weight
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
// both columns of one packed row.
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

#include <type_traits>

#include "sm90.cuh"

namespace quant_sm90 {

using namespace tpubc_sm90;

constexpr int kTileN = 64;        // output columns a CTA owns (wgmma M)
constexpr int kTileT = 8;         // T rows of a wgmma (its N)
constexpr int kTilesT = 4;        // T tiles a CTA carries
constexpr int kStageK = 64;       // K rows a ring slot holds
constexpr int kStepsPerStage = kStageK / 16;
constexpr int kStages = 6;        // depth of the ring
constexpr int kMaxSplit = 16;     // the largest cluster (non-portable > 8)
constexpr int kConsumers = 128;   // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kCtasPerSm = 4;
constexpr int kXBytes = 32768;    // activation chunk; the partials after
constexpr int kScaleRows = 4;     // group rows a slot holds at most

// Shared memory (from a 1024-byte aligned start): the activation chunk,
// the ring's weight and scale slots, the barriers.
constexpr int kXOffset = 0;
constexpr int kSlotW = kTileN * kStageK / 2;  // packed int4: 2048 bytes
constexpr int kWOffset = kXOffset + kXBytes;
constexpr int kSlotS = kScaleRows * kTileN * 4;
constexpr int kSOffset = kWOffset + kStages * kSlotW;
constexpr int kBarOffset = kSOffset + kStages * kSlotS;
constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment

static_assert(8 * kTilesT * kTileN * 4 <= kXBytes, "partials fit");

// ------------------------------------------------------------- the splits

// The contraction is split into whole units: groups when a group is whole
// k-steps (group % 16 == 0), else k-steps. Split r of `split` takes units
// [r U / split, (r + 1) U / split). kernels.int4_split_bounds mirrors it.
__host__ __device__ inline int split_units(int ks, int group) {
  return group % 16 == 0 ? ks / group : (ks + 15) / 16;
}

struct Steps {
  int begin, end;  // k-steps [begin, end)
};

__host__ __device__ inline Steps split_steps(int ks, int group, int split,
                                             int r) {
  const int units = split_units(ks, group);
  const int per = group % 16 == 0 ? group / 16 : 1;
  const int total = (ks + 15) / 16;
  const int u0 = (int)((long long)r * units / split);
  const int u1 = (int)((long long)(r + 1) * units / split);
  const int end = u1 * per < total ? u1 * per : total;
  return {u0 * per, end};
}

// The groups whose scales stream with the weight (a slot holds their rows
// by TMA): 16, 32 and multiples of 64. A slot starts a multiple of 64 rows
// of K past a group boundary, so its k-step j (of 4) reads scale row
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

// ------------------------------------------------------------ the dequant

// (w & mask) | bits in one LOP3 (C would take two: SASS has one immediate).
template <uint32_t kMask, uint32_t kBits>
__device__ __forceinline__ uint32_t and_or(uint32_t w) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n"  // (a & b) | c
      : "=r"(r) : "r"(w), "n"(kMask), "n"(kBits));
  return r;
}

// The byte in bits [8 b, 8 b + 8) of w, as the A register (bf16 pair) of
// its two weights ((lo - 8) s, (hi - 8) s), lo the lower k: each nibble
// is or-ed into a float's mantissa where its unit is 1, so that the float
// is exactly 2^m + nibble and one subtraction gives nibble - 8; then one
// f32 product and a round to bf16, as the reference's cast. A weight whose
// k is past the contraction (ok_lo, ok_hi false) is 0.
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

}  // namespace quant_sm90
