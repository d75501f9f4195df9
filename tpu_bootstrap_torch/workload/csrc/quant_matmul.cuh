// The CTA layout, helpers and epilogue shared by the quantized matmul
// kernels: K1/K1e (int8_matmul.cu) and K6/K6e (int4_matmul.cu). Only the
// weight format, and so the inner loop, differs between them.
//
// Layout: one CTA per (32-column N tile, 8-row T tile[, expert]), 256
// threads. A warp covers 8 consecutive weight rows x 32 columns: each
// thread loads 8 bytes of one row with one 8-byte load. The CTA's
// activation chunk (8 rows x 512 K) is staged in shared memory, already
// rounded to bf16 and widened to f32. Each thread keeps 8 x 8 f32 sums,
// and the 64 K slices are reduced at the end in a fixed order (a
// butterfly inside the warp, then the warps in index order), so an
// output's reduction order depends only on K, never on T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace quant_matmul {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                           // columns per thread
constexpr int kTileN = 32;                         // columns per CTA
constexpr int kThreadsPerRow = kTileN / kCols;     // 4
constexpr int kRowsPerWarp = 32 / kThreadsPerRow;  // 8
constexpr int kSlices = kWarps * kRowsPerWarp;     // 64 K slices per CTA
constexpr int kChunkK = 512;                       // K rows per chunk
constexpr int kTileT = 8;

static_assert(kTileT * kTileN == kThreads, "one output per thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 8 bytes of row r, columns n0 .. n0 + 7 (zero past the edges). The
// 8-byte load is used when the row segment is whole and aligned.
template <typename B>
__device__ __forceinline__ uint2 load_row8(const B* __restrict__ q, int r,
                                           int n0, int r_total, int n_total,
                                           bool vec_ok) {
  uint2 w = make_uint2(0u, 0u);
  if (r >= r_total) return w;
  const B* row = q + (size_t)r * n_total;
  if (vec_ok && n0 + kCols <= n_total) {
    return __ldg(reinterpret_cast<const uint2*>(row + n0));
  }
  uint32_t b[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    b[c] = (n0 + c < n_total) ? (uint32_t)(uint8_t)row[n0 + c] : 0u;
  }
  w.x = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  w.y = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
  return w;
}

// Stages x[t0 .. t0 + 7, k0 .. k0 + 511] into xs, rounded to bf16 first
// as the reference does; rows past t_total and columns past k_total are 0.
template <typename T>
__device__ __forceinline__ void stage_x(float (&xs)[kChunkK][kTileT],
                                        const T* __restrict__ x, int k0,
                                        int t0, int t_total, int k_total) {
  for (int i = threadIdx.x; i < kChunkK * kTileT; i += kThreads) {
    const int kk = i % kChunkK;
    const int tt = i / kChunkK;
    const int k = k0 + kk;
    const int t = t0 + tt;
    float v = 0.f;
    if (k < k_total && t < t_total) {
      v = round_bf16(to_float(x[(size_t)t * k_total + k]));
    }
    xs[kk][tt] = v;
  }
}

// The fixed-order reduction of the 64 slices' sums; returns the whole sum
// of this thread's output (row threadIdx.x / kTileN, column
// threadIdx.x % kTileN of the CTA's tile).
__device__ __forceinline__ float reduce_slices(
    float (&acc)[kTileT][kCols], float (&red)[kWarps][kTileT][kTileN]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = lane % kThreadsPerRow;
#pragma unroll
  for (int tt = 0; tt < kTileT; ++tt) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = acc[tt][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[tt][c] = v;
    }
  }
  if (lane / kThreadsPerRow == 0) {
#pragma unroll
    for (int tt = 0; tt < kTileT; ++tt)
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp][tt][cg * kCols + c] = acc[tt][c];
  }
  __syncthreads();
  const int tt = threadIdx.x / kTileN;
  const int col = threadIdx.x % kTileN;
  float sum = red[0][tt][col];
#pragma unroll
  for (int wi = 1; wi < kWarps; ++wi) sum += red[wi][tt][col];
  return sum;
}

template <typename T>
struct Type {
  using type = T;
};

// Calls launch(Type<X>{}, std::bool_constant<expert>{}) with X the
// activations' type and expert whether the launch has an expert axis
// (e > 1); the dense form is its own instantiation, without the expert
// offsets.
template <typename F>
void dispatch(int x_is_bf16, int e, F&& launch) {
  if (x_is_bf16 && e > 1) {
    launch(Type<__nv_bfloat16>{}, std::true_type{});
  } else if (x_is_bf16) {
    launch(Type<__nv_bfloat16>{}, std::false_type{});
  } else if (e > 1) {
    launch(Type<float>{}, std::true_type{});
  } else {
    launch(Type<float>{}, std::false_type{});
  }
}

}  // namespace quant_matmul
