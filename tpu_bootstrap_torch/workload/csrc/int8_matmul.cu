// Kernel K1: x (T, K) @ int8 q (K, N) * s (N,) -> (T, N) in x's dtype.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/quant.py
// `_matmul_kernel` (launched by `_quant_matmul`, dense form). Same
// arithmetic: the activations are rounded to bf16 (as the reference casts
// x to bfloat16 before its dot), the int8 weight is widened exactly, the
// products are summed in f32, and the per-output-channel f32 scale is
// applied once after the sum.
//
// What bounds it on the H100: bytes. At decode batch (T = 8) a launch
// reads K*N weight bytes and does 2*T*K*N operations, about 16 FLOP per
// weight byte, far under the card's ~295 FLOP/byte ridge. So the design
// streams the weight exactly once per T tile of 8 rows, with wide
// coalesced loads and many loads in flight, and keeps every partial sum
// in registers:
//   * one CTA per (32-column N tile, 8-row T tile), 256 threads;
//   * a warp covers 8 consecutive K rows x 32 columns: each thread loads
//     8 int8 weights of one row with one 8-byte load (a row segment of
//     32 bytes is one full DRAM sector), and issues the 8 loads of a
//     512-row K chunk before it uses any of them;
//   * the CTA's activation chunk (8 rows x 512 K) is staged in shared
//     memory, already rounded to bf16 and widened to f32;
//   * each thread keeps 8 x 8 f32 sums; at the end the 64 K slices are
//     reduced in a fixed order (a butterfly inside the warp, then the
//     8 warps in index order), scaled and stored.
//
// Batch invariance: every output's reduction order depends only on K and
// on the fixed tile constants below, never on T or on which rows share
// the launch, so a row computed in a batch is bitwise the row computed
// alone. There is no split-K.
//
// Ragged edges are masked: T, K and N may be any positive size. The
// 8-byte weight loads are used when N is a multiple of 8 and q is 8-byte
// aligned; otherwise the weights are read byte by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                        // columns per thread
constexpr int kTileN = 32;                      // columns per CTA
constexpr int kThreadsPerRow = kTileN / kCols;  // 4
constexpr int kRowsPerWarp = 32 / kThreadsPerRow;  // 8
constexpr int kSlices = kWarps * kRowsPerWarp;  // 64 K slices per CTA
constexpr int kRowsPerSlice = 8;                // K rows per slice per chunk
constexpr int kChunkK = kSlices * kRowsPerSlice;  // 512
constexpr int kTileT = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint2 load_row8(const int8_t* __restrict__ q,
                                           int k, int n0, int k_total,
                                           int n_total, bool vec_ok) {
  uint2 w = make_uint2(0u, 0u);
  if (k >= k_total) return w;
  const int8_t* row = q + (size_t)k * n_total;
  if (vec_ok && n0 + kCols <= n_total) {
    return __ldg(reinterpret_cast<const uint2*>(row + n0));
  }
  int8_t b[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    b[c] = (n0 + c < n_total) ? row[n0 + c] : (int8_t)0;
  }
  w.x = (uint32_t)(uint8_t)b[0] | ((uint32_t)(uint8_t)b[1] << 8) |
        ((uint32_t)(uint8_t)b[2] << 16) | ((uint32_t)(uint8_t)b[3] << 24);
  w.y = (uint32_t)(uint8_t)b[4] | ((uint32_t)(uint8_t)b[5] << 8) |
        ((uint32_t)(uint8_t)b[6] << 16) | ((uint32_t)(uint8_t)b[7] << 24);
  return w;
}

__device__ __forceinline__ float byte_at(uint32_t word, int i) {
  return (float)(int8_t)((word >> (8 * i)) & 0xffu);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, T* __restrict__ out,
                   int t_total, int k_total, int n_total, int vec_ok) {
  __shared__ __align__(16) float xs[kChunkK][kTileT];
  __shared__ float red[kWarps][kTileT][kTileN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = lane % kThreadsPerRow;
  const int kr = lane / kThreadsPerRow;
  const int slice = warp * kRowsPerWarp + kr;
  const int n0 = blockIdx.x * kTileN + cg * kCols;
  const int t0 = blockIdx.y * kTileT;

  float acc[kTileT][kCols];
#pragma unroll
  for (int tt = 0; tt < kTileT; ++tt)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[tt][c] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kChunkK) {
    // Weight loads for the whole chunk first: 8 independent 8-byte
    // loads in flight per thread while the activations are staged.
    uint2 w[kRowsPerSlice];
#pragma unroll
    for (int r = 0; r < kRowsPerSlice; ++r) {
      w[r] = load_row8(q, k0 + slice + r * kSlices, n0, k_total, n_total,
                       vec_ok != 0);
    }
    for (int i = tid; i < kChunkK * kTileT; i += kThreads) {
      const int kk = i % kChunkK;
      const int tt = i / kChunkK;
      const int k = k0 + kk;
      const int t = t0 + tt;
      float v = 0.f;
      if (k < k_total && t < t_total) {
        // Round to bf16 first, as the reference does.
        v = __bfloat162float(
            __float2bfloat16_rn(to_float(x[(size_t)t * k_total + k])));
      }
      xs[kk][tt] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerSlice; ++r) {
      const int kk = slice + r * kSlices;
      const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
      const float xv[kTileT] = {xa.x, xa.y, xa.z, xa.w,
                                xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float wf = byte_at(c < 4 ? w[r].x : w[r].y, c & 3);
#pragma unroll
        for (int tt = 0; tt < kTileT; ++tt) {
          acc[tt][c] = fmaf(xv[tt], wf, acc[tt][c]);
        }
      }
    }
    __syncthreads();
  }

  // Fixed-order reduction of the 64 K slices: butterfly over the 8 rows
  // of a warp, then the warps in index order.
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
  if (kr == 0) {
#pragma unroll
    for (int tt = 0; tt < kTileT; ++tt)
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp][tt][cg * kCols + c] = acc[tt][c];
  }
  __syncthreads();
  const int tt = tid / kTileN;
  const int col = tid % kTileN;
  const int t = t0 + tt;
  const int n = blockIdx.x * kTileN + col;
  if (t < t_total && n < n_total) {
    float sum = red[0][tt][col];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) sum += red[wi][tt][col];
    store(out + (size_t)t * n_total + n, sum * s[n]);
  }
}

static_assert(kTileT * kTileN == kThreads, "one output per thread");

}  // namespace

extern "C" int tpubc_int8_matmul(const void* x, const void* q, const void* s,
                                 void* out, int t, int k, int n,
                                 int x_is_bf16, void* stream) {
  if (t < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileN - 1) / kTileN, (t + kTileT - 1) / kTileT);
  const int vec_ok = (n % 8 == 0) && ((reinterpret_cast<uintptr_t>(q) & 7) == 0);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), t, k,
        n, vec_ok);
  } else {
    int8_matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<float*>(out), t, k, n,
        vec_ok);
  }
  return (int)cudaGetLastError();
}
