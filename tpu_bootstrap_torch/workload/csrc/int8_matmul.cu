// Kernel K1: x (T, K) @ int8 q (K, N) * s (N,) -> (T, N) in x's dtype,
// and its expert form K1e: x (E, T, K) @ q (E, K, N) * s (E, 1, N) ->
// (E, T, N), one independent K1 product per expert.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/quant.py
// `_matmul_kernel` (launched by `_quant_matmul`, in its dense form with
// grid (N tiles, K tiles) and its expert form with grid (E, N tiles,
// K tiles)). Same arithmetic: the activations are rounded to bf16 (as the reference casts
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
//   * the CTA layout, activation staging and fixed-order epilogue of
//     quant_matmul.cuh (shared with K6): one CTA per (32-column N tile,
//     8-row T tile), 256 threads, 8 x 8 f32 sums per thread;
//   * each thread loads 8 int8 weights of one K row with one 8-byte load
//     (a row segment of 32 bytes is one full DRAM sector), and issues the
//     8 loads of a 512-row K chunk before it uses any of them;
//   * the reduced sum is scaled once and stored.
//
// Batch invariance: every output's reduction order depends only on K and
// on the fixed tile constants of quant_matmul.cuh, never on T or on which rows share
// the launch, so a row computed in a batch is bitwise the row computed
// alone. There is no split-K. The expert form adds blockIdx.z = expert
// and offsets x, q, s and out by it; each expert's product is the dense
// one, so a MoE token's result does not depend on the other tokens that
// share its expert's slots in the launch.
//
// Ragged edges are masked: T, K and N may be any positive size. The
// 8-byte weight loads are used when N is a multiple of 8 and q is 8-byte
// aligned; otherwise the weights are read byte by byte.

#include "quant_matmul.cuh"

namespace {

using namespace quant_matmul;

constexpr int kRowsPerSlice = kChunkK / kSlices;  // 8 K rows per slice

__device__ __forceinline__ float byte_at(uint32_t word, int i) {
  return (float)(int8_t)((word >> (8 * i)) & 0xffu);
}

template <typename T, bool kExpert>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, T* __restrict__ out,
                   int t_total, int k_total, int n_total, int vec_ok) {
  __shared__ __align__(16) float xs[kChunkK][kTileT];
  __shared__ float red[kWarps][kTileT][kTileN];

  const int lane = threadIdx.x & 31;
  const int slice = (threadIdx.x >> 5) * kRowsPerWarp + lane / kThreadsPerRow;
  const int n0 = blockIdx.x * kTileN + (lane % kThreadsPerRow) * kCols;
  const int t0 = blockIdx.y * kTileT;
  if constexpr (kExpert) {  // this CTA's expert's operands
    const size_t e = blockIdx.z;
    x += e * t_total * k_total;
    q += e * k_total * n_total;
    s += e * n_total;
    out += e * t_total * n_total;
  }

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
    stage_x(xs, x, k0, t0, t_total, k_total);
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

  const float sum = reduce_slices(acc, red);
  const int t = t0 + threadIdx.x / kTileN;
  const int n = blockIdx.x * kTileN + threadIdx.x % kTileN;
  if (t < t_total && n < n_total) {
    store(out + (size_t)t * n_total + n, sum * s[n]);
  }
}

}  // namespace

// Kernel K1 (e = 1: x (T, K), q (K, N), s (N,), out (T, N)) and its expert
// form K1e (x (E, T, K), q (E, K, N), s (E, 1, N), out (E, T, N)).
extern "C" int tpubc_int8_matmul(const void* x, const void* q, const void* s,
                                 void* out, int e, int t, int k, int n,
                                 int x_is_bf16, void* stream) {
  if (e < 1 || t < 1 || k < 1 || n < 1 || e > 65535 ||
      (t + kTileT - 1) / kTileT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n + kTileN - 1) / kTileN, (t + kTileT - 1) / kTileT, e);
  const int vec_ok = (n % 8 == 0) && ((reinterpret_cast<uintptr_t>(q) & 7) == 0);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dispatch(x_is_bf16, e, [&](auto x_type, auto expert) {
    using X = typename decltype(x_type)::type;
    int8_matmul_kernel<X, decltype(expert)::value>
        <<<grid, kThreads, 0, st>>>(
            static_cast<const X*>(x), static_cast<const int8_t*>(q),
            static_cast<const float*>(s), static_cast<X*>(out), t, k, n,
            vec_ok);
  });
  return (int)cudaGetLastError();
}
