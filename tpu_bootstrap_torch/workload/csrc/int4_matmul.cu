// Kernel K6: x (T, K) @ int4 q (Ks/2, N) with group scales s (Ks/g, N)
// -> (T, N) in x's dtype, and its expert form K6e: x (E, T, K) @
// q (E, Ks/2, N), s (E, Ks/g, N) -> (E, T, N), one product per expert.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/quant.py
// `_matmul4_kernel` (launched by `_quant_matmul` with grid (N tiles,
// K tiles), and with grid (E, N tiles, K tiles) for expert stacks). Same
// arithmetic, element for element:
//   * storage is nibble-packed along K: byte (i, n) holds k = 2i in its
//     low nibble and k = 2i + 1 in its high nibble, each as value + 8;
//   * a weight is unpacked by widening the byte to int first,
//     (b & 0xF) - 8 and (b >> 4) - 8, multiplied in f32 by its group's
//     scale s[k / g, n] (g is even, so both nibbles of a byte share it)
//     and rounded to bf16, as the reference scales before its bf16 cast;
//   * the activation is rounded to bf16, the product of two bf16 values
//     is exact in f32, and the products are summed in f32;
//   * no scale is applied after the sum; the output is cast to x's dtype.
// Ks is the stored contraction (whole groups); only the first `kdim`
// rows are real. Rows k >= kdim are masked here, not left to the zero
// padding: their activation is staged as 0 and their weight as 0, so
// they contribute nothing whatever the storage holds.
//
// What bounds it on the H100: bytes. At decode batch (T = 8) a launch
// reads K*N/2 weight bytes plus K/g*N*4 scale bytes and does 2*T*K*N
// operations, about 32 FLOP per weight byte, far under the card's ~295
// FLOP/byte ridge. The layout is K1's, shared through quant_matmul.cuh,
// so the weight is streamed once per 8-row T tile with wide loads, and
// every partial sum stays in registers:
//   * one CTA per (32-column N tile, 8-row T tile[, expert]), 256 threads,
//     8 x 8 f32 sums per thread, the activation chunk (8 rows x 512 K)
//     staged in shared memory and the fixed-order epilogue of
//     quant_matmul.cuh;
//   * each thread loads 8 bytes (16 weights: 2 K rows x 8 columns) of one
//     packed row with one 8-byte load, and issues the 4 loads of a
//     256-packed-row (512 K row) chunk before it uses any of them.
// The group scales are read with scalar loads (they are a sixteenth of
// the weight bytes at g = 64, and L1 serves the rows of one group).
//
// Batch invariance: every output's reduction order depends only on Ks
// and the fixed tile constants, never on T or on which rows share the
// launch; there is no split-K. The expert form adds blockIdx.z = expert.

#include "quant_matmul.cuh"

namespace {

using namespace quant_matmul;

constexpr int kChunkP = kChunkK / 2;                // 256 packed rows
constexpr int kPackedPerSlice = kChunkP / kSlices;  // 4 per slice

template <typename T, bool kExpert>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                   const float* __restrict__ s, T* __restrict__ out,
                   int t_total, int kdim, int p_total, int n_total,
                   int group, int vec_ok) {
  __shared__ __align__(16) float xs[kChunkK][kTileT];
  __shared__ float red[kWarps][kTileT][kTileN];

  const int lane = threadIdx.x & 31;
  const int slice = (threadIdx.x >> 5) * kRowsPerWarp + lane / kThreadsPerRow;
  const int n0 = blockIdx.x * kTileN + (lane % kThreadsPerRow) * kCols;
  const int t0 = blockIdx.y * kTileT;
  if constexpr (kExpert) {  // this CTA's expert's operands
    const size_t e = blockIdx.z;
    x += e * t_total * kdim;
    q += e * p_total * n_total;
    s += e * (2 * p_total / group) * n_total;
    out += e * t_total * n_total;
  }

  float acc[kTileT][kCols];
#pragma unroll
  for (int tt = 0; tt < kTileT; ++tt)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[tt][c] = 0.f;

  for (int p0 = 0; p0 < p_total; p0 += kChunkP) {
    // Weight loads for the whole chunk first: 4 independent 8-byte
    // loads in flight per thread while the activations are staged.
    uint2 w[kPackedPerSlice];
#pragma unroll
    for (int r = 0; r < kPackedPerSlice; ++r) {
      w[r] = load_row8(q, p0 + slice + r * kSlices, n0, p_total, n_total,
                       vec_ok != 0);
    }
    stage_x(xs, x, 2 * p0, t0, t_total, kdim);  // rows past kdim are 0
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPackedPerSlice; ++r) {
      const int pr = slice + r * kSlices;  // packed row within the chunk
      const int p = p0 + pr;
      if (p < p_total) {
        const int k = 2 * p;
        const float* srow = s + (size_t)(k / group) * n_total;
        const float4 xa = *reinterpret_cast<const float4*>(&xs[2 * pr][0]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[2 * pr][4]);
        const float4 ya = *reinterpret_cast<const float4*>(&xs[2 * pr + 1][0]);
        const float4 yb = *reinterpret_cast<const float4*>(&xs[2 * pr + 1][4]);
        const float xlo[kTileT] = {xa.x, xa.y, xa.z, xa.w,
                                   xb.x, xb.y, xb.z, xb.w};
        const float xhi[kTileT] = {ya.x, ya.y, ya.z, ya.w,
                                   yb.x, yb.y, yb.z, yb.w};
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t word = c < 4 ? w[r].x : w[r].y;
          const int b = (int)((word >> (8 * (c & 3))) & 0xffu);
          const float sc = (n0 + c < n_total) ? __ldg(srow + n0 + c) : 0.f;
          // Widen, scale in f32, round to bf16; rows past kdim are 0.
          const float wlo = k < kdim ? round_bf16((float)((b & 0xF) - 8) * sc)
                                     : 0.f;
          const float whi = k + 1 < kdim
                                ? round_bf16((float)((b >> 4) - 8) * sc)
                                : 0.f;
#pragma unroll
          for (int tt = 0; tt < kTileT; ++tt) {
            acc[tt][c] = fmaf(xlo[tt], wlo, acc[tt][c]);
            acc[tt][c] = fmaf(xhi[tt], whi, acc[tt][c]);
          }
        }
      }
    }
    __syncthreads();
  }

  const float sum = reduce_slices(acc, red);
  const int t = t0 + threadIdx.x / kTileN;
  const int n = blockIdx.x * kTileN + threadIdx.x % kTileN;
  if (t < t_total && n < n_total) store(out + (size_t)t * n_total + n, sum);
}

}  // namespace

// Kernel K6 (e = 1: x (T, kdim), q (p, N) uint8 with p = Ks / 2, s
// (Ks / group, N)) and its expert form K6e (x (E, T, kdim), q (E, p, N),
// s (E, Ks / group, N)).
extern "C" int tpubc_int4_matmul(const void* x, const void* q, const void* s,
                                 void* out, int e, int t, int kdim, int p,
                                 int n, int group, int x_is_bf16,
                                 void* stream) {
  if (e < 1 || t < 1 || kdim < 1 || n < 1 || group < 2 || group % 2 != 0 ||
      (2 * p) % group != 0 || kdim > 2 * p || e > 65535 ||
      (t + kTileT - 1) / kTileT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n + kTileN - 1) / kTileN, (t + kTileT - 1) / kTileT, e);
  const int vec_ok = (n % 8 == 0) && ((reinterpret_cast<uintptr_t>(q) & 7) == 0);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dispatch(x_is_bf16, e, [&](auto x_type, auto expert) {
    using X = typename decltype(x_type)::type;
    int4_matmul_kernel<X, decltype(expert)::value>
        <<<grid, kThreads, 0, st>>>(
            static_cast<const X*>(x), static_cast<const uint8_t*>(q),
            static_cast<const float*>(s), static_cast<X*>(out), t, kdim, p,
            n, group, vec_ok);
  });
  return (int)cudaGetLastError();
}
