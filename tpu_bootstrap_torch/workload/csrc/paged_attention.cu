// Kernel K2: single-query attention over a block-paged int8 KV pool.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/decode_attention.py
// `_paged_kernel` (launched by `paged_decode_attention_int8`). Same
// function: q (B, H, D) scaled by D^-0.5 in f32; K/V pools (N, bs, Hk, D)
// int8 with per-vector f32 scales (N, bs, Hk), dequantized in registers;
// row b attends to its own positions [0, lengths[b]) read through
// block_tables[b, :]; online softmax in f32; out = acc / l in q's dtype.
// GQA is native: query head h = kh * g + i uses KV head kh.
//
// What bounds it on the H100: bytes. A decode step reads each row's own
// blocks once (K and V at 1 byte per element plus one f32 scale per
// vector) and does ~4 operations per byte. The design therefore reads
// exactly those bytes and nothing else:
//   * one CTA per (row, KV head), holding the whole query group of g
//     heads, so each cached vector is read once for all g query heads;
//   * the CTA walks the row's blocks j < ceil(length / bs), loading the
//     table entry itself, and stages only the valid positions of each
//     block (16-byte loads) into shared memory; positions past the
//     frontier, blocks the row does not own and the null block are never
//     read, so their content cannot reach the result;
//   * the softmax state (m, l) and the accumulator stay in f32 in shared
//     memory across blocks; every sum runs in a fixed order.
// The loop ends at the row's length, never at the table width, so the
// result is bitwise the same for any table width that covers the row.
// Tables may alias blocks across rows: reads go only through the table.
//
// The tile body (staging, scores, online softmax, p . v) is shared with
// K5 in decode_attention.cuh; this file supplies how a paged row's tiles
// are found: tile j is physical block block_tables[b, j], holding
// min(bs, length - j * bs) of the row's positions, all of them admitted.
//
// Limits (mirrored by decode_attention.paged_supports): D a multiple of
// 16, and the shared-memory layout of decode_attention.cuh for a tile of
// bs positions within the 48 KB a CTA gets without opting in.

#include "decode_attention.cuh"

namespace {

using namespace decode_attention;

// A paged row: its blocks up to its length, read through its table row.
struct PagedTiles {
  const int* bt;  // the row's table, nb entries
  int nb, bs, len;
  __device__ int tiles() const {
    const int n = len > 0 ? (len + bs - 1) / bs : 0;
    return n < nb ? n : nb;
  }
  __device__ int count(int j) const { return min(bs, len - j * bs); }
  __device__ size_t base(int j) const { return (size_t)bt[j] * bs; }
  __device__ bool admits(int, int) const { return true; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                       const float* __restrict__ ks,
                       const int8_t* __restrict__ vq,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int nb, int bs, int hk, int d, int g, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const PagedTiles src{bt + (size_t)b * nb, nb, bs, lengths[b]};
  attend<T>(smem, q, kq, ks, vq, vs, out, src, bs, b, blockIdx.y, hk, d, g,
            sm_scale);
}

}  // namespace

extern "C" int tpubc_paged_attention_smem_bytes(int bs, int d, int g) {
  return make_layout(bs, d, g).total;
}

extern "C" int tpubc_paged_attention(const void* q, const void* kq,
                                     const void* ks, const void* vq,
                                     const void* vs, const void* bt,
                                     const void* lengths, void* out, int b,
                                     int hk, int g, int d, int bs, int nb,
                                     float sm_scale, int q_is_bf16,
                                     void* stream) {
  if (b < 1 || hk < 1 || g < 1 || bs < 1 || nb < 1 || d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = make_layout(bs, d, g).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid(b, hk);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (q_is_bf16) {
    paged_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
        static_cast<const float*>(vs), static_cast<const int*>(bt),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
        nb, bs, hk, d, g, sm_scale);
  } else {
    paged_attention_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(kq),
        static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
        static_cast<const float*>(vs), static_cast<const int*>(bt),
        static_cast<const int*>(lengths), static_cast<float*>(out), nb, bs,
        hk, d, g, sm_scale);
  }
  return (int)cudaGetLastError();
}
