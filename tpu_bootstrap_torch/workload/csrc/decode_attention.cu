// Kernel K5: single-query attention over a contiguous int8 KV cache with
// one validity row shared by the batch.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/decode_attention.py
// `_kernel` (launched by `decode_attention_int8`), which `generate` runs on
// every decode step of an int8 KV cache and the speculative draft on each
// of its single-query steps. Same function: q (B, H, D) scaled by D^-0.5
// in f32; K/V caches (B, L, Hk, D) int8 with per-vector f32 scales
// (B, L, Hk), dequantized in registers; position l is attended iff
// valid[l] (a masked position's score is -inf where the reference adds a
// -1e30 bias: both give it weight exactly 0 once any position is valid);
// softmax in f32; out in q's dtype. GQA is native: query head h = kh * g
// + i uses KV head kh.
//
// What bounds it on the H100: latency (a step reads a few MB). The body is
// K2's, shared through decode_attention.cuh: every chunk of the call
// requested at once across one wave of CTAs, per-chunk partials combined in
// chunk order. This file supplies the chunks of a contiguous row: chunk c
// covers positions [c * kChunk, min(L, (c + 1) * kChunk)), so any L >= 1
// works and the last chunk may be partial (the Pallas kernel instead
// needed L to tile by Mosaic's rules), and position l is admitted by the
// shared row valid[l]. A masked position is never read, and a row's result
// is bitwise the same in any batch and under any split.
//
// Limits (mirrored by kernels.decode_plan and decode_attention.supports):
// D a multiple of 16, and the shared-memory layout of
// decode_attention.cuh for chunks of kChunk positions within what a CTA
// may opt into.

#include "decode_attention.cuh"

namespace {

using namespace decode_attention;

constexpr int kChunk = 64;  // positions per chunk (kernels.DECODE_CHUNK)

// A contiguous row: positions [0, len) of the row starting at vector
// index row0 (= b * L), admitted by the shared mask.
struct ContiguousChunks {
  const uint8_t* valid;  // (L,)
  int len;
  size_t row0;
  __device__ int limit() const { return (len + kChunk - 1) / kChunk; }
  __device__ int chunks() const { return limit(); }
  __device__ int count(int c) const { return min(kChunk, len - c * kChunk); }
  __device__ size_t base(int c) const { return row0 + (size_t)c * kChunk; }
  __device__ bool admits(int c, int t) const {
    return __ldg(valid + c * kChunk + t) != 0;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas)
decode_attention_kernel(const Args a, const uint8_t* __restrict__ valid,
                        int len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z;
  const ContiguousChunks src{valid, len, (size_t)b * len};
  attend<T, 0, kChunk>(smem, a, src, b);
}

}  // namespace

extern "C" int tpubc_decode_attention_smem_bytes(int d, int g) {
  return make_layout(kChunk, d, g).total;
}

// ws: the partials, (B, Hk, ceil(L / kChunk), g, D + 2) f32; ranks (the
// cluster) is the split of kernels.decode_plan.
extern "C" int tpubc_decode_attention(const void* q, const void* kq,
                                      const void* ks, const void* vq,
                                      const void* vs, const void* valid,
                                      void* out, void* ws, int b, int len,
                                      int hk, int g, int d, int ranks,
                                      float sm_scale, int q_is_bf16,
                                      void* stream) {
  if (b < 1 || b > 65535 || len < 1 || !split_ok(hk, g, d, kChunk, ranks))
    return (int)cudaErrorInvalidValue;
  const Args a{q, static_cast<const int8_t*>(kq),
               static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
               static_cast<const float*>(vs), out, static_cast<float*>(ws),
               hk, g, d, kChunk, ranks, sm_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* mask = static_cast<const uint8_t*>(valid);
  return (int)(q_is_bf16
                   ? launch<decode_attention_kernel<__nv_bfloat16>>(
                         a, b, st, mask, len)
                   : launch<decode_attention_kernel<float>>(a, b, st, mask,
                                                            len));
}
