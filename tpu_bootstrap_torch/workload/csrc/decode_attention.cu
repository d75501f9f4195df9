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
// online softmax in f32; out = acc / l in q's dtype. GQA is native: query
// head h = kh * g + i uses KV head kh.
//
// What bounds it on the H100: bytes (the cache at 1 byte per element plus
// a scale per vector; ~4 operations per byte). The tile body is K2's,
// shared through decode_attention.cuh: one CTA per (row, KV head) holding
// the whole query group, each cached vector read once with 16-byte loads,
// softmax state in f32 in shared memory, every sum in a fixed order. This
// file supplies how a contiguous row's tiles are found: tile j covers
// positions [j * kTile, min(L, (j + 1) * kTile)) of the row, so any L >= 1
// works and the last tile may be partial (the Pallas kernel instead needed
// L to tile by Mosaic's rules). A masked position is never read.
//
// Limits (mirrored by decode_attention.supports): D a multiple of 16, and
// the shared-memory layout of decode_attention.cuh for a tile of kTile
// positions within the 48 KB a CTA gets without opting in.

#include "decode_attention.cuh"

namespace {

using namespace decode_attention;

constexpr int kTile = 128;  // positions per tile (mirrored in kernels.py)

// A contiguous row: positions [0, len) of the row starting at vector
// index row0 (= b * L), admitted by the shared mask.
struct ContiguousTiles {
  const uint8_t* valid;  // (L,)
  int len;
  size_t row0;
  __device__ int tiles() const { return (len + kTile - 1) / kTile; }
  __device__ int count(int j) const { return min(kTile, len - j * kTile); }
  __device__ size_t base(int j) const { return row0 + (size_t)j * kTile; }
  __device__ bool admits(int j, int t) const {
    return __ldg(valid + j * kTile + t) != 0;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,
                        const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const uint8_t* __restrict__ valid,
                        T* __restrict__ out, int len, int hk, int d, int g,
                        float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const ContiguousTiles src{valid, len, (size_t)b * len};
  attend<T>(smem, q, kq, ks, vq, vs, out, src, kTile, b, blockIdx.y, hk, d,
            g, sm_scale);
}

}  // namespace

extern "C" int tpubc_decode_attention_smem_bytes(int d, int g) {
  return make_layout(kTile, d, g).total;
}

extern "C" int tpubc_decode_attention(const void* q, const void* kq,
                                      const void* ks, const void* vq,
                                      const void* vs, const void* valid,
                                      void* out, int b, int len, int hk,
                                      int g, int d, float sm_scale,
                                      int q_is_bf16, void* stream) {
  if (b < 1 || len < 1 || hk < 1 || g < 1 || d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = make_layout(kTile, d, g).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid(b, hk);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (q_is_bf16) {
    decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
        static_cast<const float*>(vs), static_cast<const uint8_t*>(valid),
        static_cast<__nv_bfloat16*>(out), len, hk, d, g, sm_scale);
  } else {
    decode_attention_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(kq),
        static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
        static_cast<const float*>(vs), static_cast<const uint8_t*>(valid),
        static_cast<float*>(out), len, hk, d, g, sm_scale);
  }
  return (int)cudaGetLastError();
}
