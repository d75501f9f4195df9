// Kernel K2: single-query attention over a block-paged int8 KV pool.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/decode_attention.py
// `_paged_kernel` (launched by `paged_decode_attention_int8`). Same
// function: q (B, H, D) scaled by D^-0.5 in f32; K/V pools (N, bs, Hk, D)
// int8 with per-vector f32 scales (N, bs, Hk), dequantized in registers;
// row b attends to its own positions [0, lengths[b]) read through
// block_tables[b, :]; softmax in f32; out in q's dtype. GQA is native:
// query head h = kh * g + i uses KV head kh.
//
// What bounds it on the H100: latency. A decode step reads each row's own
// blocks once (a few MB for a batch), so the design (decode_attention.cuh)
// requests every block of the call at once across one wave of CTAs and
// combines per-block partials in block order. This file supplies the
// chunks of a paged row: chunk c is logical block c, physical block
// block_tables[b, c], holding min(bs, length - c * bs) of the row's
// positions, all of them admitted; the row has min(ceil(length / bs), nb)
// chunks. Positions past the frontier, blocks the row does not own and
// the null block are never read, so their content cannot reach the result,
// and the result is bitwise the same for any table width that covers the
// row, any batch the row is launched in and any split. Tables may alias
// blocks across rows: reads go only through the table.
//
// Limits (mirrored by kernels.paged_plan and decode_attention.
// paged_supports): D a multiple of 16, and the shared-memory
// layout of decode_attention.cuh for chunks of bs positions within what a
// CTA may opt into.

#include "decode_attention.cuh"

namespace {

using namespace decode_attention;

// A paged row: its blocks up to its length, read through its table row.
struct PagedChunks {
  const int* bt;  // the row's table, nb entries
  int nb, bs, len;
  __device__ int limit() const { return nb; }
  __device__ int chunks() const {
    const int n = len > 0 ? (len + bs - 1) / bs : 0;
    return n < nb ? n : nb;
  }
  __device__ int count(int c) const { return min(bs, len - c * bs); }
  __device__ size_t base(int c) const { return (size_t)__ldg(bt + c) * bs; }
  __device__ bool admits(int, int) const { return true; }
};

// kD and kBs, where not 0, are the head dim and block size compiled in.
template <typename T, int kD, int kBs>
__global__ void __launch_bounds__(kThreads, kMinCtas)
paged_attention_kernel(const Args a, const int* __restrict__ bt,
                       const int* __restrict__ lengths, int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z;
  const PagedChunks src{bt + (size_t)b * nb, nb, a.chunk, __ldg(lengths + b)};
  attend<T, kD, kBs>(smem, a, src, b);
}

// The decode model's head dim and the serving engine's block, both 64,
// are compiled in beside the general kernel: the index arithmetic of the
// inner loops folds, about 8% of a launch at the serving shapes (PERF.md).
constexpr int kModelD = 64, kModelBlock = 64;

template <typename T>
cudaError_t run(const Args& a, int b, cudaStream_t st, const int* bt,
                const int* lengths, int nb) {
  if (a.d == kModelD && a.chunk == kModelBlock)
    return launch<paged_attention_kernel<T, kModelD, kModelBlock>>(
        a, b, st, bt, lengths, nb);
  return launch<paged_attention_kernel<T, 0, 0>>(a, b, st, bt, lengths, nb);
}

}  // namespace

extern "C" int tpubc_paged_attention_smem_bytes(int bs, int d, int g) {
  return make_layout(bs, d, g).total;
}

// ws: the partials, (B, Hk, nb, g, D + 2) f32; ranks (the cluster) is the
// split of kernels.paged_plan.
extern "C" int tpubc_paged_attention(const void* q, const void* kq,
                                     const void* ks, const void* vq,
                                     const void* vs, const void* bt,
                                     const void* lengths, void* out,
                                     void* ws, int b, int hk, int g, int d,
                                     int bs, int nb, int ranks,
                                     float sm_scale, int q_is_bf16,
                                     void* stream) {
  if (b < 1 || b > 65535 || nb < 1 || !split_ok(hk, g, d, bs, ranks))
    return (int)cudaErrorInvalidValue;
  const Args a{q, static_cast<const int8_t*>(kq),
               static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
               static_cast<const float*>(vs), out, static_cast<float*>(ws),
               hk, g, d, bs, ranks, sm_scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(bt);
  const int* lens = static_cast<const int*>(lengths);
  return (int)(q_is_bf16 ? run<__nv_bfloat16>(a, b, st, table, lens, nb)
                         : run<float>(a, b, st, table, lens, nb));
}
