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
// Limits (mirrored by decode_attention.paged_supports): D a multiple of
// 16, and the shared-memory layout below within the 48 KB a CTA gets
// without opting in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

struct Layout {
  int q, acc, sc, m, l, alpha, ks, vs, k, v, total;
};

__host__ __device__ inline Layout make_layout(int bs, int d, int g) {
  Layout L;
  int off = 0;
  L.q = off;     off += align16(g * d * 4);
  L.acc = off;   off += align16(g * d * 4);
  L.sc = off;    off += align16(g * bs * 4);
  L.m = off;     off += align16(g * 4);
  L.l = off;     off += align16(g * 4);
  L.alpha = off; off += align16(g * 4);
  L.ks = off;    off += align16(bs * 4);
  L.vs = off;    off += align16(bs * 4);
  L.k = off;     off += align16(bs * (d + 4));  // rows padded: no bank conflicts
  L.v = off;     off += align16(bs * d);
  L.total = off;
  return L;
}

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
  const Layout L = make_layout(bs, d, g);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* s_s = reinterpret_cast<float*>(smem + L.sc);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* a_s = reinterpret_cast<float*>(smem + L.alpha);
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem + L.k);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + L.v);

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = hk * g;
  const int kstride = d + 4;
  const int len = lengths[b];
  int nblocks = len > 0 ? (len + bs - 1) / bs : 0;
  if (nblocks > nb) nblocks = nb;

  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, dd = i % d;
    q_s[i] = to_float(q[((size_t)b * h + kh * g + gi) * d + dd]) * sm_scale;
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int chunks = d / 16;
  for (int j = 0; j < nblocks; ++j) {
    const int p = bt[(size_t)b * nb + j];
    const int nvalid = min(bs, len - j * bs);
    for (int i = tid; i < nvalid * chunks; i += kThreads) {
      const int t = i / chunks, c = i % chunks;
      const size_t row = ((size_t)p * bs + t) * hk + kh;
      const uint4 kv = __ldg(reinterpret_cast<const uint4*>(kq + row * d) + c);
      const uint4 vv = __ldg(reinterpret_cast<const uint4*>(vq + row * d) + c);
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + t * kstride + c * 16);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<uint4*>(v_s + t * d + c * 16) = vv;
    }
    for (int t = tid; t < nvalid; t += kThreads) {
      const size_t row = ((size_t)p * bs + t) * hk + kh;
      ks_s[t] = ks[row];
      vs_s[t] = vs[row];
    }
    __syncthreads();

    // Scores: one (query head, position) pair per thread, D in order.
    for (int i = tid; i < g * nvalid; i += kThreads) {
      const int gi = i / nvalid, t = i % nvalid;
      const float* qq = q_s + gi * d;
      const int8_t* kr = k_s + t * kstride;
      const float sc = ks_s[t];
      float dot = 0.f;
      for (int dd = 0; dd < d; dd += 4) {
        const char4 c4 = *reinterpret_cast<const char4*>(kr + dd);
        dot = fmaf(qq[dd], (float)c4.x * sc, dot);
        dot = fmaf(qq[dd + 1], (float)c4.y * sc, dot);
        dot = fmaf(qq[dd + 2], (float)c4.z * sc, dot);
        dot = fmaf(qq[dd + 3], (float)c4.w * sc, dot);
      }
      s_s[gi * bs + t] = dot;
    }
    __syncthreads();

    // Online-softmax update: one warp per query head, butterfly reductions.
    for (int gi = warp; gi < g; gi += kWarps) {
      float* row = s_s + gi * bs;
      float mx = kNeg;
      for (int t = lane; t < nvalid; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < nvalid; t += 32) {
        const float pr = expf(row[t] - m_new);
        row[t] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v, positions in order.
    for (int i = tid; i < g * d; i += kThreads) {
      const int gi = i / d, dd = i % d;
      const float* pr = s_s + gi * bs;
      float a = 0.f;
      for (int t = 0; t < nvalid; ++t) {
        a = fmaf(pr[t], (float)v_s[t * d + dd] * vs_s[t], a);
      }
      acc_s[i] = acc_s[i] * a_s[gi] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, dd = i % d;
    store(out + ((size_t)b * h + kh * g + gi) * d + dd, acc_s[i] / l_s[gi]);
  }
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
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
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
