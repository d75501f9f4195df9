// The single-query attention body shared by the two int8 decode-attention
// kernels: K2 (paged_attention.cu, a block-paged pool read through a block
// table, masked by the row's length) and K5 (decode_attention.cu, a
// contiguous cache masked by one shared validity row). Only how a tile of
// positions is addressed and which positions it admits differ; both are a
// `Tiles` policy:
//
//   int tiles()                 tiles the CTA walks, in order;
//   int count(int j)            positions staged from tile j (<= capacity);
//   size_t base(int j)          vector index of tile j's first position
//                               (times Hk, plus the KV head, is the row of
//                               the (.., Hk, D) K/V arrays and their scales);
//   bool admits(int j, int t)   whether position t of tile j is attended.
//
// What bounds both on the H100: bytes. A decode step reads each cached
// vector once (K and V at 1 byte per element plus one f32 scale per vector)
// and does ~4 operations per byte. The design therefore reads those bytes
// once and keeps everything else on chip:
//   * one CTA per (row, KV head), holding the whole query group of g heads,
//     so each cached vector is read once for all g query heads;
//   * each tile's admitted positions are staged into shared memory with
//     16-byte loads; a position the policy does not admit is never read:
//     its staged K/V row and scales are zeros and its score is -inf, so it
//     adds exactly 0 to every sum and garbage there cannot reach the result;
//   * the softmax state (m, l) and the accumulator stay in f32 in shared
//     memory across tiles; every sum runs in a fixed order, so a row's
//     result does not depend on the batch it is launched in.
// A row that admits no position at all gets zeros (l == 0), as the plain
// versions give.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_attention {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
// The shared memory a CTA gets without opting in; both kernels' layouts
// must fit it (kernels.py mirrors the layout and checks the limit).
constexpr int kSmemLimit = 48 * 1024;

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

// Shared-memory layout for tiles of `tile` positions, head dim d and a
// query group of g heads.
__host__ __device__ inline Layout make_layout(int tile, int d, int g) {
  Layout L;
  int off = 0;
  L.q = off;     off += align16(g * d * 4);
  L.acc = off;   off += align16(g * d * 4);
  L.sc = off;    off += align16(g * tile * 4);
  L.m = off;     off += align16(g * 4);
  L.l = off;     off += align16(g * 4);
  L.alpha = off; off += align16(g * 4);
  L.ks = off;    off += align16(tile * 4);
  L.vs = off;    off += align16(tile * 4);
  L.k = off;     off += align16(tile * (d + 4));  // rows padded: no bank conflicts
  L.v = off;     off += align16(tile * d);
  L.total = off;
  return L;
}

// Attention of row b's query group at KV head kh over the positions `src`
// walks. q (B, H, D) and out (B, H, D) in T; kq/vq int8 and ks/vs f32 with
// the row layout `src.base` indexes. d is a multiple of 16.
template <typename T, typename Tiles>
__device__ __forceinline__ void attend(
    unsigned char* smem, const T* __restrict__ q,
    const int8_t* __restrict__ kq, const float* __restrict__ ks,
    const int8_t* __restrict__ vq, const float* __restrict__ vs,
    T* __restrict__ out, const Tiles& src, int tile, int b, int kh, int hk,
    int d, int g, float sm_scale) {
  const Layout L = make_layout(tile, d, g);
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

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = hk * g;
  const int kstride = d + 4;

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
  const int ntiles = src.tiles();
  for (int j = 0; j < ntiles; ++j) {
    const size_t base = src.base(j);
    const int n = src.count(j);
    for (int i = tid; i < n * chunks; i += kThreads) {
      const int t = i / chunks, c = i % chunks;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (src.admits(j, t)) {
        const size_t row = (base + t) * hk + kh;
        kv = __ldg(reinterpret_cast<const uint4*>(kq + row * d) + c);
        vv = __ldg(reinterpret_cast<const uint4*>(vq + row * d) + c);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + t * kstride + c * 16);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<uint4*>(v_s + t * d + c * 16) = vv;
    }
    for (int t = tid; t < n; t += kThreads) {
      const bool ok = src.admits(j, t);
      const size_t row = (base + t) * hk + kh;
      ks_s[t] = ok ? ks[row] : 0.f;
      vs_s[t] = ok ? vs[row] : 0.f;
    }
    __syncthreads();

    // Scores: one (query head, position) pair per thread, D in order.
    for (int i = tid; i < g * n; i += kThreads) {
      const int gi = i / n, t = i % n;
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
      s_s[gi * tile + t] = src.admits(j, t) ? dot : -INFINITY;
    }
    __syncthreads();

    // Online-softmax update: one warp per query head, butterfly reductions.
    for (int gi = warp; gi < g; gi += kWarps) {
      float* row = s_s + gi * tile;
      float mx = kNeg;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
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
      const float* pr = s_s + gi * tile;
      float a = 0.f;
      for (int t = 0; t < n; ++t) {
        a = fmaf(pr[t], (float)v_s[t * d + dd] * vs_s[t], a);
      }
      acc_s[i] = acc_s[i] * a_s[gi] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, dd = i % d;
    const float l = l_s[gi];
    store(out + ((size_t)b * h + kh * g + gi) * d + dd,
          l > 0.f ? acc_s[i] / l : 0.f);
  }
}

}  // namespace decode_attention
