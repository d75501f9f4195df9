// The single-query attention body shared by the two int8 decode-attention
// kernels: K2 (paged_attention.cu, a block-paged pool read through a block
// table, masked by the row's length) and K5 (decode_attention.cu, a
// contiguous cache masked by one validity row shared by the batch). Only
// how a row's positions are cut into chunks, where a chunk lives and which
// of its positions are attended differ; both are a `Chunks` policy:
//
//   int limit()                 chunks a row may have, known before the
//                               row's own data is read (the workspace's
//                               stride);
//   int chunks()                chunks of this row, in logical order;
//   int count(int c)            positions of chunk c;
//   size_t base(int c)          vector index of chunk c's first position
//                               (times Hk, plus the KV head, is the row of
//                               the (.., Hk, D) K/V arrays and their scales);
//   bool admits(int c, int t)   whether position t of chunk c is attended.
//
// What bounds both on the H100: latency, not bytes. A decode step reads a
// few MB (each cached vector once: K and V at 1 byte per element plus one
// f32 scale), less than the card must keep in flight to reach its memory
// rate, so the goal is one launch, every byte requested at once across
// the grid, one memory round trip, and a short combine:
//   * split over positions: a row's chunks are spread over a cluster of
//     `ranks` CTAs (rank r holds chunks r, r + ranks, ...), a CTA holding
//     one KV head of its chunks with its whole query group, so each cached
//     vector is read once for all g query heads; the grid is (ranks, Hk,
//     B), sized so that the whole call's chunks are in its first wave;
//   * every chunk is staged with 16-byte cp.async copies into a ring of
//     kSlots slots, the next chunk's bytes in flight while one computes; a
//     position the policy does not admit is never read (its staged bytes
//     are zeros and its score is -inf);
//   * each inner loop is split across the threads: each warp owns a
//     quarter of the chunk's positions; lanes share a position's row for
//     the scores (16 bytes a lane, the dot reduced by shuffles), the warp
//     takes its positions' softmax (m_w, l_w) and p . v, and the warps are
//     combined in a fixed order (weights e^(m_w - m_c)); int8 values are
//     widened by a byte permute and a subtraction, exactly;
//   * each chunk yields its own partial (m_c, l_c, acc_c) in f32, never
//     folded into another chunk's; after the cluster's barrier, out =
//     sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M) l_c with M = max_c m_c,
//     both sums in chunk order. The partials go through a workspace in
//     global memory (L2) and the cluster's barrier; a row of one chunk is
//     finished by its CTA from its own shared memory, by the same formula.
// A chunk's partial is computed by the same arithmetic whichever CTA holds
// it, and the combine runs in chunk order, so a row's result depends only
// on its q, its K/V in logical order and which positions are admitted: not
// on B, the table width, physical block ids, `ranks` or the SM count.
// Everything is f32 (q * D^-0.5, dequantization, exp, sums); a chunk with
// no admitted position contributes exactly 0, and a row with none gives
// zeros, as the plain versions do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace decode_attention {

using tpubc_sm90::cp_async16;
using tpubc_sm90::cp_async4;
using tpubc_sm90::smem_addr;

constexpr int kThreads = 128;
// CTAs an SM holds: the register budget (64 a thread) that keeps a
// cluster-of-8 grid over B = 8 rows and 16 KV heads (1,024 CTAs) in one
// wave on 132 SMs.
constexpr int kMinCtas = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 2;     // chunks a CTA has staged or in flight
constexpr int kMaxRanks = 8;  // the portable cluster size
constexpr int kGroup = 8;     // chunks whose partials the combine loads at once
// The dynamic shared memory a CTA may opt into on the H100 (kernels.py
// mirrors the layout and checks the limit).
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

// Shared-memory layout of a CTA: chunks of `chunk` positions, head dim d,
// a query group of g heads. Offsets in bytes; the partial holds a chunk's
// acc and (m, l) per query head (for a row of one chunk), a ring slot K,
// V, their scales and the admitted flags of one chunk.
struct Layout {
  int q, s, red, wm, part, part_bytes, slot, slot_bytes, v, ks, vs, ok,
      total;
};

__host__ __device__ inline Layout make_layout(int chunk, int d, int g) {
  Layout L;
  int off = 0;
  L.q = off;    off += align16(g * d * 4);           // q * D^-0.5, f32
  L.s = off;    off += align16(g * chunk * 4);       // scores, then p * vs
  L.red = off;  off += align16(kWarps * g * d * 4);  // p . v per warp
  L.wm = off;   off += align16(2 * kWarps * g * 4);  // max, sum per warp
  L.part_bytes = align16((g * d + 2 * g) * 4);       // acc, then (m, l)
  L.part = off; off += L.part_bytes;
  L.v = align16(chunk * d);
  L.ks = L.v + align16(chunk * d);
  L.vs = L.ks + align16(chunk * 4);
  L.ok = L.vs + align16(chunk * 4);
  L.slot_bytes = L.ok + align16(chunk);
  L.slot = off; off += kSlots * L.slot_bytes;
  L.total = off;
  return L;
}

// What the C entries check before a launch: the head dim, the split and
// the shared memory it needs.
inline bool split_ok(int hk, int g, int d, int chunk, int ranks) {
  return hk >= 1 && hk <= 65535 && g >= 1 && chunk >= 1 && d >= 16 &&
         d % 16 == 0 && ranks >= 1 && ranks <= kMaxRanks &&
         make_layout(chunk, d, g).total <= kSmemLimit;
}

struct Args {
  const void* q;  // (B, H, D) in T
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  void* out;  // (B, H, D) in T
  // Partials, f32: acc (B, Hk, nc, g, D), then (m, l) (B, Hk, nc, g, 2).
  float* ws;
  int hk, g, d, chunk, ranks;
  float sm_scale;
};

// An int8 b as a float, exactly: b ^ 0x80 (in byte j of w, already
// xor-ed) goes into the mantissa of 2^23 by one byte permute, and one
// subtraction takes the 2^23 + 128 off.
__device__ __forceinline__ float widen(uint32_t w, int j) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | j)) -
         8388736.f;
}

// The 16 int8 values at `p` (16-byte aligned shared memory) as floats.
__device__ __forceinline__ void unpack16(const int8_t* p, float (&f)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = widen(w[j / 4], j % 4);
}

// The two int8 values at `p` (2-byte aligned shared memory) as floats.
__device__ __forceinline__ void unpack2(const int8_t* p, float& v0,
                                        float& v1) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
  v0 = widen(w, 0);
  v1 = widen(w, 1);
}

// dot + sum_j q[j] k[j] over 16 terms, in order; q 16-byte aligned.
__device__ __forceinline__ float dot16(const float* q, const float (&k)[16],
                                       float dot) {
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(q + j);
    dot = fmaf(q4.x, k[j], dot);
    dot = fmaf(q4.y, k[j + 1], dot);
    dot = fmaf(q4.z, k[j + 2], dot);
    dot = fmaf(q4.w, k[j + 3], dot);
  }
  return dot;
}

// out = sum_c w_c acc_c / sum_c w_c l_c, w_c = e^(m_c - M), M = max_c m_c,
// over chunks 0..n-1 in order; get(c, m, l, acc) loads chunk c's partial.
// A chunk with no admitted position (m_c = -inf) has w_c = 0, and a row
// with none gives 0. The first kGroup chunks' loads are all issued before
// any is used.
template <typename Get>
__device__ __forceinline__ float combine(int n, const Get& get) {
  float m[kGroup], l[kGroup], a[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    m[u] = -INFINITY;
    l[u] = a[u] = 0.f;
    if (u < n) get(u, m[u], l[u], a[u]);
  }
  float mx = -INFINITY;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) mx = fmaxf(mx, m[u]);
  for (int c = kGroup; c < n; ++c) {
    float mc, lc, ac;
    get(c, mc, lc, ac);
    mx = fmaxf(mx, mc);
  }
  float lsum = 0.f, acc = 0.f;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (u < n) {
      const float w = m[u] == -INFINITY ? 0.f : expf(m[u] - mx);
      lsum = fmaf(w, l[u], lsum);
      acc = fmaf(w, a[u], acc);
    }
  }
  for (int c = kGroup; c < n; ++c) {
    float mc, lc, ac;
    get(c, mc, lc, ac);
    const float w = mc == -INFINITY ? 0.f : expf(mc - mx);
    lsum = fmaf(w, lc, lsum);
    acc = fmaf(w, ac, acc);
  }
  return lsum > 0.f ? acc / lsum : 0.f;
}

// Attention of row b's query group at KV head blockIdx.y over the chunks
// `src` cuts the row into, this CTA holding rank blockIdx.x's share. Every
// CTA of the cluster calls it; q, kq and vq are 16-byte aligned.
// kD and kChunk, where not 0, are the head dim and the chunk size known at
// compile time (K2's instantiation for the decode model; K5's chunk).
template <typename T, int kD, int kChunk, typename Chunks>
__device__ __forceinline__ void attend(unsigned char* smem, const Args& a,
                                       const Chunks& src, int b) {
  const int rank = blockIdx.x;  // the cluster is the grid's x extent
  const int ranks = a.ranks;
  const int chunk = kChunk > 0 ? kChunk : a.chunk;
  const int d = kD > 0 ? kD : a.d;
  const int g = a.g, hk = a.hk;
  const int kh = blockIdx.y;
  const int outs = g * d;  // the group's outputs, query head i's at i * d
  const Layout L = make_layout(chunk, d, g);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* wm_s = reinterpret_cast<float*>(smem + L.wm);  // warps' maxima
  float* ws_s = wm_s + kWarps * g;                      // warps' sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = src.limit();
  // The first chunks' addresses are requested before the row's own length
  // is known (K2 reads its block table), so their loads overlap.
  size_t first[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = rank + s * ranks;
    first[s] = c < nc ? src.base(c) : 0;
  }
  const int n_chunks = src.chunks();
  if (n_chunks <= 1 && rank > 0) return;  // the row is rank 0's alone
  const int mine =
      n_chunks > rank ? (n_chunks - rank + ranks - 1) / ranks : 0;

  // q's bytes are staged by cp.async into `red` (free until the first
  // p . v) with the first chunk, and scaled to f32 once they land.
  const T* qrow =
      static_cast<const T*>(a.q) + ((size_t)b * hk + kh) * g * d;

  // Stage chunk c, whose first vector is `base`, into ring slot `slot`:
  // first the admitted flags (positions past the chunk's count are never
  // read), then (after a barrier) the copies they allow.
  auto flags = [&](int c, int slot) {
    uint8_t* ok = smem + L.slot + slot * L.slot_bytes + L.ok;
    const int n = src.count(c);
    for (int t = tid; t < n; t += kThreads) ok[t] = src.admits(c, t);
  };
  auto copies = [&](int c, size_t base, int slot) {
    unsigned char* sb = smem + L.slot + slot * L.slot_bytes;
    const uint8_t* ok = sb + L.ok;
    const int n = src.count(c);
    // Piece i is 16 bytes p = i % pieces of position t = i / pieces's row,
    // staged at byte 16 i of the slot's K (and V); a thread's pieces step
    // by kThreads, so (t, p) step by (dt, dp) with a carry.
    const int pieces = d / 16;
    const int dt = kThreads / pieces, dp = kThreads % pieces;
    const uint32_t k_dst = smem_addr(sb), v_dst = smem_addr(sb + L.v);
    const size_t stride = (size_t)hk * d;  // bytes from a position to the next
    int t = tid / pieces, p = tid % pieces;
    for (int i = tid; i < n * pieces; i += kThreads) {
      const bool in = ok[t];
      const size_t at = (base + t) * stride + (size_t)kh * d + p * 16;
      cp_async16(k_dst + 16 * i, in ? a.kq + at : a.kq, in ? 16 : 0);
      cp_async16(v_dst + 16 * i, in ? a.vq + at : a.vq, in ? 16 : 0);
      t += dt;
      p += dp;
      if (p >= pieces) {
        p -= pieces;
        ++t;
      }
    }
    for (int t = tid; t < n; t += kThreads) {
      const bool in = ok[t];
      const size_t at = (base + t) * hk + kh;
      cp_async4(smem_addr(sb + L.ks + t * 4), in ? a.ks + at : a.ks,
                in ? 4 : 0);
      cp_async4(smem_addr(sb + L.vs + t * 4), in ? a.vs + at : a.vs,
                in ? 4 : 0);
    }
  };
  // The first chunks' flags: every load issued before the first store.
  for (int t = tid; t < chunk; t += kThreads) {
    bool in[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = rank + s * ranks;
      in[s] = s < mine && t < src.count(c) && src.admits(c, t);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      smem[L.slot + s * L.slot_bytes + L.ok + t] = in[s];
  }
  __syncthreads();  // the flags
  if (mine > 0) {
    const unsigned char* qb = reinterpret_cast<const unsigned char*>(qrow);
    for (int i = tid; i < outs * (int)sizeof(T) / 16; i += kThreads)
      cp_async16(smem_addr(red) + i * 16, qb + i * 16, 16);
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (s < mine) copies(rank + s * ranks, first[s], s);
    tpubc_sm90::cp_async_commit();
  }

  // The lanes that share a position's row: d / 16 rounded up to a power
  // of two, at most a warp (lanes past d / 16 add zeros; past 32 a lane
  // takes every 32nd 16-byte segment).
  int lanes = 1;
  while (lanes * 16 < d && lanes < 32) lanes *= 2;
  const int per_warp = 32 / lanes;
  const int seg = lane & (lanes - 1);
  const bool one_seg = lanes * 16 >= d;
  // Positions a warp owns, and the lanes that share a softmax row (the
  // warp's positions rounded up to a power of two, at most a warp): both
  // from the chunk size alone, so a chunk's sums run in one order.
  const int per = (chunk + kWarps - 1) / kWarps;
  int row_lanes = 1;
  while (row_lanes < per && row_lanes < 32) row_lanes *= 2;
  const int row_pass = 32 / row_lanes;
  const int row_lane = lane & (row_lanes - 1);
  // Partials of row b at KV head kh, query head i of its group, chunk c:
  // in the workspace, acc at ws[(((b * hk + kh) * nc + c) * g + i) * d +
  // dd]; for a row of one chunk, in the CTA's partial, acc at [i * d + dd]
  // and (m, l) at [outs + 2 i].
  const size_t part0 = ((size_t)b * hk + kh) * nc * g;
  float* ws_ml = a.ws + (size_t)gridDim.z * hk * nc * g * d;

  for (int k = 0; k < mine; ++k) {
    tpubc_sm90::cp_async_wait<kSlots - 1>();
    __syncthreads();  // chunk k has landed for every thread
    if (k == 0) {
      const T* raw = reinterpret_cast<const T*>(red);
      for (int i = tid; i < outs; i += kThreads)
        q_s[i] = to_float(raw[i]) * a.sm_scale;
      __syncthreads();
    }
    const int c = rank + k * ranks, slot = k % kSlots;
    const unsigned char* sb = smem + L.slot + slot * L.slot_bytes;
    const int8_t* k_s = reinterpret_cast<const int8_t*>(sb);
    const int8_t* v_s = reinterpret_cast<const int8_t*>(sb + L.v);
    const float* ks_s = reinterpret_cast<const float*>(sb + L.ks);
    const float* vs_s = reinterpret_cast<const float*>(sb + L.vs);
    const uint8_t* ok = sb + L.ok;
    const int n = src.count(c);
    // Warp w owns the chunk's positions [t0, t1): it scores them, takes
    // their softmax and their part of p . v.
    const int t0 = min(n, warp * per), t1 = min(n, t0 + per);

    // Scores: `lanes` lanes a position, 16 of D at a time, summed by
    // shuffles; then times the position's K scale.
    const int items = t1 - t0;
    for (int i0 = 0; i0 < items; i0 += per_warp) {
      const int it = i0 + lane / lanes;
      const bool live = it < items && seg * 16 < d;
      const int t = t0 + it;
      const int8_t* kr = k_s + t * d;
      float kf[16];
      if (one_seg && live) unpack16(kr + seg * 16, kf);
      for (int i = 0; i < g; ++i) {
        const float* qq = q_s + i * d;
        float dot = 0.f;
        if (one_seg) {
          if (live) dot = dot16(qq + seg * 16, kf, dot);
        } else if (it < items) {
          for (int sg = seg; sg * 16 < d; sg += lanes) {
            unpack16(kr + sg * 16, kf);
            dot = dot16(qq + sg * 16, kf, dot);
          }
        }
        for (int o = lanes / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        if (it < items && seg == 0)
          s_s[i * chunk + t] = ok[t] ? dot * ks_s[t] : -INFINITY;
      }
    }
    __syncwarp();

    // The warp's softmax of each query head over its positions: m_w, p =
    // e^(s - m_w) (0 where not admitted), l_w = sum p, and p * vs in place
    // of the scores; `row_lanes` lanes a head, several heads at once.
    for (int r0 = 0; r0 < g; r0 += row_pass) {
      const int r = r0 + lane / row_lanes;
      float mx = -INFINITY, sum = 0.f;
      if (r < g)
        for (int t = t0 + row_lane; t < t1; t += row_lanes)
          mx = fmaxf(mx, s_s[r * chunk + t]);
      for (int o = row_lanes / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      if (r < g) {
        for (int t = t0 + row_lane; t < t1; t += row_lanes) {
          float* sp = s_s + r * chunk + t;
          const float p = *sp == -INFINITY ? 0.f : expf(*sp - mx);
          sum += p;
          *sp = p * vs_s[t];
        }
      }
      for (int o = row_lanes / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      if (r < g && row_lane == 0) {
        wm_s[warp * g + r] = mx;
        ws_s[warp * g + r] = sum;
      }
    }
    __syncwarp();

    // p . v over the warp's positions, two outputs a lane (unrolled by 2:
    // by 4 the general K2 kernel spills at its 64 registers).
    for (int o = 2 * lane; o < outs; o += 64) {
      const int r = o / d;
      const float* pr = s_s + r * chunk;
      const int8_t* vc = v_s + (o - r * d);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 2
      for (int t = t0; t < t1; ++t) {
        const float p = pr[t];
        float v0, v1;
        unpack2(vc + t * d, v0, v1);
        a0 = fmaf(p, v0, a0);
        a1 = fmaf(p, v1, a1);
      }
      red[warp * outs + o] = a0;
      red[warp * outs + o + 1] = a1;
    }
    __syncthreads();  // every warp's (m_w, l_w) and p . v

    // The chunk's partial: m_c = max_w m_w, and the warps' l_w and p . v
    // weighted by e^(m_w - m_c) (0 for a warp with nothing admitted),
    // summed in warp order; into the workspace, or, for a row of one
    // chunk, the CTA's own partial.
    float* part = reinterpret_cast<float*>(smem + L.part);
    auto weights = [&](int r, float (&e)[kWarps]) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm_s[w * g + r]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float m = wm_s[w * g + r];
        e[w] = m == -INFINITY ? 0.f : expf(m - mx);
      }
      return mx;
    };
    for (int r = tid; r < g; r += kThreads) {
      float e[kWarps];
      const float mx = weights(r, e);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l = fmaf(e[w], ws_s[w * g + r], l);
      if (n_chunks == 1) {
        part[outs + 2 * r] = mx;
        part[outs + 2 * r + 1] = l;
      } else {
        float* at = ws_ml + (part0 + (size_t)c * g + r) * 2;
        __stcg(at, mx);
        __stcg(at + 1, l);
      }
    }
    for (int o = tid; o < outs; o += kThreads) {
      const int r = o / d;
      float e[kWarps];
      weights(r, e);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        acc = fmaf(e[w], red[w * outs + o], acc);
      if (n_chunks == 1)
        part[o] = acc;
      else
        __stcg(a.ws + (part0 + (size_t)c * g) * d + o, acc);
    }
    __syncthreads();  // the slot, scores and sums are free again

    if (k + kSlots < mine) {
      const int cn = rank + (k + kSlots) * ranks;
      flags(cn, slot);
      __syncthreads();
      copies(cn, src.base(cn), slot);
    }
    tpubc_sm90::cp_async_commit();
  }

  T* orow = static_cast<T*>(a.out) + ((size_t)b * hk + kh) * g * d;
  if (n_chunks <= 1) {  // rank 0: the one chunk's partial is on chip
    const float* part = reinterpret_cast<const float*>(smem + L.part);
    for (int o = tid; o < outs; o += kThreads) {
      const int r = o / d;
      store(orow + o, combine(n_chunks, [&](int, float& m, float& l,
                                            float& acc) {
              m = part[outs + 2 * r];
              l = part[outs + 2 * r + 1];
              acc = part[o];
            }));
    }
    return;
  }
  tpubc_sm90::cluster_sync();  // every chunk's partial is in the workspace
  for (int o = rank * kThreads + tid; o < outs; o += ranks * kThreads) {
    const int r = o / d;
    store(orow + o, combine(n_chunks, [&](int c, float& m, float& l,
                                          float& acc) {
            const size_t p = part0 + (size_t)c * g;
            m = __ldcg(ws_ml + 2 * (p + r));
            l = __ldcg(ws_ml + 2 * (p + r) + 1);
            acc = __ldcg(a.ws + p * d + o);
          }));
  }
}

// Launches kKernel on a grid (ranks, Hk, B) in clusters of `ranks`
// CTAs along x, with the shared memory of the split; the first launch of
// each kernel opts it into up to kSmemLimit bytes.
template <auto kKernel, typename... Params>
cudaError_t launch(const Args& a, int b, cudaStream_t st, Params... params) {
  static const cudaError_t prepared = [] {
    cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)  // room for many CTAs on an SM
      err = cudaFuncSetAttribute(
          kKernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (prepared != cudaSuccess) return prepared;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ranks, a.hk, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = make_layout(a.chunk, a.d, a.g).total;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kKernel, a, params...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace decode_attention
