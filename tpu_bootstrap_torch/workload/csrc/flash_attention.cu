// Kernels K3 and K4: flash attention, forward and backward; f32 inputs here,
// bf16 inputs on the tensor cores in csrc/flash_attention_sm90.cu. The C
// entries at the end serve both: they route by dtype, so a bf16 tensor
// never reaches the kernels of this file.
//
// Replaces the Pallas kernels of tpu_bootstrap/workload/flash_attention.py:
//   flash_fwd  <- `_fwd_kernel` (launched by `_fwd`)
//   flash_dq   <- `_dq_kernel`  (launched by `_bwd`)
//   flash_dkv  <- `_dkv_kernel` (launched by `_bwd`), together with the
//                 reference's separate f32 sum of dk/dv over the query group
// Same functions: q (B, S, H, D), k/v (B, S, Hk, D) with H % Hk == 0 (query
// head h reads KV head h / (H / Hk), the contiguous grouping of repeat_kv),
// f32 here. Every operand is f32 and q is scaled by sm_scale in
// f32 before the dot; scores of masked pairs are -1e30; the softmax is online
// in f32. Forward: O = softmax(q k^T) v in q's dtype and LSE = m + log(l),
// (B, S, H) f32. Backward, with delta' = rowsum(dO * O) - dlse given (B, S, H)
// f32: p = exp(s - lse), ds = p * (dO v^T - delta'), dq = ds k * sm_scale,
// dk = ds^T (q * sm_scale), dv = p^T dO, dk and dv summed over the group.
// Masks: causal keeps rows >= cols on global positions, and every column at
// or past the true length S is masked. The kernels read the model layout
// directly (row stride H * D or Hk * D), so no transpose or padding copy is
// made, and only the S real rows of every output are written.
//
// What bounds them on the H100: operations. At the train shapes (S = 1023
// and 8191, D = 64) attention does 2*S*D operations per score for
// 2 * D * (bytes per element) bytes per row, far above the card's ~295
// operations per byte. These kernels compute in f32 on the CUDA cores, as
// the Pallas bodies are written, so their ceiling is the 67 TFLOP/s f32
// rate. What the design does:
//   * tiles of 64 query rows by 64 KV rows, staged in shared memory as f32;
//     each thread owns a 4 x 8 block of the score tile (rows w*16 + rg + 4i,
//     columns cg + 8j) and a 4 x D/8 block of the output (columns
//     cg*4 + 32v + e), so both products read shared memory as 16-byte
//     vectors without bank conflicts and reuse each load 4 to 8 times in
//     registers;
//   * row reductions of the online softmax stay inside one warp (the 8
//     lanes that share rg, three xor shuffles);
//   * the TPU's sequential innermost grid axis, which carried the softmax
//     state and the dq / dk / dv sums in VMEM scratch, becomes a loop inside
//     the CTA; the sums stay in registers. Causal loops stop at the diagonal
//     (forward, dq) or start at it (dkv), as the reference's pl.when skips,
//     and the heaviest tiles are launched first;
//   * dkv: one CTA per (batch, KV head, KV tile) walks every query head of
//     its group and every query tile in a fixed order, so dk and dv come out
//     summed over the group with no per-query-head buffers, no atomics, and
//     bitwise the same on every run.
//
// Limits (mirrored by kernels.FLASH_HEAD_DIMS): D in {32, 64, 128}; the
// shared memory of a CTA above 48 KB is requested with
// cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using namespace tpubc_flash;

constexpr int kThreads = 128;
constexpr int kTile = 64;            // query rows and KV rows of a tile
constexpr int kPStride = kTile + 8;  // row stride of a (64, 64) f32 tile

template <int D>
struct Dims {
  static constexpr int kStride = D + 4;  // row stride of a (64, D) f32 tile
  static constexpr int kTileFloats = kTile * kStride;
  static constexpr int kOut = D / 8;      // output columns a thread owns
  static constexpr int kVec = D / 32;     // float4 groups of them
};

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Thread coordinates inside a (64 x 64) tile: rows row0 + 4i (i < 4),
// score columns cg + 8j (j < 8), output columns cg*4 + 32v + e.
struct Coords {
  int row0, cg;
};

__device__ __forceinline__ Coords coords() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {warp * 16 + (lane >> 3), lane & 7};
}

// Max and sum over the 8 lanes that share a row group.
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// Stage rows [row_begin, row_begin + 64) of one head into a (64, D + 4) f32
// tile, times `scale`; rows at or past `s` are zero. `src` points at row 0
// of the head; rows are `row_stride` elements apart. 16-byte loads.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          size_t row_stride, int row_begin,
                                          int s, float scale) {
  constexpr int kChunks = D / 4;
  constexpr int S = Dims<D>::kStride;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int gr = row_begin + r;
    float* out = dst + r * S + c * 4;
    if (gr >= s) {
      *reinterpret_cast<float4*>(out) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const uint4 raw =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)gr * row_stride) + c);
    const float4 t = *reinterpret_cast<const float4*>(&raw);
    *reinterpret_cast<float4*>(out) =
        make_float4(t.x * scale, t.y * scale, t.z * scale, t.w * scale);
  }
}

// Per-row f32 values (lse or delta') of rows [row_begin, row_begin + 64);
// rows past s read as 0. `src` points at row 0 of the head, `stride` apart.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          size_t stride, int row_begin, int s) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int gr = row_begin + r;
    dst[r] = gr < s ? src[(size_t)gr * stride] : 0.f;
  }
}

// acc[i][j] = X[row0 + 4i, :] . Y[cg + 8j, :] over D, in order of d.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][8], const float* X,
                                         const float* Y, const Coords& t) {
  constexpr int S = Dims<D>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(X + (t.row0 + 4 * i) * S + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[j] = *reinterpret_cast<const float4*>(Y + (t.cg + 8 * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = acc[i][j];
        a = fmaf(x[i].x, y[j].x, a);
        a = fmaf(x[i].y, y[j].y, a);
        a = fmaf(x[i].z, y[j].z, a);
        acc[i][j] = fmaf(x[i].w, y[j].w, a);
      }
  }
}

// o[i][4v + e] += sum_c P[row0 + 4i, c] * Z[c, cg*4 + 32v + e], c in order.
template <int D>
__device__ __forceinline__ void tile_acc(float (&o)[4][Dims<D>::kOut],
                                         const float* P, const float* Z,
                                         const Coords& t) {
  constexpr int S = Dims<D>::kStride;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (t.row0 + 4 * i) * kPStride + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int v = 0; v < Dims<D>::kVec; ++v) {
        const float4 z = *reinterpret_cast<const float4*>(
            Z + (c + cc) * S + t.cg * 4 + 32 * v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = lane_of(p[i], cc);
          o[i][4 * v] = fmaf(pv, z.x, o[i][4 * v]);
          o[i][4 * v + 1] = fmaf(pv, z.y, o[i][4 * v + 1]);
          o[i][4 * v + 2] = fmaf(pv, z.z, o[i][4 * v + 2]);
          o[i][4 * v + 3] = fmaf(pv, z.w, o[i][4 * v + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Rows [row_begin + row0 + 4i] of a (64, D) register block, times `scale`,
// into the model-layout output; rows at or past s are not written.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, size_t row_stride,
                                           int row_begin, int s,
                                           const float (&o)[4][Dims<D>::kOut],
                                           const float (&scale)[4],
                                           const Coords& t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row_begin + t.row0 + 4 * i;
    if (gr >= s) continue;
    float* row = dst + (size_t)gr * row_stride;
#pragma unroll
    for (int v = 0; v < Dims<D>::kVec; ++v)
      store4(row + t.cg * 4 + 32 * v, o[i][4 * v] * scale[i],
             o[i][4 * v + 1] * scale[i], o[i][4 * v + 2] * scale[i],
             o[i][4 * v + 3] * scale[i]);
  }
}

// ------------------------------------------------------------------ forward
// Grid (B * H, number of q tiles); q tile = num_tiles - 1 - blockIdx.y, so
// under causal the longest loops start first.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int s, int h, int hk,
                 float sm_scale, int causal) {
  constexpr int F = Dims<D>::kTileFloats;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + F;
  float* v_s = k_s + F;
  float* p_s = v_s + F;

  const int nt = (s + kTile - 1) / kTile;
  const int qi = nt - 1 - blockIdx.y;
  const Heads g = heads(blockIdx.x / h, blockIdx.x % h, s, h, hk, D);
  const Coords t = coords();
  load_tile<D>(q_s, q + g.q_base, g.q_stride, qi * kTile, s, sm_scale);

  float m[4], l[4], acc[4][Dims<D>::kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Dims<D>::kOut; ++c) acc[i][c] = 0.f;
  }
  const int kv_tiles = causal ? qi + 1 : nt;
  for (int kj = 0; kj < kv_tiles; ++kj) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k_s, k + g.kv_base, g.kv_stride, kj * kTile, s, 1.f);
    load_tile<D>(v_s, v + g.kv_base, g.kv_stride, kj * kTile, s, 1.f);
    __syncthreads();
    float sc[4][8];
    tile_dot<D>(sc, q_s, k_s, t);
    if ((causal && kj == qi) || (kj + 1) * kTile > s) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (masked(qi * kTile + t.row0 + 4 * i, kj * kTile + t.cg + 8 * j, s,
                     causal))
            sc[i][j] = kNeg;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, sc[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(t.row0 + 4 * i) * kPStride + t.cg + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < Dims<D>::kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_acc<D>(acc, p_s, v_s, t);
  }

  // acc / l in f32, as the reference divides before the cast.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Dims<D>::kOut; ++c) acc[i][c] /= l[i];
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(o + g.q_base, g.q_stride, qi * kTile, s, acc, one, t);
  if (t.cg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = qi * kTile + t.row0 + 4 * i;
      if (gr < s) lse[g.lse_base + (size_t)gr * g.lse_stride] = m[i] + logf(l[i]);
    }
  }
}

// ----------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int s, int h, int hk, float sm_scale,
                int causal) {
  constexpr int F = Dims<D>::kTileFloats;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + F;
  float* k_s = do_s + F;
  float* v_s = k_s + F;
  float* ds_s = v_s + F;
  float* lse_s = ds_s + kTile * kPStride;
  float* dl_s = lse_s + kTile;

  const int nt = (s + kTile - 1) / kTile;
  const int qi = nt - 1 - blockIdx.y;
  const Heads g = heads(blockIdx.x / h, blockIdx.x % h, s, h, hk, D);
  const Coords t = coords();
  load_tile<D>(q_s, q + g.q_base, g.q_stride, qi * kTile, s, sm_scale);
  load_tile<D>(do_s, dout + g.q_base, g.q_stride, qi * kTile, s, 1.f);
  load_rows(lse_s, lse + g.lse_base, g.lse_stride, qi * kTile, s);
  load_rows(dl_s, delta + g.lse_base, g.lse_stride, qi * kTile, s);

  float acc[4][Dims<D>::kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Dims<D>::kOut; ++c) acc[i][c] = 0.f;
  const int kv_tiles = causal ? qi + 1 : nt;
  for (int kj = 0; kj < kv_tiles; ++kj) {
    __syncthreads();
    load_tile<D>(k_s, k + g.kv_base, g.kv_stride, kj * kTile, s, 1.f);
    load_tile<D>(v_s, v + g.kv_base, g.kv_stride, kj * kTile, s, 1.f);
    __syncthreads();
    float p[4][8], dp[4][8];
    tile_dot<D>(p, q_s, k_s, t);
    const bool edge = (causal && kj == qi) || (kj + 1) * kTile > s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float row_lse = lse_s[t.row0 + 4 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sc = edge && masked(qi * kTile + t.row0 + 4 * i,
                                        kj * kTile + t.cg + 8 * j, s, causal)
                             ? kNeg : p[i][j];
        p[i][j] = expf(sc - row_lse);
      }
    }
    tile_dot<D>(dp, do_s, v_s, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dl = dl_s[t.row0 + 4 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ds_s[(t.row0 + 4 * i) * kPStride + t.cg + 8 * j] = p[i][j] * (dp[i][j] - dl);
    }
    __syncthreads();
    tile_acc<D>(acc, ds_s, k_s, t);
  }
  const float scale[4] = {sm_scale, sm_scale, sm_scale, sm_scale};
  store_rows<D>(dq + g.q_base, g.q_stride, qi * kTile, s, acc, scale, t);
}

// ---------------------------------------------------------------------- dkv
// Grid (B * Hk, number of KV tiles); KV tile = blockIdx.y, so under causal
// the tiles that see every query tile start first.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int s, int h, int hk,
                 float sm_scale, int causal) {
  constexpr int F = Dims<D>::kTileFloats;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + F;
  float* q_s = v_s + F;
  float* do_s = q_s + F;
  float* p_s = do_s + F;
  float* ds_s = p_s + kTile * kPStride;
  float* lse_s = ds_s + kTile * kPStride;
  float* dl_s = lse_s + kTile;

  const int nt = (s + kTile - 1) / kTile;
  const int kj = blockIdx.y;
  const int b = blockIdx.x / hk, kh = blockIdx.x % hk;
  const int group = h / hk;
  const Coords t = coords();
  const Heads g0 = heads(b, kh * group, s, h, hk, D);
  load_tile<D>(k_s, k + g0.kv_base, g0.kv_stride, kj * kTile, s, 1.f);
  load_tile<D>(v_s, v + g0.kv_base, g0.kv_stride, kj * kTile, s, 1.f);

  float dk_acc[4][Dims<D>::kOut], dv_acc[4][Dims<D>::kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Dims<D>::kOut; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }
  for (int gi = 0; gi < group; ++gi) {
    const Heads g = heads(b, kh * group + gi, s, h, hk, D);
    for (int qi = causal ? kj : 0; qi < nt; ++qi) {
      __syncthreads();
      load_tile<D>(q_s, q + g.q_base, g.q_stride, qi * kTile, s, sm_scale);
      load_tile<D>(do_s, dout + g.q_base, g.q_stride, qi * kTile, s, 1.f);
      load_rows(lse_s, lse + g.lse_base, g.lse_stride, qi * kTile, s);
      load_rows(dl_s, delta + g.lse_base, g.lse_stride, qi * kTile, s);
      __syncthreads();
      // Transposed tile: rows are KV positions, columns query positions.
      float st[4][8];
      tile_dot<D>(st, k_s, q_s, t);
      const bool edge = (causal && qi == kj) || (qi + 1) * kTile > s ||
                        (kj + 1) * kTile > s;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = qi * kTile + t.cg + 8 * j;  // query position
          const int col = kj * kTile + t.row0 + 4 * i;  // KV position
          const bool off = edge && (row >= s || masked(row, col, s, causal));
          const float p = off ? 0.f : expf(st[i][j] - lse_s[t.cg + 8 * j]);
          p_s[(t.row0 + 4 * i) * kPStride + t.cg + 8 * j] = p;
        }
      tile_dot<D>(st, v_s, do_s, t);  // dp^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = (t.row0 + 4 * i) * kPStride + t.cg + 8 * j;
          ds_s[idx] = p_s[idx] * (st[i][j] - dl_s[t.cg + 8 * j]);
        }
      __syncthreads();
      tile_acc<D>(dv_acc, p_s, do_s, t);
      tile_acc<D>(dk_acc, ds_s, q_s, t);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dk + g0.kv_base, g0.kv_stride, kj * kTile, s, dk_acc, one, t);
  store_rows<D>(dv + g0.kv_base, g0.kv_stride, kj * kTile, s, dv_acc, one, t);
}

// ------------------------------------------------------------------ launch

template <int D>
constexpr int fwd_smem() { return (3 * Dims<D>::kTileFloats + kTile * kPStride) * 4; }
template <int D>
constexpr int dq_smem() {
  return (4 * Dims<D>::kTileFloats + kTile * kPStride + 2 * kTile) * 4;
}
template <int D>
constexpr int dkv_smem() {
  return (4 * Dims<D>::kTileFloats + 2 * kTile * kPStride + 2 * kTile) * 4;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

bool bad_dims(int b, int s, int h, int hk) {
  return b < 1 || s < 1 || hk < 1 || h < hk || h % hk != 0 ||
         (long long)b * h > 0x7fffffffLL || (s + kTile - 1) / kTile > 65535;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
        int s, int h, int hk, float sm_scale, int causal, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t e = prepare(kernel, fwd_smem<D>());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * h, (s + kTile - 1) / kTile);
  kernel<<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), s,
      h, hk, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int b, int s, int h,
       int hk, float sm_scale, int causal, cudaStream_t st) {
  auto kernel = flash_dq_kernel<D>;
  cudaError_t e = prepare(kernel, dq_smem<D>());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * h, (s + kTile - 1) / kTile);
  kernel<<<grid, kThreads, dq_smem<D>(), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_out), s, h, hk, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int b, int s,
        int h, int hk, float sm_scale, int causal, cudaStream_t st) {
  auto kernel = flash_dkv_kernel<D>;
  cudaError_t e = prepare(kernel, dkv_smem<D>());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * hk, (s + kTile - 1) / kTile);
  kernel<<<grid, kThreads, dkv_smem<D>(), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), s, h, hk, sm_scale, causal);
  return (int)cudaGetLastError();
}

// Calls fn<D>() for the runtime head dim, or reports an invalid value.
#define TPUBC_FLASH_DISPATCH(FN, ...)                                        \
  do {                                                                        \
    if (d == 32) return FN<32>(__VA_ARGS__);                           \
    if (d == 64) return FN<64>(__VA_ARGS__);                           \
    if (d == 128) return FN<128>(__VA_ARGS__);                         \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)

template <int D>
int smem_bytes(int role) {
  return role == kFwd ? fwd_smem<D>() : role == kDq ? dq_smem<D>()
         : role == kDkv ? dkv_smem<D>() : 0;
}

}  // namespace

// The entries route by dtype: bf16 to the tensor-core kernels of
// csrc/flash_attention_sm90.cu, f32 to the kernels above.

extern "C" int tpubc_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int b, int s, int h, int hk,
                               int d, float sm_scale, int causal, int is_bf16,
                               void* stream) {
  if (bad_dims(b, s, h, hk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tpubc_flash::fwd_sm90(q, k, v, o, lse, b, s, h, hk, d, sm_scale,
                                 causal, st);
  TPUBC_FLASH_DISPATCH(fwd, q, k, v, o, lse, b, s, h, hk, sm_scale, causal, st);
}

extern "C" int tpubc_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq_out, int b, int s,
                              int h, int hk, int d, float sm_scale, int causal,
                              int is_bf16, void* stream) {
  if (bad_dims(b, s, h, hk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tpubc_flash::dq_sm90(q, k, v, dout, lse, delta, dq_out, b, s, h,
                                hk, d, sm_scale, causal, st);
  TPUBC_FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, b, s, h, hk,
                       sm_scale, causal, st);
}

extern "C" int tpubc_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int b,
                               int s, int h, int hk, int d, float sm_scale,
                               int causal, int is_bf16, void* stream) {
  if (bad_dims(b, s, h, hk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tpubc_flash::dkv_sm90(q, k, v, dout, lse, delta, dk, dv, b, s, h,
                                 hk, d, sm_scale, causal, st);
  TPUBC_FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, b, s, h, hk,
                       sm_scale, causal, st);
}

// Dynamic shared memory of a flash kernel (0: fwd, 1: dq, 2: dkv) at head
// dim d for the dtype (kernels.flash_smem_bytes mirrors it); 0 for a head
// dim the kernels do not take.
extern "C" int tpubc_flash_smem_bytes(int role, int d, int is_bf16) {
  if (is_bf16) return tpubc_flash::smem_bytes_sm90(role, d);
  if (d == 32) return smem_bytes<32>(role);
  if (d == 64) return smem_bytes<64>(role);
  if (d == 128) return smem_bytes<128>(role);
  return 0;
}
