// Kernels K3 and K4 for bf16 inputs, on Hopper's tensor cores (sm_90a).
//
// Replace, for bf16, the Pallas kernels of
// tpu_bootstrap/workload/flash_attention.py:
//   flash_fwd_sm90_kernel  <- `_fwd_kernel` (:110, launched by `_fwd`)
//   flash_dq_sm90_kernel   <- `_dq_kernel`  (:233, launched by `_bwd`)
//   flash_dkv_sm90_kernel  <- `_dkv_kernel` (:267, launched by `_bwd`),
//                             with the reference's f32 sum of dk and dv over
//                             the query group (:379-389)
// The functions are those of the f32 kernels in csrc/flash_attention.cu
// (see there), with the one rounding the tensor cores bring: the
// probabilities P and the score gradients dS are rounded to bf16 before
// they enter the second products (P V, P^T dO, dS^T Q, dS K), a relative
// error of at most 2^-9 a term. Every sum is f32. The scores are f32 sums of
// exact products of the bf16 inputs, scaled by sm_scale afterwards in f32
// (the reference scales q in f32 first: the two agree to f32 rounding,
// where rounding a scaled q to bf16 would not for D = 32 or 128).
//
// What bounds them on the H100: operations, or nearly. The forward at the
// train shape (B = 8, S = 1023, H = 16, D = 64, causal) does 17 GFLOP and
// moves 67 MB, 0.017 ms at bf16 wgmma's 989 TFLOP/s against 0.020 ms at
// 3.35 TB/s: it sits at the ridge. At S = 8191, and in the backward (seven
// products), the operations bound it several times over. What the design
// does:
//   * every product is a wgmma (m64nNk16, f32 accumulators in registers).
//     A CTA has two consumer warpgroups, each owning 64 rows of the CTA's
//     tile (query rows for the forward and dq, KV rows for dkv), and one
//     producer warp. At D <= 64 the forward (64 KV rows a step) and dq (32,
//     as it holds two score tiles) keep two CTAs on an SM, which caps a
//     thread at 96 registers; the four warpgroups an SM then gets ran
//     faster on an H100 than one CTA with 168 registers and wider steps.
//     dkv holds dk and dv for its 64 rows, so it keeps one CTA;
//   * no operand is transposed in memory. The score products read both
//     operands K-major as the model layout stores them: S = Q K^T (forward,
//     dq), dP = dO V^T (dq), and in dkv the transposed formulation
//     S^T = K Q^T, dP^T = V dO^T. The second products read V, K, dO and Q
//     from the same tiles as MN-major (transposed) B operands;
//   * P and dS never touch shared memory: the f32 accumulator layout of a
//     product is the register layout of the next one's A operand, so they
//     are converted to bf16 pairs in place (the FlashAttention-3 layout);
//   * one thread of the producer warp streams the inner loop's tiles (K and
//     V; Q and dO for dkv) by TMA: box loads through tensor maps over the
//     model layout (B, S, heads, D), into a two-stage ring of swizzled
//     shared-memory tiles, rows past S zero-filled. Each stage is handed
//     over through mbarriers (full: the loads' bytes landed; empty: every
//     consumer read it), so the producer keeps the next steps in flight
//     while the consumers compute. dkv's per-column lse and delta' rows
//     come by cp.async from the warp's 32 lanes, counted on the same
//     full barrier;
//   * fixed order, no atomics: dkv's CTA walks every query head of its
//     group and every query tile in order, so dk and dv are summed over
//     the group in registers and come out bitwise the same on every run.
//     Causal loops stop at the diagonal (forward, dq) or start at it (dkv),
//     a warpgroup skips a step that is masked for all its rows, and the
//     heaviest tiles launch first.
// Masks, as in the f32 kernels: -1e30 for the scores of masked pairs in
// the forward, P = 0 at masked pairs and at query rows past S in the
// backward; a zero-filled K row scores 0, not -inf, so columns past S are
// masked explicitly.
//
// Limits (mirrored by kernels.FLASH_HEAD_DIMS and kernels.flash_tiles): D in
// {32, 64, 128}; shared memory above 48 KB is requested with
// cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace tpubc_flash {
namespace {

using namespace tpubc_sm90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;  // depth of the ring
constexpr int kWG = 128;    // threads of a warpgroup
constexpr int kConsumers = 2;
constexpr int kThreads = kWG * kConsumers + 32;  // + the producer warp
constexpr int kRows = 64 * kConsumers;           // rows a CTA owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A (rows x D) bf16 tile in shared memory: D / kCols column blocks of rows
// of kW bytes, each block swizzled (sm90.cuh).
template <int D>
struct Tile {
  static constexpr int kW = D >= 64 ? 128 : 64;  // bytes of a block's row
  static constexpr int kCols = kW / 2;           // columns of a block
  static constexpr int kBlocks = D / kCols;      // 1, or 2 for D = 128
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * D * 2;
  }
};

// Descriptor of a K-major operand: rows [row0, row0 + 64 or N) of a tile of
// `rows` rows, columns [16kk, 16kk + 16). Inside a block the 16 columns
// are 32 bytes of the row: the start moves by 32 bytes a step and the
// swizzle, keyed on address bits, follows. Leading offset unused (16);
// stride offset: one 8-row atom.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  constexpr int W = Tile<D>::kW;
  const int byte = kk * 32;
  return make_desc<W>(tile + (byte / W) * rows * W + row0 * W + byte % W, 16,
                      8 * W);
}

// Descriptor of an MN-major B operand: column block nb of a tile of `rows`
// rows, its rows [16kk, 16kk + 16) as the reduction. Leading offset: the
// next column block (unused: an operand is one block wide); stride offset:
// the next 8 rows.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int nb,
                                            int kk) {
  constexpr int W = Tile<D>::kW;
  return make_desc<W>(tile + nb * rows * W + kk * 16 * W, rows * W, 8 * W);
}

// Rows [row0, row0 + rows) of head `head` of batch `b` into a tile of
// `rows` rows, by TMA: one box a column block. Rows at or past S arrive as
// zeros. The box bytes count against `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int rows, int head,
                                          int row0, int b) {
#pragma unroll
  for (int nb = 0; nb < Tile<D>::kBlocks; ++nb)
    tma_load_4d(tile + nb * rows * Tile<D>::kW, map, bar,
                nb * Tile<D>::kCols, head, row0, b);
}

// Per-row f32 values (lse or delta') of rows [row0, row0 + rows); rows past
// s read 0.
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const float* __restrict__ src,
                                          size_t stride, int row0, int rows,
                                          int s, int lane) {
  for (int r = lane; r < rows; r += 32) {
    const int gr = row0 + r;
    const bool in = gr < s;
    cp_async4(dst + 4 * r, src + (size_t)(in ? gr : 0) * stride, in ? 4 : 0);
  }
}

// This thread's place in an accumulator fragment: element i lies in row
// `row` + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + `col` + (i & 1).
struct Frag {
  int row, col;
};

__device__ __forceinline__ Frag frag() {
  const int t = threadIdx.x % kWG;
  return {(t / 32) * 16 + (t % 32) / 4, 2 * (t % 4)};
}

__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(const Frag& f, int i) {
  return 8 * (i >> 2) + f.col + (i & 1);
}

// Max and sum over the 4 lanes that hold one row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A (64 x N) f32 accumulator as the bf16 A operands of N / 16 products.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// A (64 x D) accumulator, held as column blocks.
template <int D>
using Acc = float[Tile<D>::kBlocks][Tile<D>::kCols / 2];

template <int D>
__device__ __forceinline__ void zero(Acc<D>& acc) {
#pragma unroll
  for (int nb = 0; nb < Tile<D>::kBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < Tile<D>::kCols / 2; ++i) acc[nb][i] = 0.f;
}

// acc += A (64 x N, registers) B, B column block by block from an
// MN-major tile of N rows.
template <int D, int N>
__device__ __forceinline__ void acc_product(Acc<D>& acc,
                                            const uint32_t (&a)[N / 16][4],
                                            uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < Tile<D>::kBlocks; ++nb)
      wgmma_rs<Tile<D>::kCols>(acc[nb], a[kk], mnmajor<D>(tile, N, nb, kk), 1);
}

// d = A B^T over D, A rows [row0, row0 + 64) of a tile of `a_rows` rows, B
// a tile of N rows; both K-major.
template <int D, int N>
__device__ __forceinline__ void score_product(float (&d)[N / 2], uint32_t a,
                                              int a_rows, int row0,
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(d, kmajor<D>(a, a_rows, row0, kk), kmajor<D>(b, N, 0, kk),
                kk);
}

template <int D>
__device__ __forceinline__ void fence_acc(Acc<D>& acc) {
#pragma unroll
  for (int nb = 0; nb < Tile<D>::kBlocks; ++nb) fence_regs(acc[nb]);
}

// Rows row0 + (this thread's fragment rows) of a (64 x D) accumulator,
// times `scale`, as bf16 into the model layout; rows at or past s are not
// written.
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst,
                                          size_t stride, int row0, int s,
                                          const Acc<D>& acc, float scale) {
  const Frag f = frag();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = row0 + f.row + 8 * hh;
    if (gr >= s) continue;
    bf16* row = dst + (size_t)gr * stride;
#pragma unroll
    for (int nb = 0; nb < Tile<D>::kBlocks; ++nb)
#pragma unroll
      for (int i = 2 * hh; i < Tile<D>::kCols / 2; i += 4)
        *reinterpret_cast<uint32_t*>(row + nb * Tile<D>::kCols +
                                     frag_col(f, i)) =
            pack_bf16(acc[nb][i] * scale, acc[nb][i + 1] * scale);
  }
}

// The 1024-byte aligned start of the dynamic shared memory (the kernels
// ask for 1024 bytes more than their layout).
__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Barriers: [0] the CTA's own tiles landed, [1, 1 + kStages) a stage
// landed (the TMA thread's arrival and its bytes, plus `row_lanes`
// cp.async arrivals for dkv's rows), [1 + kStages, 1 + 2 kStages) a stage
// was read by every consumer thread.
constexpr int kBarBytes = 8 * (1 + 2 * kStages);

__device__ __forceinline__ void init_barriers(uint64_t* bar, int row_lanes) {
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bar[1 + i], 1 + row_lanes);
      mbar_init(&bar[1 + kStages + i], kWG * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// Step n of the inner loop uses stage n % kStages; its round is
// n / kStages.
__device__ __forceinline__ void producer_acquire(uint64_t* bar, int n) {
  if (n >= kStages)
    mbar_wait(&bar[1 + kStages + n % kStages], (n / kStages - 1) & 1);
}

__device__ __forceinline__ void consumer_acquire(uint64_t* bar, int n) {
  mbar_wait(&bar[1 + n % kStages], (n / kStages) & 1);
}

__device__ __forceinline__ void consumer_release(uint64_t* bar, int n) {
  mbar_arrive(&bar[1 + kStages + n % kStages]);
}

// ------------------------------------------------------------------ forward

template <int D>
struct FwdLayout {
  static constexpr int kCols = 64;  // KV rows a step
  static constexpr int kCtas = D == 128 ? 1 : 2;  // resident on an SM
  static constexpr int kRing = Tile<D>::bytes(kRows);  // after Q
  static constexpr int kStage = 2 * Tile<D>::bytes(kCols);  // K, V
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kSmem = kBars + kBarBytes + 1024;
};

// Grid (B * H, number of 128-row query tiles); query tile = last -
// blockIdx.y, so under causal the longest loops start first.
template <int D>
__global__ void __launch_bounds__(kThreads, FwdLayout<D>::kCtas)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      bf16* __restrict__ o, float* __restrict__ lse, int s,
                      int h, int hk, float sm_scale, int causal) {
  using L = FwdLayout<D>;
  constexpr int N = L::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t q_s = smem_addr(smem), ring = q_s + L::kRing;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int q0 = ((s + kRows - 1) / kRows - 1 - blockIdx.y) * kRows;
  const Heads g = heads(blockIdx.x / h, blockIdx.x % h, s, h, hk, D);
  const int steps = ((causal ? min(q0 + kRows, s) : s) + N - 1) / N;
  init_barriers(bar, 0);

  const int wg = threadIdx.x / kWG;
  if (wg == kConsumers) {  // the producer warp: one thread issues the loads
    if (threadIdx.x % 32 == 0) {
      mbar_arrive_expect_tx(&bar[0], Tile<D>::bytes(kRows));
      load_tile<D>(q_s, &q_map, &bar[0], kRows, g.hq, q0, g.b);
      for (int n = 0; n < steps; ++n) {
        producer_acquire(bar, n);
        uint64_t* full = &bar[1 + n % kStages];
        const uint32_t kt = ring + (n % kStages) * L::kStage;
        mbar_arrive_expect_tx(full, 2 * Tile<D>::bytes(N));
        load_tile<D>(kt, &k_map, full, N, g.kh, n * N, g.b);
        load_tile<D>(kt + Tile<D>::bytes(N), &v_map, full, N, g.kh, n * N,
                     g.b);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows [r0, r0 + 64).
  const Frag f = frag();
  const int r0 = q0 + 64 * wg;
  const float c = sm_scale * kLog2e;  // scores in log2 units
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  Acc<D> acc;
  zero<D>(acc);
  mbar_wait(&bar[0], 0);
  for (int n = 0; n < steps; ++n) {
    consumer_acquire(bar, n);
    const int c0 = n * N;
    if (causal && c0 > r0 + 63) {  // every pair masked for these rows
      consumer_release(bar, n);
      continue;
    }
    const uint32_t kt = ring + (n % kStages) * L::kStage;
    float sc[N / 2];
    wgmma_fence();
    score_product<D, N>(sc, q_s, kRows, 64 * wg, kt);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // The row max is taken on the raw scores and scaled once (c > 0), so
    // each probability is one FFMA and one exp2.
    const bool edge = (causal && c0 + N - 1 > r0) || c0 + N > s;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (edge && masked(r0 + f.row + 8 * frag_half(i), c0 + frag_col(f, i),
                         s, causal))
        sc[i] = kNeg;
      mx[frag_half(i)] = fmaxf(mx[frag_half(i)], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]) * c);
      alpha[hh] = exp2_approx(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];  // this thread's share of the row sum
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      sc[i] = exp2_approx(fmaf(sc[i], c, -m[frag_half(i)]));
      l[frag_half(i)] += sc[i];
    }
#pragma unroll
    for (int nb = 0; nb < Tile<D>::kBlocks; ++nb)
#pragma unroll
      for (int i = 0; i < Tile<D>::kCols / 2; ++i)
        acc[nb][i] *= alpha[frag_half(i)];
    uint32_t p[N / 16][4];
    to_a<N>(p, sc);
    wgmma_fence();
    acc_product<D, N>(acc, p, kt + Tile<D>::bytes(N));
    wgmma_commit();
    wgmma_wait();
    fence_acc<D>(acc);
    consumer_release(bar, n);
  }

  // acc / l in f32, as the reference divides before the cast.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
#pragma unroll
  for (int nb = 0; nb < Tile<D>::kBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < Tile<D>::kCols / 2; ++i) acc[nb][i] /= l[frag_half(i)];
  store_acc<D>(o + g.q_base, g.q_stride, r0, s, acc, 1.f);
  if (f.col == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = r0 + f.row + 8 * hh;
      if (gr < s)
        lse[g.lse_base + (size_t)gr * g.lse_stride] =
            m[hh] * kLn2 + logf(l[hh]);
    }
  }
}

// ----------------------------------------------------------------------- dq

template <int D>
struct DqLayout {
  static constexpr int kCols = D == 128 ? 64 : 32;  // KV rows a step
  static constexpr int kCtas = D == 128 ? 1 : 2;
  static constexpr int kDo = Tile<D>::bytes(kRows);  // after Q
  static constexpr int kRing = 2 * Tile<D>::bytes(kRows);
  static constexpr int kStage = 2 * Tile<D>::bytes(kCols);  // K, V
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kSmem = kBars + kBarBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, DqLayout<D>::kCtas)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int s, int h, int hk, float sm_scale, int causal) {
  using L = DqLayout<D>;
  constexpr int N = L::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t q_s = smem_addr(smem), do_s = q_s + L::kDo;
  const uint32_t ring = q_s + L::kRing;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int q0 = ((s + kRows - 1) / kRows - 1 - blockIdx.y) * kRows;
  const Heads g = heads(blockIdx.x / h, blockIdx.x % h, s, h, hk, D);
  const int steps = ((causal ? min(q0 + kRows, s) : s) + N - 1) / N;
  init_barriers(bar, 0);

  const int wg = threadIdx.x / kWG;
  if (wg == kConsumers) {  // the producer warp: one thread issues the loads
    if (threadIdx.x % 32 == 0) {
      mbar_arrive_expect_tx(&bar[0], 2 * Tile<D>::bytes(kRows));
      load_tile<D>(q_s, &q_map, &bar[0], kRows, g.hq, q0, g.b);
      load_tile<D>(do_s, &do_map, &bar[0], kRows, g.hq, q0, g.b);
      for (int n = 0; n < steps; ++n) {
        producer_acquire(bar, n);
        uint64_t* full = &bar[1 + n % kStages];
        const uint32_t kt = ring + (n % kStages) * L::kStage;
        mbar_arrive_expect_tx(full, 2 * Tile<D>::bytes(N));
        load_tile<D>(kt, &k_map, full, N, g.kh, n * N, g.b);
        load_tile<D>(kt + Tile<D>::bytes(N), &v_map, full, N, g.kh, n * N,
                     g.b);
      }
    }
    return;
  }

  const Frag f = frag();
  const int r0 = q0 + 64 * wg;
  const float c = sm_scale * kLog2e;
  float row_lse[2], row_dl[2];  // lse in log2 units, delta'
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = r0 + f.row + 8 * hh;
    const size_t at = g.lse_base + (size_t)gr * g.lse_stride;
    row_lse[hh] = gr < s ? lse[at] * kLog2e : 0.f;
    row_dl[hh] = gr < s ? delta[at] : 0.f;
  }
  Acc<D> acc;
  zero<D>(acc);
  mbar_wait(&bar[0], 0);
  for (int n = 0; n < steps; ++n) {
    consumer_acquire(bar, n);
    const int c0 = n * N;
    if (causal && c0 > r0 + 63) {
      consumer_release(bar, n);
      continue;
    }
    const uint32_t kt = ring + (n % kStages) * L::kStage;
    float sc[N / 2], dp[N / 2];
    wgmma_fence();
    score_product<D, N>(sc, q_s, kRows, 64 * wg, kt);
    score_product<D, N>(dp, do_s, kRows, 64 * wg, kt + Tile<D>::bytes(N));
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = (causal && c0 + N - 1 > r0) || c0 + N > s;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int hh = frag_half(i);
      const float p =
          edge && masked(r0 + f.row + 8 * hh, c0 + frag_col(f, i), s, causal)
              ? 0.f
              : exp2_approx(fmaf(sc[i], c, -row_lse[hh]));
      sc[i] = p * (dp[i] - row_dl[hh]);  // dS
    }
    uint32_t ds[N / 16][4];
    to_a<N>(ds, sc);
    wgmma_fence();
    acc_product<D, N>(acc, ds, kt);
    wgmma_commit();
    wgmma_wait();
    fence_acc<D>(acc);
    consumer_release(bar, n);
  }
  store_acc<D>(dq + g.q_base, g.q_stride, r0, s, acc, sm_scale);
}

// ---------------------------------------------------------------------- dkv

template <int D>
struct DkvLayout {
  static constexpr int kCols = D == 128 ? 32 : 64;  // query rows a step
  static constexpr int kCtas = 1;
  static constexpr int kV = Tile<D>::bytes(kRows);  // after K
  static constexpr int kRing = 2 * Tile<D>::bytes(kRows);
  static constexpr int kStage = 2 * Tile<D>::bytes(kCols);  // Q, dO
  static constexpr int kRowVals = kRing + kStages * kStage;  // lse, delta'
  static constexpr int kBars = kRowVals + kStages * 2 * kCols * 4;
  static constexpr int kSmem = kBars + kBarBytes + 1024;
};

// Grid (B * Hk, number of 128-row KV tiles); KV tile = blockIdx.y, so under
// causal the tiles that see every query tile start first.
template <int D>
__global__ void __launch_bounds__(kThreads, DkvLayout<D>::kCtas)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int s, int h, int hk,
                      float sm_scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int N = L::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t k_s = smem_addr(smem), v_s = k_s + L::kV;
  const uint32_t ring = k_s + L::kRing, row_vals = k_s + L::kRowVals;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int k0 = blockIdx.y * kRows;
  const int b = blockIdx.x / hk, kh = blockIdx.x % hk, group = h / hk;
  const Heads g0 = heads(b, kh * group, s, h, hk, D);
  const int first = causal ? k0 / N : 0;  // query tiles before it are masked
  const int per_head = (s + N - 1) / N - first;
  const int steps = group * per_head;
  init_barriers(bar, 32);

  const int wg = threadIdx.x / kWG;
  if (wg == kConsumers) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar[0], 2 * Tile<D>::bytes(kRows));
      load_tile<D>(k_s, &k_map, &bar[0], kRows, kh, k0, b);
      load_tile<D>(v_s, &v_map, &bar[0], kRows, kh, k0, b);
    }
    for (int n = 0; n < steps; ++n) {
      producer_acquire(bar, n);
      const Heads g = heads(b, kh * group + n / per_head, s, h, hk, D);
      const int c0 = (first + n % per_head) * N;
      const int st = n % kStages;
      uint64_t* full = &bar[1 + st];
      if (lane == 0) {
        const uint32_t qt = ring + st * L::kStage;
        mbar_arrive_expect_tx(full, 2 * Tile<D>::bytes(N));
        load_tile<D>(qt, &q_map, full, N, g.hq, c0, b);
        load_tile<D>(qt + Tile<D>::bytes(N), &do_map, full, N, g.hq, c0, b);
      }
      const uint32_t rows = row_vals + st * 2 * N * 4;
      load_rows(rows, lse + g.lse_base, g.lse_stride, c0, N, s, lane);
      load_rows(rows + N * 4, delta + g.lse_base, g.lse_stride, c0, N, s,
                lane);
      cp_async_arrive(full);
    }
    return;
  }

  // Consumer warpgroup wg: KV rows [r0, r0 + 64). Transposed tiles: rows
  // are KV positions, columns query positions.
  const Frag f = frag();
  const int r0 = k0 + 64 * wg;
  const float c = sm_scale * kLog2e;
  const float* vals = reinterpret_cast<const float*>(smem + L::kRowVals);
  Acc<D> dk_acc, dv_acc;
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  mbar_wait(&bar[0], 0);
  for (int n = 0; n < steps; ++n) {
    consumer_acquire(bar, n);
    const int c0 = (first + n % per_head) * N;
    if ((causal && c0 + N - 1 < r0) || r0 >= s) {
      consumer_release(bar, n);
      continue;
    }
    const int st = n % kStages;
    const uint32_t qt = ring + st * L::kStage;
    const uint32_t dot = qt + Tile<D>::bytes(N);
    const float* col_lse = vals + st * 2 * N;
    const float* col_dl = col_lse + N;
    float sc[N / 2], dp[N / 2];
    wgmma_fence();
    score_product<D, N>(sc, k_s, kRows, 64 * wg, qt);   // S^T = K Q^T
    score_product<D, N>(dp, v_s, kRows, 64 * wg, dot);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = (causal && c0 < r0 + 63) || c0 + N > s || r0 + 64 > s;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int col = frag_col(f, i), qpos = c0 + col;
      const bool off =
          edge && (qpos >= s ||
                   masked(qpos, r0 + f.row + 8 * frag_half(i), s, causal));
      const float p =
          off ? 0.f : exp2_approx(fmaf(sc[i], c, -col_lse[col] * kLog2e));
      sc[i] = p;                           // P^T
      dp[i] = p * (dp[i] - col_dl[col]);  // dS^T
    }
    uint32_t pt[N / 16][4], dst[N / 16][4];
    to_a<N>(pt, sc);
    to_a<N>(dst, dp);
    wgmma_fence();
    acc_product<D, N>(dv_acc, pt, dot);  // dV += P^T dO
    acc_product<D, N>(dk_acc, dst, qt);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait();
    fence_acc<D>(dv_acc);
    fence_acc<D>(dk_acc);
    consumer_release(bar, n);
  }
  store_acc<D>(dk + g0.kv_base, g0.kv_stride, r0, s, dk_acc, sm_scale);
  store_acc<D>(dv + g0.kv_base, g0.kv_stride, r0, s, dv_acc, 1.f);
}

// ------------------------------------------------------------------ launch

// cuTensorMapEncodeTiled, fetched from the driver at first use, so the
// library links no libcuda.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over a model-layout bf16 tensor (B, S, heads, D) whose box
// is `rows` rows of one head by one column block, swizzled as the tiles
// are (sm90.cuh). Rows past S read as zeros.
template <int D>
bool tile_map(CUtensorMap* map, const void* base, int b, int s, int heads,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr int W = Tile<D>::kW;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)s,
                        (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                           (cuuint64_t)s * heads * D * 2};
  cuuint32_t box[4] = {(cuuint32_t)Tile<D>::kCols, 1, (cuuint32_t)rows, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

dim3 grid(int bh, int s) { return dim3(bh, (s + kRows - 1) / kRows); }

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
        int s, int h, int hk, float sm_scale, int causal, cudaStream_t st) {
  constexpr int N = FwdLayout<D>::kCols;
  CUtensorMap qm, km, vm;
  if (!tile_map<D>(&qm, q, b, s, h, kRows) || !tile_map<D>(&km, k, b, s, hk, N) ||
      !tile_map<D>(&vm, v, b, s, hk, N))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90_kernel<D>;
  constexpr int smem = FwdLayout<D>::kSmem;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid(b * h, s), kThreads, smem, st>>>(
      qm, km, vm, static_cast<bf16*>(o), static_cast<float*>(lse), s, h, hk,
      sm_scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int b, int s, int h,
       int hk, float sm_scale, int causal, cudaStream_t st) {
  constexpr int N = DqLayout<D>::kCols;
  CUtensorMap qm, km, vm, dom;
  if (!tile_map<D>(&qm, q, b, s, h, kRows) || !tile_map<D>(&km, k, b, s, hk, N) ||
      !tile_map<D>(&vm, v, b, s, hk, N) ||
      !tile_map<D>(&dom, dout, b, s, h, kRows))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dq_sm90_kernel<D>;
  constexpr int smem = DqLayout<D>::kSmem;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid(b * h, s), kThreads, smem, st>>>(
      qm, km, vm, dom, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq_out), s, h, hk,
      sm_scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int b, int s,
        int h, int hk, float sm_scale, int causal, cudaStream_t st) {
  constexpr int N = DkvLayout<D>::kCols;
  CUtensorMap qm, km, vm, dom;
  if (!tile_map<D>(&qm, q, b, s, h, N) || !tile_map<D>(&km, k, b, s, hk, kRows) ||
      !tile_map<D>(&vm, v, b, s, hk, kRows) ||
      !tile_map<D>(&dom, dout, b, s, h, N))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dkv_sm90_kernel<D>;
  constexpr int smem = DkvLayout<D>::kSmem;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid(b * hk, s), kThreads, smem, st>>>(
      qm, km, vm, dom, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, h, hk, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int smem_bytes(int role) {
  return role == kFwd ? FwdLayout<D>::kSmem
         : role == kDq ? DqLayout<D>::kSmem
         : role == kDkv ? DkvLayout<D>::kSmem : 0;
}

}  // namespace

#define TPUBC_SM90_DISPATCH(FN, ...)                       \
  do {                                                      \
    if (d == 32) return FN<32>(__VA_ARGS__);                \
    if (d == 64) return FN<64>(__VA_ARGS__);                \
    if (d == 128) return FN<128>(__VA_ARGS__);              \
    return (int)cudaErrorInvalidValue;                      \
  } while (0)

int fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int s, int h, int hk, int d, float sm_scale, int causal,
             cudaStream_t st) {
  TPUBC_SM90_DISPATCH(fwd, q, k, v, o, lse, b, s, h, hk, sm_scale, causal, st);
}

int dq_sm90(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq_out, int b, int s,
            int h, int hk, int d, float sm_scale, int causal,
            cudaStream_t st) {
  TPUBC_SM90_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, b, s, h, hk,
                      sm_scale, causal, st);
}

int dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int b,
             int s, int h, int hk, int d, float sm_scale, int causal,
             cudaStream_t st) {
  TPUBC_SM90_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, b, s, h, hk,
                      sm_scale, causal, st);
}

int smem_bytes_sm90(int role, int d) {
  if (d == 32) return smem_bytes<32>(role);
  if (d == 64) return smem_bytes<64>(role);
  if (d == 128) return smem_bytes<128>(role);
  return 0;
}

}  // namespace tpubc_flash
