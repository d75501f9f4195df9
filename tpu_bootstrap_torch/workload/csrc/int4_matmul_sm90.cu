// Kernel K6: x (T, K) @ int4 q (Ks/2, N) with group scales s (Ks/g, N)
// -> (T, N) in x's dtype, and its expert form K6e: x (E, T, K) @
// q (E, Ks/2, N), s (E, Ks/g, N) -> (E, T, N), one product per expert; on
// Hopper's tensor cores (sm_90a), in the layout of quant_matmul_sm90.cuh.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/quant.py
// `_matmul4_kernel` (launched by `_quant_matmul` with grid (N tiles,
// K tiles), and with grid (E, N tiles, K tiles) for expert stacks). Same
// arithmetic, element for element:
//   * storage is nibble-packed along K: byte (i, n) holds k = 2i in its
//     low nibble and k = 2i + 1 in its high nibble, each as value + 8;
//   * a weight is nibble - 8 in f32 (exactly), times its group's scale
//     s[k / g, n] in f32 (g is even, so both nibbles of a byte share it),
//     rounded to bf16, as the reference scales before its bf16 cast;
//   * the activation is rounded to bf16, the product of two bf16 values is
//     exact in f32 (wgmma's bf16 inputs, f32 accumulators), and the
//     products are summed in f32;
//   * no scale is applied after the sum; the output is cast to x's dtype.
// Ks is the stored contraction (whole groups); only the first `kdim` rows
// are real. Rows k >= kdim are masked, not left to the zero padding: their
// activation is staged as 0 and their weight as 0, so they contribute
// nothing whatever the storage (or a padded scale) holds.
//
// What bounds it on the H100: bytes. At decode batch (T = 8) a launch
// reads K N / 2 weight bytes plus K / g N 4 scale bytes and does 2 T K N
// operations, 32 FLOP a weight byte, far under the card's ~295 FLOP/byte
// ridge; and at these sizes (0.5 to 17 MB) a launch is a few microseconds,
// so latency and filling the card count as much. What the design does:
//   * swap-AB: the weight is wgmma's M side, so 8 T rows are a full
//     instruction (m64n8k16) and the bytes go through the tensor cores
//     once per T tile, with no padding of T to 64;
//   * the A fragment fits the packing: a register is one packed byte
//     (two k of one column), dequantized with 2 LOP3, 2 FADD, 2 FMUL and
//     one bf16x2 convert (quant_matmul_sm90.cuh `dequant`), from a 16-bit
//     shared-memory load that serves both of a thread's columns;
//   * the weight and scale tiles stream by TMA (a box of 32 packed rows
//     by 64 columns, and the slot's group rows) into a 6-slot ring ahead
//     of the consumers, so the copies overlap the dequant; each thread
//     reads each (group, column) scale it needs once a k-step from shared
//     memory;
//   * the dequant of one half-stage (two k-steps) overlaps the wgmmas of
//     the one before: two fragment buffers, one commit group each;
//   * the contraction is split by a count fixed by the weight's shape and
//     the card (kernels.int4_plan): two CTAs per SM where the splits allow
//     (at least one at every decode shape), the splits a cluster that sums
//     in rank order.
// The transpose the storage needs (N-contiguous bytes, a fragment that
// wants one column across k) is done by the permutation of the fragment's
// rows (quant_matmul_sm90.cuh) and the swizzled box: each 16-bit load
// reads two columns of one packed row, without bank conflicts.
//
// A wgmma reads its A registers and writes its accumulators after it is
// issued, until the wait for its group. The compiler does not know that:
// the fragments are pinned (an empty asm that "uses" them) before each
// wgmma fence and after the wait that ends their read, and every wgmma is
// waited for before the accumulators cross from one loop to the next. A
// fragment write or a wgmma in a branch makes ptxas serialize every wgmma
// (C7520), so the masked steps run the same code with zero weights.
//
// Storage a tensor map cannot address (N % 16 != 0, a group that is not
// whole k-steps, an unaligned base) runs the same kernel with the
// producer warp's 32 lanes copying the weight bytes into the same slots,
// and the consumers reading each weight's scale from global memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "quant_matmul_sm90.cuh"

namespace tpubc_int4 {

using namespace tpubc_sm90;
using namespace quant_sm90;

struct Args {
  const void* x;
  const uint8_t* q;
  const float* s;
  void* out;
  int t, kdim, p, n, group, split;  // t: rows per expert; p = Ks / 2
  int mtiles;       // column tiles: blockIdx.y = tile + mtiles * T group
  int scale_shift;  // a slot's step j reads scale row j >> scale_shift
  int x_vec;        // x rows may be read 16 bytes at a time
};

// Producer: fills slot i % kStages with stage i of this CTA's k-steps
// [ks0, ks1), after the consumers released its previous use.
template <bool kTma>
__device__ __forceinline__ void produce(const CUtensorMap* q_map,
                                        const CUtensorMap* s_map,
                                        const Args& a, const uint8_t* q,
                                        uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int e, int n0,
                                        int ks0, int ks1) {
  const int lane = threadIdx.x % 32;
  const int stages = (ks1 - ks0 + kStepsPerStage - 1) / kStepsPerStage;
  if (kTma && lane != 0) return;
  for (int i = 0; i < stages; ++i) {
    const int slot = i % kStages;
    if (i >= kStages) mbar_wait(&empty[slot], (i / kStages - 1) & 1);
    const int k0 = 16 * (ks0 + i * kStepsPerStage);
    uint8_t* w = smem + kWOffset + slot * kSlotW;
    if constexpr (kTma) {
      mbar_arrive_expect_tx(
          &full[slot], kSlotW + (kScaleRows >> a.scale_shift) * kTileN * 4);
      tma_load_3d(smem_addr(w), q_map, &full[slot], n0, k0 / 2, e);
      tma_load_3d(smem_addr(smem + kSOffset + slot * kSlotS), s_map,
                  &full[slot], n0, k0 / a.group, e);
    } else {
      const int p0 = k0 / 2;
#pragma unroll 8
      for (int idx = lane; idx < kSlotW; idx += 32) {
        const int r = idx / kTileN, c = idx % kTileN;
        const int p = p0 + r, n = n0 + c;
        w[wslot_offset(r, c)] =
            p < a.p && n < a.n ? __ldg(q + (size_t)p * a.n + n) : 0;
      }
      mbar_arrive(&full[slot]);
    }
  }
}

// The consumer warpgroup over this CTA's k-steps [ks0, ks1), for kTiles T
// tiles of 8 rows from t0; its partial sums end in `red`.
//
// Stage i waits for slot i % kStages and goes in two halves of two k-steps:
// each half dequantizes its steps into one of two fragment buffers and
// issues one wgmma per k-step and T tile (one commit group), then waits
// for the group before it, so the other buffer is free again; the slot is
// released once the second half has read it. No wgmma and no fragment
// write sits in a branch (ptxas would serialize every wgmma): the steps
// past the split (a partial last stage) or past kdim are masked to zero
// weights, their wgmmas reading the chunk's first activation step.
template <bool kTma, int kTiles, typename X>
struct Consumer {
  const Args& a;
  const X* x;
  const float* s;  // this expert's scales (global)
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  int ks0, ks1, t0, n0, c0, j4;
  int stages;
  int chunk = 0;   // first k-step of the staged activation chunk
  static constexpr int kChunkK = chunk_k(kTiles);
  static constexpr int kNkb = kChunkK / 64;

  // Stages the chunk that starts at k-step `ks` (after the wgmmas that
  // read the last one, if any).
  __device__ __forceinline__ void next_chunk(int ks, bool first) {
    if (!first) {
      wgmma_wait_group<0>();
      named_barrier_sync(1, kConsumers);
    }
    chunk = ks;
    stage_x<kTiles>(smem + kXOffset, x, a.t, a.kdim, t0, 16 * ks,
                    min(kChunkK, 16 * (ks1 - ks)), kNkb, a.x_vec != 0);
    fence_proxy_async();
    named_barrier_sync(1, kConsumers);
  }

  // Steps 2 kHalf, 2 kHalf + 1 of the stage at k-step ks, from its slot's
  // weights w and scales sc, into frag; then their wgmmas.
  template <bool kMasked, int kHalf>
  __device__ __forceinline__ void half(int ks, const uint8_t* w,
                                       const float* sc,
                                       uint32_t (&frag)[2][4],
                                       float (&acc)[kTiles][4]) {
    int local[2];  // the chunk's k-step each wgmma reads
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kHalf + h;
      const int kb = 16 * (ks + j);  // first k of the step
      // Packed rows 8 j + j4 (k pairs 2 j4) and 8 j + j4 + 4: the slot's
      // swizzle repeats every 8 rows.
      const uint32_t w1 = *reinterpret_cast<const uint16_t*>(
          w + 512 * j + wslot_offset(j4, c0));
      const uint32_t w2 = *reinterpret_cast<const uint16_t*>(
          w + 512 * j + wslot_offset(j4 + 4, c0));
      const int ka = kb + 2 * j4, kc = ka + 8;  // k of the low nibbles
      // The k past which weights are 0: kdim, or this step's start when
      // the step is past the split.
      const int lim = !kMasked || ks + j < ks1 ? a.kdim : 0;
      local[h] = !kMasked || ks + j < ks1 ? ks + j - chunk : 0;
      float sa0, sa1, sc0, sc1;  // scales: (k pair, column c0 / c0 + 1)
      if constexpr (kTma) {
        const float2 v = *reinterpret_cast<const float2*>(
            sc + (j >> a.scale_shift) * kTileN + c0);
        sa0 = sc0 = v.x;
        sa1 = sc1 = v.y;
      } else {
        const int n = n0 + c0;
        const float* ra = s + (size_t)(ka / a.group) * a.n + n;
        const float* rc = s + (size_t)(kc / a.group) * a.n + n;
        sa0 = ka < lim && n < a.n ? __ldg(ra) : 0.f;
        sa1 = ka < lim && n + 1 < a.n ? __ldg(ra + 1) : 0.f;
        sc0 = kc < lim && n < a.n ? __ldg(rc) : 0.f;
        sc1 = kc < lim && n + 1 < a.n ? __ldg(rc + 1) : 0.f;
      }
      const bool a_lo = !kMasked || ka < lim, a_hi = !kMasked || ka + 1 < lim;
      const bool c_lo = !kMasked || kc < lim, c_hi = !kMasked || kc + 1 < lim;
      frag[h][0] = dequant<0>(w1, sa0, a_lo, a_hi);
      frag[h][1] = dequant<1>(w1, sa1, a_lo, a_hi);
      frag[h][2] = dequant<0>(w2, sc0, c_lo, c_hi);
      frag[h][3] = dequant<1>(w2, sc1, c_lo, c_hi);
    }
    const uint32_t xs = smem_addr(smem + kXOffset);
    fence_frag(frag);  // written before the fence that the wgmmas follow
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int tt = 0; tt < kTiles; ++tt)
        wgmma_rs_kmajor<8>(acc[tt], frag[h],
                           xchunk_desc(xs, tt, kNkb, local[h]), 1);
    wgmma_commit();
  }

  template <bool kMasked>
  __device__ __forceinline__ void stage(int i, uint32_t (&frag0)[2][4],
                                        uint32_t (&frag1)[2][4],
                                        float (&acc)[kTiles][4]) {
    const int slot = i % kStages;
    const int ks = ks0 + i * kStepsPerStage;
    if (16 * (ks - chunk) == kChunkK) next_chunk(ks, false);
    mbar_wait(&full[slot], (i / kStages) & 1);
    const uint8_t* w = smem + kWOffset + slot * kSlotW;
    const float* sc = reinterpret_cast<const float*>(smem + kSOffset +
                                                     slot * kSlotS);
    half<kMasked, 0>(ks, w, sc, frag0, acc);
    wgmma_wait_group<1>();  // the last stage's second half: frag1 is free
    fence_frag(frag1);
    half<kMasked, 1>(ks, w, sc, frag1, acc);
    mbar_arrive(&empty[slot]);
    wgmma_wait_group<1>();  // this stage's first half: frag0 is free
    fence_frag(frag0);
  }

  // Waits for every wgmma, then pins the registers they wrote and read: no
  // copy of an accumulator (the compiler's, between two loops) may happen
  // while a wgmma still writes it.
  __device__ __forceinline__ static void drain(uint32_t (&frag1)[2][4],
                                               float (&acc)[kTiles][4]) {
    wgmma_wait_group<0>();
    fence_frag(frag1);
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) fence_regs(acc[tt]);
  }

  // Pins a fragment's registers: before wgmma_fence, so that every write
  // of them precedes it (a write the compiler sank past the fence would
  // race the wgmma's read); after the wait that ends the wgmmas' read, so
  // that they stay live (and unreused) until then.
  __device__ __forceinline__ static void fence_frag(uint32_t (&frag)[2][4]) {
    fence_regs(frag[0]);
    fence_regs(frag[1]);
  }

  // Every stage; the stages whose steps are all in the split and under
  // kdim go through the unmasked dequant.
  __device__ __forceinline__ void run(float* red) {
    float acc[kTiles][4];
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[tt][k] = 0.f;
    uint32_t frag0[2][4] = {}, frag1[2][4] = {};
    next_chunk(ks0, true);
    const int whole = min(ks1, a.kdim / 16) - ks0;  // unmasked steps
    const int clean = whole > 0 ? whole / kStepsPerStage : 0;
    int i = 0;
    for (; i < clean; ++i) stage<false>(i, frag0, frag1, acc);
    drain(frag1, acc);  // the loops may hold acc in other registers
    for (; i < stages; ++i) stage<true>(i, frag0, frag1, acc);
    drain(frag1, acc);
    named_barrier_sync(1, kConsumers);  // every wgmma read its chunk
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) {
      float* row = red + (kTileT * tt + 2 * j4) * kTileN + c0;
      row[0] = acc[tt][0];
      row[kTileN] = acc[tt][1];
      row[1] = acc[tt][2];
      row[kTileN + 1] = acc[tt][3];
    }
  }
};

// The plain-load form reads each scale from global memory, which costs
// registers: it is given room for 2 CTAs an SM, so that nothing spills.
template <typename X, bool kExpert, bool kTma>
__global__ void __launch_bounds__(kThreads, kTma ? kCtasPerSm : 2)
int4_matmul_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap s_map,
                        const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;

  const int rank = blockIdx.x;  // the cluster is the grid's x extent
  const int mt = blockIdx.y % a.mtiles;
  const int t0 = blockIdx.y / a.mtiles * kTilesT * kTileT;
  const int n0 = mt * kTileN;
  const int e = kExpert ? blockIdx.z : 0;
  const int ks = 2 * a.p;
  const X* x = static_cast<const X*>(a.x) + (size_t)e * a.t * a.kdim;
  X* out = static_cast<X*>(a.out) + (size_t)e * a.t * a.n;
  const uint8_t* q = a.q + (size_t)e * a.p * a.n;
  const float* s = a.s + (size_t)e * (ks / a.group) * a.n;
  const int tiles = min(kTilesT, (a.t - t0 + kTileT - 1) / kTileT);
  const Steps st = split_steps(ks, a.group, a.split, rank);
  const int stages = (st.end - st.begin + kStepsPerStage - 1) /
                     kStepsPerStage;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kTma ? 1 : 32);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem + kXOffset);  // [8 tiles][64]
  if (threadIdx.x >= kConsumers) {
    produce<kTma>(&q_map, &s_map, a, q, smem, full, empty, e, n0, st.begin,
                  st.end);
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c0 = 16 * warp + 2 * (lane / 4);
#define TPUBC_INT4_CONSUME(TILES)                                          \
  Consumer<kTma, TILES, X>{a, x, s, smem, full, empty, st.begin, st.end,   \
                           t0, n0, c0, lane % 4, stages}                   \
      .run(red)
    // T tiles of this CTA: 1, 2, or up to kTilesT (3 runs as 4: the rows
    // past T are staged as zeros and never reduced), which keeps the
    // build to three bodies an instantiation.
    switch (tiles) {
      case 1: TPUBC_INT4_CONSUME(1); break;
      case 2: TPUBC_INT4_CONSUME(2); break;
      default: TPUBC_INT4_CONSUME(kTilesT); break;
    }
#undef TPUBC_INT4_CONSUME
  }
  cluster_sync();  // every split's partial is in its shared memory
  if (threadIdx.x < kConsumers) {
    const int rows = min(kTilesT * kTileT, a.t - t0);
    const int total = rows * kTileN;
    const int per = (total + a.split - 1) / a.split;
    const int end = min(total, (rank + 1) * per);
    for (int f = rank * per + threadIdx.x; f < end; f += kConsumers) {
      const uint32_t addr = smem_addr(red + f);
      float part[kMaxSplit];  // every load in flight before the first add
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        part[r] = r < a.split ? ld_cluster(cluster_peer(addr, r)) : 0.f;
      float sum = part[0];
#pragma unroll
      for (int r = 1; r < kMaxSplit; ++r)
        if (r < a.split) sum += part[r];
      const int n = n0 + f % kTileN;
      if (n < a.n) store(out + (size_t)(t0 + f / kTileN) * a.n + n, sum);
    }
  }
  cluster_sync_relaxed();  // no CTA leaves while the cluster reads its partial
}

// ------------------------------------------------------------------ launch

// Tensor maps, encoded once per (base, shape) and kept: the serve loop
// launches the same weights every step.
struct MapKey {
  const void* base;
  int e, rows, n, box_rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && e == o.e && rows == o.rows && n == o.n &&
           box_rows == o.box_rows;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.base);
    for (int v : {k.e, k.rows, k.n, k.box_rows})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

std::mutex map_mutex;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;  // guarded-by: map_mutex

// The weight's map (box: 32 packed rows by 64 column bytes, 64B swizzle)
// when box_rows is 0, else its scales' (box: box_rows group rows by 64
// columns); a 3-d view (N, rows, E). Rows and columns past the storage
// read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int e, int rows, int n,
                int box_rows) {
  const MapKey key{base, e, rows, n, box_rows};
  std::lock_guard<std::mutex> lock(map_mutex);
  const auto found = map_cache.find(key);
  if (found != map_cache.end()) {
    *map = found->second;
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const bool scales = box_rows > 0;
  const cuuint64_t elt = scales ? 4 : 1;
  cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)rows, (cuuint64_t)e};
  cuuint64_t strides[2] = {n * elt, (cuuint64_t)rows * n * elt};
  cuuint32_t box[3] = {(cuuint32_t)kTileN,
                       (cuuint32_t)(scales ? box_rows : kStageK / 2), 1};
  cuuint32_t step[3] = {1, 1, 1};
  if (encode(map,
             scales ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             3, const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             scales ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (map_cache.size() >= 4096) map_cache.clear();
  map_cache.emplace(key, *map);
  return true;
}

template <typename X, bool kExpert, bool kTma>
cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& s_map,
                   const Args& a, dim3 grid, cudaStream_t st) {
  auto kernel = int4_matmul_sm90_kernel<X, kExpert, kTma>;
  static const cudaError_t prepared = [&] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)  // room for kCtasPerSm CTAs on an SM
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }();
  if (prepared != cudaSuccess) return prepared;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q_map, s_map, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename X, bool kExpert>
cudaError_t launch_any(bool tma, const CUtensorMap& q_map,
                       const CUtensorMap& s_map, const Args& a, dim3 grid,
                       cudaStream_t st) {
  return tma ? launch<X, kExpert, true>(q_map, s_map, a, grid, st)
             : launch<X, kExpert, false>(q_map, s_map, a, grid, st);
}

}  // namespace tpubc_int4

// Kernel K6 (e = 1: x (T, kdim), q (p, N) uint8 with p = Ks / 2, s
// (Ks / group, N)) and its expert form K6e (x (E, T, kdim), q (E, p, N),
// s (E, Ks / group, N)); `split` from kernels.int4_plan, checked here.
extern "C" int tpubc_int4_matmul(const void* x, const void* q, const void* s,
                                 void* out, int e, int t, int kdim, int p,
                                 int n, int group, int x_is_bf16, int split,
                                 void* stream) {
  using namespace quant_sm90;
  using tpubc_int4::Args;
  const int ks = 2 * p;
  if (e < 1 || e > 65535 || t < 1 || kdim < 1 || p < 1 || n < 1 ||
      group < 2 || group % 2 != 0 || ks % group != 0 || kdim > ks ||
      split < 1 || split > kMaxSplit || split > split_units(ks, group)) {
    return (int)cudaErrorInvalidValue;
  }
  const int mtiles = (n + kTileN - 1) / kTileN;
  const int tgroups = ((t + kTileT - 1) / kTileT + kTilesT - 1) / kTilesT;
  if ((long long)mtiles * tgroups > 65535) return (int)cudaErrorInvalidValue;
  const bool tma = n % 16 == 0 && scales_in_slot(group) &&
                   (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  Args a{x, static_cast<const uint8_t*>(q), static_cast<const float*>(s),
         out, t, kdim, p, n, group, split, mtiles,
         scale_shift(group),
         kdim % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0};
  CUtensorMap q_map = {}, s_map = {};
  if (tma && (!tpubc_int4::tensor_map(&q_map, q, e, p, n, 0) ||
              !tpubc_int4::tensor_map(&s_map, s, e, ks / group, n,
                                      kScaleRows >> a.scale_shift))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(split, mtiles * tgroups, e);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16 && e > 1) {
    err = tpubc_int4::launch_any<__nv_bfloat16, true>(tma, q_map, s_map, a,
                                                      grid, st);
  } else if (x_is_bf16) {
    err = tpubc_int4::launch_any<__nv_bfloat16, false>(tma, q_map, s_map, a,
                                                       grid, st);
  } else if (e > 1) {
    err = tpubc_int4::launch_any<float, true>(tma, q_map, s_map, a, grid, st);
  } else {
    err = tpubc_int4::launch_any<float, false>(tma, q_map, s_map, a, grid, st);
  }
  return (int)err;
}
