// Kernel K1: x (T, K) @ int8 q (K, N) * s (N,) -> (T, N) in x's dtype,
// and its expert form K1e: x (E, T, K) @ q (E, K, N) * s (E, 1, N) ->
// (E, T, N), one product per expert; on Hopper's tensor cores (sm_90a):
// the Format<8> instantiations of the kernel of quant_matmul_sm90.cuh,
// which K6/K6e share.
//
// Replaces the Pallas kernel tpu_bootstrap/workload/quant.py
// `_matmul_kernel` (launched by `_quant_matmul` with grid (N tiles,
// K tiles), and with grid (E, N tiles, K tiles) for expert stacks). Same
// arithmetic: the activation is rounded to bf16 (the reference casts x to
// bfloat16 before its dot), the int8 weight widens to bf16 exactly, the
// product of two bf16 values is exact in f32 (wgmma's bf16 inputs, f32
// accumulators), the products are summed in f32, and the column's f32
// scale multiplies the whole sum once, before the cast to x's dtype.
//
// What bounds it on the H100: bytes. At decode batch (T = 8) a launch
// reads K N weight bytes and does 2 T K N operations, 16 FLOP a weight
// byte, far under the card's ~295 FLOP/byte ridge; and at these sizes (1
// to 34 MB) a launch is a few to a few tens of microseconds, so latency
// and filling the card count as much. What the design does:
//   * swap-AB: the weight is wgmma's M side, so 8 T rows are a full
//     instruction (m64n8k16) and the bytes go through the tensor cores
//     once per T tile, with no padding of T to 64; up to 4 T tiles share
//     each widened fragment, so the weight is read once per 32 rows;
//   * the transpose the storage needs (N-contiguous bytes, a fragment that
//     wants one column across k) is the fragment's row permutation and the
//     swizzled box: a thread's four 16-bit shared loads (rows k, k + 1,
//     k + 8, k + 9, columns c0 and c0 + 1) hold its four A registers'
//     bytes, without bank conflicts;
//   * each byte widens with one PRMT and one FADD, each pair of floats
//     packs to bf16 with one PRMT (quant_matmul_sm90.cuh `widen8`): no
//     scale enters the loop;
//   * the weight tiles stream by TMA (a box of 64 rows by 64 column bytes,
//     64B swizzle) into a 5-slot ring ahead of the consumers, so the
//     copies overlap the widening, and the widening of one half-stage (two
//     k-steps) overlaps the wgmmas of the one before;
//   * the contraction is split by a count fixed by the weight's shape and
//     the card (kernels.int8_plan) into whole ring slots (64 K), so that
//     only K's tail is a partial stage, the splits a cluster that sums in
//     rank order; the scale is applied to the cluster's sum;
//   * the column scales the epilogue applies are copied into shared memory
//     by the producer warp at the start (cp.async), so that no load
//     follows the cluster's sum.
//
// Batch invariance: the split, so every output's order of sums, depends on
// K, N and the SM count only, never on T or on which rows share the launch
// (quant_matmul_sm90.cuh). The expert form adds blockIdx.z = expert.
//
// Storage a tensor map cannot address (N % 16 != 0, an unaligned base)
// runs the same kernel with the producer warp's 32 lanes copying the
// weight bytes into the same slots.

#include "quant_matmul_sm90.cuh"

// Kernel K1 (e = 1: x (T, K), q (K, N) int8, s (N,)) and its expert form
// K1e (x (E, T, K), q (E, K, N), s (E, 1, N)); `split` from
// kernels.int8_plan, checked here.
extern "C" int tpubc_int8_matmul(const void* x, const void* q, const void* s,
                                 void* out, int e, int t, int k, int n,
                                 int x_is_bf16, int split, void* stream) {
  using namespace quant_sm90;
  if (e < 1 || e > 65535 || t < 1 || k < 1 || n < 1 || split < 1 ||
      split > kMaxSplit ||
      split > split_units((k + 15) / 16, kStepsPerStage) ||
      !grid_fits(t, n)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool tma = n % 16 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const Args a{x, static_cast<const uint8_t*>(q),
               static_cast<const float*>(s), out, t, k, k, n,
               kStepsPerStage, split, 1, (n + kTileN - 1) / kTileN, 0,
               k % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0};
  CUtensorMap q_map = {};
  if (tma && !tensor_map(&q_map, q, e, k, n, Smem<8>::kBoxRows, false))
    return (int)cudaErrorInvalidValue;
  return (int)launch_any<8>(x_is_bf16 != 0, e, tma, q_map, q_map, a,
                            reinterpret_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a CTA of the int4 (bits 4) or int8 (bits 8)
// kernel; kernels.quant_smem_bytes mirrors it.
extern "C" int tpubc_quant_smem_bytes(int bits) {
  using namespace quant_sm90;
  return bits == 4 ? Smem<4>::kBytes : bits == 8 ? Smem<8>::kBytes : -1;
}
