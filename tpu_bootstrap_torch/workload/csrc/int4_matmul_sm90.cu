// Kernel K6: x (T, K) @ int4 q (Ks/2, N) with group scales s (Ks/g, N)
// -> (T, N) in x's dtype, and its expert form K6e: x (E, T, K) @
// q (E, Ks/2, N), s (E, Ks/g, N) -> (E, T, N), one product per expert; on
// Hopper's tensor cores (sm_90a): the Format<4> instantiations of the
// kernel of quant_matmul_sm90.cuh, which K1/K1e share.
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
// Storage a tensor map cannot address (N % 16 != 0, a group that is not
// whole k-steps, an unaligned base) runs the same kernel with the
// producer warp's 32 lanes copying the weight bytes into the same slots,
// and the consumers reading each weight's scale from global memory.

#include "quant_matmul_sm90.cuh"

// Kernel K6 (e = 1: x (T, kdim), q (p, N) uint8 with p = Ks / 2, s
// (Ks / group, N)) and its expert form K6e (x (E, T, kdim), q (E, p, N),
// s (E, Ks / group, N)); `split` from kernels.int4_plan, checked here.
extern "C" int tpubc_int4_matmul(const void* x, const void* q, const void* s,
                                 void* out, int e, int t, int kdim, int p,
                                 int n, int group, int x_is_bf16, int split,
                                 void* stream) {
  using namespace quant_sm90;
  const int ks = 2 * p;
  const int per = group % 16 == 0 ? group / 16 : 1;
  if (e < 1 || e > 65535 || t < 1 || kdim < 1 || p < 1 || n < 1 ||
      group < 2 || group % 2 != 0 || ks % group != 0 || kdim > ks ||
      split < 1 || split > kMaxSplit ||
      split > split_units((ks + 15) / 16, per) || !grid_fits(t, n)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool tma = n % 16 == 0 && scales_in_slot(group) &&
                   (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  const Args a{x, static_cast<const uint8_t*>(q),
               static_cast<const float*>(s), out, t, kdim, p, n, per, split,
               group, (n + kTileN - 1) / kTileN, scale_shift(group),
               kdim % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0};
  CUtensorMap q_map = {}, s_map = {};
  if (tma && (!tensor_map(&q_map, q, e, p, n, Smem<4>::kBoxRows, false) ||
              !tensor_map(&s_map, s, e, ks / group, n,
                          Format<4>::kScaleRows >> a.scale_shift, true))) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_any<4>(x_is_bf16 != 0, e, tma, q_map, s_map, a,
                            reinterpret_cast<cudaStream_t>(stream));
}
