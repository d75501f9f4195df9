// What the flash kernels' two sources share: csrc/flash_attention.cu (the
// f32 kernels on the CUDA cores, and the C entries of both) and
// csrc/flash_attention_sm90.cu (the bf16 kernels on the tensor cores).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace tpubc_flash {

constexpr float kNeg = -1e30f;  // score of a masked pair, as the reference's

// Kernel roles, as numbered by the C entry tpubc_flash_smem_bytes.
enum Role { kFwd = 0, kDq = 1, kDkv = 2 };

// Geometry shared by the kernels: strides of the model layout and the base
// pointers of one (batch, head) row.
struct Heads {
  int b, hq, kh;          // batch, query head, KV head
  size_t q_stride, kv_stride, lse_stride;
  size_t q_base, kv_base, lse_base;
};

__device__ __forceinline__ Heads heads(int b, int hq, int s, int h, int hk,
                                       int d) {
  Heads g;
  g.b = b;
  g.hq = hq;
  g.kh = hq / (h / hk);
  g.q_stride = (size_t)h * d;
  g.kv_stride = (size_t)hk * d;
  g.lse_stride = (size_t)h;
  g.q_base = (size_t)b * s * g.q_stride + (size_t)hq * d;
  g.kv_base = (size_t)b * s * g.kv_stride + (size_t)g.kh * d;
  g.lse_base = (size_t)b * s * h + hq;
  return g;
}

// Masked score: column at or past s, or (causal) a row before its column.
__device__ __forceinline__ bool masked(int row, int col, int s, int causal) {
  return col >= s || (causal && row < col);
}

// The bf16 kernels (csrc/flash_attention_sm90.cu), launched by the C
// entries for bf16 inputs: the entries' arguments without the dtype flag.
// Each returns a cudaError_t as int.
int fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int s, int h, int hk, int d, float sm_scale, int causal,
             cudaStream_t st);
int dq_sm90(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, int b, int s, int h,
            int hk, int d, float sm_scale, int causal, cudaStream_t st);
int dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int b,
             int s, int h, int hk, int d, float sm_scale, int causal,
             cudaStream_t st);
// Dynamic shared memory of a bf16 kernel (Role) at head dim d; 0 for a
// head dim it does not take.
int smem_bytes_sm90(int role, int d);

}  // namespace tpubc_flash
