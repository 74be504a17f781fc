// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// strides, chunk positions, bf16 packing and stores, and quad reductions.
//
// Layout. Every tensor is addressed as [B, heads, L, D] through three element
// strides (batch, head, row); the last dim is contiguous. The Python wrapper
// passes the [B, L, H, D] activations of the model as transposed views, so no
// copy is made for the kernel. lse and delta are plain f32 [B, H, L].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvdflash {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, l;
};

// Global positions of a ring shard's rows: row r lies at off0 + r when r < len,
// else at off1 + (r - len). One chunk has off1 = off0 + len.
struct Chunks {
  int off0, off1, len;
};

__device__ __forceinline__ int pos_of(const Chunks& c, int r) {
  return r < c.len ? c.off0 + r : c.off1 + (r - c.len);
}

// Smallest and largest position of rows [a, b].
__device__ __forceinline__ int min_pos(const Chunks& c, int a, int b) {
  return (a < c.len && b >= c.len) ? min(c.off0 + a, c.off1) : pos_of(c, a);
}

__device__ __forceinline__ int max_pos(const Chunks& c, int a, int b) {
  return (a < c.len && b >= c.len) ? max(c.off0 + c.len - 1, pos_of(c, b))
                                   : pos_of(c, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Sum / max over the four lanes that share a fragment row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

inline void fill_strides(Strides* s, const long long* src, int n) {
  for (int i = 0; i < n; ++i) {
    s[i].b = src[3 * i];
    s[i].h = src[3 * i + 1];
    s[i].l = src[3 * i + 2];
  }
}

}  // namespace hvdflash

#include "hvd_error.cuh"
