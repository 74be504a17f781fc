// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// and the rotary pass (rope.cu): strides, chunk positions, bf16 packing and
// stores, quad reductions, the rotary tables, and the counter-rotation of
// accumulator rows (the backward's dQ and dK).
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

// ------------------------------------------------------------------ rotary
//
// Fused rotary embedding (horovod_tpu/ops/flash_attention.py:_rot_apply):
// element j < D/2 of a row at position p and its partner j + D/2 become
//   x_j cos - x_{j+D/2} sin   and   x_{j+D/2} cos + x_j sin,
// cos and sin of p * base^(-2j/D) read from f32 [positions, D/2] tables
// (flash_attention.rope_tables: PyTorch's full-precision cos and sin of the
// f32 angles, which reach 8191 rad at L = 8192, where __sinf would not
// do), computed in f32 and rounded to bf16 once. The transpose rotation
// (the gradient's counter-rotation) flips sin's sign.
struct Rope {
  const float* cos;  // [positions, D / 2] f32; null: no rotary
  const float* sin;
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// Counter-rotates this lane's rows (row0 and row0 + 8; rows at or past n
// skipped) of a 64 x D f32 accumulator (hopper.cuh's layout) by the
// transpose R(-p), the gradient's rotation (dQ, dK), in registers: column
// 8i + tc + e and its partner 8(i + D/16) + tc + e lie in the same lane.
template <int D>
__device__ __forceinline__ void unrotate_rows(float (&acc)[D / 2], int row0,
                                              int n, const Chunks& c,
                                              const Rope& rope, int tc) {
  constexpr int kHalf = D / 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const long long at = static_cast<long long>(pos_of(c, row)) * kHalf + tc;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const float2 cs =
          *reinterpret_cast<const float2*>(rope.cos + at + 8 * i);
      const float2 sn =
          *reinterpret_cast<const float2*>(rope.sin + at + 8 * i);
      const float s2[2] = {sn.x, sn.y}, c2[2] = {cs.x, cs.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& a = acc[4 * i + 2 * r + e];
        float& b = acc[4 * (i + D / 16) + 2 * r + e];
        const float a0 = a;
        a = a0 * c2[e] + b * s2[e];
        b = b * c2[e] - a0 * s2[e];
      }
    }
  }
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
