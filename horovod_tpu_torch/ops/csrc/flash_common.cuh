// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_ring.cu): strides, chunk positions, bf16 packing and stores, and
// quad reductions; and for the ring's backward steps (flash_ring.cu) the
// tile sizes, global -> shared staging of a tile (cp.async for bf16), and
// the bf16 tensor-core product (mma.sync m16n8k16, f32 accumulation) with
// its ldmatrix fragment loads from shared memory.
//
// Layout. Every tensor is addressed as [B, heads, L, D] through three element
// strides (batch, head, row); the last dim is contiguous. The Python wrapper
// passes the [B, L, H, D] activations of the model as transposed views, so no
// copy is made for the kernel. lse and delta are plain f32 [B, H, L].
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = 2 * (lane % 4):
//   A (16x16, row major): a0 = A[g][t..t+1],   a1 = A[g+8][t..t+1],
//                         a2 = A[g][t+8..t+9], a3 = A[g+8][t+8..t+9]
//   B (16x8):             b0 = B[t..t+1][g],   b1 = B[t+8..t+9][g]
//   C (16x8, f32):        c0,c1 = C[g][t..t+1], c2,c3 = C[g+8][t..t+1]
// ldmatrix.x4 hands each lane exactly these registers for four 8x8 blocks
// whose rows the lanes address (lanes 8m..8m+7 the rows of block m). Two
// neighbouring C tiles (columns 16k..16k+15) hold exactly the A fragment of
// columns 16k..16k+15, so a score tile feeds the next product from registers
// (FlashAttention-2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvdflash {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;             // rows a block owns
constexpr int kBlockN = 64;             // rows streamed per loop step
constexpr int kWarps = 4;               // 16 owned rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                 // bf16 of padding per shared row:
                                        // ldmatrix rows then hit distinct
                                        // banks
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; zeros when
// `valid` is false (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight elements of a row into 16 bytes of shared memory: bf16 rows go
// asynchronously (cp.async, completed by cp_async_wait), f32 rows are
// converted to bf16 on the way.
__device__ __forceinline__ void stage8(const bf16* src, bf16* dst,
                                       bool valid) {
  cp_async16(dst, src, valid);
}

__device__ __forceinline__ void stage8(const float* src, bf16* dst,
                                       bool valid) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (valid) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                   pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Stages rows [row0, row0 + 64) of one [L, D] slice (row stride `sl`) into a
// shared tile with D + kPad elements per row. Rows at or past L are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const T* base,
                                          long long sl, int row0, int L) {
  constexpr int kChunks = D / 8;
  constexpr int kLd = D + kPad;
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < L;
    stage8(valid ? base + row * sl + col : base, dst + r * kLd + col, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Per-lane element offsets into a shared tile with row length kLd:
//  a_off:  the A fragment of a 16x16 block (lanes 0-15 its rows at column
//          0, lanes 16-31 at column 8). With .trans the same addresses give
//          the B fragments of two n8 tiles when the tile holds B as it is
//          (element (k, n) at [k][n]: V for P.V, K for dS.K, dO and Q in K3).
//  bt_off: the B fragments of two n8 tiles when the tile holds B
//          transposed (element (k, n) at [n][k]: K for Q.K^T, V for
//          dO.V^T, Q and dO for the K3 products).
template <int kLd>
__device__ __forceinline__ int a_off(int lane) {
  return (lane % 16) * kLd + (lane / 16) * 8;
}

template <int kLd>
__device__ __forceinline__ int bt_off(int lane) {
  return ((lane % 8) + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;
}

// c += a . b on the tensor cores, bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[nt], c[nt + 1] += a . (the two n8 tiles in b, as ldmatrix gave them).
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// The A fragment of columns 16kk..16kk+15 from the f32 C tiles 2kk, 2kk+1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
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

// Launches `kernel` after lifting its dynamic shared-memory cap to `smem`.
template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream,
                   const P& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace hvdflash

#include "hvd_error.cuh"
