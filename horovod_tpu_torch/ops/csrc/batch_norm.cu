// BatchNorm statistics (kernels K7 and K8).
//
// Replaces: horovod_tpu/ops/batch_norm.py:_stats_kernel (K7, launched by
// batch_norm_stats) and :_grad_stats_kernel (K8, launched by
// batch_norm_grad_stats). Over a row-major (M, C) activation, the channels
// last and contiguous:
//   K7: per channel (sum x, sum x^2);
//   K8: per channel (sum dy, sum dy * (x - mean) * rstd), i.e. (dbeta, dgamma).
// Each operand is read once, bf16 or f32, both sums of the pair come from
// that one read, they accumulate in f32, and the result is (2, C) f32.
//
// Bound on the H100: bytes. K7 does 3 operations per element it reads (two
// adds and a product) and K8 five, far below the card's 295 operations per
// byte, so both are bound by reading the activation: at the ResNet-50 stem
// (M = 256 * 112 * 112, C = 64, bf16) 411 MB, 0.123 ms at 3.35 TB/s for K7
// and twice that for K8, which reads dy and x.
//
// Design: pass 1 splits the rows among `splits` blocks (grid.x) and the
// channels among column tiles (grid.y). A block is 256 threads laid out as
// tx threads along C, each owning VEC = 8 neighbouring channels (one
// 16-byte load of bf16, two of f32), times ty = 256 / tx threads along M:
// at C = 64 a warp covers four 128-byte rows, at C >= 2048 the block spans
// one row. Each thread strides over its block's rows with f32 accumulators
// in registers; the ty partial sums meet in shared memory and are added in
// a fixed order, and the block writes its (2, C-tile) partials to the
// workspace [splits, 2, C]. Pass 2 adds the splits' partials per channel,
// again in a fixed order. No float atomics: the same input gives
// bit-identical statistics on every run and on every rank. Both ragged
// tails are masked: rows past M by the loop bound, channels past C by the
// column test (VEC = 1 when C is not a multiple of 8).
// Not yet done (later work): TMA or cp.async staging, a last-block
// reduction instead of the second launch, a wider VEC for f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hvd_error.cuh"

namespace hvdbn {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kFinalGroups = kThreads / 32;  // pass 2: 8 warps of 32 channels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// VEC elements from p into f32: 16-byte loads for VEC = 8 (p 16-byte
// aligned), one scalar load for VEC = 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_float(p[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(VEC % kPer == 0, "VEC must fill whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < VEC / kPer; ++i) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = to_float(e[j]);
    }
  }
}

// tx threads along C (VEC channels each) by ty threads along M.
struct Shape {
  int tx, ty;
};

__host__ __device__ inline Shape block_shape(int C, int vec) {
  const int tc = (C + vec - 1) / vec;
  const int tx = tc < kThreads ? tc : kThreads;
  return {tx, kThreads / tx};
}

// Pass 1. GRAD = false: K7 on x (dy, mean, rstd unused). GRAD = true: K8.
template <typename TX, typename TD, int VEC, bool GRAD>
__global__ void __launch_bounds__(kThreads)
    bn_partial_kernel(const TX* __restrict__ x, const TD* __restrict__ dy,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, float* __restrict__ ws,
                      long long M, int C, long long rows_per_split) {
  __shared__ float red[2][kThreads * VEC];
  const Shape sh = block_shape(C, VEC);
  const int width = sh.tx * VEC;  // channels of this block's tile
  const int tx = threadIdx.x % sh.tx, ty = threadIdx.x / sh.tx;
  const int c0 = blockIdx.y * width + tx * VEC;
  const bool in_block = ty < sh.ty;
  const bool active = in_block && c0 < C;
  const long long r_begin = blockIdx.x * rows_per_split;
  const long long r_end = min(M, r_begin + rows_per_split);

  float a[VEC], b[VEC], mu[VEC], rs[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = b[j] = 0.f;
    mu[j] = 0.f;
    rs[j] = 0.f;
  }
  if (GRAD && active) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = mean[c0 + j];
      rs[j] = rstd[c0 + j];
    }
  }
  if (active) {
    for (long long r = r_begin + ty; r < r_end; r += sh.ty) {
      float v[VEC];
      load_vec<TX, VEC>(x + r * C + c0, v);
      if constexpr (GRAD) {
        float d[VEC];
        load_vec<TD, VEC>(dy + r * C + c0, d);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          a[j] += d[j];
          b[j] += d[j] * ((v[j] - mu[j]) * rs[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          a[j] += v[j];
          b[j] += v[j] * v[j];
        }
      }
    }
  }
  if (in_block) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[0][ty * width + tx * VEC + j] = a[j];
      red[1][ty * width + tx * VEC + j] = b[j];
    }
  }
  __syncthreads();
  float* out = ws + blockIdx.x * 2LL * C;
  for (int col = threadIdx.x; col < width; col += kThreads) {
    const int c = blockIdx.y * width + col;
    if (c >= C) continue;
    float s0 = 0.f, s1 = 0.f;
    for (int t = 0; t < sh.ty; ++t) {  // a fixed order: deterministic
      s0 += red[0][t * width + col];
      s1 += red[1][t * width + col];
    }
    out[c] = s0;
    out[C + c] = s1;
  }
}

// Pass 2: out[k][c] = sum over s of ws[s][k][c]. A block owns 32 channels;
// warp g adds the splits g, g + 8, ..., then warp 0 adds the 8 sums in order.
__global__ void __launch_bounds__(kThreads)
    bn_finalize_kernel(const float* __restrict__ ws, float* __restrict__ out,
                       int splits, int C) {
  __shared__ float red[2][kFinalGroups][32];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float s0 = 0.f, s1 = 0.f;
  if (c < C) {
    for (int s = g; s < splits; s += kFinalGroups) {
      s0 += ws[s * 2LL * C + c];
      s1 += ws[s * 2LL * C + C + c];
    }
  }
  red[0][g][lane] = s0;
  red[1][g][lane] = s1;
  __syncthreads();
  if (g == 0 && c < C) {
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int k = 0; k < kFinalGroups; ++k) {
      t0 += red[0][k][lane];
      t1 += red[1][k][lane];
    }
    out[c] = t0;
    out[C + c] = t1;
  }
}

template <typename TX, typename TD, int VEC, bool GRAD>
cudaError_t run(const void* x, const void* dy, const void* mean,
                const void* rstd, void* ws, void* out, long long M, int C,
                int splits, cudaStream_t stream) {
  const Shape sh = block_shape(C, VEC);
  const int col_tiles = ((C + VEC - 1) / VEC + sh.tx - 1) / sh.tx;
  const long long rows_per_split = (M + splits - 1) / splits;
  const dim3 grid(splits, col_tiles);
  bn_partial_kernel<TX, TD, VEC, GRAD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<float*>(ws), M, C, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finalize_kernel<<<(C + 31) / 32, kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), splits, C);
  return cudaGetLastError();
}

template <typename TX, typename TD, bool GRAD>
cudaError_t run_vec(const void* x, const void* dy, const void* mean,
                    const void* rstd, void* ws, void* out, long long M, int C,
                    int vec, int splits, cudaStream_t stream) {
  if (vec == 8)
    return run<TX, TD, 8, GRAD>(x, dy, mean, rstd, ws, out, M, C, splits,
                                stream);
  if (vec == 1)
    return run<TX, TD, 1, GRAD>(x, dy, mean, rstd, ws, out, M, C, splits,
                                stream);
  return cudaErrorInvalidValue;
}

}  // namespace hvdbn

// dtype: 0 = bfloat16, 1 = float32. vec: 8 (C % 8 == 0 and 16-byte aligned
// bases) or 1. ws: f32 [splits, 2, C] scratch; out: f32 [2, C]. Returns the
// cudaError_t of the launches.
extern "C" int hvd_bn_stats(const void* x, int x_dtype, void* ws, void* out,
                            long long M, int C, int vec, int splits,
                            void* stream) {
  using namespace hvdbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return run_vec<bf16, bf16, false>(x, nullptr, nullptr, nullptr, ws, out,
                                      M, C, vec, splits, st);
  if (x_dtype == 1)
    return run_vec<float, float, false>(x, nullptr, nullptr, nullptr, ws,
                                        out, M, C, vec, splits, st);
  return cudaErrorInvalidValue;
}

// mean, rstd: f32 [C]. dy and x may differ in dtype (f32 dy with bf16 x).
extern "C" int hvd_bn_grad_stats(const void* dy, int dy_dtype, const void* x,
                                 int x_dtype, const void* mean,
                                 const void* rstd, void* ws, void* out,
                                 long long M, int C, int vec, int splits,
                                 void* stream) {
  using namespace hvdbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((x_dtype | dy_dtype) & ~1) return cudaErrorInvalidValue;
  switch (x_dtype * 2 + dy_dtype) {
    case 0:
      return run_vec<bf16, bf16, true>(x, dy, mean, rstd, ws, out, M, C, vec,
                                       splits, st);
    case 1:
      return run_vec<bf16, float, true>(x, dy, mean, rstd, ws, out, M, C,
                                        vec, splits, st);
    case 2:
      return run_vec<float, bf16, true>(x, dy, mean, rstd, ws, out, M, C,
                                        vec, splits, st);
    case 3:
      return run_vec<float, float, true>(x, dy, mean, rstd, ws, out, M, C,
                                         vec, splits, st);
    default:
      return cudaErrorInvalidValue;
  }
}
