// BatchNorm kernels: the statistics (K7, K8) and the normalize and dx passes.
//
// Replaces: horovod_tpu/ops/batch_norm.py:_stats_kernel (K7, launched by
// batch_norm_stats) and :_grad_stats_kernel (K8, launched by
// batch_norm_grad_stats), and the elementwise passes that the JAX package
// leaves to XLA: the normalize of _bn_train_fwd (:211) and _lean_fwd
// (:363-365) and the dx of _bn_train_bwd (:237-241) and _lean_bwd
// (:381-409). Over a row-major (M, C) activation, the channels last and
// contiguous, whose rows split into G ghost groups of M / G contiguous rows
// (G = 1: one group, plain BN):
//   K7: per (group, channel) (sum x, sum x^2);
//   K8: per (group, channel) (sum dy, sum dy * x_hat), i.e. (dbeta, dgamma),
//       where x_hat = (x - mean) * rstd and, with the ReLU mask, dy counts
//       only where the pre-activation x_hat * gamma + beta is > 0;
//   bn_apply: y = x * a + b per (group, channel), optionally max(y, 0);
//   bn_dx: dx = k * (dy - c1 - x_hat * c2) [+ c3 + c4 * (x - mean)], dy
//       masked as in K8, with k = gamma * rstd, c1 = dbeta / count,
//       c2 = dgamma / count and the mean and var cotangent terms c3, c4.
// The per-(group, channel) terms come from the caller in f32, computed there
// with the same torch expressions as the plain versions; each kernel rounds
// them to RT as it loads them (the lean formulas' .astype(dtype)).
//
// Arithmetic. Two modes, each the op-for-op image of one Python formula:
// "pallas" (RT = float) computes in f32 and rounds once to x's dtype at the
// end (_FusedBatchNormFn); "lean" (RT = x's dtype) rounds every product and
// sum to x's dtype, as the lean path's bf16 ops do (_lean_fwd, _lean_bwd).
// Each operation is its own correctly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn: never contracted into an FMA), then rounded to RT,
// so the two passes equal their plain versions bit for bit. The statistics'
// sums may contract: they are held to a tolerance, in another order anyway.
//
// Bound on the H100: bytes. The passes do 2 to 12 operations per element,
// far below the card's 295 operations per byte: at the ResNet-50 stem
// (M = 256 * 112 * 112, C = 64, bf16) one read of x is 411 MB, 0.123 ms at
// 3.35 TB/s; K7 reads x, K8 x and dy, bn_apply reads x and writes y (0.245
// ms), bn_dx reads x and dy and writes dx (0.368 ms).
//
// Design. A block is 256 threads laid out as tx threads along C, each owning
// VEC = 8 neighbouring channels (one 16-byte load of bf16, two of f32),
// times ty = 256 / tx threads along M: at C = 64 a warp covers four 128-byte
// rows, at C >= 2048 the block spans one row. Blocks split the rows of each
// group (grid.x = groups * splits, so no block straddles a group and each
// thread loads its group's per-channel terms once) and the channels among
// column tiles (grid.y). Each thread strides over its block's rows.
// Statistics: f32 accumulators in registers; the ty partial sums meet in
// shared memory and are added in a fixed order, and the block writes its
// (2, C-tile) partials to the workspace [groups * splits, 2, C]; a second
// launch adds each group's splits per channel, again in a fixed order. No
// float atomics: the same input gives bit-identical statistics on every run
// and on every rank. Passes: each thread loads kUnroll rows before it
// computes and stores them, to keep loads in flight. Both ragged tails are
// masked: rows past a group's end by the loop bound, channels past C by the
// column test (VEC = 1 when C is not a multiple of 8 or a base is not 16-byte
// aligned).
// Not yet done (later work): TMA or cp.async staging, a last-block
// reduction instead of the statistics' second launch, the per-channel terms
// computed on the device instead of by small torch ops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hvd_error.cuh"

namespace hvdbn {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kFinalGroups = kThreads / 32;  // pass 2: 8 warps of 32 channels
constexpr int kApplyUnroll = 4;              // rows in flight per thread
constexpr int kDxUnroll = 2;
// bn_dx's per-(group, channel) terms, planes of a pointer array
enum Term { kMean, kRstd, kScale, kC1, kC2, kGamma, kBeta, kC3, kC4, kTerms };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to RT and back: the result of one operation in RT's arithmetic
template <typename RT>
__device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<RT>(v));
}

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

// VEC f32 values rounded to T and stored at p, as load_vec reads them.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(v[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < VEC / kPer; ++i) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) e[j] = from_float<T>(v[i * kPer + j]);
      reinterpret_cast<uint4*>(p)[i] = raw;
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

// The rows [begin, end) of this block: split s of group g, each group Mg
// rows, each split rows_per_split of them.
struct Rows {
  int g;
  long long begin, end;
};

__device__ __forceinline__ Rows block_rows(long long Mg, int splits,
                                           long long rows_per_split) {
  const int g = blockIdx.x / splits, s = blockIdx.x % splits;
  const long long group_end = (g + 1) * Mg;
  const long long begin = g * Mg + s * rows_per_split;
  return {g, begin, min(group_end, begin + rows_per_split)};
}

// The pre-activation x_hat * gamma + beta in RT (_lean_bwd:385): the ReLU
// mask is pre > 0. It recomputes the sign of the forward's x * a + b, which
// may differ from it where that is 0; the reference takes this one.
template <typename RT>
__device__ __forceinline__ float pre_of(float xh, float ga, float be) {
  return rnd<RT>(__fadd_rn(rnd<RT>(__fmul_rn(xh, ga)), be));
}

// x - mean, x_hat = (x - mean) * rstd and the dy that counts (0 where the
// ReLU mask is off), each operation rounded to RT: _bn_train_bwd's
// arithmetic (RT = float) or _lean_bwd:381-386's (RT = x's dtype).
template <typename RT, bool MASK>
__device__ __forceinline__ void masked(float x, float dy, float mu, float rs,
                                       float ga, float be, float& xm,
                                       float& xh, float& d) {
  xm = rnd<RT>(__fsub_rn(x, mu));
  xh = rnd<RT>(__fmul_rn(xm, rs));
  d = rnd<RT>(dy);
  if (MASK && !(pre_of<RT>(xh, ga, be) > 0.f)) d = 0.f;
}

// Statistics, pass 1. GRAD = false: K7 on x (dy and the terms unused).
// GRAD = true: K8; gamma and beta non-null select the ReLU mask.
template <typename TX, typename TD, typename RT, int VEC, bool GRAD>
__global__ void __launch_bounds__(kThreads)
    bn_partial_kernel(const TX* __restrict__ x, const TD* __restrict__ dy,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ ws,
                      long long Mg, int C, int splits,
                      long long rows_per_split) {
  __shared__ float red[2][kThreads * VEC];
  const Shape sh = block_shape(C, VEC);
  const int width = sh.tx * VEC;  // channels of this block's tile
  const int tx = threadIdx.x % sh.tx, ty = threadIdx.x / sh.tx;
  const int c0 = blockIdx.y * width + tx * VEC;
  const bool in_block = ty < sh.ty;
  const bool active = in_block && c0 < C;
  const Rows rows = block_rows(Mg, splits, rows_per_split);
  const bool mask = GRAD && gamma != nullptr;

  float a[VEC], b[VEC], mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = b[j] = 0.f;
    mu[j] = rs[j] = ga[j] = be[j] = 0.f;
  }
  if (GRAD && active) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = rnd<RT>(mean[rows.g * C + c0 + j]);
      rs[j] = rnd<RT>(rstd[rows.g * C + c0 + j]);
      if (mask) {
        ga[j] = rnd<RT>(gamma[rows.g * C + c0 + j]);
        be[j] = rnd<RT>(beta[rows.g * C + c0 + j]);
      }
    }
  }
  if (active) {
    for (long long r = rows.begin + ty; r < rows.end; r += sh.ty) {
      float v[VEC];
      load_vec<TX, VEC>(x + r * C + c0, v);
      if constexpr (GRAD) {
        float d[VEC];
        load_vec<TD, VEC>(dy + r * C + c0, d);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float xm, xh, dm;
          masked<RT, false>(v[j], d[j], mu[j], rs[j], 0.f, 0.f, xm, xh, dm);
          if (mask && !(pre_of<RT>(xh, ga[j], be[j]) > 0.f)) dm = 0.f;
          a[j] += dm;
          b[j] += dm * xh;
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

// Statistics, pass 2: out[g][k][c] = sum over s of ws[g * splits + s][k][c].
// Block (x, g) owns 32 channels of group g; warp w adds the splits w, w + 8,
// ..., then warp 0 adds the 8 sums in order.
__global__ void __launch_bounds__(kThreads)
    bn_finalize_kernel(const float* __restrict__ ws, float* __restrict__ out,
                       int splits, int C) {
  __shared__ float red[2][kFinalGroups][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const float* part = ws + blockIdx.y * (long long)splits * 2 * C;
  float s0 = 0.f, s1 = 0.f;
  if (c < C) {
    for (int s = w; s < splits; s += kFinalGroups) {
      s0 += part[s * 2LL * C + c];
      s1 += part[s * 2LL * C + C + c];
    }
  }
  red[0][w][lane] = s0;
  red[1][w][lane] = s1;
  __syncthreads();
  if (w == 0 && c < C) {
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int k = 0; k < kFinalGroups; ++k) {
      t0 += red[0][k][lane];
      t1 += red[1][k][lane];
    }
    out[blockIdx.y * 2LL * C + c] = t0;
    out[blockIdx.y * 2LL * C + C + c] = t1;
  }
}

// bn_apply: y = x * a + b in RT (then x's dtype), max(y, 0) with RELU. a, b:
// f32 [G, C], rounded to RT here.
template <typename TX, typename RT, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, TX* __restrict__ y,
                    long long Mg, int C, int splits, long long rows_per_split) {
  const Shape sh = block_shape(C, VEC);
  const int tx = threadIdx.x % sh.tx, ty = threadIdx.x / sh.tx;
  const int c0 = blockIdx.y * sh.tx * VEC + tx * VEC;
  if (ty >= sh.ty || c0 >= C) return;
  const Rows rows = block_rows(Mg, splits, rows_per_split);
  float a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = rnd<RT>(scale[rows.g * C + c0 + j]);
    b[j] = rnd<RT>(shift[rows.g * C + c0 + j]);
  }
  for (long long r = rows.begin + ty; r < rows.end;
       r += kApplyUnroll * sh.ty) {
    float v[kApplyUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru < rows.end) load_vec<TX, VEC>(x + ru * C + c0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru >= rows.end) continue;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float t = rnd<RT>(__fadd_rn(rnd<RT>(__fmul_rn(v[u][j], a[j])), b[j]));
        if (RELU) t = t < 0.f ? 0.f : t;  // NaN stays NaN, as torch.relu
        o[j] = t;
      }
      store_vec<TX, VEC>(y + ru * C + c0, o);
    }
  }
}

// The kTerms planes of bn_dx's terms, each f32 [G, C] (null when unused),
// rounded to RT as they are loaded.
struct Terms {
  const float* p[kTerms];
};

// bn_dx: dx = k * (dy - c1 - x_hat * c2), dy masked with RELU; with EXTRA
// + c3 + c4 * (x - mean). Every operation rounded to RT, then to x's dtype.
template <typename TX, typename TD, typename RT, int VEC, bool RELU,
          bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    bn_dx_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                 const Terms terms, TX* __restrict__ dx, long long Mg, int C,
                 int splits, long long rows_per_split) {
  const Shape sh = block_shape(C, VEC);
  const int tx = threadIdx.x % sh.tx, ty = threadIdx.x / sh.tx;
  const int c0 = blockIdx.y * sh.tx * VEC + tx * VEC;
  if (ty >= sh.ty || c0 >= C) return;
  const Rows rows = block_rows(Mg, splits, rows_per_split);
  const int at = rows.g * C + c0;
  float mu[VEC], rs[VEC], k[VEC], c1[VEC], c2[VEC], ga[VEC], be[VEC],
      c3[VEC], c4[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = rnd<RT>(terms.p[kMean][at + j]);
    rs[j] = rnd<RT>(terms.p[kRstd][at + j]);
    k[j] = rnd<RT>(terms.p[kScale][at + j]);
    c1[j] = rnd<RT>(terms.p[kC1][at + j]);
    c2[j] = rnd<RT>(terms.p[kC2][at + j]);
    ga[j] = RELU ? rnd<RT>(terms.p[kGamma][at + j]) : 0.f;
    be[j] = RELU ? rnd<RT>(terms.p[kBeta][at + j]) : 0.f;
    c3[j] = EXTRA ? rnd<RT>(terms.p[kC3][at + j]) : 0.f;
    c4[j] = EXTRA ? rnd<RT>(terms.p[kC4][at + j]) : 0.f;
  }
  for (long long r = rows.begin + ty; r < rows.end; r += kDxUnroll * sh.ty) {
    float v[kDxUnroll][VEC], d[kDxUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru < rows.end) {
        load_vec<TX, VEC>(x + ru * C + c0, v[u]);
        load_vec<TD, VEC>(dy + ru * C + c0, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDxUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru >= rows.end) continue;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float xm, xh, g;
        masked<RT, RELU>(v[u][j], d[u][j], mu[j], rs[j], ga[j], be[j], xm, xh,
                         g);
        const float t1 = rnd<RT>(__fsub_rn(g, c1[j]));
        const float t2 = rnd<RT>(__fmul_rn(xh, c2[j]));
        float t = rnd<RT>(__fmul_rn(k[j], rnd<RT>(__fsub_rn(t1, t2))));
        if (EXTRA) {
          t = rnd<RT>(__fadd_rn(t, c3[j]));
          t = rnd<RT>(__fadd_rn(t, rnd<RT>(__fmul_rn(c4[j], xm))));
        }
        o[j] = t;
      }
      store_vec<TX, VEC>(dx + ru * C + c0, o);
    }
  }
}

// ---------------------------------------------------------------- dispatch

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<bf16>) or f(Tag<float>) for dtype codes 0 and 1
template <typename F>
cudaError_t by_dtype(int code, F&& f) {
  if (code == 0) return f(Tag<bf16>{});
  if (code == 1) return f(Tag<float>{});
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t by_vec(int vec, F&& f) {
  if (vec == 8) return f(std::integral_constant<int, 8>{});
  if (vec == 1) return f(std::integral_constant<int, 1>{});
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t by_flag(int flag, F&& f) {
  return flag ? f(std::true_type{}) : f(std::false_type{});
}

// (grid, rows per split) of a sweep over G groups of Mg rows
inline dim3 grid_of(long long Mg, int C, int vec, int groups, int splits,
                    long long* rows_per_split) {
  const Shape sh = block_shape(C, vec);
  const int col_tiles = ((C + vec - 1) / vec + sh.tx - 1) / sh.tx;
  *rows_per_split = (Mg + splits - 1) / splits;
  return dim3(groups * splits, col_tiles);
}

template <typename TX, typename TD, typename RT, int VEC, bool GRAD>
cudaError_t run_stats(const void* x, const void* dy, const void* mean,
                      const void* rstd, const void* gamma, const void* beta,
                      void* ws, void* out, long long M, int C, int groups,
                      int splits, cudaStream_t stream) {
  const long long Mg = M / groups;
  long long rows_per_split;
  const dim3 grid = grid_of(Mg, C, VEC, groups, splits, &rows_per_split);
  bn_partial_kernel<TX, TD, RT, VEC, GRAD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(ws), Mg, C, splits, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finalize_kernel<<<dim3((C + 31) / 32, groups), kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), splits, C);
  return cudaGetLastError();
}

}  // namespace hvdbn

// dtype: 0 = bfloat16, 1 = float32. M rows in `groups` groups of M / groups
// (the caller checks that groups divides M). vec: 8 (C % 8 == 0 and 16-byte
// aligned bases) or 1. splits: blocks per group. Each entry returns the
// cudaError_t of its launches.

// K7. ws: f32 [groups * splits, 2, C] scratch; out: f32 [groups, 2, C].
extern "C" int hvd_bn_stats(const void* x, int x_dtype, void* ws, void* out,
                            long long M, int C, int groups, int vec,
                            int splits, void* stream) {
  using namespace hvdbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_vec(vec, [&](auto v) {
      return run_stats<TX, TX, float, decltype(v)::value, false>(
          x, nullptr, nullptr, nullptr, nullptr, nullptr, ws, out, M, C,
          groups, splits, st);
    });
  });
}

// K8. mean, rstd: f32 [groups, C]; gamma, beta: f32 [groups, C] for the ReLU
// mask, or both null. lean: 1 rounds the terms, x_hat and the pre-activation
// to x's dtype. dy and x may differ in dtype (f32 dy with bf16 x).
extern "C" int hvd_bn_grad_stats(const void* dy, int dy_dtype, const void* x,
                                 int x_dtype, const void* mean,
                                 const void* rstd, const void* gamma,
                                 const void* beta, int lean, void* ws,
                                 void* out, long long M, int C, int groups,
                                 int vec, int splits, void* stream) {
  using namespace hvdbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((gamma == nullptr) != (beta == nullptr)) return cudaErrorInvalidValue;
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_dtype(dy_dtype, [&](auto td) {
      using TD = typename decltype(td)::type;
      return by_flag(lean, [&](auto l) {
        using RT = std::conditional_t<decltype(l)::value, TX, float>;
        return by_vec(vec, [&](auto v) {
          return run_stats<TX, TD, RT, decltype(v)::value, true>(
              x, dy, mean, rstd, gamma, beta, ws, out, M, C, groups, splits,
              st);
        });
      });
    });
  });
}

// bn_apply. y: [M, C] in x's dtype; a, b: f32 [groups, C].
extern "C" int hvd_bn_apply(void* y, const void* x, int x_dtype,
                            const void* a, const void* b, int lean, int relu,
                            long long M, int C, int groups, int vec,
                            int splits, void* stream) {
  using namespace hvdbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long Mg = M / groups;
  long long rows_per_split;
  const dim3 grid = grid_of(Mg, C, vec, groups, splits, &rows_per_split);
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_flag(lean, [&](auto l) {
      using RT = std::conditional_t<decltype(l)::value, TX, float>;
      return by_vec(vec, [&](auto v) {
        return by_flag(relu, [&](auto r) {
          bn_apply_kernel<TX, RT, decltype(v)::value, decltype(r)::value>
              <<<grid, kThreads, 0, st>>>(
                  static_cast<const TX*>(x), static_cast<const float*>(a),
                  static_cast<const float*>(b), static_cast<TX*>(y), Mg, C,
                  splits, rows_per_split);
          return cudaGetLastError();
        });
      });
    });
  });
}

// bn_dx. dx: [M, C] in x's dtype; terms: a host array of 9 device
// pointers, each f32 [groups, C]: mean, rstd, k, c1, c2, gamma, beta (read
// with relu), c3, c4 (read with extra).
extern "C" int hvd_bn_dx(void* dx, const void* dy, int dy_dtype,
                         const void* x, int x_dtype, const void* const* terms,
                         int lean, int relu, int extra, long long M, int C,
                         int groups, int vec, int splits, void* stream) {
  using namespace hvdbn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Terms t;
  for (int i = 0; i < kTerms; ++i) {
    t.p[i] = static_cast<const float*>(terms[i]);
    const bool used = i < kGamma || (i < kC3 ? relu : extra);
    if (used && t.p[i] == nullptr) return cudaErrorInvalidValue;
  }
  const long long Mg = M / groups;
  long long rows_per_split;
  const dim3 grid = grid_of(Mg, C, vec, groups, splits, &rows_per_split);
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_dtype(dy_dtype, [&](auto td) {
      using TD = typename decltype(td)::type;
      return by_flag(lean, [&](auto l) {
        using RT = std::conditional_t<decltype(l)::value, TX, float>;
        return by_vec(vec, [&](auto v) {
          return by_flag(relu, [&](auto r) {
            return by_flag(extra, [&](auto e) {
              bn_dx_kernel<TX, TD, RT, decltype(v)::value, decltype(r)::value,
                           decltype(e)::value><<<grid, kThreads, 0, st>>>(
                  static_cast<const TD*>(dy), static_cast<const TX*>(x), t,
                  static_cast<TX*>(dx), Mg, C, splits, rows_per_split);
              return cudaGetLastError();
            });
          });
        });
      });
    });
  });
}
