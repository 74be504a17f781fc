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
//   bn_dx: dx = k * (dy - c1 - x_hat * c2) [+ c3] [+ c4 * (x - mean)], dy
//       masked as in K8, with k = gamma * rstd, c1 = dbeta * (1 / count),
//       c2 = dgamma * (1 / count), c3 = gmean * (1 / count) and c4 = gvar *
//       (2 / count), 1 / count and 2 / count f32 scalars from the caller.
// The passes take the raw f32 per-(group, channel) vectors, each with its
// own group and channel strides (a group stride of 0 shares a (C,) vector
// among the groups), and form their terms themselves, once a block, with
// the plain versions' correctly rounded f32 operations; in lean mode each
// term is then rounded to x's dtype (the lean formulas' .astype(dtype)).
//
// Arithmetic. Two modes, each the op-for-op image of one Python formula:
// "pallas" (RT = float) computes in f32 and rounds once to x's dtype at the
// end (_FusedBatchNormFn); "lean" (RT = x's dtype) rounds every product and
// sum to x's dtype, as the lean path's bf16 ops do (_lean_fwd, _lean_bwd).
// Each operation is its own correctly rounded instruction, never contracted
// into an FMA: __fmul_rn, __fadd_rn, __fsub_rn in f32; in bf16 the packed
// add.rn / sub.rn / mul.rn.bf16x2, two channels an instruction. A bf16
// operation rounds the exact result once; the plain version rounds the f32
// result to bf16, which is the same value because f32 carries more than
// twice bf16's 8 significant bits (rounding twice is then innocuous for +,
// -, *). So the two passes equal their plain versions bit for bit. The
// statistics' sums may contract: they are held to a tolerance, in another
// order anyway.
//
// Bound on the H100: bytes. The passes do 2 to 12 operations per element,
// far below the card's 295 operations per byte: at the ResNet-50 stem
// (M = 256 * 112 * 112, C = 64, bf16) one read of x is 411 MB, 0.123 ms at
// 3.35 TB/s; K7 reads x, K8 x and dy, bn_apply reads x and writes y (0.245
// ms), bn_dx reads x and dy and writes dx (0.368 ms).
//
// Design. The statistics: blocks of 256 threads laid out as tx threads along
// C, each owning VEC = 8 neighbouring channels (one 16-byte load of bf16,
// two of f32), times ty = 256 / tx threads along M: at C = 64 a warp covers
// four 128-byte rows, at C >= 2048 the block spans one row. Blocks split the
// rows of each group (grid.x = groups * splits, so no block straddles a
// group) and the channels among column tiles (grid.y). Each thread strides
// over its block's rows with f32 accumulators in registers; the ty partial
// sums meet in shared memory and are added in a fixed order, and the block
// writes its (2, C-tile) partials to the workspace [groups * splits, 2, C];
// a second launch adds each group's splits per channel, again in a fixed
// order. No float atomics: the same input gives bit-identical statistics on
// every run and on every rank.
// The passes: one launch a call. A block is tx * ty threads (tx along C,
// at most 1024 channels a tile, ty = 256 / tx along M).
// Before it walks its rows the block forms its tile's terms into shared
// memory, one channel a thread, each warp reading 32 neighbouring channels
// of a raw vector at once; each thread then reads its VEC channels' terms
// into registers with 16-byte shared loads. The caller's plan gives each
// group `splits` blocks: enough rows a thread (16) to amortise the terms,
// the blocks a whole multiple of the 132 SMs (each SM the same share of
// rows), at least 132 where the rows allow it and at most 1056; the
// splits depend on (M, C, G, VEC) only. Split s of a group takes the
// rows [Mg * s / splits, Mg * (s + 1) / splits). Each thread keeps
// kPassUnroll rows of x (and dy) in flight before it computes and stores
// them (streaming hints, ld.global.cs and st.global.cs, measured no faster
// at the ResNet-50 stem: the loads alone 1-3 % slower). Both ragged tails
// are masked: rows past a split's end by the loop bound, channels past C by
// the column test (VEC = 1 when C is not a multiple of 8 or a base is not
// 16-byte aligned; then each lane pair holds one channel twice).
// Not yet done (later work): TMA or cp.async staging; for the statistics a
// split for short launches as the passes' and a last-block reduction
// instead of their second launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hvd_error.cuh"

namespace hvdbn {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kFinalGroups = kThreads / 32;  // pass 2: 8 warps of 32 channels
// The passes: channels of a block's tile at most (its terms sit in shared
// memory: 9 planes of 1024 f32 values are 36 KB), and rows of x (and dy) in
// flight per thread.
constexpr int kPassTile = 1024;
constexpr int kPassUnroll = 4;
// bn_dx's raw per-(group, channel) f32 inputs, in the order of the caller's
// array
enum DxInput { kMean, kRstd, kGamma, kBeta, kDbeta, kDgamma, kGmean, kGvar,
               kDxInputs };

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

// ------------------------------------------------------------------ passes

typedef __nv_bfloat162 bf162;

__device__ __forceinline__ unsigned bits_of(bf162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ bf162 bf162_of(unsigned u) {
  bf162 v;
  memcpy(&v, &u, sizeof(u));
  return v;
}

// Two channels in RT's arithmetic (P), the correctly rounded operations on
// both lanes, and the conversions from loaded pairs and to f32 lanes.
template <typename RT>
struct Arith;

template <>
struct Arith<float> {
  typedef float2 P;
  static __device__ __forceinline__ P of(float2 v) { return v; }
  static __device__ __forceinline__ P of(bf162 v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ float2 lanes(P v) { return v; }
  static __device__ __forceinline__ P add(P a, P b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  static __device__ __forceinline__ P sub(P a, P b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
  }
  static __device__ __forceinline__ P mul(P a, P b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  // d where pre > 0, else 0 (the ReLU mask)
  static __device__ __forceinline__ P keep(P d, P pre) {
    return make_float2(pre.x > 0.f ? d.x : 0.f, pre.y > 0.f ? d.y : 0.f);
  }
  // max(t, 0); NaN stays NaN, as torch.relu
  static __device__ __forceinline__ P relu(P t) {
    return make_float2(t.x < 0.f ? 0.f : t.x, t.y < 0.f ? 0.f : t.y);
  }
};

#define HVD_BF16X2_OP(name, op)                                           \
  static __device__ __forceinline__ P name(P a, P b) {                    \
    unsigned d;                                                           \
    asm(op ".rn.bf16x2 %0, %1, %2;"                                       \
        : "=r"(d)                                                         \
        : "r"(bits_of(a)), "r"(bits_of(b)));                              \
    return bf162_of(d);                                                   \
  }

template <>
struct Arith<bf16> {
  typedef bf162 P;
  static __device__ __forceinline__ P of(float2 v) {
    return __floats2bfloat162_rn(v.x, v.y);
  }
  static __device__ __forceinline__ P of(bf162 v) { return v; }
  static __device__ __forceinline__ float2 lanes(P v) {
    return __bfloat1622float2(v);
  }
  HVD_BF16X2_OP(add, "add")
  HVD_BF16X2_OP(sub, "sub")
  HVD_BF16X2_OP(mul, "mul")
  static __device__ __forceinline__ P keep(P d, P pre) {
    const float2 p = lanes(pre);
    return bf162_of(bits_of(d) & ((p.x > 0.f ? 0xFFFFu : 0u) |
                                  (p.y > 0.f ? 0xFFFF0000u : 0u)));
  }
  static __device__ __forceinline__ P relu(P t) {
    const float2 v = lanes(t);
    return bf162_of(bits_of(t) & ((v.x < 0.f ? 0u : 0xFFFFu) |
                                  (v.y < 0.f ? 0u : 0xFFFF0000u)));
  }
};
#undef HVD_BF16X2_OP

// lane pairs of VEC channels (VEC = 1: one pair, the channel twice)
template <int VEC>
__host__ __device__ constexpr int pairs_of_vec() {
  return VEC == 1 ? 1 : VEC / 2;
}

// VEC elements of T as loaded: whole 16-byte words, or one element
template <typename T, int VEC>
struct Raw {
  uint4 w[VEC * sizeof(T) / 16];
};
template <typename T>
struct Raw<T, 1> {
  T e;
};

// VEC elements at p (global or shared memory)
template <typename T, int VEC>
__device__ __forceinline__ void load_raw(const T* p, Raw<T, VEC>& r) {
  if constexpr (VEC == 1) {
    r.e = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC * (int)sizeof(T) / 16; ++i)
      r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  }
}

// The raw elements as pairs in RT's arithmetic (rounded to RT: exact unless
// f32 dy meets bf16 arithmetic, where it is the plain version's .to(dtype))
template <typename RT, typename T, int VEC>
__device__ __forceinline__ void to_pairs(
    const Raw<T, VEC>& r,
    typename Arith<RT>::P (&v)[pairs_of_vec<VEC>()]) {
  using A = Arith<RT>;
  if constexpr (VEC == 1) {
    const float f = to_float(r.e);
    v[0] = A::of(make_float2(f, f));
  } else if constexpr (std::is_same<T, bf16>::value) {
    const bf162* e = reinterpret_cast<const bf162*>(r.w);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) v[j] = A::of(e[j]);
  } else {
    const float2* e = reinterpret_cast<const float2*>(r.w);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) v[j] = A::of(e[j]);
  }
}

// VEC channels' pairs rounded to T (x's dtype) and stored at p
template <typename T, typename RT, int VEC>
__device__ __forceinline__ void store_pairs(
    T* p, const typename Arith<RT>::P (&v)[pairs_of_vec<VEC>()]) {
  using A = Arith<RT>;
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(A::lanes(v[0]).x);
  } else {
    Raw<T, VEC> r;
    if constexpr (std::is_same<T, bf16>::value) {
      bf162* e = reinterpret_cast<bf162*>(r.w);
#pragma unroll
      for (int j = 0; j < VEC / 2; ++j) e[j] = Arith<bf16>::of(v[j]);
    } else {
      float2* e = reinterpret_cast<float2*>(r.w);
#pragma unroll
      for (int j = 0; j < VEC / 2; ++j) e[j] = A::lanes(v[j]);
    }
#pragma unroll
    for (int i = 0; i < VEC * (int)sizeof(T) / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = r.w[i];
  }
}

// A raw per-(group, channel) f32 input of the passes: (g, c) at
// p[g * gs + c * cs]; p is null for an input not given.
struct Term {
  const float* p;
  long long gs, cs;
};

__device__ __forceinline__ float value(const Term& t, int g, int c) {
  return __ldg(t.p + g * t.gs + c * t.cs);
}

// bn_dx's inputs and the caller's 1 / count and 2 / count in f32
struct DxInputs {
  Term t[kDxInputs];
  float inv, two;
};

// tx threads along C (VEC channels each, at most kPassTile channels) by ty
// along M: a pass block is tx * ty threads.
__host__ __device__ inline Shape pass_shape(int C, int vec) {
  const int tc = (C + vec - 1) / vec;
  const int most = kPassTile / vec < kThreads ? kPassTile / vec : kThreads;
  const int tx = tc < most ? tc : most;
  return {tx, kThreads / tx};
}

// The rows of split s of group g: [Mg * s / splits, Mg * (s + 1) / splits)
// of the group, every row of the group in exactly one split.
__device__ __forceinline__ Rows pass_rows(long long Mg, int splits) {
  const int g = blockIdx.x / splits, s = blockIdx.x % splits;
  const long long begin = g * Mg + Mg * s / splits;
  long long end = g * Mg + Mg * (s + 1) / splits;
  return {g, begin, end};
}

// A thread's VEC channels of one term plane in shared memory, as pairs
template <typename RT, int VEC>
__device__ __forceinline__ void term_pairs(
    const RT* s, typename Arith<RT>::P (&v)[pairs_of_vec<VEC>()]) {
  Raw<RT, VEC> r;
  load_raw(s, r);
  to_pairs<RT, RT, VEC>(r, v);
}

// bn_apply: y = x * a + b in RT (then x's dtype), max(y, 0) with RELU. The
// block's tile of a and b, rounded to RT, in shared memory: 2 planes.
template <typename TX, typename RT, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const TX* __restrict__ x, const Term a, const Term b,
                    TX* __restrict__ y, long long Mg, int C, int splits) {
  using A = Arith<RT>;
  using P = typename A::P;
  constexpr int NP = pairs_of_vec<VEC>();
  extern __shared__ __align__(16) unsigned char smem[];
  RT* s = reinterpret_cast<RT*>(smem);
  const Shape sh = pass_shape(C, VEC);
  const int width = sh.tx * VEC, cb = blockIdx.y * width;
  const Rows rows = pass_rows(Mg, splits);
  for (int i = threadIdx.x; i < width && cb + i < C; i += blockDim.x) {
    const int c = cb + i;
    s[i] = from_float<RT>(value(a, rows.g, c));
    s[width + i] = from_float<RT>(value(b, rows.g, c));
  }
  __syncthreads();
  const int tx = threadIdx.x % sh.tx, ty = threadIdx.x / sh.tx;
  const int c0 = cb + tx * VEC;
  if (c0 >= C) return;
  P va[NP], vb[NP];
  term_pairs<RT, VEC>(s + tx * VEC, va);
  term_pairs<RT, VEC>(s + width + tx * VEC, vb);
  for (long long r = rows.begin + ty; r < rows.end;
       r += kPassUnroll * sh.ty) {
    Raw<TX, VEC> in[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru < rows.end) load_raw(x + ru * C + c0, in[u]);
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru >= rows.end) continue;
      P v[NP];
      to_pairs<RT>(in[u], v);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        P t = A::add(A::mul(v[j], va[j]), vb[j]);
        if (RELU) t = A::relu(t);
        v[j] = t;
      }
      store_pairs<TX, RT, VEC>(y + ru * C + c0, v);
    }
  }
}

// bn_dx: dx = k * (dy - c1 - x_hat * c2), dy masked with RELU; with EXTRA
// + c3 (gmean given) + c4 * (x - mean) (gvar given). Every operation
// rounded to RT, then to x's dtype. The block's tile of terms, each the
// plain version's f32 expression rounded to RT, in shared memory: mu, rs,
// k, c1, c2, then ga, be with RELU, then c3, c4 with EXTRA.
template <typename TX, typename TD, typename RT, int VEC, bool RELU,
          bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    bn_dx_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                 const DxInputs in, TX* __restrict__ dx, long long Mg, int C,
                 int splits) {
  using A = Arith<RT>;
  using P = typename A::P;
  constexpr int NP = pairs_of_vec<VEC>();
  constexpr int kGa = 5, kBe = 6, kC3 = 5 + 2 * RELU, kC4 = kC3 + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  RT* s = reinterpret_cast<RT*>(smem);
  const Shape sh = pass_shape(C, VEC);
  const int width = sh.tx * VEC, cb = blockIdx.y * width;
  const Rows rows = pass_rows(Mg, splits);
  const bool with_c3 = EXTRA && in.t[kGmean].p != nullptr;
  const bool with_c4 = EXTRA && in.t[kGvar].p != nullptr;
  for (int i = threadIdx.x; i < width && cb + i < C; i += blockDim.x) {
    const int c = cb + i, g = rows.g;
    const float rs = value(in.t[kRstd], g, c);
    const float ga = value(in.t[kGamma], g, c);
    RT* col = s + i;
    col[0] = from_float<RT>(value(in.t[kMean], g, c));
    col[width] = from_float<RT>(rs);
    col[2 * width] = from_float<RT>(__fmul_rn(ga, rs));
    col[3 * width] =
        from_float<RT>(__fmul_rn(value(in.t[kDbeta], g, c), in.inv));
    col[4 * width] =
        from_float<RT>(__fmul_rn(value(in.t[kDgamma], g, c), in.inv));
    if (RELU) {
      col[kGa * width] = from_float<RT>(ga);
      col[kBe * width] = from_float<RT>(value(in.t[kBeta], g, c));
    }
    if (EXTRA) {
      col[kC3 * width] = from_float<RT>(
          with_c3 ? __fmul_rn(value(in.t[kGmean], g, c), in.inv) : 0.f);
      col[kC4 * width] = from_float<RT>(
          with_c4 ? __fmul_rn(value(in.t[kGvar], g, c), in.two) : 0.f);
    }
  }
  __syncthreads();
  const int tx = threadIdx.x % sh.tx, ty = threadIdx.x / sh.tx;
  const int c0 = cb + tx * VEC;
  if (c0 >= C) return;
  const RT* mine = s + tx * VEC;
  P mu[NP], rs[NP], k[NP], c1[NP], c2[NP], ga[NP], be[NP], c3[NP], c4[NP];
  term_pairs<RT, VEC>(mine, mu);
  term_pairs<RT, VEC>(mine + width, rs);
  term_pairs<RT, VEC>(mine + 2 * width, k);
  term_pairs<RT, VEC>(mine + 3 * width, c1);
  term_pairs<RT, VEC>(mine + 4 * width, c2);
  if (RELU) {
    term_pairs<RT, VEC>(mine + kGa * width, ga);
    term_pairs<RT, VEC>(mine + kBe * width, be);
  }
  if (EXTRA) {
    term_pairs<RT, VEC>(mine + kC3 * width, c3);
    term_pairs<RT, VEC>(mine + kC4 * width, c4);
  }
  for (long long r = rows.begin + ty; r < rows.end;
       r += kPassUnroll * sh.ty) {
    Raw<TX, VEC> vx[kPassUnroll];
    Raw<TD, VEC> vd[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru < rows.end) {
        load_raw(x + ru * C + c0, vx[u]);
        load_raw(dy + ru * C + c0, vd[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru >= rows.end) continue;
      P v[NP], d[NP];
      to_pairs<RT>(vx[u], v);
      to_pairs<RT>(vd[u], d);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const P xm = A::sub(v[j], mu[j]);
        const P xh = A::mul(xm, rs[j]);
        P g = d[j];
        if (RELU) g = A::keep(g, A::add(A::mul(xh, ga[j]), be[j]));
        P t = A::mul(k[j], A::sub(A::sub(g, c1[j]), A::mul(xh, c2[j])));
        if (with_c3) t = A::add(t, c3[j]);
        if (with_c4) t = A::add(t, A::mul(c4[j], xm));
        v[j] = t;
      }
      store_pairs<TX, RT, VEC>(dx + ru * C + c0, v);
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

// The passes' launch: grid (groups * splits, column tiles), tx * ty
// threads, `planes` term planes of the tile in RT in shared memory.
struct PassLaunch {
  dim3 grid;
  int threads;
  size_t smem;
};

template <typename RT>
PassLaunch pass_launch(int C, int vec, int groups, int splits, int planes) {
  const Shape sh = pass_shape(C, vec);
  const int col_tiles = ((C + vec - 1) / vec + sh.tx - 1) / sh.tx;
  return {dim3(groups * splits, col_tiles), sh.tx * sh.ty,
          (size_t)planes * sh.tx * vec * sizeof(RT)};
}

// A per-(group, channel) input from the caller's (pointer, group stride,
// channel stride) triple.
inline Term term_of(const long long* v) {
  return {reinterpret_cast<const float*>(v[0]), v[1], v[2]};
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

// The passes take one packed block of 8-byte fields, so that the caller
// makes one call with one argument.

// bn_apply, one launch: y = x * a + b in the mode's arithmetic. p: y, x
// ([M, C], y in x's dtype), x's dtype, lean, relu, M, C, groups, vec,
// splits, stream, then (pointer, group stride, channel stride) of a and of
// b, each f32 (C,) (group stride 0) or [groups, C].
extern "C" int hvd_bn_apply(const long long* p) {
  using namespace hvdbn;
  void* y = reinterpret_cast<void*>(p[0]);
  const void* x = reinterpret_cast<const void*>(p[1]);
  const int x_dtype = p[2], lean = p[3], relu = p[4];
  const long long M = p[5];
  const int C = p[6], groups = p[7], vec = p[8], splits = p[9];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p[10]);
  const Term a = term_of(p + 11), b = term_of(p + 14);
  if (a.p == nullptr || b.p == nullptr) return cudaErrorInvalidValue;
  const long long Mg = M / groups;
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_flag(lean, [&](auto l) {
      using RT = std::conditional_t<decltype(l)::value, TX, float>;
      const PassLaunch pl = pass_launch<RT>(C, vec, groups, splits, 2);
      return by_vec(vec, [&](auto v) {
        return by_flag(relu, [&](auto r) {
          bn_apply_kernel<TX, RT, decltype(v)::value, decltype(r)::value>
              <<<pl.grid, pl.threads, pl.smem, st>>>(
                  static_cast<const TX*>(x), a, b, static_cast<TX*>(y), Mg,
                  C, splits);
          return cudaGetLastError();
        });
      });
    });
  });
}

// bn_dx, one launch. p: dx, dy, dy's dtype, x, x's dtype ([M, C], dx in
// x's dtype), lean, relu, M, C, groups, vec, splits, stream, then the
// kDxInputs (pointer, group stride, channel stride) triples, each f32 (C,)
// or [groups, C]: mean, rstd, gamma, beta (read with relu), dbeta, dgamma,
// gmean, gvar (each null when not given); then 1 / count and 2 / count as
// doubles that hold f32 values.
extern "C" int hvd_bn_dx(const long long* p) {
  using namespace hvdbn;
  void* dx = reinterpret_cast<void*>(p[0]);
  const void* dy = reinterpret_cast<const void*>(p[1]);
  const void* x = reinterpret_cast<const void*>(p[3]);
  const int dy_dtype = p[2], x_dtype = p[4], lean = p[5], relu = p[6];
  const long long M = p[7];
  const int C = p[8], groups = p[9], vec = p[10], splits = p[11];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p[12]);
  DxInputs in;
  for (int i = 0; i < kDxInputs; ++i) in.t[i] = term_of(p + 13 + 3 * i);
  double scales[2];
  memcpy(scales, p + 13 + 3 * kDxInputs, sizeof(scales));
  in.inv = static_cast<float>(scales[0]);
  in.two = static_cast<float>(scales[1]);
  if (!in.t[kMean].p || !in.t[kRstd].p || !in.t[kGamma].p ||
      !in.t[kDbeta].p || !in.t[kDgamma].p || (relu && !in.t[kBeta].p))
    return cudaErrorInvalidValue;
  const int extra = in.t[kGmean].p != nullptr || in.t[kGvar].p != nullptr;
  const long long Mg = M / groups;
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_dtype(dy_dtype, [&](auto td) {
      using TD = typename decltype(td)::type;
      return by_flag(lean, [&](auto l) {
        using RT = std::conditional_t<decltype(l)::value, TX, float>;
        const PassLaunch pl = pass_launch<RT>(C, vec, groups, splits,
                                              5 + 2 * relu + 2 * extra);
        return by_vec(vec, [&](auto v) {
          return by_flag(relu, [&](auto r) {
            return by_flag(extra, [&](auto e) {
              bn_dx_kernel<TX, TD, RT, decltype(v)::value, decltype(r)::value,
                           decltype(e)::value>
                  <<<pl.grid, pl.threads, pl.smem, st>>>(
                      static_cast<const TD*>(dy), static_cast<const TX*>(x),
                      in, static_cast<TX*>(dx), Mg, C, splits);
              return cudaGetLastError();
            });
          });
        });
      });
    });
  });
}
