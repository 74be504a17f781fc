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
//   K7: per (group, channel) (sum x, sum x^2); with the forward's terms
//       also mean = s * inv, var = max(ss * inv - mean^2, 0), rstd =
//       rsqrt(var + eps), a = gamma * rstd and b = beta - mean * a, with
//       inv = 1 / count as an f32 scalar from the caller (_bn_train_fwd
//       :205-209, _lean_fwd :356-360);
//   K8: per (group, channel) (sum dy, sum dy * x_hat), i.e. (dbeta, dgamma),
//       where x_hat = (x - mean) * rstd and, with the ReLU mask, dy counts
//       only where the pre-activation x_hat * gamma + beta is > 0;
//   bn_apply: y = x * a + b per (group, channel), optionally max(y, 0);
//   bn_dx: dx = k * (dy - c1 - x_hat * c2) [+ c3] [+ c4 * (x - mean)], dy
//       masked as in K8, with k = gamma * rstd, c1 = dbeta * (1 / count),
//       c2 = dgamma * (1 / count), c3 = gmean * (1 / count) and c4 = gvar *
//       (2 / count), 1 / count and 2 / count f32 scalars from the caller.
// Every kernel takes its per-(group, channel) f32 inputs raw, each with its
// own group and channel strides (a group stride of 0 shares a (C,) vector
// among the groups), and forms its terms itself with the plain versions'
// correctly rounded f32 operations; in lean mode the passes then round
// each term to x's dtype (the lean formulas' .astype(dtype)).
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
// -, *). So the two passes equal their plain versions bit for bit, and so
// do K7's terms the torch operations on K7's own sums (rsqrtf is the
// rsqrt of ATen's CUDA torch.rsqrt). The statistics' sums are held to a
// tolerance: they add the same f32 values in another order (x * x and
// dy * x_hat each an explicit FMA into the sum).
//
// Bound on the H100: bytes. The kernels do 2 to 12 operations per element,
// far below the card's 295 operations per byte: at the ResNet-50 stem
// (M = 256 * 112 * 112, C = 64, bf16) one read of x is 411 MB, 0.123 ms at
// 3.35 TB/s; K7 reads x, K8 x and dy, bn_apply reads x and writes y (0.245
// ms), bn_dx reads x and dy and writes dx (0.368 ms).
//
// Design. Every kernel is one launch a call, on a grid (G * splits, column
// tiles): split s of group g takes the rows [Mg * s / splits, Mg * (s + 1) /
// splits) of the group, so every row of the group is in exactly one split
// and no block straddles a group. The caller's plan (from (M, C, G, VEC)
// alone) sizes the splits: blocks a whole multiple of the 132 SMs (each SM
// the same share of rows), at least 132 where the rows allow it, enough
// rows a thread to amortise a block's fixed work. A block is tx * ty
// threads, tx along C, each owning VEC = 8 neighbouring channels (one
// 16-byte load of bf16, two of f32; VEC = 1 when C is not a multiple of 8
// or a base is not 16-byte aligned, and then the passes' lane pairs hold
// one channel twice), by ty = 256 / tx along M. Each thread keeps
// kUnroll rows of x (and dy) in flight before it uses them, K7 twice as
// many (streaming hints, ld.global.cs and st.global.cs, measured no faster
// in the passes at the ResNet-50 stem: the loads alone 1-3 % slower). Both
// ragged tails are masked: rows past a split's end by the loop bound,
// channels past C by the column test.
// The statistics: the caller picks tx, at most kStatsTile channels a tile.
// Each thread sums its rows in f32 registers; the ty partial sums meet in
// shared memory and are added in a fixed order, and the block writes its
// (2, tile) sums to the caller's scratch, then takes an integer ticket on
// its (group, tile)'s counter. The block that draws the last ticket adds
// the tile's splits in a fixed order that does not depend on which block
// came last (thread part q adds the splits q, q + Q, ... in float4s, then
// the Q parts are added in order), writes the outputs (and K7's terms) and
// sets the counter back to 0, so the scratch is ready for the next call
// and a call launches no memset. No float atomics: the same input gives
// bit-identical statistics on every run and on every rank. The plan caps
// the blocks at one wave of two an SM (each block at most 128 registers a
// thread), which also keeps the last block's serial read (splits * 2 *
// tile f32 values) small beside the kernel. (A thread block cluster holds
// at most 16 blocks, far fewer than the splits.)
// The passes: a tile of at most kPassTile channels a block. Before it walks
// its rows the block forms its tile's terms into shared memory, one
// channel a thread, each warp reading 32 neighbouring channels of a raw
// vector at once; each thread then reads its VEC channels' terms into
// registers with 16-byte shared loads.
// Not yet done (later work): TMA or cp.async staging of row chunks; for
// the statistics a two-level (or cluster) first stage of the last block's
// reduction, whose serial read grows with the splits (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hvd_error.cuh"

namespace hvdbn {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
// rows of x (and dy) in flight per thread (K7, which reads x alone, keeps
// twice as many)
constexpr int kUnroll = 4;
// The statistics: channels of a block's tile at most (its (2, tile) sums
// meet in shared memory), and the splits' partial sums a thread of the last
// block has in flight.
constexpr int kStatsTile = 128;
constexpr int kFinalBatch = 8;
// The passes: channels of a block's tile at most (its terms sit in shared
// memory: 9 planes of 1024 f32 values are 36 KB).
constexpr int kPassTile = 1024;
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

// tx threads along C (VEC channels each) by ty threads along M.
struct Shape {
  int tx, ty;
};

// The rows [begin, end) of a block of group g.
struct Rows {
  int g;
  long long begin, end;
};

// The pre-activation x_hat * gamma + beta in RT (_lean_bwd:385): the ReLU
// mask is pre > 0. It recomputes the sign of the forward's x * a + b, which
// may differ from it where that is 0; the reference takes this one.
template <typename RT>
__device__ __forceinline__ float pre_of(float xh, float ga, float be) {
  return rnd<RT>(__fadd_rn(rnd<RT>(__fmul_rn(xh, ga)), be));
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

// The rows of split s of group g (block x = g * splits + s): [Mg * s /
// splits, Mg * (s + 1) / splits) of the group, every row of the group in
// exactly one split.
__device__ __forceinline__ Rows split_rows(long long Mg, int splits) {
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
  const Rows rows = split_rows(Mg, splits);
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
       r += kUnroll * sh.ty) {
    Raw<TX, VEC> in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru < rows.end) load_raw(x + ru * C + c0, in[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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
  const Rows rows = split_rows(Mg, splits);
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
       r += kUnroll * sh.ty) {
    Raw<TX, VEC> vx[kUnroll];
    Raw<TD, VEC> vd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * sh.ty;
      if (ru < rows.end) {
        load_raw(x + ru * C + c0, vx[u]);
        load_raw(dy + ru * C + c0, vd[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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

// --------------------------------------------------------------- statistics

// VEC elements as loaded, in f32
template <typename T, int VEC>
__device__ __forceinline__ void floats_of(const Raw<T, VEC>& r,
                                          float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_float(r.e);
  } else {
    const T* e = reinterpret_cast<const T*>(r.w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_float(e[j]);
  }
}

// VEC elements at p in global memory, through the read-only path
template <typename T, int VEC>
__device__ __forceinline__ void ldg_raw(const T* p, Raw<T, VEC>& r) {
  if constexpr (VEC == 1) {
    r.e = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC * (int)sizeof(T) / 16; ++i)
      r.w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
}

// K7's and K8's inputs. x, dy: [G * Mg, C]; mean, rstd (K8): x_hat's
// statistics; gamma, beta: K8's ReLU mask (null p: none) or K7's terms.
// ws: [G * tiles * splits][stride] f32 partial sums, stride = 2 * tile
// rounded up to 4; tickets: [G * tiles] counters, 0 between calls; out: f32
// planes [n][G][C] (K7 (s, ss) or (mean, var, rstd, a, b); K8 (dbeta,
// dgamma)); inv = 1 / count and eps in f32 for K7's terms.
struct StatsParams {
  const void* x;
  const void* dy;
  Term mean, rstd, gamma, beta;
  float* ws;
  unsigned* tickets;
  float* out;
  long long Mg;
  int C, G, tx, splits, stride;
  float inv, eps;
};

// GRAD = false: K7 on x (TERMS: with the forward's terms). GRAD = true: K8,
// x_hat and the mask in RT's arithmetic.
template <typename TX, typename TD, typename RT, int VEC, bool GRAD,
          bool TERMS>
__global__ void __launch_bounds__(kThreads, 2)
    bn_stats_kernel(const StatsParams p) {
  __shared__ float red[2][kThreads * VEC];
  __shared__ float4 part[kThreads];
  __shared__ float tot[2 * kStatsTile];
  __shared__ bool last;
  const int tx_n = p.tx, ty_n = kThreads / tx_n, C = p.C;
  const int width = tx_n * VEC, cb = blockIdx.y * width;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int c0 = cb + tx * VEC;
  const bool in_block = ty < ty_n;
  const bool active = in_block && c0 < C;
  Rows rows = split_rows(p.Mg, p.splits);
  const int g = rows.g;
  const bool mask = GRAD && p.gamma.p != nullptr;

  float s0[VEC], s1[VEC], mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s0[j] = s1[j] = 0.f;
    mu[j] = rs[j] = ga[j] = be[j] = 0.f;
  }
  if (GRAD && active) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = rnd<RT>(value(p.mean, g, c0 + j));
      rs[j] = rnd<RT>(value(p.rstd, g, c0 + j));
      if (mask) {
        ga[j] = rnd<RT>(value(p.gamma, g, c0 + j));
        be[j] = rnd<RT>(value(p.beta, g, c0 + j));
      }
    }
  }
  if (active) {
    const TX* x = static_cast<const TX*>(p.x);
    const TD* dy = static_cast<const TD*>(p.dy);
    constexpr int U = GRAD ? kUnroll : 2 * kUnroll;
    for (long long r = rows.begin + ty; r < rows.end; r += U * ty_n) {
      Raw<TX, VEC> vx[U];
      Raw<TD, VEC> vd[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long ru = r + u * ty_n;
        if (ru < rows.end) {
          ldg_raw(x + ru * C + c0, vx[u]);
          if constexpr (GRAD) ldg_raw(dy + ru * C + c0, vd[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * ty_n >= rows.end) continue;
        float v[VEC];
        floats_of(vx[u], v);
        if constexpr (GRAD) {
          float d[VEC];
          floats_of(vd[u], d);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            // x_hat = (x - mean) * rstd and the dy that counts, each
            // operation rounded to RT: _bn_train_bwd's arithmetic (RT =
            // float) or _lean_bwd:381-386's (RT = x's dtype)
            const float xm = rnd<RT>(__fsub_rn(v[j], mu[j]));
            const float xh = rnd<RT>(__fmul_rn(xm, rs[j]));
            float dm = rnd<RT>(d[j]);
            if (mask && !(pre_of<RT>(xh, ga[j], be[j]) > 0.f)) dm = 0.f;
            s0[j] = __fadd_rn(s0[j], dm);
            s1[j] = __fmaf_rn(dm, xh, s1[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            s0[j] = __fadd_rn(s0[j], v[j]);
            s1[j] = __fmaf_rn(v[j], v[j], s1[j]);
          }
        }
      }
    }
  }
  if (in_block) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[0][ty * width + tx * VEC + j] = s0[j];
      red[1][ty * width + tx * VEC + j] = s1[j];
    }
  }
  __syncthreads();
  // The block's (2, tile) sums, each over the ty rows in order, to its
  // row of the scratch (the padding to a whole float4 as 0).
  const int tiles = gridDim.y, n = 2 * width;
  const long long tile_row = (long long)(g * tiles + blockIdx.y) * p.splits;
  float* mine = p.ws + (tile_row + blockIdx.x % p.splits) * p.stride;
  for (int v = threadIdx.x; v < p.stride; v += kThreads) {
    float t = 0.f;
    if (v < n) {
      const float* col = &red[v / width][v % width];
#pragma unroll 8
      for (int k = 0; k < ty_n; ++k) t = __fadd_rn(t, col[k * width]);
    }
    mine[v] = t;
  }
  __threadfence();
  __syncthreads();
  unsigned* ticket = p.tickets + g * tiles + blockIdx.y;
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == (unsigned)(p.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block of the tile: part q adds the splits q, q + Q, ... in
  // float4s (read from L2, where the other blocks wrote them; kFinalBatch
  // loads in flight, then added in order), then the Q parts are added in
  // order.
  const float4* all = reinterpret_cast<const float4*>(p.ws + tile_row *
                                                      p.stride);
  const int n4 = p.stride / 4, Q = kThreads / n4;
  if (threadIdx.x < Q * n4) {
    const int q = threadIdx.x / n4, i = threadIdx.x % n4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = q; s0 < p.splits; s0 += kFinalBatch * Q) {
      float4 w[kFinalBatch];
#pragma unroll
      for (int k = 0; k < kFinalBatch; ++k) {
        const int s = s0 + k * Q;
        if (s < p.splits) w[k] = __ldcg(all + (long long)s * n4 + i);
      }
#pragma unroll
      for (int k = 0; k < kFinalBatch; ++k) {
        if (s0 + k * Q >= p.splits) break;
        acc.x = __fadd_rn(acc.x, w[k].x);
        acc.y = __fadd_rn(acc.y, w[k].y);
        acc.z = __fadd_rn(acc.z, w[k].z);
        acc.w = __fadd_rn(acc.w, w[k].w);
      }
    }
    part[q * n4 + i] = acc;
  }
  __syncthreads();
  const float* parts = reinterpret_cast<const float*>(part);
  for (int v = threadIdx.x; v < n; v += kThreads) {
    float t = 0.f;
    for (int q = 0; q < Q; ++q) t = __fadd_rn(t, parts[q * p.stride + v]);
    tot[v] = t;
  }
  __syncthreads();
  const long long plane = (long long)p.G * C;
  float* out = p.out + (long long)g * C;
  for (int col = threadIdx.x; col < width && cb + col < C;
       col += kThreads) {
    const int c = cb + col;
    const float s = tot[col], ss = tot[width + col];
    if constexpr (TERMS) {
      // the torch operations of batch_norm_stats_terms_ref, each rounded
      // on its own: s / count and ss / count as ATen's CUDA division by a
      // Python number (a product with 1.0f / count), clamp(min=0)
      // propagating NaN, rsqrt as torch.rsqrt
      const float mean = __fmul_rn(s, p.inv);
      const float d = __fsub_rn(__fmul_rn(ss, p.inv), __fmul_rn(mean, mean));
      const float var = d != d ? d : fmaxf(d, 0.f);
      const float rstd = rsqrtf(__fadd_rn(var, p.eps));
      const float a = __fmul_rn(value(p.gamma, g, c), rstd);
      const float b = __fsub_rn(value(p.beta, g, c), __fmul_rn(mean, a));
      out[c] = mean;
      out[plane + c] = var;
      out[2 * plane + c] = rstd;
      out[3 * plane + c] = a;
      out[4 * plane + c] = b;
    } else {
      out[c] = s;
      out[plane + c] = ss;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
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

// K7's or K8's launch: grid (groups * splits, column tiles) of tx * ty
// threads, the tile tx * vec channels; the scratch row of a block holds
// its (2, tile) sums, 2 * tile rounded up to whole float4s.
template <typename TX, typename TD, typename RT, int VEC, bool GRAD,
          bool TERMS>
cudaError_t run_stats(StatsParams p, long long M, int vec,
                      cudaStream_t stream) {
  if (p.tx < 1 || p.tx * vec > kStatsTile || p.splits < 1 || p.G < 1 ||
      M % p.G)
    return cudaErrorInvalidValue;
  const int width = p.tx * vec;
  p.Mg = M / p.G;
  p.stride = (2 * width + 3) / 4 * 4;
  const dim3 grid(p.G * p.splits, (p.C + width - 1) / width);
  bn_stats_kernel<TX, TD, RT, VEC, GRAD, TERMS>
      <<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The statistics' fields common to K7 and K8: the output, the scratch, the
// plan.
inline StatsParams stats_params(void* out, void* ws, void* tickets, int C,
                                int groups, int tx, int splits) {
  StatsParams sp;
  memset(&sp, 0, sizeof(sp));
  sp.out = static_cast<float*>(out);
  sp.ws = static_cast<float*>(ws);
  sp.tickets = static_cast<unsigned*>(tickets);
  sp.C = C;
  sp.G = groups;
  sp.tx = tx;
  sp.splits = splits;
  return sp;
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
// aligned bases) or 1. Each entry takes one packed block of 8-byte fields,
// so that the caller makes one call with one argument, and returns the
// cudaError_t of its launch.

// K7, one launch. p: out, x, x's dtype, M, C, groups, vec, tx, splits,
// stream, ws (f32 [groups * tiles * splits][stride]), tickets (u32 [groups *
// tiles], 0), then (pointer, group stride, channel stride) of gamma and of
// beta, each f32 (C,) (group stride 0) or [groups, C], and 1 / count and
// eps as doubles. Without gamma and beta (null pointers) out is f32 [2,
// groups, C]: (sum x, sum x^2); with them [5, groups, C]: (mean, var, rstd,
// a, b), the forward's terms from f32(1 / count) and f32(eps).
extern "C" int hvd_bn_stats(const long long* p) {
  using namespace hvdbn;
  const int x_dtype = p[2], C = p[4], groups = p[5], vec = p[6];
  StatsParams sp = stats_params(reinterpret_cast<void*>(p[0]),
                                reinterpret_cast<void*>(p[10]),
                                reinterpret_cast<void*>(p[11]), C, groups,
                                p[7], p[8]);
  sp.x = reinterpret_cast<const void*>(p[1]);
  sp.gamma = term_of(p + 12);
  sp.beta = term_of(p + 15);
  double scales[2];
  memcpy(scales, p + 18, sizeof(scales));
  sp.inv = static_cast<float>(scales[0]);
  sp.eps = static_cast<float>(scales[1]);
  const long long M = p[3];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p[9]);
  const int terms = sp.gamma.p != nullptr;
  if ((sp.beta.p != nullptr) != terms) return cudaErrorInvalidValue;
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_vec(vec, [&](auto v) {
      return by_flag(terms, [&](auto t) {
        return run_stats<TX, TX, float, decltype(v)::value, false,
                         decltype(t)::value>(sp, M, vec, st);
      });
    });
  });
}

// K8, one launch. p: out (f32 [2, groups, C]: dbeta, dgamma), dy, dy's
// dtype, x, x's dtype (dy and x may differ: f32 dy with bf16 x), lean (1
// rounds the terms, x_hat and the pre-activation to x's dtype), M, C,
// groups, vec, tx, splits, stream, ws, tickets (as K7's), then the
// (pointer, group stride, channel stride) triples of mean, rstd, and of
// gamma and beta for the ReLU mask (both null: no mask), each f32 (C,) or
// [groups, C].
extern "C" int hvd_bn_grad_stats(const long long* p) {
  using namespace hvdbn;
  const int dy_dtype = p[2], x_dtype = p[4], lean = p[5], C = p[7];
  const int groups = p[8], vec = p[9];
  StatsParams sp = stats_params(reinterpret_cast<void*>(p[0]),
                                reinterpret_cast<void*>(p[13]),
                                reinterpret_cast<void*>(p[14]), C, groups,
                                p[10], p[11]);
  sp.dy = reinterpret_cast<const void*>(p[1]);
  sp.x = reinterpret_cast<const void*>(p[3]);
  sp.mean = term_of(p + 15);
  sp.rstd = term_of(p + 18);
  sp.gamma = term_of(p + 21);
  sp.beta = term_of(p + 24);
  const long long M = p[6];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p[12]);
  if (!sp.mean.p || !sp.rstd.p ||
      (sp.gamma.p == nullptr) != (sp.beta.p == nullptr))
    return cudaErrorInvalidValue;
  return by_dtype(x_dtype, [&](auto tx) {
    using TX = typename decltype(tx)::type;
    return by_dtype(dy_dtype, [&](auto td) {
      using TD = typename decltype(td)::type;
      return by_flag(lean, [&](auto l) {
        using RT = std::conditional_t<decltype(l)::value, TX, float>;
        return by_vec(vec, [&](auto v) {
          return run_stats<TX, TD, RT, decltype(v)::value, true, false>(
              sp, M, vec, st);
        });
      });
    });
  });
}

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
