// The flash-attention forward on Hopper: one mainloop, two epilogues.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_fwd_kernel (:170, launched
// by _pallas_forward_lse) as kernel K1, and _ring_step_kernel (:431,
// launched by flash_ring_step) as kernel K4.
//   K1: O = softmax(scale * Q K^T) V, causal or full, and the per-row
//       log-sum-exp that the backward kernels recompute P from.
//   K4: one ring step: the carried online-softmax state (o, m, l; f32, o
//       un-normalised, m in natural-log units) += this k/v shard, in place.
//       Causal masks run on the shards' GLOBAL positions (Chunks, one or two
//       chunks; a q or key tile may straddle the zigzag chunk boundary).
//   Rotary (the TPU kernels' `rotary` flag) happens before the launch: the
//   rotary pass (rope.cu) rotates q and k once a layer at their positions
//   (K4: the shards' global ones), and K1 and K4 run on the copies, which
//   the backward reads again (flash_attention._FlashFn, parallel/ring.py).
//
// Bounds on the H100 at the main-path shapes, bf16, causal (B*H*L(L+1)/2
// visible (q, k) pairs, 2 products of 2 * D FLOP each and one exp2 a pair):
//   K1 at [8, 12, 2048, 64]: 51.6 GFLOP, 52 us at 989 TFLOP/s on the tensor
//   cores; 201 M exp2, 52 us on the special-function units (16 a clock per
//   SM, about 3.9 T/s); q, k, v, O 101 MB, 30 us at 3.35 TB/s.
//   K4 at [2, 12, 8192, 64] (the sp step): 206 GFLOP, 0.208 ms; 805 M exp2,
//   0.206 ms; 40 MB of bf16 inputs and 50 MB of f32 state read and written,
//   27 us. Both are bound by the tensor cores and the exponentials alike.
//
// Design (FlashAttention-3's shape, hopper.cuh's PTX):
// - One block per (batch * head, q tile), the q tiles issued last first
//   (the latest rows see the most keys). A producer warpgroup that gives its
//   registers away (setmaxnreg) and consumer warpgroups of 64 q rows each:
//   three (192-row q tiles) for D <= 64, two for D = 128, whose O takes
//   twice the registers. One block an SM.
// - The producer's one thread brings Q once and streams 128-key tiles of K
//   and V through a ring of shared-memory stages (3; 2 at D = 128) by TMA:
//   4-D tensor maps over the model's own layout, GQA by the kv head's
//   coordinate, one full and one empty mbarrier a stage. Rows past the end
//   arrive as zeros.
// - The consumers multiply on the tensor cores with wgmma: S = Q K^T
//   (m64n128k16, both from shared memory, K-major), P rounded to bf16 in
//   registers, O += P V (m64nDk16, P from registers, V MN-major). Each
//   warpgroup runs S, softmax and P V of a tile in turn; the warp schedulers
//   run one warpgroup's exponentials under another's products. (Issuing
//   tile j's S beside tile j-1's P V inside a warpgroup, and making the
//   warpgroups take turns on named barriers, both measured slower, and
//   ptxas serialized their wgmmas: PERF.md.)
// - The online softmax stays in f32 registers: one exp2 a score with the
//   scale folded into one FMA. The key loop stops at the last tile the
//   block sees, a warpgroup skips a tile that none of its rows sees, and
//   only tiles that straddle the diagonal or a ragged end are masked, with
//   one compare a score where the tile's keys lie in one chunk.
// - No rotary here. Rotating q and k in shared memory after the TMA landing
//   (each q block re-rotating every key tile it reads, at L = 8192 about 32
//   times a tile, with 64 KB of f32 tables from L2 a 128 x 128 tile, then a
//   proxy fence and an mbarrier a stage) took about twice the kernel without
//   rotary; the pass of rope.cu rotates each row once, bit for bit as that
//   in-kernel rotation did (PERF.md).
// Left: nothing overlaps one block's prologue and epilogue with the next
// block's loads (a persistent, longest-first tile loop would), and O is
// stored from registers.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace hvdflash {

using namespace hvdhopper;

constexpr int kFwdN = 128;        // keys a tile (TMA box rows of K and V)
constexpr int kWgRows = 64;       // q rows a consumer warpgroup owns (and
                                  // TMA box rows of Q)

// The shape of a block and its shared memory, in bytes from a 1024-byte
// aligned base: Q (per box of columns, one 64-row box a consumer), the K
// stages, the V stages, then the mbarriers (Q's, full[s], empty[s]).
// D <= 64 runs three consumer warpgroups (192 q rows), D = 128 two, whose
// O takes twice the registers.
template <int D>
struct FwdTile {
  static constexpr int kWgs = D == 128 ? 2 : 3;  // consumer warpgroups
  static constexpr int kM = kWgs * kWgRows;      // q rows a block owns
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kConsumers = 128 * kWgs;
  // setmaxnreg: the producer's registers go to the consumers (65536 a SM)
  static constexpr int kProducerRegs = kWgs == 3 ? 24 : 40;
  static constexpr int kConsumerRegs = kWgs == 3 ? 160 : 232;
  static constexpr int kCols = D < 64 ? D : 64;  // columns of a TMA box
  static constexpr int kBoxes = D / kCols;
  static constexpr int kRow = kCols * 2;         // bytes of a box row
  static constexpr int kBox = kFwdN * kRow;      // one K or V box
  static constexpr int kTile = kBoxes * kBox;    // a K or V tile
  static constexpr int kQBox = kWgRows * kRow;   // one Q box
  static constexpr int kQ = kBoxes * kWgs * kQBox;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr uint32_t kSwizzle = kRow == 128 ? 1 : 2;  // 128 B, 64 B
  static constexpr int kSbo = 8 * kRow;          // 8 rows of a swizzle atom
  static constexpr int kBars = kQ + 2 * kStages * kTile;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

struct FwdParams {
  CUtensorMap tq, tk, tv;  // 4-D bf16 maps (hopper.cuh)
  void* out;               // K1: [B, H, L, D] through `so`, q's dtype
  Strides so;
  float* lse;              // K1: [B, H, L]
  float* o;                // K4: [B, H, Lq, D], in place
  float* m;                // K4: [B, H, Lq], natural log, in place
  float* l;                // K4: [B, H, Lq], in place
  int H, G, Lq, Lk;
  Chunks qc, kc;           // K1: one chunk at 0
  float scale;
  int causal;
};

// Whether the key tile at n0 holds a key that some query of rows [a, b]
// may see.
__device__ __forceinline__ bool fwd_tile_visible(const FwdParams& p, int a,
                                                 int b, int n0) {
  if (!p.causal) return true;
  const int k_last = min(n0 + kFwdN, p.Lk) - 1;
  return min_pos(p.kc, n0, k_last) <= max_pos(p.qc, a, min(b, p.Lq - 1));
}

// Whether rows [a, b] (below Lq) and the key tile at n0 hold an entry to
// mask: the ragged end of the keys, or a key after some query. Rows past Lq
// are never masked: they are never stored.
__device__ __forceinline__ bool fwd_tile_needs_mask(const FwdParams& p, int a,
                                                    int b, int n0) {
  b = min(b, p.Lq - 1);
  if (n0 + kFwdN > p.Lk) return true;
  return p.causal &&
         max_pos(p.kc, n0, n0 + kFwdN - 1) > min_pos(p.qc, a, b);
}

// The first key tile from j on that the q rows [m0, m0 + rows) see
// (n_tiles if none). The producer and the consumers walk the same list.
__device__ __forceinline__ int fwd_next_tile(const FwdParams& p, int m0,
                                             int rows, int j, int n_tiles) {
  while (j < n_tiles && !fwd_tile_visible(p, m0, m0 + rows - 1, j * kFwdN))
    ++j;
  return j;
}

// All of O += P V for one tile, V at `v` (MN-major); `accumulate` false
// makes the first slice write O instead.
template <int D>
__device__ __forceinline__ void tile_pv(float (&o)[D / 2],
                                        const uint32_t (&pa)[kFwdN / 16][4],
                                        uint32_t v, bool accumulate) {
  using Tile = FwdTile<D>;
#pragma unroll
  for (int kk = 0; kk < kFwdN / 16; ++kk)
    wgmma_rs<D>(o, pa[kk],
                make_desc(v + kk * 16 * Tile::kRow, Tile::kBox, Tile::kSbo,
                          Tile::kSwizzle),
                accumulate || kk > 0);
}

// The online softmax of one tile's raw scores `s` (the scale folds into
// exp2): masks them, updates the running max (log2 units) and this lane's
// share of the row sum, rescales O (when it holds anything) and leaves P
// rounded to bf16 in `pa`, as the TPU kernel rounds it to V's type.
template <int D>
__device__ __forceinline__ void online_softmax(
    const FwdParams& p, float (&s)[kFwdN / 2], float (&o)[D / 2],
    uint32_t (&pa)[kFwdN / 16][4], float (&m_run)[2], float (&l_run)[2],
    const int (&row_pos)[2], int n0, int tc, float scale2, bool need_mask,
    bool o_live) {
  if (need_mask) {
    const int k_last = min(n0 + kFwdN, p.Lk) - 1;
    if (n0 >= p.kc.len || k_last < p.kc.len) {
      // The tile's keys lie in one chunk, at positions col + shift (always
      // so for K1): one compare a score against its row's last column.
      const int shift = n0 >= p.kc.len ? p.kc.off1 - p.kc.len : p.kc.off0;
      int lim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lim[r] = (p.causal ? min(row_pos[r] - shift, k_last) : k_last) - n0 -
                 tc;
#pragma unroll
      for (int i = 0; i < kFwdN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i * 8 + (e & 1) > lim[e >> 1]) s[4 * i + e] = -INFINITY;
      }
    } else {  // a zigzag chunk boundary inside the tile
#pragma unroll
      for (int i = 0; i < kFwdN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + i * 8 + tc + (e & 1);
          if (col >= p.Lk ||
              (p.causal && pos_of(p.kc, col) > row_pos[e >> 1]))
            s[4 * i + e] = -INFINITY;
        }
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kFwdN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
  }
  float alpha[2], nbase[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * scale2);
    // A row that has seen no visible key keeps m = -inf; the base 0 then
    // turns its masked scores into exp2(-inf) = 0, never NaN.
    const float base_r = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m_run[r] - base_r);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
    nbase[r] = -base_r;
  }
#pragma unroll
  for (int i = 0; i < kFwdN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(s[4 * i + e], scale2, nbase[e >> 1]));
      s[4 * i + e] = x;
      l_run[e >> 1] += x;
    }
  }
  if (o_live) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
  }
#pragma unroll
  for (int kk = 0; kk < kFwdN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D, bool kRing, typename TO>
__global__ void __launch_bounds__(FwdTile<D>::kThreads, 1)
    flash_fwd_kernel(__grid_constant__ const FwdParams p) {
  using Tile = FwdTile<D>;
  constexpr int kStages = Tile::kStages;
  constexpr int kWgs = Tile::kWgs;
  constexpr int kM = Tile::kM;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.G);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kM;  // last first
  const int n_tiles = (p.Lk + kFwdN - 1) / kFwdN;
  const int j_first = fwd_next_tile(p, m0, kM, 0, n_tiles);
  if (j_first >= n_tiles) return;  // nothing visible: the state stays

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + Tile::kQ;
  const uint32_t sV = sK + kStages * Tile::kTile;
  const uint32_t bar_q = base + Tile::kBars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, Tile::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // The warpgroup, broadcast from lane 0 so that ptxas sees a warp-uniform
  // value: a branch on a thread-dependent one is a divergent path to it,
  // and it serializes the wgmmas inside.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == kWgs) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<Tile::kProducerRegs>();
    if (threadIdx.x != Tile::kConsumers) return;
    prefetch_tensor_map(&p.tq);
    prefetch_tensor_map(&p.tk);
    prefetch_tensor_map(&p.tv);
    mbar_arrive_expect_tx(bar_q, Tile::kQ);
    for (int x = 0; x < Tile::kBoxes; ++x)
      for (int w = 0; w < kWgs; ++w)
        tma_load_4d(sQ + (x * kWgs + w) * Tile::kQBox, &p.tq, bar_q,
                    x * Tile::kCols, m0 + w * kWgRows, h, b);
    int it = 0;
    for (int j = j_first; j < n_tiles;
         j = fwd_next_tile(p, m0, kM, j + 1, n_tiles), ++it) {
      const int s = it % kStages;
      mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const uint32_t full = bar_full + 8 * s;
      mbar_arrive_expect_tx(full, 2 * Tile::kTile);
      for (int x = 0; x < Tile::kBoxes; ++x) {
        const uint32_t off = s * Tile::kTile + x * Tile::kBox;
        tma_load_4d(sK + off, &p.tk, full, x * Tile::kCols, j * kFwdN, kvh,
                    b);
        tma_load_4d(sV + off, &p.tv, full, x * Tile::kCols, j * kFwdN, kvh,
                    b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<Tile::kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tc = (lane & 3) * 2;
  const int wrow = m0 + wg * kWgRows;  // this warpgroup's first row
  const int row0 = wrow + warp * 16 + lane / 4;
  const int rows[2] = {row0, row0 + 8};
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Lq;

  // The state: o (accumulator layout, hopper.cuh), the running max in log2
  // units and this lane's share of the row sum. K1's o is first written by
  // its first P V (a constant zero there would make ptxas copy accumulator
  // registers between wgmmas and serialize them).
  float o[D / 2];
  bool o_live = kRing;
  float m_run[2], l_run[2];
  int row_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = rows[r] < p.Lq;
    row_pos[r] = pos_of(p.qc, rows[r]);
    if constexpr (kRing) {
      // The carried state; its row sum enters one lane of each quad.
      m_run[r] = valid ? p.m[row_base + rows[r]] * kLog2e : -INFINITY;
      l_run[r] = (valid && tc == 0) ? p.l[row_base + rows[r]] : 0.f;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        float2 x = make_float2(0.f, 0.f);
        if (valid)
          x = *reinterpret_cast<const float2*>(
              p.o + (row_base + rows[r]) * D + i * 8 + tc);
        o[4 * i + 2 * r] = x.x;
        o[4 * i + 2 * r + 1] = x.y;
      }
    } else {
      m_run[r] = -INFINITY;
      l_run[r] = 0.f;
    }
  }
  const float scale2 = p.scale * kLog2e;
  const uint64_t desc_q =
      make_desc(sQ + wg * Tile::kQBox, 16, Tile::kSbo, Tile::kSwizzle);

  mbar_wait(bar_q, 0);

  float s[kFwdN / 2];             // S, then P, of one tile (64 x 128)
  uint32_t pa[kFwdN / 16][4];     // P in bf16: the A fragments of P V
  int it = 0;
  for (int j = j_first; j < n_tiles;
       j = fwd_next_tile(p, m0, kM, j + 1, n_tiles), ++it) {
    const int stage = it % kStages;
    const int n0 = j * kFwdN;
    // Whether this warpgroup's rows see a key of the tile: a block's tile
    // may lie wholly after the rows of its first warpgroups (causal), and
    // rows past Lq are never stored. A warpgroup that sees none only hands
    // the stage back.
    const bool sees =
        wrow < p.Lq &&
        (!p.causal || fwd_tile_visible(p, wrow, wrow + kWgRows - 1, n0));
    mbar_wait(bar_full + 8 * stage, (it / kStages) & 1);
    const uint32_t cK = sK + stage * Tile::kTile;
    if (sees) {
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = kk * 16, x = col / Tile::kCols;
        const uint32_t in_row = (col % Tile::kCols) * 2;
        wgmma_ss_m64n128(
            s, desc_q + ((x * kWgs * Tile::kQBox + in_row) >> 4),
            make_desc(cK + x * Tile::kBox + in_row, 16, Tile::kSbo,
                      Tile::kSwizzle),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      online_softmax<D>(p, s, o, pa, m_run, l_run, row_pos, n0, tc, scale2,
                        fwd_tile_needs_mask(p, wrow, wrow + kWgRows - 1, n0),
                        o_live);
      wgmma_fence();
      tile_pv<D>(o, pa, sV + stage * Tile::kTile, o_live);
      wgmma_commit();
      o_live = true;
      wgmma_wait<0>();
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk) fence_operands(pa[kk]);
    }
    mbar_arrive(bar_empty + 8 * stage);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const int row = rows[r];
    if constexpr (kRing) {
      // Un-normalised: o, the quad's summed l, m back in natural-log units.
      if (row >= p.Lq) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        store2(p.o + (row_base + row) * D + i * 8 + tc, o[4 * i + 2 * r],
               o[4 * i + 2 * r + 1]);
      if (tc == 0) {
        p.m[row_base + row] = m_run[r] * kLn2;
        p.l[row_base + row] = l;
      }
    } else {
      const float lsum = l == 0.f ? 1.f : l;  // a row with no visible key
      const float inv = 1.f / lsum;
      if (row >= p.Lq) continue;
      TO* out = static_cast<TO*>(p.out) + b * p.so.b + h * p.so.h +
                row * p.so.l;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        store2(out + i * 8 + tc, o[4 * i + 2 * r] * inv,
               o[4 * i + 2 * r + 1] * inv);
      if (tc == 0) p.lse[row_base + row] = m_run[r] * kLn2 + logf(lsum);
    }
  }
}

// Encodes q's, k's and v's maps from `maps` (3 x 11: dims, byte strides,
// box, as flash_attention.tensor_map returns them) after checking that the
// boxes are the tiles this kernel takes, and launches.
template <int D, bool kRing, typename TO>
cudaError_t run_fwd(FwdParams& p, const void* const* qkv,
                    const long long* maps, int B, cudaStream_t stream) {
  using Tile = FwdTile<D>;
  CUtensorMap* dst[3] = {&p.tq, &p.tk, &p.tv};
  for (int i = 0; i < 3; ++i) {
    const long long* m = maps + 11 * i;
    if (m[0] != D || m[7] != Tile::kCols ||
        m[8] != (i == 0 ? kWgRows : kFwdN) || m[9] != 1 || m[10] != 1)
      return cudaErrorInvalidValue;
    const cudaError_t err =
        encode_map(dst[i], qkv[i], m,
                   Tile::kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_fwd_kernel<D, kRing, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.Lq + Tile::kM - 1) / Tile::kM);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kRing, typename TO>
cudaError_t run_fwd_d(FwdParams& p, const void* const* qkv,
                      const long long* maps, int B, int D,
                      cudaStream_t stream) {
  switch (D) {
    case 32: return run_fwd<32, kRing, TO>(p, qkv, maps, B, stream);
    case 64: return run_fwd<64, kRing, TO>(p, qkv, maps, B, stream);
    case 128: return run_fwd<128, kRing, TO>(p, qkv, maps, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hvdflash

// K1. q, k, v: bf16 [B, H or G, L, D] views (rotated already under rotary),
// through `maps` (3 x 11 values, flash_attention.tensor_map); out_strides:
// out's (batch, head, row) element strides; out_dtype: 0 = bfloat16, 1 =
// float32. Returns the cudaError_t of the launch.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* maps,
                             const long long* out_strides, int B, int H,
                             int G, int L, int D, int out_dtype, float scale,
                             int causal, void* stream) {
  using namespace hvdflash;
  FwdParams p = {};
  p.out = out;
  fill_strides(&p.so, out_strides, 1);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.G = G;
  p.Lq = L;
  p.Lk = L;
  p.qc = p.kc = Chunks{0, L, L};
  p.scale = scale;
  p.causal = causal;
  const void* qkv[3] = {q, k, v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return run_fwd_d<false, bf16>(p, qkv, maps, B, D, st);
  if (out_dtype == 1) return run_fwd_d<false, float>(p, qkv, maps, B, D, st);
  return cudaErrorInvalidValue;
}

// K4. q [B, H, Lq, D], k, v [B, G, Lk, D]: bf16 views through `maps` (q and
// k rotated already at their global positions under rotary); o, m, l: the
// carried f32 state, updated in place; chunks: (off0, off1, len) of the q
// shard, then of the k/v shard.
extern "C" int hvd_flash_ring_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* m, void* l,
                                  const long long* maps, int B, int H, int G,
                                  int Lq, int Lk, int D, const int* chunks,
                                  float scale, int causal, void* stream) {
  using namespace hvdflash;
  FwdParams p = {};
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.H = H;
  p.G = G;
  p.Lq = Lq;
  p.Lk = Lk;
  p.qc = Chunks{chunks[0], chunks[1], chunks[2]};
  p.kc = Chunks{chunks[3], chunks[4], chunks[5]};
  p.scale = scale;
  p.causal = causal;
  const void* qkv[3] = {q, k, v};
  return run_fwd_d<true, float>(p, qkv, maps, B, D,
                                static_cast<cudaStream_t>(stream));
}
