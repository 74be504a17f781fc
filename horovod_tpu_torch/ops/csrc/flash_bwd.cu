// The flash-attention backward on Hopper: one mainloop, four epilogues.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_bwd_dq_kernel (:841) as
// kernel K2 and _bwd_dkv_kernel (:895) as kernel K3, both launched by
// _pallas_backward (:959); and _ring_bwd_dq_kernel (:620) as kernel K5 and
// _ring_bwd_dkv_kernel (:673) as kernel K6, both launched by
// flash_ring_bwd_step. P is recomputed from the forward's log-sum-exp;
// delta = rowsum(dO * O) is computed outside (as XLA computes it for the
// TPU kernels):
//   P = exp(scale * Q K^T - lse),  dS = P * (dO V^T - delta) * scale
//   K2: dQ = dS K                  (3 products per visible (q, k) pair)
//   K3: dV = P^T dO, dK = dS^T Q   (4 products), summed over the H / G
//       query heads of a kv head inside the block (GQA), so dK and dV are
//       written once at G heads.
//   K5, K6: one ring step of K2 and K3 (the kRing instantiations): the
//       rank's q shard against the k/v shard it holds at that step, P from
//       the whole ring's lse, causal masks on the shards' GLOBAL positions
//       (Chunks: one chunk, or two for the zigzag schedule, which a tile may
//       straddle), Lq and Lk apart. The step's sums are added to f32
//       accumulators in place (K5: dq; K6: dk and dv, which travel around
//       the ring with their k/v shard); rows that see no key of the shard
//       keep their value bit for bit.
//   K2 and K3 with rotary (the kRot instantiations; the TPU kernels'
//   `rotary` flag): S, dS and the sums run in rotated space, on q and k that
//   rope.cu rotated once a layer in the forward (autograd keeps the copies:
//   flash_attention._FlashFn); the kernels counter-rotate their finished dQ
//   and dK (the transpose rotation, on the f32 accumulators in registers,
//   before the cast); dV is rotation-free. K5 and K6 have no rotary
//   instantiation: the ring rotates its q shard and its home k shard once in
//   its forward (rope.cu) and they read those, and their dq and dk stay in
//   rotated space, since their sums carry across ring steps; the ring
//   counter-rotates them once after its last step (parallel/ring.py).
// Precision follows the TPU kernels: the products take bf16 inputs and sum
// in f32; P is rounded to bf16 (dO's type) before the dV product, and dS
// before the dK and dQ products.
//
// Bounds on the H100 at the training shape [8, 12, 2048, 64] bf16 causal
// (B*H*L(L+1)/2 visible pairs, 2 * D FLOP a product and one exp2 a pair):
//   K2: 77.3 GFLOP, 78 us at 989 TFLOP/s; 201 M exp2, 52 us on the
//       special-function units; about 127 MB read and written, 38 us.
//   K3: 103.1 GFLOP, 104 us; the same exponentials and bytes.
// At the sp step's launch, [2, 12, 8192, 64] causal over zigzag chunks
// (0, 4096) on one rank (the same pairs as a causal L = 8192):
//   K5: 309 GFLOP, 0.313 ms; K6: 412 GFLOP, 0.417 ms; 805 M exp2, 0.206 ms;
//   bf16 inputs 25 MB, f32 rows 1.6 MB, f32 accumulators read and written
//   50 MB (K5) or 101 MB (K6), 23 and 38 us.
// At the long-context LM's launch, [2, 6, 8192, 128] on 2 kv heads, causal,
// with or without rotary: K2 0.313 ms, K3 0.417 ms.
// All four are bound by the tensor cores.
//
// Design (flash_fwd.cu's shape on hopper.cuh's PTX; one mainloop):
// - A block owns rows of one side and streams tiles of the other. K2 owns
//   q rows of one (batch, query head) and streams the key tiles (K, V) of
//   its kv head, q tiles issued last first (the latest rows see the most
//   keys). K3 owns key rows of one (batch, kv head) and streams the (query
//   head of its group, q tile) pairs (Q, dO and the tile's lse and delta),
//   key tiles issued first first for the same reason.
// - A producer warpgroup gives its registers away (setmaxnreg). Its first
//   thread loads the block's own two operands once (K2: Q, dO; K3: K, V)
//   and streams the other two through a ring of shared-memory stages by
//   TMA: 4-D tensor maps over the model's own layout, GQA by the head
//   coordinate, one full and one empty mbarrier a stage; rows past the end
//   arrive as zeros. In K3 the lanes of its first warp also copy the
//   tile's lse (log2 units) and delta into the stage and arrive on the full
//   barrier beside the TMA's transaction count (lse and delta rows are 4
//   bytes wide and start anywhere: TMA wants 16-byte aligned rows).
// - Consumer warpgroups own 64 rows each. Per tile, with both operands
//   K-major in shared memory: X = R1 S1^T and Y = R2 S2^T by wgmma (K2:
//   S = Q K^T, dP = dO V^T; K3 transposed: S^T = K Q^T, dP^T = V dO^T,
//   rows keys and columns queries, so no fragment is ever transposed). P
//   and dS are formed in f32 registers and rounded into A fragments; then
//   acc1 += dS S1 (K2: dQ += dS K; K3: dK += dS^T Q) and, in K3, acc2 +=
//   P S2 (dV += P^T dO), S1 and S2 MN-major (the transpose bit), as V is
//   in the forward's P V.
// - The stream stops at the last tile the block sees (K2: the diagonal; K3
//   starts there), a warpgroup skips a tile that none of its rows sees, and
//   only tiles that straddle the diagonal, a chunk boundary or a ragged end
//   are masked. Masks run on positions (Chunks; one chunk at 0 in K2 and
//   K3), and the accumulators start from their first product (`live`; a
//   constant zero or a loaded value there can make ptxas copy accumulator
//   registers between the wgmmas and serialize them).
// - Two launches, each writing its outputs once: no float atomics. The
//   ring's epilogue reads the carried f32 row and writes it back with the
//   step's sum added; a warpgroup that saw no tile stores nothing. (A block
//   that sees no tile still loads its owned rows: returning before the
//   roles split made ptxas spill in K6 at D = 64.)
// - Rotary (kRot). The TPU kernels rotate the q or k block a grid step
//   holds, in VMEM: a q block of K2 rotates its own q and every k block it
//   reads. Done so here, every block that streams a tile rotated it
//   again, about 32 times a tile at L = 8192 causal, on the consumer
//   warpgroups between the TMA landing and the wgmma, with 64 KB of f32
//   tables a 128-row tile from L2, a fence for the async proxy and a stage
//   barrier: K2_rot took 2.0x and K3_rot 1.5x the same launch without
//   rotary. Now q and k arrive rotated (rope.cu, one pass each a layer,
//   bound by bytes: 0.021 ms at the long-context launch), the mainloop is
//   the one without rotary, bound by the tensor cores, and the only rotary
//   work left is the counter-rotation of dQ (K2) and dK (K3) in the
//   epilogue, once an output row.
// Tiles: three consumers (192 owned rows a block) and 64-row streamed tiles
// at D <= 64; two consumers at D = 128, where K3 streams 32-row q tiles (its
// dK and dV alone take 128 registers a thread there). Measured against this
// (PERF.md): two consumers at D = 64, 128-key tiles in K2, 32-row q tiles
// in K3, 3 or 6 stages, a persistent block an SM walking the work items,
// K2's q blocks anchored at L's end, and the masks inside the exponential
// loop were slower or no faster; the owned operands as register fragments
// gave wrong dQ, dK, dV where the two products had one width, cause not
// found, and were dropped.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace hvdflash {

using namespace hvdhopper;

constexpr int kBwdRows = 64;  // rows a consumer warpgroup owns (and TMA box
                              // rows of the owned operands)

// The shape of a block and its shared memory, in bytes from a 1024-byte
// aligned base: the two owned operands (per box of columns, one 64-row box
// a consumer), the stages of the two streamed operands, K3's lse and delta
// a stage, then the mbarriers (the owned operands', full[s], empty[s]).
template <int D, bool kDkv>
struct BwdTile {
  static constexpr int kWgs = D == 128 ? 2 : 3;  // consumer warpgroups
  static constexpr int kN = kDkv && D == 128 ? 32 : 64;  // streamed rows
  static constexpr int kM = kWgs * kBwdRows;  // rows a block owns
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kConsumers = 128 * kWgs;
  // setmaxnreg: the producer's registers go to the consumers (65536 a SM)
  static constexpr int kProducerRegs = kWgs == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWgs == 3 ? 160 : 232;
  static constexpr int kCols = D < 64 ? D : 64;  // columns of a TMA box
  static constexpr int kBoxes = D / kCols;
  static constexpr int kRow = kCols * 2;         // bytes of a box row
  static constexpr int kOwnBox = kBwdRows * kRow;
  static constexpr int kOwn = kBoxes * kWgs * kOwnBox;  // an owned operand
  static constexpr int kBox = kN * kRow;                // a streamed box
  static constexpr int kTile = kBoxes * kBox;           // a streamed operand
  static constexpr int kStages = (!kDkv && D == 128) ? 3 : 4;
  static constexpr uint32_t kSwizzle = kRow == 128 ? 1 : 2;  // 128 B, 64 B
  static constexpr int kSbo = 8 * kRow;  // 8 rows of a swizzle atom
  static constexpr int kStats = kDkv ? 2 * kN : 0;  // floats a stage
  static constexpr int kStatsAt = 2 * kOwn + 2 * kStages * kTile;
  static constexpr int kBars = kStatsAt + kStages * kStats * 4;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
  // arrivals on a full barrier: the TMA thread's, and K3's copying lanes'
  static constexpr int kFullArrivals = kDkv ? 32 : 1;
};

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // 4-D bf16 maps (hopper.cuh)
  const float* lse;             // [B, H, Lq], natural log
  const float* delta;           // [B, H, Lq]
  void* out1;                   // K2, K5: dq [B, H, Lq, D]; K3, K6: dk
                                // [B, G, Lk, D] (K5, K6: f32, in place)
  void* out2;                   // K3, K6: dv [B, G, Lk, D]
  Strides s1, s2;               // their (batch, head, row) element strides
  int H, G, Lq, Lk;
  Chunks qc, kc;                // K2, K3: one chunk at 0; K5, K6: the shards'
  Rope rope;                    // kRot: the rotary tables (counter-rotation)
  float scale;
  int causal;
};

// The owned rows' sequence length and the streamed rows'.
template <bool kDkv>
__device__ __forceinline__ int own_len(const BwdParams& p) {
  return kDkv ? p.Lk : p.Lq;
}

template <bool kDkv>
__device__ __forceinline__ int stream_len(const BwdParams& p) {
  return kDkv ? p.Lq : p.Lk;
}

// Whether the owned rows [a, b] (a below their end) and the streamed tile
// at c0 hold a (query, key) pair that is visible.
template <bool kDkv, int kN>
__device__ __forceinline__ bool bwd_tile_visible(const BwdParams& p, int a,
                                                 int b, int c0) {
  if (!p.causal) return true;
  b = min(b, own_len<kDkv>(p) - 1);
  const int c1 = min(c0 + kN, stream_len<kDkv>(p)) - 1;
  return kDkv ? min_pos(p.kc, a, b) <= max_pos(p.qc, c0, c1)
              : min_pos(p.kc, c0, c1) <= max_pos(p.qc, a, b);
}

// Whether the owned rows [a, b] and the streamed tile at c0 hold an entry
// to mask: the ragged end of the streamed rows, or a key after a query.
// Owned rows past their end are never masked: they are never stored.
template <bool kDkv, int kN>
__device__ __forceinline__ bool bwd_tile_needs_mask(const BwdParams& p,
                                                    int a, int b, int c0) {
  if (c0 + kN > stream_len<kDkv>(p)) return true;
  if (!p.causal) return false;
  b = min(b, own_len<kDkv>(p) - 1);
  const int c1 = c0 + kN - 1;
  return kDkv ? max_pos(p.kc, a, b) > min_pos(p.qc, c0, c1)
              : max_pos(p.kc, c0, c1) > min_pos(p.qc, a, b);
}

// The first streamed tile from j on that the owned rows [m0, m0 + rows)
// see (n_tiles if none). The producer and the consumers walk the same list.
template <bool kDkv, int kN>
__device__ __forceinline__ int bwd_next_tile(const BwdParams& p, int m0,
                                             int rows, int j, int n_tiles) {
  while (j < n_tiles &&
         !bwd_tile_visible<kDkv, kN>(p, m0, m0 + rows - 1, j * kN))
    ++j;
  return j;
}

// x = R . S^T over the head dim for one tile: R this warpgroup's owned rows
// at `own`, S the streamed tile at `t`, both K-major.
template <int D, bool kDkv>
__device__ __forceinline__ void tile_rst(
    float (&x)[BwdTile<D, kDkv>::kN / 2], uint32_t own, uint32_t t) {
  using Tile = BwdTile<D, kDkv>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16, bx = col / Tile::kCols;
    const uint32_t in_row = (col % Tile::kCols) * 2;
    wgmma_ss<Tile::kN>(
        x,
        make_desc(own + bx * Tile::kWgs * Tile::kOwnBox + in_row, 16,
                  Tile::kSbo, Tile::kSwizzle),
        make_desc(t + bx * Tile::kBox + in_row, 16, Tile::kSbo,
                  Tile::kSwizzle),
        kk > 0);
  }
}

// Sets the masked scores of one tile to -inf (exp2 then makes P and dS 0):
// streamed rows past their end, and keys after their query. x is 64 x kN in
// the accumulator layout (hopper.cuh), this lane's rows row0 and row0 + 8
// of the owned rows, columns the streamed rows from c0 (this lane's first
// at c0 + tc).
template <bool kDkv, int kN>
__device__ __forceinline__ void mask_scores(const BwdParams& p,
                                            float (&x)[kN / 2], int row0,
                                            int c0, int tc) {
  int row_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    row_pos[r] = pos_of(kDkv ? p.kc : p.qc, row0 + 8 * r);
  const Chunks& sc = kDkv ? p.qc : p.kc;  // the streamed rows' chunks
  const int c_last = min(c0 + kN, kDkv ? p.Lq : p.Lk) - 1;
  if (c0 >= sc.len || c_last < sc.len) {
    // The tile's streamed rows lie in one chunk (always so for K2 and K3),
    // at positions index + shift: a row sees the indices i * 8 + c in
    // [lo, hi], one or two compares a score.
    const int shift = c0 >= sc.len ? sc.off1 - sc.len : sc.off0;
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lim = row_pos[r] - shift - c0 - tc;
      lo[r] = kDkv && p.causal ? lim : 0;
      hi[r] = !kDkv && p.causal ? min(c_last - c0 - tc, lim)
                                : c_last - c0 - tc;
    }
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = i * 8 + (e & 1);
        if (idx < lo[e >> 1] || idx > hi[e >> 1]) x[4 * i + e] = -INFINITY;
      }
    }
  } else {  // a chunk boundary inside the tile
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + i * 8 + tc + (e & 1);
        const int rp = row_pos[e >> 1];
        const bool masked =
            kDkv ? col >= p.Lq || (p.causal && rp > pos_of(p.qc, col))
                 : col >= p.Lk || (p.causal && pos_of(p.kc, col) > rp);
        if (masked) x[4 * i + e] = -INFINITY;
      }
    }
  }
}

// acc = [acc +] A . S for one tile: A (64 x kN, bf16) from registers in k16
// slices, S the streamed tile at `t`, MN-major; `accumulate` false makes
// the first slice write acc instead.
template <int D, bool kDkv>
__device__ __forceinline__ void tile_as(
    float (&acc)[D / 2], const uint32_t (&a)[BwdTile<D, kDkv>::kN / 16][4],
    uint32_t t, bool accumulate) {
  using Tile = BwdTile<D, kDkv>;
#pragma unroll
  for (int kk = 0; kk < Tile::kN / 16; ++kk)
    wgmma_rs<D>(acc, a[kk],
                make_desc(t + kk * 16 * Tile::kRow, Tile::kBox, Tile::kSbo,
                          Tile::kSwizzle),
                accumulate || kk > 0);
}

// A 64 x N f32 accumulator (hopper.cuh's layout) rounded to bf16 as the A
// fragments of its N / 16 k16 slices.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// This lane's rows (row0 and row0 + 8) of a 64 x D f32 accumulator to out
// (row stride sl) in TO; zeros where no tile was seen.
template <int D, typename TO>
__device__ __forceinline__ void store_rows(TO* out, long long sl,
                                           const float (&acc)[D / 2],
                                           int row0, int n, int tc,
                                           bool live) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(out + row * sl + i * 8 + tc, live ? acc[4 * i + 2 * r] : 0.f,
             live ? acc[4 * i + 2 * r + 1] : 0.f);
  }
}

// The ring's epilogue: this lane's rows of a 64 x D f32 accumulator added to
// the carried f32 rows at sum (row stride sl), in place.
template <int D>
__device__ __forceinline__ void add_rows(float* sum, long long sl,
                                         const float (&acc)[D / 2],
                                         int row0, int n, int tc) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float* at = sum + row * sl + i * 8 + tc;
      const float2 c = *reinterpret_cast<const float2*>(at);
      store2(at, c.x + acc[4 * i + 2 * r], c.y + acc[4 * i + 2 * r + 1]);
    }
  }
}

template <int D, bool kDkv, bool kRing, bool kRot, typename TO>
__global__ void __launch_bounds__(BwdTile<D, kDkv>::kThreads, 1)
    flash_bwd_kernel(__grid_constant__ const BwdParams p) {
  static_assert(!(kRing && kRot), "K5 and K6 read q and k rotated by rope.cu");
  using Tile = BwdTile<D, kDkv>;
  constexpr int kStages = Tile::kStages;
  constexpr int kWgs = Tile::kWgs;
  constexpr int kN = Tile::kN;
  const int group = p.H / p.G;
  // K2: the block's query head; K3: its kv head
  const int heads = kDkv ? p.G : p.H;
  const int b = blockIdx.x / heads;
  const int hb = blockIdx.x % heads;
  const int kvh = kDkv ? hb : hb / group;
  const int m0 = (kDkv ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * Tile::kM;
  const int n_own = own_len<kDkv>(p);
  const int n_tiles = (stream_len<kDkv>(p) + kN - 1) / kN;
  const int n_heads = kDkv ? group : 1;  // streamed heads (K3: the group's)
  const int j_first = bwd_next_tile<kDkv, kN>(p, m0, Tile::kM, 0, n_tiles);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sOwn1 = base;
  const uint32_t sOwn2 = base + Tile::kOwn;
  const uint32_t sStr1 = base + 2 * Tile::kOwn;
  const uint32_t sStr2 = sStr1 + kStages * Tile::kTile;
  float* stats = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                          Tile::kStatsAt);
  const uint32_t bar_own = base + Tile::kBars;
  const uint32_t bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, Tile::kFullArrivals);
      mbar_init(bar_empty + 8 * s, Tile::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // The warpgroup, broadcast from lane 0 so that ptxas sees a warp-uniform
  // value (a branch on a thread-dependent one serializes the wgmmas inside).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (wg == kWgs) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<Tile::kProducerRegs>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x >= Tile::kConsumers + Tile::kFullArrivals) return;
    const CUtensorMap* own1 = kDkv ? &p.tk : &p.tq;
    const CUtensorMap* own2 = kDkv ? &p.tv : &p.tdo;
    const CUtensorMap* str1 = kDkv ? &p.tq : &p.tk;
    const CUtensorMap* str2 = kDkv ? &p.tdo : &p.tv;
    if (lane == 0) {
      prefetch_tensor_map(own1);
      prefetch_tensor_map(own2);
      prefetch_tensor_map(str1);
      prefetch_tensor_map(str2);
      mbar_arrive_expect_tx(bar_own, 2 * Tile::kOwn);
      for (int x = 0; x < Tile::kBoxes; ++x)
        for (int w = 0; w < kWgs; ++w) {
          const uint32_t off = (x * kWgs + w) * Tile::kOwnBox;
          const int row = m0 + w * kBwdRows;
          tma_load_4d(sOwn1 + off, own1, bar_own, x * Tile::kCols, row, hb,
                      b);
          tma_load_4d(sOwn2 + off, own2, bar_own, x * Tile::kCols, row, hb,
                      b);
        }
    }
    int it = 0;
    for (int g = 0; g < n_heads; ++g) {
      const int h = kDkv ? kvh * group + g : kvh;  // the streamed head
      for (int j = j_first; j < n_tiles;
           j = bwd_next_tile<kDkv, kN>(p, m0, Tile::kM, j + 1, n_tiles),
               ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        if constexpr (kDkv) {
          const long long row_base =
              (static_cast<long long>(b) * p.H + h) * p.Lq;
          float* st = stats + s * Tile::kStats;
          for (int c = lane; c < kN; c += 32) {
            const int q = j * kN + c;
            const bool valid = q < p.Lq;
            st[c] = valid ? p.lse[row_base + q] * kLog2e : 0.f;
            st[kN + c] = valid ? p.delta[row_base + q] : 0.f;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * Tile::kTile);
          for (int x = 0; x < Tile::kBoxes; ++x) {
            const uint32_t off = s * Tile::kTile + x * Tile::kBox;
            tma_load_4d(sStr1 + off, str1, full, x * Tile::kCols, j * kN, h,
                        b);
            tma_load_4d(sStr2 + off, str2, full, x * Tile::kCols, j * kN, h,
                        b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<Tile::kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tc = (lane & 3) * 2;
  const int wrow = m0 + wg * kBwdRows;  // this warpgroup's first row
  const int row0 = wrow + warp * 16 + lane / 4;
  // K2: this lane's rows' lse (log2 units) and delta
  float lse2[2], dlt[2];
  if constexpr (!kDkv) {
    const long long row_base = (static_cast<long long>(b) * p.H + hb) * p.Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool valid = row < p.Lq;
      lse2[r] = valid ? p.lse[row_base + row] * kLog2e : 0.f;
      dlt[r] = valid ? p.delta[row_base + row] : 0.f;
    }
  }
  const float scale2 = p.scale * kLog2e;
  const uint32_t own1 = sOwn1 + wg * Tile::kOwnBox;  // this warpgroup's rows
  const uint32_t own2 = sOwn2 + wg * Tile::kOwnBox;

  mbar_wait(bar_own, 0);

  float x[kN / 2], y[kN / 2];    // X, then P; Y, then dS (64 x kN)
  uint32_t pa[kN / 16][4];       // K3: P^T in bf16, the A fragments of dV
  uint32_t da[kN / 16][4];       // dS in bf16, the A fragments of acc1
  float acc1[D / 2];             // K2: dQ; K3: dK
  float acc2[kDkv ? D / 2 : 1];  // K3: dV
  // The accumulators are first written by their first product (a constant
  // zero there would make ptxas copy accumulator registers between wgmmas
  // and serialize them).
  bool live = false;
  int it = 0;
  for (int g = 0; g < n_heads; ++g) {
    for (int j = j_first; j < n_tiles;
         j = bwd_next_tile<kDkv, kN>(p, m0, Tile::kM, j + 1, n_tiles),
             ++it) {
      const int stage = it % kStages;
      const int c0 = j * kN;
      // Whether this warpgroup's rows see an entry of the tile (rows past
      // the end are never stored). A warpgroup that sees none only hands
      // the stage back.
      const bool sees = wrow < n_own && bwd_tile_visible<kDkv, kN>(
                                            p, wrow, wrow + kBwdRows - 1, c0);
      mbar_wait(bar_full + 8 * stage, (it / kStages) & 1);
      if (sees) {
        const uint32_t t1 = sStr1 + stage * Tile::kTile;
        const uint32_t t2 = sStr2 + stage * Tile::kTile;
        fence_operands(x);
        fence_operands(y);
        wgmma_fence();
        tile_rst<D, kDkv>(x, own1, t1);
        tile_rst<D, kDkv>(y, own2, t2);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(x);
        fence_operands(y);
        if (bwd_tile_needs_mask<kDkv, kN>(p, wrow, wrow + kBwdRows - 1, c0))
          mask_scores<kDkv, kN>(p, x, row0, c0, tc);
        const float* st = stats + stage * Tile::kStats;
#pragma unroll
        for (int i = 0; i < kN / 8; ++i) {
          float col_lse[2], col_dlt[2];  // K3: the columns' (queries')
          if constexpr (kDkv) {
            const float2 l = *reinterpret_cast<const float2*>(st + i * 8 + tc);
            const float2 d =
                *reinterpret_cast<const float2*>(st + kN + i * 8 + tc);
            col_lse[0] = l.x;
            col_lse[1] = l.y;
            col_dlt[0] = d.x;
            col_dlt[1] = d.y;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = e & 1;
            const float l = kDkv ? col_lse[c] : lse2[r];
            const float dd = kDkv ? col_dlt[c] : dlt[r];
            const float pr = ex2(fmaf(x[4 * i + e], scale2, -l));
            x[4 * i + e] = pr;
            y[4 * i + e] = pr * (y[4 * i + e] - dd) * p.scale;
          }
        }
        to_a<kN>(da, y);
        if constexpr (kDkv) to_a<kN>(pa, x);
        wgmma_fence();
        tile_as<D, kDkv>(acc1, da, t1, live);
        if constexpr (kDkv) tile_as<D, kDkv>(acc2, pa, t2, live);
        wgmma_commit();
        live = true;
        wgmma_wait<0>();
        fence_operands(acc1);
        if constexpr (kDkv) fence_operands(acc2);
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          fence_operands(da[kk]);
          if constexpr (kDkv) fence_operands(pa[kk]);
        }
      }
      mbar_arrive(bar_empty + 8 * stage);
    }
  }

  if constexpr (kRing) {
    // The carried sums plus this step's; a warpgroup that saw no tile
    // leaves its rows as they were (where K2 and K3 store zeros).
    float* sum1 = static_cast<float*>(p.out1) + b * p.s1.b + hb * p.s1.h;
    if (!live) return;
    add_rows<D>(sum1, p.s1.l, acc1, row0, n_own, tc);
    if constexpr (kDkv)
      add_rows<D>(static_cast<float*>(p.out2) + b * p.s2.b + hb * p.s2.h,
                  p.s2.l, acc2, row0, n_own, tc);
  } else {
    // dQ (K2) or dK (K3) back from rotated space: the transpose rotation at
    // the owned rows' positions
    const Chunks& own_c = kDkv ? p.kc : p.qc;
    if (kRot && live) unrotate_rows<D>(acc1, row0, n_own, own_c, p.rope, tc);
    TO* out1 = static_cast<TO*>(p.out1) + b * p.s1.b + hb * p.s1.h;
    store_rows<D, TO>(out1, p.s1.l, acc1, row0, n_own, tc, live);
    if constexpr (kDkv) {
      TO* out2 = static_cast<TO*>(p.out2) + b * p.s2.b + hb * p.s2.h;
      store_rows<D, TO>(out2, p.s2.l, acc2, row0, n_own, tc, live);
    }
  }
}

// Encodes the maps of q, k, v and dout from `maps` (4 x 11: dims, byte
// strides, box, as flash_attention.tensor_map returns them) after checking
// that the boxes are the tiles this kernel takes, and launches.
template <int D, bool kDkv, bool kRing, bool kRot, typename TO>
cudaError_t run_bwd(BwdParams& p, const void* const* qkvd,
                    const long long* maps, int B, cudaStream_t stream) {
  using Tile = BwdTile<D, kDkv>;
  CUtensorMap* dst[4] = {&p.tq, &p.tk, &p.tv, &p.tdo};
  for (int i = 0; i < 4; ++i) {
    const long long* m = maps + 11 * i;
    const bool owned = (i == 0 || i == 3) != kDkv;  // K2: q, dout; K3: k, v
    if (m[0] != D || m[7] != Tile::kCols ||
        m[8] != (owned ? kBwdRows : Tile::kN) || m[9] != 1 || m[10] != 1)
      return cudaErrorInvalidValue;
    const cudaError_t err =
        encode_map(dst[i], qkvd[i], m,
                   Tile::kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_bwd_kernel<D, kDkv, kRing, kRot, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return err;
  const int rows = kDkv ? p.Lk : p.Lq;
  const dim3 grid(B * (kDkv ? p.G : p.H), (rows + Tile::kM - 1) / Tile::kM);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDkv, bool kRing, bool kRot, typename TO>
cudaError_t run_bwd_dr(BwdParams& p, const void* const* qkvd,
                       const long long* maps, int B, int D,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return run_bwd<32, kDkv, kRing, kRot, TO>(p, qkvd, maps, B, stream);
    case 64:
      return run_bwd<64, kDkv, kRing, kRot, TO>(p, qkvd, maps, B, stream);
    case 128:
      return run_bwd<128, kDkv, kRing, kRot, TO>(p, qkvd, maps, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K2 or K3, counter-rotating dQ or dK where the tables are given (q and k
// rotated already), else without rotary.
template <bool kDkv, typename TO>
cudaError_t run_bwd_d(BwdParams& p, const void* const* qkvd,
                      const long long* maps, int B, int D,
                      cudaStream_t stream) {
  if (p.rope.cos != nullptr)
    return run_bwd_dr<kDkv, false, true, TO>(p, qkvd, maps, B, D, stream);
  return run_bwd_dr<kDkv, false, false, TO>(p, qkvd, maps, B, D, stream);
}

// K2 or K3 with outputs in `dtype` (0 = bfloat16, 1 = float32).
template <bool kDkv>
int run_flash_bwd(BwdParams& p, const void* const* qkvd,
                  const long long* maps, int B, int D, int dtype,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_bwd_d<kDkv, bf16>(p, qkvd, maps, B, D, st);
  if (dtype == 1) return run_bwd_d<kDkv, float>(p, qkvd, maps, B, D, st);
  return cudaErrorInvalidValue;
}

BwdParams bwd_params(const void* lse, const void* delta, void* out1,
                     void* out2, const void* rope_cos, const void* rope_sin,
                     int H, int G, int Lq, int Lk, float scale, int causal) {
  BwdParams p = {};
  p.rope = Rope{static_cast<const float*>(rope_cos),
                static_cast<const float*>(rope_sin)};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out1 = out1;
  p.out2 = out2;
  p.H = H;
  p.G = G;
  p.Lq = Lq;
  p.Lk = Lk;
  p.qc = Chunks{0, Lq, Lq};
  p.kc = Chunks{0, Lk, Lk};
  p.scale = scale;
  p.causal = causal;
  return p;
}

// K5 or K6: the shards' chunks, contiguous f32 sums ([B, H, Lq, D] or
// [B, G, Lk, D]), launched.
template <bool kDkv>
int run_ring_bwd(BwdParams& p, const void* const* qkvd,
                 const long long* maps, int B, int D, const int* chunks,
                 void* stream) {
  p.qc = Chunks{chunks[0], chunks[1], chunks[2]};
  p.kc = Chunks{chunks[3], chunks[4], chunks[5]};
  const int heads = kDkv ? p.G : p.H, rows = kDkv ? p.Lk : p.Lq;
  const Strides s = {static_cast<long long>(heads) * rows * D,
                     static_cast<long long>(rows) * D, D};
  p.s1 = p.s2 = s;
  return run_bwd_dr<kDkv, true, false, float>(
      p, qkvd, maps, B, D, static_cast<cudaStream_t>(stream));
}

}  // namespace hvdflash

// K2. q, dout [B, H, L, D] and k, v [B, G, L, D]: bf16 views through `maps`
// (4 x 11 values, flash_attention.tensor_map; q and dout with 64-row boxes,
// k and v with the streamed tile's); lse, delta: f32 [B, H, L]; dq in
// `dtype` (0 = bfloat16, 1 = float32) at out_strides (batch, head, row);
// rope_cos, rope_sin: f32 [positions, D / 2] rotary tables, or null for no
// rotary (with them, q and k must come rotated at 0..L-1, as rope.cu
// rotates them, and dq is counter-rotated). Returns the cudaError_t of the
// launch.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const void* rope_cos, const void* rope_sin,
                                const long long* maps,
                                const long long* out_strides, int B, int H,
                                int G, int L, int D, int dtype, float scale,
                                int causal, void* stream) {
  using namespace hvdflash;
  BwdParams p = bwd_params(lse, delta, dq, nullptr, rope_cos, rope_sin, H, G,
                           L, L, scale, causal);
  fill_strides(&p.s1, out_strides, 1);
  const void* qkvd[4] = {q, k, v, dout};
  return run_flash_bwd<false>(p, qkvd, maps, B, D, dtype, stream);
}

// K3. As K2, with k and v in 64-row boxes and q and dout in the streamed
// tile's; dk, dv [B, G, L, D] at out_strides (2 x (batch, head, row)).
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const void* rope_cos, const void* rope_sin,
                                 const long long* maps,
                                 const long long* out_strides, int B, int H,
                                 int G, int L, int D, int dtype, float scale,
                                 int causal, void* stream) {
  using namespace hvdflash;
  BwdParams p = bwd_params(lse, delta, dk, dv, rope_cos, rope_sin, H, G, L, L,
                           scale, causal);
  fill_strides(&p.s1, out_strides, 1);
  fill_strides(&p.s2, out_strides + 3, 1);
  const void* qkvd[4] = {q, k, v, dout};
  return run_flash_bwd<true>(p, qkvd, maps, B, D, dtype, stream);
}

// K5. q, dout [B, H, Lq, D] and k, v [B, G, Lk, D]: bf16 views through
// `maps`, boxed as K2's; lse (the whole ring's, natural log), delta: f32
// [B, H, Lq]; dq: the carried f32 sum [B, H, Lq, D], contiguous, updated in
// place; chunks: (off0, off1, len) of the q shard, then of the k/v shard.
// Under rotary q and k come rotated at their global positions (rope.cu) and
// dq stays in rotated space.
extern "C" int hvd_flash_ring_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, const long long* maps, int B,
                                     int H, int G, int Lq, int Lk, int D,
                                     const int* chunks, float scale,
                                     int causal, void* stream) {
  using namespace hvdflash;
  BwdParams p = bwd_params(lse, delta, dq, nullptr, nullptr, nullptr, H, G,
                           Lq, Lk, scale, causal);
  const void* qkvd[4] = {q, k, v, dout};
  return run_ring_bwd<false>(p, qkvd, maps, B, D, chunks, stream);
}

// K6. As K5, boxed as K3's; dk, dv: the carried f32 sums [B, G, Lk, D],
// contiguous, updated in place (dk in rotated space under rotary).
extern "C" int hvd_flash_ring_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv,
                                      const long long* maps, int B, int H,
                                      int G, int Lq, int Lk, int D,
                                      const int* chunks, float scale,
                                      int causal, void* stream) {
  using namespace hvdflash;
  BwdParams p = bwd_params(lse, delta, dk, dv, nullptr, nullptr, H, G, Lq,
                           Lk, scale, causal);
  const void* qkvd[4] = {q, k, v, dout};
  return run_ring_bwd<true>(p, qkvd, maps, B, D, chunks, stream);
}
