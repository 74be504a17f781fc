// Ring-attention backward steps: the dQ contribution (kernel K5) and the
// dK/dV contribution (kernel K6) of one ring step. The forward step (K4)
// runs on the Hopper forward mainloop in flash_fwd.cu.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_ring_bwd_dq_kernel and
// _ring_bwd_dkv_kernel (both launched by flash_ring_bwd_step). One launch is
// one ring step: the rank's q shard against the k/v shard it holds at that
// step.
//   K5: dq += dS K, P = exp(scale * Q K^T - lse) from the forward ring's lse
//       (no recompute of the forward), dS = P * (dO V^T - delta) * scale.
//   K6: dv += P^T dO, dk += dS^T Q, the GQA group summed in the block. The
//       f32 accumulators travel around the ring with their k/v shard.
// All accumulators are f32 and updated in place.
//
// Causal masks run on GLOBAL positions. A shard is one contiguous chunk or
// two equal chunks (the zigzag schedule: rank r holds chunks r and 2n-1-r),
// so row r of a shard sits at off0 + r (r < len) or off1 + r - len
// (Chunks, flash_common.cuh). A 64-row tile may straddle the two chunks; the
// mask is per element, so any ragged length works.
//
// Bound on the H100 for one off-diagonal step at B=2, H=12, Lq=Lk=2048, D=64
// (every tile visible): K5 does 3 products of 2*B*H*Lq*Lk*D (38.7 GFLOP,
// 39 us at 989 TFLOP/s bf16) and moves 51 MB; K6 4 products (51.5 GFLOP,
// 52 us) and 76 MB. Both are bound by the tensor cores.
//
// Design (mma.sync): one block of 4 warps per 64-row tile that
// the block owns (q rows in K5, key rows in K6); the owned rows' operands go
// once into registers as mma A fragments; the other side streams in 64-row
// tiles, double-buffered in shared memory by cp.async, read with ldmatrix,
// multiplied by mma.sync (bf16 in, f32 accumulators). What the ring adds:
// - a tile pair whose smallest key position exceeds its largest query
//   position is skipped, and the prefetch fetches the next VISIBLE tile, so
//   the double buffer stays in step; a step with no visible tile returns
//   before loading anything and leaves the accumulators as they were.
// Not yet done (later work): wgmma, TMA and warp specialisation.
#include "flash_common.cuh"

namespace hvdflash {

struct RingParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Lq], natural log
  const float* delta;  // [B, H, Lq]
  float* dq;           // K5: [B, H, Lq, D], in place
  float* dk;           // K6: [B, G, Lk, D], in place
  float* dv;           // K6: [B, G, Lk, D], in place
  Strides sq, sk, sv, sdo;
  int B, H, G, Lq, Lk;
  Chunks qc, kc;
  float scale;
  int causal;
};

// Whether the key tile at n0 holds a key that some query of the q tile at m0
// may see.
__device__ __forceinline__ bool tile_visible(const RingParams& p, int m0,
                                             int n0) {
  if (!p.causal) return true;
  const int q_last = min(m0 + kBlockM, p.Lq) - 1;
  const int k_last = min(n0 + kBlockN, p.Lk) - 1;
  return min_pos(p.kc, n0, k_last) <= max_pos(p.qc, m0, q_last);
}

// Whether a visible tile pair holds an entry to mask: a ragged edge, or a
// key after some query.
__device__ __forceinline__ bool tile_needs_mask(const RingParams& p, int m0,
                                                int n0) {
  if (m0 + kBlockM > p.Lq || n0 + kBlockN > p.Lk) return true;
  return p.causal && max_pos(p.kc, n0, n0 + kBlockN - 1) >
                         min_pos(p.qc, m0, m0 + kBlockM - 1);
}

__device__ __forceinline__ bool masked(const RingParams& p, int row, int col,
                                       int row_pos, int col_pos) {
  return row >= p.Lq || col >= p.Lk || (p.causal && col_pos > row_pos);
}

// The first key tile from j on that the q tile at m0 sees (n_tiles if none).
__device__ __forceinline__ int next_key_tile(const RingParams& p, int m0,
                                             int j, int n_tiles) {
  while (j < n_tiles && !tile_visible(p, m0, j * kBlockN)) ++j;
  return j;
}

// acc (the C fragments of 16 rows x D of this warp) from an f32 [L, D] slab;
// rows at or past L read as zeros.
template <int D>
__device__ __forceinline__ void load_acc(float (&acc)[D / 8][4],
                                         const float* base,
                                         const int (&rows)[2], int L,
                                         int tc) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = rows[r] < L;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float2 x = make_float2(0.f, 0.f);
      if (valid)
        x = *reinterpret_cast<const float2*>(
            base + static_cast<long long>(rows[r]) * D + dt * 8 + tc);
      acc[dt][2 * r] = x.x;
      acc[dt][2 * r + 1] = x.y;
    }
  }
}

template <int D>
__device__ __forceinline__ void store_acc(float* base,
                                          const float (&acc)[D / 8][4],
                                          const int (&rows)[2], int L,
                                          int tc) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      store2(base + static_cast<long long>(rows[r]) * D + dt * 8 + tc,
             acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ring_bwd_dq_kernel(const RingParams p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlockN * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kBlockM * kLd;
  bf16* sK = sDO + kBlockM * kLd;  // 2 buffers
  bf16* sV = sK + 2 * kTile;       // 2 buffers

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // last first
  const int n_tiles = (p.Lk + kBlockN - 1) / kBlockN;
  int j = next_key_tile(p, m0, 0, n_tiles);
  if (j >= n_tiles) return;  // nothing visible: dq stays as it is

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tc = (lane & 3) * 2;
  const int row0 = m0 + warp * 16 + (lane >> 2);
  const int rows[2] = {row0, row0 + 8};
  const int offa = a_off<kLd>(lane), offb = bt_off<kLd>(lane);

  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Lq;
  float* dq = p.dq + row_base * D;

  load_tile<T, D>(sQ, q, p.sq.l, m0, p.Lq);
  load_tile<T, D>(sDO, dout, p.sdo.l, m0, p.Lq);
  cp_async_commit();
  load_tile<T, D>(sK, k, p.sk.l, j * kBlockN, p.Lk);
  load_tile<T, D>(sV, v, p.sv.l, j * kBlockN, p.Lk);
  cp_async_commit();

  float acc[D / 8][4];
  load_acc<D>(acc, dq, rows, p.Lq, tc);  // the carried dq
  float lse2[2], dlt[2];
  int row_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < p.Lq;
    lse2[r] = in ? p.lse[row_base + rows[r]] * kLog2e : 0.f;
    dlt[r] = in ? p.delta[row_base + rows[r]] : 0.f;
    row_pos[r] = pos_of(p.qc, rows[r]);
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(qa[kk], sQ + warp * 16 * kLd + kk * 16 + offa);
    ldsm_x4(da[kk], sDO + warp * 16 * kLd + kk * 16 + offa);
  }
  const float scale2 = p.scale * kLog2e;

  for (int it = 0; j < n_tiles; ++it) {
    const int n0 = j * kBlockN;
    const int jn = next_key_tile(p, m0, j + 1, n_tiles);
    if (jn < n_tiles) {
      load_tile<T, D>(sK + ((it + 1) & 1) * kTile, k, p.sk.l, jn * kBlockN,
                      p.Lk);
      load_tile<T, D>(sV + ((it + 1) & 1) * kTile, v, p.sv.l, jn * kBlockN,
                      p.Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + (it & 1) * kTile;
    const bf16* cV = sV + (it & 1) * kTile;

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; nt += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, cK + nt * 8 * kLd + kk * 16 + offb);
        mma_pair(s[nt], s[nt + 1], qa[kk], bb);
        ldsm_x4(bb, cV + nt * 8 * kLd + kk * 16 + offb);
        mma_pair(dp[nt], dp[nt + 1], da[kk], bb);
      }
    }

    const bool need_mask = tile_needs_mask(p, m0, n0);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool out = false;
        if (need_mask) {
          const int col = n0 + nt * 8 + tc + (e & 1);
          out = masked(p, rows[e >> 1], col, row_pos[e >> 1],
                       pos_of(p.kc, col));
        }
        const float pr = out ? 0.f : exp2f(s[nt][e] * scale2 - lse2[e >> 1]);
        s[nt][e] = pr * (dp[nt][e] - dlt[e >> 1]) * p.scale;  // dS
      }
    }

    // dQ += dS . K
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t dsa[4];
      c_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, cK + kk * 16 * kLd + dt * 8 + offa);
        mma_pair(acc[dt], acc[dt + 1], dsa, bb);
      }
    }
    __syncthreads();
    j = jn;
  }
  store_acc<D>(dq, acc, rows, p.Lq, tc);
}

// The first (head, q tile) step from s on whose q tile sees the key tile at
// n0 (n_steps if none); step s is query head kvh * group + s / m_tiles, q
// tile s % m_tiles.
__device__ __forceinline__ int next_q_step(const RingParams& p, int n0, int s,
                                           int m_tiles, int n_steps) {
  while (s < n_steps && !tile_visible(p, (s % m_tiles) * kBlockN, n0)) ++s;
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ring_bwd_dkv_kernel(const RingParams p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlockN * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBlockM * kLd;
  bf16* sQ = sV + kBlockM * kLd;  // 2 buffers
  bf16* sDO = sQ + 2 * kTile;     // 2 buffers
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kTile);  // 2 x, log2
  float* sDelta = sLse + 2 * kBlockN;                        // 2 x

  const int n0 = blockIdx.x * kBlockM;  // the key rows this block owns
  const int group = p.H / p.G;
  const int m_tiles = (p.Lq + kBlockN - 1) / kBlockN;
  const int n_steps = group * m_tiles;
  int j = next_q_step(p, n0, 0, m_tiles, n_steps);
  if (j >= n_steps) return;  // no query sees these keys: dk, dv stay

  const int b = blockIdx.y / p.G;
  const int kvh = blockIdx.y % p.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tc = (lane & 3) * 2;
  const int key0 = n0 + warp * 16 + (lane >> 2);
  const int keys[2] = {key0, key0 + 8};
  const int offa = a_off<kLd>(lane), offb = bt_off<kLd>(lane);

  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const long long key_base = (static_cast<long long>(b) * p.G + kvh) * p.Lk;
  float* dkp = p.dk + key_base * D;
  float* dvp = p.dv + key_base * D;
  load_tile<T, D>(sK, k, p.sk.l, n0, p.Lk);
  load_tile<T, D>(sV, v, p.sv.l, n0, p.Lk);
  cp_async_commit();

  auto stage = [&](int step, int buf) {
    const int h = kvh * group + step / m_tiles;
    const int m0 = (step % m_tiles) * kBlockN;
    load_tile<T, D>(sQ + buf * kTile,
                    static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
                    p.sq.l, m0, p.Lq);
    load_tile<T, D>(sDO + buf * kTile,
                    static_cast<const T*>(p.dout) + b * p.sdo.b +
                        h * p.sdo.h,
                    p.sdo.l, m0, p.Lq);
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Lq;
    for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
      const bool in = m0 + i < p.Lq;
      sLse[buf * kBlockN + i] = in ? p.lse[row_base + m0 + i] * kLog2e : 0.f;
      sDelta[buf * kBlockN + i] = in ? p.delta[row_base + m0 + i] : 0.f;
    }
  };
  stage(j, 0);
  cp_async_commit();

  // The accumulators that travelled here with this k/v shard.
  float dk[D / 8][4], dv[D / 8][4];
  load_acc<D>(dk, dkp, keys, p.Lk, tc);
  load_acc<D>(dv, dvp, keys, p.Lk, tc);
  int key_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_pos[r] = pos_of(p.kc, keys[r]);

  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(ka[kk], sK + warp * 16 * kLd + kk * 16 + offa);
    ldsm_x4(va[kk], sV + warp * 16 * kLd + kk * 16 + offa);
  }
  const float scale2 = p.scale * kLog2e;

  for (int it = 0; j < n_steps; ++it) {
    const int m0 = (j % m_tiles) * kBlockN;
    const int jn = next_q_step(p, n0, j + 1, m_tiles, n_steps);
    if (jn < n_steps) stage(jn, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ + (it & 1) * kTile;
    const bf16* cDO = sDO + (it & 1) * kTile;
    const float* cLse = sLse + (it & 1) * kBlockN;
    const float* cDelta = sDelta + (it & 1) * kBlockN;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries.
    float st[kBlockN / 8][4], dpt[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; nt += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, cQ + nt * 8 * kLd + kk * 16 + offb);
        mma_pair(st[nt], st[nt + 1], ka[kk], bb);
        ldsm_x4(bb, cDO + nt * 8 * kLd + kk * 16 + offb);
        mma_pair(dpt[nt], dpt[nt + 1], va[kk], bb);
      }
    }

    const bool need_mask = tile_needs_mask(p, m0, n0);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + tc + (e & 1);  // query within the tile
        bool out = false;
        if (need_mask) {
          const int qrow = m0 + i;
          out = masked(p, qrow, keys[e >> 1], pos_of(p.qc, qrow),
                       key_pos[e >> 1]);
        }
        const float pr = out ? 0.f : exp2f(st[nt][e] * scale2 - cLse[i]);
        st[nt][e] = pr;                                        // P^T
        dpt[nt][e] = pr * (dpt[nt][e] - cDelta[i]) * p.scale;  // dS^T
      }
    }

    // dV += P^T . dO and dK += dS^T . Q
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, cDO + kk * 16 * kLd + dt * 8 + offa);
        mma_pair(dv[dt], dv[dt + 1], pa, bb);
        ldsm_x4_t(bb, cQ + kk * 16 * kLd + dt * 8 + offa);
        mma_pair(dk[dt], dk[dt + 1], dsa, bb);
      }
    }
    __syncthreads();
    j = jn;
  }
  store_acc<D>(dkp, dk, keys, p.Lk, tc);
  store_acc<D>(dvp, dv, keys, p.Lk, tc);
}

enum RingKernel { kRingDq = 1, kRingDkv = 2 };

template <typename T, int D>
cudaError_t run_ring(const RingParams& p, int which, cudaStream_t stream) {
  const int ld = (D + kPad) * sizeof(bf16);
  switch (which) {
    case kRingDq:
      return launch(ring_bwd_dq_kernel<T, D>,
                    dim3((p.Lq + kBlockM - 1) / kBlockM, p.B * p.H),
                    (2 * kBlockM + 4 * kBlockN) * ld, stream, p);
    case kRingDkv:
      return launch(
          ring_bwd_dkv_kernel<T, D>,
          dim3((p.Lk + kBlockM - 1) / kBlockM, p.B * p.G),
          (2 * kBlockM + 4 * kBlockN) * ld + 4 * kBlockN * sizeof(float),
          stream, p);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_ring_d(const RingParams& p, int D, int which,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return run_ring<T, 32>(p, which, stream);
    case 64: return run_ring<T, 64>(p, which, stream);
    case 128: return run_ring<T, 128>(p, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The shared part of the two entry points: dims, chunks, strides (4 x
// (batch, head, row) element strides of q, k, v, dout).
int run_ring_entry(RingParams& p, int which, const long long* strides, int B,
                   int H, int G, int Lq, int Lk, int D, int dtype,
                   const int* chunks, float scale, int causal,
                   void* stream) {
  Strides s[4];
  fill_strides(s, strides, 4);
  p.sq = s[0];
  p.sk = s[1];
  p.sv = s[2];
  p.sdo = s[3];
  p.B = B;
  p.H = H;
  p.G = G;
  p.Lq = Lq;
  p.Lk = Lk;
  p.qc = Chunks{chunks[0], chunks[1], chunks[2]};
  p.kc = Chunks{chunks[3], chunks[4], chunks[5]};
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_ring_d<bf16>(p, D, which, st);
  if (dtype == 1) return run_ring_d<float>(p, D, which, st);
  return cudaErrorInvalidValue;
}

}  // namespace hvdflash

// chunks: (off0, off1, len) of the q shard, then of the k/v shard.
// dtype: 0 = bfloat16, 1 = float32 (products then take bf16-rounded inputs).
// Each returns the cudaError_t of the launch.
extern "C" int hvd_flash_ring_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, const long long* strides,
                                     int B, int H, int G, int Lq, int Lk,
                                     int D, int dtype, const int* chunks,
                                     float scale, int causal, void* stream) {
  using namespace hvdflash;
  RingParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  return run_ring_entry(p, kRingDq, strides, B, H, G, Lq, Lk, D, dtype,
                        chunks, scale, causal, stream);
}

extern "C" int hvd_flash_ring_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv,
                                      const long long* strides, int B, int H,
                                      int G, int Lq, int Lk, int D, int dtype,
                                      const int* chunks, float scale,
                                      int causal, void* stream) {
  using namespace hvdflash;
  RingParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return run_ring_entry(p, kRingDkv, strides, B, H, G, Lq, Lk, D, dtype,
                        chunks, scale, causal, stream);
}
