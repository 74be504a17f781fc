// Flash-attention backward: dQ (kernel K2) and dK/dV (kernel K3).
//
// Replaces: horovod_tpu/ops/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (both launched by _pallas_backward). P is recomputed from
// the forward's log-sum-exp, P = exp(scale * Q K^T - lse); with
// delta = rowsum(dO * O) computed outside (as XLA computes it for the TPU):
//   dS = P * (dO V^T - delta) * scale
//   K2: dQ = dS K                      (3 products per tile pair)
//   K3: dV = P^T dO, dK = dS^T Q       (4 products per tile pair)
// summed over the H / G query heads of a kv head inside K3 (GQA), so dK and
// dV are written once at G heads.
//
// Bound on the H100 at the training shape (B=8, H=12, L=2048, D=64, causal):
// K2 does 3 * 25.8 = 77.3 GFLOP, 78 us at 989 TFLOP/s bf16; K3 does 103.1
// GFLOP, 104 us. Each reads and writes about 5 * 25 MB (40 us at 3.35 TB/s),
// so both are bound by the tensor cores.
//
// Design: one block of 4 warps per 64-row tile that the block owns (q rows in
// K2, key rows in K3), each warp 16 rows. The owned rows' operands (Q and dO
// in K2, K and V in K3) go once through shared memory into registers as mma
// A fragments; the other side is streamed in 64-row tiles, double-buffered
// in shared memory (cp.async brings tile j+1 while tile j is multiplied) and
// read with ldmatrix. Score and dP tiles stay in registers and become P and
// dS there, feeding the next product as A fragments (bf16 in, f32
// accumulators).
// K2 walks key tiles up to the diagonal; K3 walks q tiles from the diagonal
// on. Only tiles that straddle the diagonal or the ragged end of L pay the
// element mask. Masked entries are set to 0 outright, so P is never
// exp(+inf) for a padded row. Precision follows the TPU kernels: P is
// rounded to dO's type before the dV product and dS to Q's type before the
// dK (and K's before the dQ) product.
// Not yet done (later work): wgmma, TMA and warp specialisation.
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlockN * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kBlockM * kLd;
  bf16* sK = sDO + kBlockM * kLd;  // 2 buffers
  bf16* sV = sK + 2 * kTile;       // 2 buffers

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
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
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.L;

  load_tile<T, D>(sQ, q, p.sq.l, m0, p.L);
  load_tile<T, D>(sDO, dout, p.sdo.l, m0, p.L);
  cp_async_commit();
  load_tile<T, D>(sK, k, p.sk.l, 0, p.L);
  load_tile<T, D>(sV, v, p.sv.l, 0, p.L);
  cp_async_commit();
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < p.L;
    lse2[r] = in ? p.lse[row_base + rows[r]] * kLog2e : 0.f;
    dlt[r] = in ? p.delta[row_base + rows[r]] : 0.f;
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(qa[kk], sQ + warp * 16 * kLd + kk * 16 + offa);
    ldsm_x4(da[kk], sDO + warp * 16 * kLd + kk * 16 + offa);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  const float scale2 = p.scale * kLog2e;

  const int n_end = p.causal ? min(p.L, m0 + kBlockM) : p.L;
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    if (j + 1 < n_tiles) {
      load_tile<T, D>(sK + ((j + 1) & 1) * kTile, k, p.sk.l, n0 + kBlockN,
                      p.L);
      load_tile<T, D>(sV + ((j + 1) & 1) * kTile, v, p.sv.l, n0 + kBlockN,
                      p.L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + (j & 1) * kTile;
    const bf16* cV = sV + (j & 1) * kTile;

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

    const bool need_mask = n0 + kBlockN > p.L || m0 + kBlockM > p.L ||
                           (p.causal && n0 + kBlockN - 1 > m0);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        bool masked = false;
        if (need_mask) {
          const int col = n0 + nt * 8 + tc + (e & 1);
          masked = col >= p.L || row >= p.L || (p.causal && col > row);
        }
        const float pr =
            masked ? 0.f : exp2f(s[nt][e] * scale2 - lse2[e >> 1]);
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
  }

  T* dq = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row < p.L) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        store2(dq + row * p.sdq.l + dt * 8 + tc, acc[dt][2 * r],
               acc[dt][2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
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
  const int b = blockIdx.y / p.G;
  const int kvh = blockIdx.y % p.G;
  const int group = p.H / p.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tc = (lane & 3) * 2;
  const int key0 = n0 + warp * 16 + (lane >> 2);
  const int keys[2] = {key0, key0 + 8};
  const int offa = a_off<kLd>(lane), offb = bt_off<kLd>(lane);

  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  load_tile<T, D>(sK, k, p.sk.l, n0, p.L);
  load_tile<T, D>(sV, v, p.sv.l, n0, p.L);
  cp_async_commit();

  // The (head, q tile) steps this block walks: the group's H / G query
  // heads, each from the first q tile that sees these keys (causal: tiles
  // are equal, so the one starting at n0) to the end.
  const int m_start = p.causal ? n0 : 0;
  const int m_tiles = (p.L - m_start + kBlockN - 1) / kBlockN;
  const int n_steps = group * m_tiles;
  auto stage = [&](int step, int buf) {
    const int h = kvh * group + step / m_tiles;
    const int m0 = m_start + (step % m_tiles) * kBlockN;
    load_tile<T, D>(sQ + buf * kTile,
                    static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
                    p.sq.l, m0, p.L);
    load_tile<T, D>(sDO + buf * kTile,
                    static_cast<const T*>(p.dout) + b * p.sdo.b +
                        h * p.sdo.h,
                    p.sdo.l, m0, p.L);
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.L;
    for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
      const bool in = m0 + i < p.L;
      sLse[buf * kBlockN + i] = in ? p.lse[row_base + m0 + i] * kLog2e : 0.f;
      sDelta[buf * kBlockN + i] = in ? p.delta[row_base + m0 + i] : 0.f;
    }
  };
  stage(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(ka[kk], sK + warp * 16 * kLd + kk * 16 + offa);
    ldsm_x4(va[kk], sV + warp * 16 * kLd + kk * 16 + offa);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }
  const float scale2 = p.scale * kLog2e;

  for (int j = 0; j < n_steps; ++j) {
    const int m0 = m_start + (j % m_tiles) * kBlockN;
    if (j + 1 < n_steps) stage(j + 1, (j + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ + (j & 1) * kTile;
    const bf16* cDO = sDO + (j & 1) * kTile;
    const float* cLse = sLse + (j & 1) * kBlockN;
    const float* cDelta = sDelta + (j & 1) * kBlockN;

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

    const bool need_mask =
        m0 + kBlockN > p.L || (p.causal && m0 < n0 + kBlockM - 1);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + tc + (e & 1);  // query within the tile
        bool masked = false;
        if (need_mask) {
          const int qrow = m0 + i;
          masked = qrow >= p.L || (p.causal && qrow < keys[e >> 1]);
        }
        const float pr =
            masked ? 0.f : exp2f(st[nt][e] * scale2 - cLse[i]);
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
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = keys[r];
    if (key < p.L) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        store2(dkp + key * p.sdk.l + dt * 8 + tc, dk[dt][2 * r],
               dk[dt][2 * r + 1]);
        store2(dvp + key * p.sdv.l + dt * 8 + tc, dv[dt][2 * r],
               dv[dt][2 * r + 1]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t run_bwd(const Params& p, bool dkv, cudaStream_t stream) {
  const int smem = (2 * kBlockM + 4 * kBlockN) * (D + kPad) * sizeof(bf16) +
                   (dkv ? 4 * kBlockN * sizeof(float) : 0);
  if (dkv) {
    const dim3 grid((p.L + kBlockM - 1) / kBlockM, p.B * p.G);
    return launch(flash_bwd_dkv_kernel<T, D>, grid, smem, stream, p);
  }
  const dim3 grid((p.L + kBlockM - 1) / kBlockM, p.B * p.H);
  return launch(flash_bwd_dq_kernel<T, D>, grid, smem, stream, p);
}

template <typename T>
cudaError_t run_bwd_d(const Params& p, int D, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 32: return run_bwd<T, 32>(p, dkv, stream);
    case 64: return run_bwd<T, 64>(p, dkv, stream);
    case 128: return run_bwd<T, 128>(p, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

Params bwd_params(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  int B, int H, int G, int L, float scale, int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B;
  p.H = H;
  p.G = G;
  p.L = L;
  p.scale = scale;
  p.causal = causal;
  return p;
}

int run_bwd_dtype(const Params& p, int D, int dtype, bool dkv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_bwd_d<bf16>(p, D, dkv, st);
  if (dtype == 1) return run_bwd_d<float>(p, D, dkv, st);
  return cudaErrorInvalidValue;
}

}  // namespace hvdflash

// strides: 5 x (batch, head, row) element strides of q, k, v, dout, dq.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const long long* strides, int B, int H, int G,
                                int L, int D, int dtype, float scale,
                                int causal, void* stream) {
  using namespace hvdflash;
  Params p = bwd_params(q, k, v, dout, lse, delta, B, H, G, L, scale, causal);
  p.dq = dq;
  Strides s[5];
  fill_strides(s, strides, 5);
  p.sq = s[0];
  p.sk = s[1];
  p.sv = s[2];
  p.sdo = s[3];
  p.sdq = s[4];
  return run_bwd_dtype(p, D, dtype, false, stream);
}

// strides: 6 x (batch, head, row) element strides of q, k, v, dout, dk, dv.
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int H, int G,
                                 int L, int D, int dtype, float scale,
                                 int causal, void* stream) {
  using namespace hvdflash;
  Params p = bwd_params(q, k, v, dout, lse, delta, B, H, G, L, scale, causal);
  p.dk = dk;
  p.dv = dv;
  Strides s[6];
  fill_strides(s, strides, 6);
  p.sq = s[0];
  p.sk = s[1];
  p.sv = s[2];
  p.sdo = s[3];
  p.sdk = s[4];
  p.sdv = s[5];
  return run_bwd_dtype(p, D, dtype, true, stream);
}
