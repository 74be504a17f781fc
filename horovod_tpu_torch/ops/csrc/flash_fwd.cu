// Flash-attention forward (kernel K1).
//
// Replaces: horovod_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _pallas_forward_lse). Computes O = softmax(scale * Q K^T) V, causal or
// full, with an online softmax over 64-key tiles in f32, and writes the
// per-row log-sum-exp the backward kernels recompute P from.
//
// Bound on the H100 at the training shape (B=8, H=12, L=2048, D=64, causal):
// 2 products of 2*B*H*L*L*D/2 FLOP each, 51.5 GFLOP, 52 us at 989 TFLOP/s
// bf16; q, k, v and O are 4 * 25 MB, 30 us at 3.35 TB/s. So it is bound by
// the tensor cores.
//
// Design: one block of 4 warps per (batch*head, 64-row q tile); each warp
// owns 16 q rows. Q goes once through shared memory into registers as mma A
// fragments. The 64-key tiles of K and V are double-buffered in shared
// memory: cp.async brings tile j+1 while the tensor cores (mma.sync, bf16 in,
// f32 accumulators) work on tile j, and ldmatrix feeds them the fragments.
// The score tile stays in registers, is turned into P there, and is the A
// operand of P.V without a round trip through shared memory. Causal runs
// stop the key loop at the diagonal, so tiles above it cost neither loads
// nor products, and the element mask runs only on tiles that straddle the
// diagonal or the ragged end of L. The q tiles are issued from the last
// (most work under the causal mask) to the first, to even out the tail of
// the grid. GQA: query head h reads kv head h / (H / G); nothing is copied
// to H heads.
// Not yet done (later work): wgmma, TMA and warp specialisation.
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlockN * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBlockM * kLd;  // 2 buffers
  bf16* sV = sK + 2 * kTile;      // 2 buffers

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tc = (lane & 3) * 2;
  const int row0 = m0 + warp * 16 + (lane >> 2);  // this thread's rows:
  const int rows[2] = {row0, row0 + 8};           // row0 and row0 + 8
  const int offa = a_off<kLd>(lane), offb = bt_off<kLd>(lane);

  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;

  load_tile<T, D>(sQ, q, p.sq.l, m0, p.L);
  cp_async_commit();
  load_tile<T, D>(sK, k, p.sk.l, 0, p.L);
  load_tile<T, D>(sV, v, p.sv.l, 0, p.L);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; K/V tile 0 may still be in flight
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qa[kk], sQ + warp * 16 * kLd + kk * 16 + offa);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};              // this lane's share of the sum
  const float scale2 = p.scale * kLog2e;

  const int n_end = p.causal ? min(p.L, m0 + kBlockM) : p.L;
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    if (j + 1 < n_tiles) {  // the next tile into the other buffer
      load_tile<T, D>(sK + ((j + 1) & 1) * kTile, k, p.sk.l, n0 + kBlockN,
                      p.L);
      load_tile<T, D>(sV + ((j + 1) & 1) * kTile, v, p.sv.l, n0 + kBlockN,
                      p.L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const bf16* cK = sK + (j & 1) * kTile;
    const bf16* cV = sV + (j & 1) * kTile;

    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; nt += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, cK + nt * 8 * kLd + kk * 16 + offb);
        mma_pair(s[nt], s[nt + 1], qa[kk], bk);
      }
    }

    const bool need_mask =
        n0 + kBlockN > p.L || (p.causal && n0 + kBlockN - 1 > m0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale2;
        if (need_mask) {
          const int col = n0 + nt * 8 + tc + (e & 1);
          if (col >= p.L || (p.causal && col > rows[e >> 1])) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      // A row that has seen no visible key keeps m = -inf; subtracting 0
      // then turns its masked scores into exp2(-inf) = 0, never NaN.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      const float alpha = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e >> 1]);
        l_run[e >> 1] += s[nt][e];
      }
    }

    // O += P . V, P rounded to bf16 as the TPU kernel rounds it to V's type.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, cV + kk * 16 * kLd + dt * 8 + offa);
        mma_pair(acc[dt], acc[dt + 1], pa, bv);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  T* out = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
  float* lse = p.lse_out + (static_cast<long long>(b) * p.H + h) * p.L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = quad_sum(l_run[r]);
    if (l == 0.f) l = 1.f;  // a row with no visible key
    const float inv = 1.f / l;
    const int row = rows[r];
    if (row < p.L) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        store2(out + row * p.so.l + dt * 8 + tc, acc[dt][2 * r] * inv,
               acc[dt][2 * r + 1] * inv);
      if (tc == 0) lse[row] = m_run[r] * kLn2 + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t run_fwd(const Params& p, cudaStream_t stream) {
  const int smem = (kBlockM + 4 * kBlockN) * (D + kPad) * sizeof(bf16);
  const dim3 grid((p.L + kBlockM - 1) / kBlockM, p.B * p.H);
  return launch(flash_fwd_kernel<T, D>, grid, smem, stream, p);
}

template <typename T>
cudaError_t run_fwd_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return run_fwd<T, 32>(p, stream);
    case 64: return run_fwd<T, 64>(p, stream);
    case 128: return run_fwd<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hvdflash

// strides: 4 x (batch, head, row) element strides of q, k, v, out.
// dtype: 0 = bfloat16, 1 = float32 (products then take bf16-rounded inputs).
// Returns the cudaError_t of the launch.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int H, int G, int L, int D, int dtype,
                             float scale, int causal, void* stream) {
  using namespace hvdflash;
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  Strides s[4];
  fill_strides(s, strides, 4);
  p.sq = s[0];
  p.sk = s[1];
  p.sv = s[2];
  p.so = s[3];
  p.B = B;
  p.H = H;
  p.G = G;
  p.L = L;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_fwd_d<bf16>(p, D, st);
  if (dtype == 1) return run_fwd_d<float>(p, D, st);
  return cudaErrorInvalidValue;
}
