// The rotary embedding of q or k, one pass over the tensor, once a layer in
// the flash forward; the backward reads the same rotated copies.
//
// Replaces: the rotation that the rotary branches of
// horovod_tpu/ops/flash_attention.py:_fwd_kernel (:190, :201), the ring's
// _ring_step_kernel (:462, :470), _bwd_dq_kernel (:869), _bwd_dkv_kernel
// (:928), _ring_bwd_dq_kernel (:651) and _ring_bwd_dkv_kernel (:705) apply
// to q and k (_rot_apply, :93). On the TPU each grid step rotates the q or
// k block it holds in VMEM, from tables streamed beside it. On this card a
// mainloop (flash_fwd.cu, flash_bwd.cu) would do that in every block that
// reads a tile: at L = 8192 causal each 128-row tile about 32 times, on the
// consumer warpgroups that should issue wgmma, with 64 KB of f32 tables a
// tile from L2. So q and k are rotated once a layer here, before K1 (or the
// ring's K4 steps); autograd keeps the rotated copies, and K2, K3, K5 and
// K6 read them through their tensor maps.
//
// Function: y = x rotated at the rows' global positions (Chunks: one chunk,
// or the two of a zigzag shard), element j < D/2 of a row at position p and
// its partner j + D/2 becoming
//   x_j cos - x_{j+D/2} sin   and   x_{j+D/2} cos + x_j sin,
// cos and sin of p * base^(-2j/D) from the f32 [positions, D/2] tables of
// flash_attention.rope_tables. Each product and the sum round apart
// (__fmul_rn, __fsub_rn, __fadd_rn: no fused multiply-add) and the result
// rounds to bf16 once, as the plain version's separate PyTorch operations
// (flash_attention.apply_rotary) do: the output equals it bit for bit.
//
// Bound: bytes. At the long-context LM's launch ([2, 6, 8192, 128] q and
// [2, 2, 8192, 128] k, bf16) q and k are read and written once, 67 MB, and
// the tables of 8192 positions are 4 MB: 0.021 ms at 3.35 TB/s; the 3 f32
// operations an element take 1.5 us at 67 TFLOP/s.
//
// Design: thread (c, r) of a block takes 16-byte chunk c of the first half
// of row r (its 8 pairs) and the partner chunk in the second half. It reads
// the chunk's 8 cos and 8 sin values once and applies them to that row's
// chunk in every head: in the model's [B, L, heads, D] layout the heads of
// one position lie side by side, so the tables are read once per position
// and sequence, not once per head. Neighbouring threads take neighbouring
// chunks of a row: a warp's 16-byte loads and stores cover whole 128-byte
// lines. Rows past L are masked.
#include "flash_common.cuh"

namespace hvdflash {

constexpr int kRopeThreads = 256;

template <int D>
__global__ void __launch_bounds__(kRopeThreads)
    rope_rotate_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                       Strides sx, Strides sy, int B, int heads, int L,
                       Chunks c, Rope rope) {
  constexpr int kHalf = D / 2;
  constexpr int kChunks = kHalf / 8;  // 16-byte chunks in half a row
  constexpr int kRows = kRopeThreads / kChunks;
  const int chunk = threadIdx.x % kChunks;
  // 32-bit rows (the entry point refuses B * L past INT_MAX): a 64-bit
  // division would go through a stack frame
  const int row = blockIdx.x * kRows + threadIdx.x / kChunks;
  if (row >= B * L) return;
  const int b = row / L, l = row - b * L;
  int pos = pos_of(c, l);
  const long long at = static_cast<long long>(pos) * kHalf + chunk * 8;
  float cs[8], sn[8];
  *reinterpret_cast<float4*>(cs) =
      __ldg(reinterpret_cast<const float4*>(rope.cos + at));
  *reinterpret_cast<float4*>(cs + 4) =
      __ldg(reinterpret_cast<const float4*>(rope.cos + at + 4));
  *reinterpret_cast<float4*>(sn) =
      __ldg(reinterpret_cast<const float4*>(rope.sin + at));
  *reinterpret_cast<float4*>(sn + 4) =
      __ldg(reinterpret_cast<const float4*>(rope.sin + at + 4));
  const bf16* xr = x + b * sx.b + l * sx.l + chunk * 8;
  bf16* yr = y + b * sy.b + l * sy.l + chunk * 8;
#pragma unroll 2
  for (int h = 0; h < heads; ++h) {
    const bf16* src = xr + h * sx.h;
    bf16* dst = yr + h * sy.h;
    uint4 u = *reinterpret_cast<const uint4*>(src);
    uint4 w = *reinterpret_cast<const uint4*>(src + kHalf);
    uint32_t* us = reinterpret_cast<uint32_t*>(&u);
    uint32_t* ws = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = unpack_bf16(us[i]), p = unpack_bf16(ws[i]);
      const float c0 = cs[2 * i], c1 = cs[2 * i + 1];
      const float s0 = sn[2 * i], s1 = sn[2 * i + 1];
      us[i] = pack_bf16(__fsub_rn(__fmul_rn(a.x, c0), __fmul_rn(p.x, s0)),
                        __fsub_rn(__fmul_rn(a.y, c1), __fmul_rn(p.y, s1)));
      ws[i] = pack_bf16(__fadd_rn(__fmul_rn(a.x, s0), __fmul_rn(p.x, c0)),
                        __fadd_rn(__fmul_rn(a.y, s1), __fmul_rn(p.y, c1)));
    }
    *reinterpret_cast<uint4*>(dst) = u;
    *reinterpret_cast<uint4*>(dst + kHalf) = w;
  }
}

template <int D>
cudaError_t run_rope(const bf16* x, bf16* y, const Strides& sx,
                     const Strides& sy, int B, int heads, int L,
                     const Chunks& c, const Rope& rope, cudaStream_t stream) {
  constexpr int kRows = kRopeThreads / (D / 16);
  const unsigned blocks = static_cast<unsigned>((B * L + kRows - 1) / kRows);
  rope_rotate_kernel<D><<<blocks, kRopeThreads, 0, stream>>>(
      x, y, sx, sy, B, heads, L, c, rope);
  return cudaGetLastError();
}

}  // namespace hvdflash

// x, y: bf16 [B, heads, L, D] at strides (6 values: x's batch, head and row
// element strides, then y's; the last dim contiguous, every stride a multiple
// of 8 elements, both bases 16-byte aligned); rope_cos, rope_sin: f32
// [positions, D / 2] tables covering the rows' positions; (off0, off1, len):
// row r lies at off0 + r below len, else at off1 + r - len. Writes y = x
// rotated. Returns the cudaError_t of the launch.
extern "C" int hvd_rope_rotate(const void* x, void* y, const void* rope_cos,
                               const void* rope_sin,
                               const long long* strides, int B, int heads,
                               int L, int D, int off0, int off1, int len,
                               void* stream) {
  using namespace hvdflash;
  if (B <= 0 || heads <= 0 || L <= 0 ||
      static_cast<long long>(B) * L > 0x7fffffffLL - 256)
    return cudaErrorInvalidValue;
  Strides s[2];
  fill_strides(s, strides, 2);
  const Chunks c = {off0, off1, len};
  const Rope rope = {static_cast<const float*>(rope_cos),
                     static_cast<const float*>(rope_sin)};
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return run_rope<32>(xp, yp, s[0], s[1], B, heads, L, c, rope, st);
    case 64: return run_rope<64>(xp, yp, s[0], s[1], B, heads, L, c, rope, st);
    case 128:
      return run_rope<128>(xp, yp, s[0], s[1], B, heads, L, c, rope, st);
    default: return cudaErrorInvalidValue;
  }
}
