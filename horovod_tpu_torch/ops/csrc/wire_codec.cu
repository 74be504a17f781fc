// Wire codec of the f32-accumulating ring: the per-hop encode and decode-add.
//
// Replaces: no Pallas kernel. On the TPU, XLA fuses the codec into each hop
// of the ring's fori_loop (horovod_tpu/parallel/ring.py:_ring_codec, over
// horovod_tpu/compression/__init__.py:quantize_int8_jax and
// dequantize_int8_jax, and the bf16 cast); here each hop of
// horovod_tpu_torch/parallel/ring.py calls these two kernels on its chunk.
//   hvd_wire_encode: int8, per block of 256 elements, amax = max |x|
//     (NaN-propagating); scale = amax / 127 if amax is finite and > 0, 0 if
//     amax == 0, NaN if amax is not finite; inv = 1 / scale where scale is
//     finite and > 0, else 0; q = clip(rint(nan_to_num(x * inv)), -127,
//     127). bf16: round to nearest even.
//   hvd_wire_decode_add: acc + q * scale[block] (or q * scale into the
//     destination, add = 0); bf16: acc + float(p).
// Every operation is its own correctly rounded intrinsic (__fdiv_rn,
// __fmul_rn, __fadd_rn, rintf: never contracted into an FMA, never a
// multiply by a reciprocal), so each kernel equals its plain version
// (ops/wire_codec.py) bit for bit, NaN where NaN.
//
// Bound on the H100: bytes. A few operations an element against the card's
// 295 operations a byte. At the LM's chunk over 4 ranks (c = 33,526,528
// f32): int8 encode reads 4 c and writes c + c / 64 bytes (0.050 ms at
// 3.35 TB/s), int8 decode-add reads c + c / 64 + 4 c and writes 4 c (0.090
// ms); bf16 encode 6 c (0.060 ms), bf16 decode-add 10 c (0.100 ms).
//
// Design, simple first: one warp per block of 256 elements, 8 elements a
// lane (two 16-byte loads of f32; 8 bytes of int8 or 16 of bf16), 8 warps
// a CUDA block, one block of 256 elements per warp and no loop. The int8
// amax meets across the warp in a __shfl_xor_sync butterfly with a max that
// keeps NaN (fmaxf drops it, and a NaN block would then quantize as if it
// were finite); lane 0 writes the block's scale. n must be a multiple of
// 256 (the ring pads its chunks) and every pointer but the scales' 16-byte
// aligned; the wrapper checks both.
// Not yet done (later work): a grid-stride loop with more bytes in flight
// per thread, and fusing the decode of one hop with the encode of the next
// (the ring's reduce-scatter leg reads each chunk it just wrote).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hvd_error.cuh"

namespace hvdwire {

constexpr int kBlock = 256;  // elements of an int8 block (compression.BLOCK)
constexpr int kPerLane = kBlock / 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
enum Mode { kBf16 = 1, kInt8 = 2 };

// max that keeps NaN: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const float* __restrict__ x, void* __restrict__ out,
                  float* __restrict__ scales, long long nblocks) {
  const long long blk = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (blk >= nblocks) return;
  const int lane = threadIdx.x & 31;
  const long long base = blk * kBlock + lane * kPerLane;
  float v[kPerLane];
  load8(x + base, v);
  if (MODE == kBf16) {
    union { __nv_bfloat16 h[kPerLane]; uint4 u; } pk;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) pk.h[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + base) = pk.u;
    return;
  }
  float amax = fabsf(v[0]);
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) amax = nan_max(amax, fabsf(v[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const bool finite = isfinite(amax);
  const float scale = !finite ? __int_as_float(0x7fc00000)
                      : amax > 0.f ? __fdiv_rn(amax, 127.f) : 0.f;
  const float inv = (finite && scale > 0.f) ? __fdiv_rn(1.f, scale) : 0.f;
  union { int8_t q[kPerLane]; uint2 u; } pk;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    float t = __fmul_rn(v[j], inv);
    if (t != t) t = 0.f;  // nan_to_num; +-inf clip to +-127 below
    t = fminf(fmaxf(rintf(t), -127.f), 127.f);
    pk.q[j] = static_cast<int8_t>(t);
  }
  *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + base) = pk.u;
  if (lane == 0) scales[blk] = scale;
}

template <int MODE, bool ADD>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const void* __restrict__ payload,
                  const float* __restrict__ scales, float* __restrict__ acc,
                  long long nblocks) {
  const long long blk = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (blk >= nblocks) return;
  const int lane = threadIdx.x & 31;
  const long long base = blk * kBlock + lane * kPerLane;
  float p[kPerLane], d[kPerLane];  // the payload's values, the decoded
  float s = 1.f;                    // the block's scale (int8)
  if (MODE == kBf16) {
    union { __nv_bfloat16 h[kPerLane]; uint4 u; } pk;
    pk.u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(payload) + base);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      d[j] = p[j] = __bfloat162float(pk.h[j]);
  } else {
    union { int8_t q[kPerLane]; uint2 u; } pk;
    pk.u = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(payload) + base);
    s = scales[blk];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      p[j] = static_cast<float>(pk.q[j]);
      d[j] = __fmul_rn(p[j], s);
    }
  }
  if (ADD) {
    float a[kPerLane];
    load8(acc + base, a);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) d[j] = __fadd_rn(a[j], d[j]);
  }
  store8(acc + base, d);
}

inline unsigned grid_of(long long nblocks) {
  return static_cast<unsigned>((nblocks + kWarps - 1) / kWarps);
}

}  // namespace hvdwire

// x: f32 [n]; out: bf16 [n] (mode 1) or int8 [n] (mode 2); scales: f32
// [n / 256] (mode 2, else unused). n % 256 == 0.
extern "C" int hvd_wire_encode(const void* x, int mode, void* out,
                               void* scales, long long n, void* stream) {
  using namespace hvdwire;
  if (n < 0 || n % kBlock != 0) return cudaErrorInvalidValue;
  const long long nblocks = n / kBlock;
  if (nblocks == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* sf = static_cast<float*>(scales);
  if (mode == kBf16)
    encode_kernel<kBf16><<<grid_of(nblocks), kThreads, 0, st>>>(
        xf, out, sf, nblocks);
  else if (mode == kInt8)
    encode_kernel<kInt8><<<grid_of(nblocks), kThreads, 0, st>>>(
        xf, out, sf, nblocks);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// payload as hvd_wire_encode's out (and scales); acc: f32 [n], written in
// place: acc + decoded (add = 1) or decoded (add = 0).
extern "C" int hvd_wire_decode_add(const void* payload, const void* scales,
                                   int mode, int add, void* acc, long long n,
                                   void* stream) {
  using namespace hvdwire;
  if (n < 0 || n % kBlock != 0) return cudaErrorInvalidValue;
  const long long nblocks = n / kBlock;
  if (nblocks == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(scales);
  float* af = static_cast<float*>(acc);
  const unsigned grid = grid_of(nblocks);
  if (mode == kBf16 && add)
    decode_kernel<kBf16, true><<<grid, kThreads, 0, st>>>(payload, sf, af,
                                                          nblocks);
  else if (mode == kBf16)
    decode_kernel<kBf16, false><<<grid, kThreads, 0, st>>>(payload, sf, af,
                                                           nblocks);
  else if (mode == kInt8 && add)
    decode_kernel<kInt8, true><<<grid, kThreads, 0, st>>>(payload, sf, af,
                                                          nblocks);
  else if (mode == kInt8)
    decode_kernel<kInt8, false><<<grid, kThreads, 0, st>>>(payload, sf, af,
                                                           nblocks);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
