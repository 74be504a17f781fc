// Wire compression for the host data plane (docs/COMPRESSION.md):
// the tensor (and the fusion buffer it rides in) stays float32 end to
// end — only the bytes each ring hop puts ON THE WIRE are encoded.
//
//   NONE  — payload is the raw buffer (bitwise-identical behavior to a
//           build without this stage).
//   BF16  — each f32 element is round-to-nearest bfloat16 on the wire:
//           2x fewer bytes per hop. Reduction still accumulates in f32
//           (the receiver widens before ReduceSum), so precision loss
//           is one rounding per hop, not a bf16 accumulator.
//   INT8  — EQuARX-style block-scaled quantization (PAPERS.md, arxiv
//           2506.17615): per kCompressionBlock(=256)-element block, an
//           f32 scale = max|x|/127 carried in-band ahead of the int8
//           payload. ~3.9x fewer bytes per hop; per-element error is
//           bounded by scale/2 (see CompressBuffer).
//
// The mode is negotiated per tensor (Request/Response carry it; the
// response cache keys on it), so every rank encodes/decodes identically
// or the coordinator rejects the op by name. CRC32C framing in
// RingExchangeOn covers the COMPRESSED payload — a corrupted compressed
// frame is a detected transport error, never silently wrong gradients.
#ifndef HVD_TPU_COMPRESSION_H
#define HVD_TPU_COMPRESSION_H

#include <cstddef>
#include <cstdint>

#include "message.h"

namespace hvdtpu {

enum class CompressionMode : uint8_t {
  NONE = 0,
  BF16 = 1,
  INT8 = 2,
};

// Elements per int8 quantization block (one in-band f32 scale each).
constexpr int64_t kCompressionBlock = 256;

const char* CompressionModeName(CompressionMode m);
// Parses "none"/"bf16"/"int8" (or "0"/"1"/"2"); NONE on anything else.
CompressionMode ParseCompressionMode(const char* s);

// Compression applies to float32 payloads only; every other dtype rides
// the wire untouched. Computed identically on every rank from the
// (negotiated) dtype, so the effective mode can never diverge.
CompressionMode EffectiveCompression(CompressionMode m, DataType dtype);

// Wire bytes for `count` f32 elements under `mode` — a pure function of
// (count, mode), so sender and receiver size their buffers without any
// extra header exchange.
std::size_t CompressedSize(int64_t count, CompressionMode mode);

// Encodes `count` f32 elements from `src` into `dst` (CompressedSize
// bytes). INT8 layout: [f32 scale x nblocks][int8 q x count], blocks of
// kCompressionBlock elements (last may be short). Counts bytes in/out
// and time into the metrics registry.
void CompressBuffer(const float* src, int64_t count, CompressionMode mode,
                    char* dst);

// Decodes `count` elements from `src` (CompressedSize bytes) into f32
// `dst`. Exact inverse of CompressBuffer up to the codec's rounding.
void DecompressBuffer(const char* src, int64_t count, CompressionMode mode,
                      float* dst);

// Fused dequant-accumulate: dst[i] += decode(src)[i] in ONE pass — the
// pipelined ring's segment consumer (cpu_operations.cc) uses this to
// skip the intermediate f32 scratch entirely (per hop that removes a
// full write+read of the chunk from the memory-traffic bill; the
// element math is identical to DecompressBuffer-then-add, so results
// stay bitwise equal to the unsliced path). Also accepts NONE (plain
// f32 accumulate) so callers need not branch.
void DecompressAccumulate(const char* src, int64_t count,
                          CompressionMode mode, float* dst);

}  // namespace hvdtpu

#endif  // HVD_TPU_COMPRESSION_H
