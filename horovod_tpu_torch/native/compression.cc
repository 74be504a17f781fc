#include "compression.h"

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstring>
#include <limits>
#include <string>

#include "half.h"
#include "metrics.h"
#include "trace.h"

namespace hvdtpu {

const char* CompressionModeName(CompressionMode m) {
  switch (m) {
    case CompressionMode::NONE: return "none";
    case CompressionMode::BF16: return "bf16";
    case CompressionMode::INT8: return "int8";
  }
  return "unknown";
}

CompressionMode ParseCompressionMode(const char* s) {
  if (s == nullptr) return CompressionMode::NONE;
  // Case-insensitive to match the Python resolver's .lower() — the env
  // default must mean the same thing on every binding.
  std::string v(s);
  for (char& c : v) c = static_cast<char>(std::tolower(c));
  if (v == "bf16" || v == "1") return CompressionMode::BF16;
  if (v == "int8" || v == "2") return CompressionMode::INT8;
  return CompressionMode::NONE;
}

CompressionMode EffectiveCompression(CompressionMode m, DataType dtype) {
  return dtype == DataType::HVD_FLOAT32 ? m : CompressionMode::NONE;
}

std::size_t CompressedSize(int64_t count, CompressionMode mode) {
  switch (mode) {
    case CompressionMode::NONE:
      return static_cast<std::size_t>(count) * sizeof(float);
    case CompressionMode::BF16:
      return static_cast<std::size_t>(count) * sizeof(uint16_t);
    case CompressionMode::INT8: {
      int64_t nblocks =
          (count + kCompressionBlock - 1) / kCompressionBlock;
      return static_cast<std::size_t>(nblocks) * sizeof(float) +
             static_cast<std::size_t>(count);
    }
  }
  return static_cast<std::size_t>(count) * sizeof(float);
}

namespace {

void CountCodecWork(CompressionMode mode, int64_t count,
                    std::size_t wire_bytes, double seconds, bool compress) {
  Metrics& m = GlobalMetrics();
  if (compress) {
    m.compression_bytes_in_total.fetch_add(
        static_cast<uint64_t>(count) * sizeof(float),
        std::memory_order_relaxed);
    m.compression_bytes_out_total.fetch_add(
        static_cast<uint64_t>(wire_bytes), std::memory_order_relaxed);
    if (mode == CompressionMode::BF16) {
      m.compression_bf16_total.fetch_add(1, std::memory_order_relaxed);
    } else if (mode == CompressionMode::INT8) {
      m.compression_int8_total.fetch_add(1, std::memory_order_relaxed);
    }
  }
  m.compression_seconds.Observe(seconds);
  // Codec span (trace.h): records from the worker threads the pipelined
  // ring runs codecs on — the ring write is lock-free and thread-safe.
  Trace& t = GlobalTrace();
  if (t.enabled()) {
    const int64_t end_ns = t.NowNs();
    t.Record(compress ? "encode" : "decode",
             compress ? TRACE_ENCODE : TRACE_DECODE,
             end_ns - static_cast<int64_t>(seconds * 1e9), end_ns,
             static_cast<int64_t>(wire_bytes));
  }
}

}  // namespace

void CompressBuffer(const float* src, int64_t count, CompressionMode mode,
                    char* dst) {
  auto t0 = std::chrono::steady_clock::now();
  switch (mode) {
    case CompressionMode::NONE:
      std::memcpy(dst, src, static_cast<std::size_t>(count) * sizeof(float));
      return;  // not a codec op; no metrics
    case CompressionMode::BF16: {
      auto* out = reinterpret_cast<uint16_t*>(dst);
      for (int64_t i = 0; i < count; ++i) out[i] = FloatToBFloat16(src[i]);
      break;
    }
    case CompressionMode::INT8: {
      int64_t nblocks =
          (count + kCompressionBlock - 1) / kCompressionBlock;
      auto* scales = reinterpret_cast<float*>(dst);
      auto* q = reinterpret_cast<int8_t*>(dst + nblocks * sizeof(float));
      for (int64_t b = 0; b < nblocks; ++b) {
        int64_t lo = b * kCompressionBlock;
        int64_t hi = std::min(lo + kCompressionBlock, count);
        float amax = 0.0f;
        bool finite = true;
        for (int64_t i = lo; i < hi; ++i) {
          float a = std::fabs(src[i]);
          if (!std::isfinite(a)) finite = false;
          amax = std::max(amax, a);
        }
        // Symmetric [-127, 127]: -128 is never produced, so dequant is
        // sign-symmetric and |x - scale*q| <= scale/2 within the block.
        // A nonfinite input (overflowed mixed-precision gradient) makes
        // the IN-BAND SCALE NaN, so the whole block decodes nonfinite —
        // downstream isfinite / loss-scale skip-step guards still fire
        // instead of silently training on a finite-ized block.
        float scale = !finite ? std::numeric_limits<float>::quiet_NaN()
                              : (amax > 0.0f ? amax / 127.0f : 0.0f);
        scales[b] = scale;
        float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
        for (int64_t i = lo; i < hi; ++i) {
          float v = src[i] * inv;
          v = std::max(-127.0f, std::min(127.0f, v));
          q[i] = static_cast<int8_t>(std::lrintf(v));
        }
      }
      break;
    }
  }
  CountCodecWork(mode, count, CompressedSize(count, mode),
                 std::chrono::duration<double>(
                     std::chrono::steady_clock::now() - t0)
                     .count(),
                 /*compress=*/true);
}

void DecompressBuffer(const char* src, int64_t count, CompressionMode mode,
                      float* dst) {
  auto t0 = std::chrono::steady_clock::now();
  switch (mode) {
    case CompressionMode::NONE:
      std::memcpy(dst, src, static_cast<std::size_t>(count) * sizeof(float));
      return;
    case CompressionMode::BF16: {
      const auto* in = reinterpret_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < count; ++i) dst[i] = BFloat16ToFloat(in[i]);
      break;
    }
    case CompressionMode::INT8: {
      int64_t nblocks =
          (count + kCompressionBlock - 1) / kCompressionBlock;
      const auto* scales = reinterpret_cast<const float*>(src);
      const auto* q =
          reinterpret_cast<const int8_t*>(src + nblocks * sizeof(float));
      for (int64_t b = 0; b < nblocks; ++b) {
        int64_t lo = b * kCompressionBlock;
        int64_t hi = std::min(lo + kCompressionBlock, count);
        float scale = scales[b];
        for (int64_t i = lo; i < hi; ++i) {
          dst[i] = static_cast<float>(q[i]) * scale;
        }
      }
      break;
    }
  }
  CountCodecWork(mode, count, CompressedSize(count, mode),
                 std::chrono::duration<double>(
                     std::chrono::steady_clock::now() - t0)
                     .count(),
                 /*compress=*/false);
}

void DecompressAccumulate(const char* src, int64_t count,
                          CompressionMode mode, float* dst) {
  auto t0 = std::chrono::steady_clock::now();
  switch (mode) {
    case CompressionMode::NONE: {
      const auto* in = reinterpret_cast<const float*>(src);
      for (int64_t i = 0; i < count; ++i) dst[i] += in[i];
      return;  // not a codec op; no metrics
    }
    case CompressionMode::BF16: {
      const auto* in = reinterpret_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < count; ++i) dst[i] += BFloat16ToFloat(in[i]);
      break;
    }
    case CompressionMode::INT8: {
      int64_t nblocks =
          (count + kCompressionBlock - 1) / kCompressionBlock;
      const auto* scales = reinterpret_cast<const float*>(src);
      const auto* q =
          reinterpret_cast<const int8_t*>(src + nblocks * sizeof(float));
      for (int64_t b = 0; b < nblocks; ++b) {
        int64_t lo = b * kCompressionBlock;
        int64_t hi = std::min(lo + kCompressionBlock, count);
        float scale = scales[b];
        for (int64_t i = lo; i < hi; ++i) {
          dst[i] += static_cast<float>(q[i]) * scale;
        }
      }
      break;
    }
  }
  CountCodecWork(mode, count, CompressedSize(count, mode),
                 std::chrono::duration<double>(
                     std::chrono::steady_clock::now() - t0)
                     .count(),
                 /*compress=*/false);
}

}  // namespace hvdtpu
