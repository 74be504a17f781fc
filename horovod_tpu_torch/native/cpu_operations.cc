#include "cpu_operations.h"

#include <algorithm>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>

#include "global_state.h"
#include "half.h"
#include "logging.h"

namespace hvdtpu {

// A failed ring exchange means the data-plane transport is desynced or a
// peer is gone — recoverable only by a generation restart. The status
// carries the CONNECTION_LOST marker (Python's elastic layer rolls back
// on it, and the background loop escalates it to a connection-lost
// shutdown — see PerformOperation) plus the transport-level cause from
// the context, so a chaos run's failure names what was injected
// (checksum mismatch, deadline expiry, peer close).
static Status RingLost(const TcpContext& ctx, const char* what) {
  std::string msg = CONNECTION_LOST_ERROR;
  msg += " [";
  msg += what;
  if (!ctx.last_error().empty()) {
    msg += ": ";
    msg += ctx.last_error();
  }
  msg += "]";
  return Status::UnknownError(msg);
}

template <typename T>
static void ReduceSumT(T* dst, const T* src, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

void ReduceSum(void* dst, const void* src, int64_t count, DataType dtype) {
  switch (dtype) {
    case DataType::HVD_UINT8:
      ReduceSumT(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src),
                 count);
      break;
    case DataType::HVD_INT8:
      ReduceSumT(static_cast<int8_t*>(dst), static_cast<const int8_t*>(src),
                 count);
      break;
    case DataType::HVD_UINT16:
      ReduceSumT(static_cast<uint16_t*>(dst),
                 static_cast<const uint16_t*>(src), count);
      break;
    case DataType::HVD_INT16:
      ReduceSumT(static_cast<int16_t*>(dst), static_cast<const int16_t*>(src),
                 count);
      break;
    case DataType::HVD_INT32:
      ReduceSumT(static_cast<int32_t*>(dst), static_cast<const int32_t*>(src),
                 count);
      break;
    case DataType::HVD_INT64:
      ReduceSumT(static_cast<int64_t*>(dst), static_cast<const int64_t*>(src),
                 count);
      break;
    case DataType::HVD_FLOAT32:
      ReduceSumT(static_cast<float*>(dst), static_cast<const float*>(src),
                 count);
      break;
    case DataType::HVD_FLOAT64:
      ReduceSumT(static_cast<double*>(dst), static_cast<const double*>(src),
                 count);
      break;
    case DataType::HVD_FLOAT16: {
      auto* d = static_cast<uint16_t*>(dst);
      const auto* s = static_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < count; ++i) {
        d[i] = FloatToHalf(HalfToFloat(d[i]) + HalfToFloat(s[i]));
      }
      break;
    }
    case DataType::HVD_BFLOAT16: {
      auto* d = static_cast<uint16_t*>(dst);
      const auto* s = static_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < count; ++i) {
        d[i] = FloatToBFloat16(BFloat16ToFloat(d[i]) + BFloat16ToFloat(s[i]));
      }
      break;
    }
    case DataType::HVD_BOOL: {
      auto* d = static_cast<uint8_t*>(dst);
      const auto* s = static_cast<const uint8_t*>(src);
      for (int64_t i = 0; i < count; ++i) d[i] = d[i] || s[i];
      break;
    }
  }
}

template <typename T>
static void ScaleT(T* buf, int64_t n, double factor) {
  for (int64_t i = 0; i < n; ++i) {
    buf[i] = static_cast<T>(buf[i] * factor);
  }
}

void ScaleBuffer(void* buf, int64_t count, DataType dtype, double factor) {
  if (factor == 1.0) return;
  switch (dtype) {
    case DataType::HVD_UINT8:
      ScaleT(static_cast<uint8_t*>(buf), count, factor);
      break;
    case DataType::HVD_INT8:
      ScaleT(static_cast<int8_t*>(buf), count, factor);
      break;
    case DataType::HVD_UINT16:
      ScaleT(static_cast<uint16_t*>(buf), count, factor);
      break;
    case DataType::HVD_INT16:
      ScaleT(static_cast<int16_t*>(buf), count, factor);
      break;
    case DataType::HVD_INT32:
      ScaleT(static_cast<int32_t*>(buf), count, factor);
      break;
    case DataType::HVD_INT64:
      ScaleT(static_cast<int64_t*>(buf), count, factor);
      break;
    case DataType::HVD_FLOAT32:
      ScaleT(static_cast<float*>(buf), count, factor);
      break;
    case DataType::HVD_FLOAT64:
      ScaleT(static_cast<double*>(buf), count, factor);
      break;
    case DataType::HVD_FLOAT16: {
      auto* b = static_cast<uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i) {
        b[i] = FloatToHalf(static_cast<float>(HalfToFloat(b[i]) * factor));
      }
      break;
    }
    case DataType::HVD_BFLOAT16: {
      auto* b = static_cast<uint16_t*>(buf);
      for (int64_t i = 0; i < count; ++i) {
        b[i] = FloatToBFloat16(
            static_cast<float>(BFloat16ToFloat(b[i]) * factor));
      }
      break;
    }
    case DataType::HVD_BOOL:
      break;  // scaling a bool is meaningless; ignore
  }
}

// Partitions `count` elements into n near-equal chunks. The same math
// lives in horovod_tpu/common/ops.py shard_partition — the Python side
// must size reduce-scatter shard buffers identically.
static void PartitionChunks(int64_t count, int n, std::vector<int64_t>* counts,
                            std::vector<int64_t>* offsets) {
  counts->assign(n, 0);
  offsets->assign(n, 0);
  int64_t base = count / n, rem = count % n;
  int64_t off = 0;
  for (int i = 0; i < n; ++i) {
    (*counts)[i] = base + (i < rem ? 1 : 0);
    (*offsets)[i] = off;
    off += (*counts)[i];
  }
}

static int64_t MaxChunk(const std::vector<int64_t>& counts) {
  int64_t m = 0;
  for (int64_t c : counts) m = std::max(m, c);
  return m;
}

// ---------------------------------------------------------------------------
// Pipelined segment engine (docs/AUTOTUNE.md "Pipelined ring transport").
//
// A ring hop's payload is sliced into HVD_TPU_PIPELINE_CHUNK_BYTES
// segments and double-buffered: while segment s's decode+ReduceSum runs
// on the worker thread, the main (background) thread encodes and
// exchanges segment s+1 — so codec work, socket transport, and the
// reduction overlap WITHIN a hop. Every rank derives the segment count
// from the globally-known chunk table and the synchronized chunk knob,
// so the per-segment frames pair up deterministically (zero-length
// sides ride an empty frame).
// ---------------------------------------------------------------------------

// One worker thread with a depth-1 job slot: Submit blocks until the
// previous job retired (which with two rotating buffers is exactly the
// guarantee that a buffer is free for reuse), Drain blocks until idle.
class SegmentWorker {
 public:
  SegmentWorker() : thread_([this] { Loop(); }) {}
  ~SegmentWorker() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    thread_.join();
  }

  void Submit(std::function<void()> fn) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return !busy_; });
    job_ = std::move(fn);
    busy_ = true;
    cv_.notify_all();
  }

  void Drain() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return !busy_; });
  }

 private:
  void Loop() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return busy_ || stop_; });
      if (stop_) return;
      std::function<void()> job = std::move(job_);
      lk.unlock();
      job();
      lk.lock();
      busy_ = false;
      cv_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::function<void()> job_;  // guarded_by(mu_)
  bool busy_ = false;          // guarded_by(mu_)
  bool stop_ = false;          // guarded_by(mu_)
  std::thread thread_;
};

// Elements per pipeline segment for the given knob value. Compressed
// payloads align to the int8 quantization block so a per-segment encode
// is bitwise-identical to the whole-chunk encode (block boundaries
// coincide); bf16 has no blocks but keeps the same alignment for free.
static int64_t SegmentElems(int64_t pipe_bytes, std::size_t elem,
                            CompressionMode cmp) {
  if (pipe_bytes <= 0) return 0;
  int64_t n = std::max<int64_t>(1, pipe_bytes / static_cast<int64_t>(elem));
  if (cmp != CompressionMode::NONE) {
    n = std::max<int64_t>(kCompressionBlock,
                          (n / kCompressionBlock) * kCompressionBlock);
  }
  return n;
}

// Ring-global segment count for a hop table: every rank must loop the
// same number of segment exchanges per hop or the frame stream desyncs.
static int64_t SegmentCount(const std::vector<int64_t>& counts, int64_t seg) {
  if (seg <= 0) return 1;
  int64_t max_chunk = MaxChunk(counts);
  return max_chunk <= seg ? 1 : (max_chunk + seg - 1) / seg;
}

static int64_t ClampSeg(int64_t chunk_count, int64_t soff, int64_t seg) {
  return std::max<int64_t>(0, std::min(seg, chunk_count - soff));
}

// Offset used for pointer arithmetic: clamped to the chunk end so a
// zero-length tail segment (short chunk, ring-global segment count)
// forms at most a one-past-the-end pointer — forming one further out
// is UB even when the length-0 exchange never dereferences it.
static int64_t SegOff(int64_t chunk_count, int64_t soff) {
  return std::min(soff, chunk_count);
}

// Reduce-scatter leg of a ring allreduce: after n-1 steps ring rank r owns
// chunk (r+1) % n, reduced over the whole ring.
//
// With cmp != NONE (dtype f32 by negotiation) this is the EQuARX-style
// dequant-reduce-requant pipeline: the accumulator chunk in `buf` stays
// f32; each hop encodes the outgoing chunk (requant), ships the small
// payload, and the receiver decodes (dequant) and ReduceSums in f32 —
// so wire bytes shrink while the sum never accumulates in the narrow
// format. CRC framing in RingExchangeOn covers the compressed payload.
//
// With pipe_bytes > 0 each hop runs the segmented double-buffered
// pipeline above; pipe_bytes == 0 (or a hop smaller than one segment)
// takes the original unsliced exchange.
static Status RingReduceScatterOn(TcpContext& ctx, Ring ring, char* buf,
                                  const std::vector<int64_t>& counts,
                                  const std::vector<int64_t>& offsets,
                                  DataType dtype, CompressionMode cmp,
                                  int64_t pipe_bytes, uint32_t group = 0) {
  // Group-aware coordinates: group != 0 with LOCAL/CROSS rides the
  // group's sub-rings (the hierarchical-composite-for-subgroups legs).
  int n = ctx.RingSizeOn(ring, group);
  int rank = ctx.RingRankOn(ring, group);
  std::size_t elem = DataTypeSize(dtype);
  int64_t seg = SegmentElems(pipe_bytes, elem, cmp);
  int64_t nseg = SegmentCount(counts, seg);
  if (cmp != CompressionMode::NONE) {
    float* f = reinterpret_cast<float*>(buf);
    if (nseg > 1) {
      // Three concurrent stages: the encoder thread requantizes segment
      // s+1 and the reducer thread dequantizes+sums segment s-1 WHILE
      // the main thread's socket exchange moves segment s — per-hop
      // cost drops from encode+transport+decode+reduce in series to
      // ~max(encode, transport, decode+reduce).
      std::vector<char> send_c[2] = {
          std::vector<char>(CompressedSize(seg, cmp)),
          std::vector<char>(CompressedSize(seg, cmp))};
      std::vector<char> recv_c[2] = {
          std::vector<char>(CompressedSize(seg, cmp)),
          std::vector<char>(CompressedSize(seg, cmp))};
      SegmentWorker encoder;  // declared after buffers: join before free
      SegmentWorker reducer;
      Metrics& m = GlobalMetrics();
      for (int step = 0; step < n - 1; ++step) {
        int send_chunk = (rank - step + n) % n;
        int recv_chunk = (rank - step - 1 + n) % n;
        auto encode_seg = [&, send_chunk](int64_t s) {
          int64_t soff = s * seg;
          int64_t sn = ClampSeg(counts[send_chunk], soff, seg);
          const float* src =
              f + offsets[send_chunk] + SegOff(counts[send_chunk], soff);
          char* out = send_c[s & 1].data();
          encoder.Submit([src, sn, cmp, out] {
            CompressBuffer(src, sn, cmp, out);
          });
        };
        encode_seg(0);
        for (int64_t s = 0; s < nseg; ++s) {
          int64_t soff = s * seg;
          int64_t sn = ClampSeg(counts[send_chunk], soff, seg);
          int64_t rn = ClampSeg(counts[recv_chunk], soff, seg);
          // Queue the next segment's encode; either way the depth-1
          // slot guarantees THIS segment's encode has retired before
          // its buffer goes on the wire.
          if (s + 1 < nseg) {
            encode_seg(s + 1);
          } else {
            encoder.Drain();
          }
          char* rc = recv_c[s & 1].data();
          if (!ctx.ExchangeOn(ring, group, send_c[s & 1].data(),
                              CompressedSize(sn, cmp), rc,
                              CompressedSize(rn, cmp))) {
            encoder.Drain();
            reducer.Drain();
            return RingLost(ctx, "ring reduce-scatter exchange failed");
          }
          m.pipeline_segments_total.fetch_add(1, std::memory_order_relaxed);
          if (rn > 0) {
            // Fused dequant-accumulate: no intermediate f32 scratch —
            // the decode and the ReduceSum are one pass (bitwise-equal
            // element math to decompress-then-add).
            float* dst = f + offsets[recv_chunk] + soff;
            reducer.Submit([rc, rn, cmp, dst] {
              DecompressAccumulate(rc, rn, cmp, dst);
            });
          }
        }
        // Hop barrier: the next hop encodes/forwards what this hop
        // reduced.
        reducer.Drain();
      }
      return Status::OK();
    }
    // Unsliced path. Scratch sized by the LARGEST chunk: callers may
    // pass a rotated chunk order (the standalone reduce-scatter op
    // does), so counts[0] is not necessarily the maximum.
    int64_t max_chunk = MaxChunk(counts);
    std::vector<char> send_c(CompressedSize(max_chunk, cmp));
    std::vector<char> recv_c(CompressedSize(max_chunk, cmp));
    std::vector<float> tmp(static_cast<std::size_t>(max_chunk));
    for (int step = 0; step < n - 1; ++step) {
      int send_chunk = (rank - step + n) % n;
      int recv_chunk = (rank - step - 1 + n) % n;
      std::size_t send_len = CompressedSize(counts[send_chunk], cmp);
      std::size_t recv_len = CompressedSize(counts[recv_chunk], cmp);
      CompressBuffer(f + offsets[send_chunk], counts[send_chunk], cmp,
                     send_c.data());
      if (!ctx.ExchangeOn(ring, group, send_c.data(), send_len,
                          recv_c.data(), recv_len)) {
        return RingLost(ctx, "ring reduce-scatter exchange failed");
      }
      DecompressBuffer(recv_c.data(), counts[recv_chunk], cmp, tmp.data());
      ReduceSum(f + offsets[recv_chunk], tmp.data(), counts[recv_chunk],
                dtype);
    }
    return Status::OK();
  }
  if (nseg > 1) {
    std::vector<char> tmp[2] = {
        std::vector<char>(static_cast<std::size_t>(seg) * elem),
        std::vector<char>(static_cast<std::size_t>(seg) * elem)};
    SegmentWorker worker;
    Metrics& m = GlobalMetrics();
    for (int step = 0; step < n - 1; ++step) {
      int send_chunk = (rank - step + n) % n;
      int recv_chunk = (rank - step - 1 + n) % n;
      for (int64_t s = 0; s < nseg; ++s) {
        int64_t soff = s * seg;
        int64_t sn = ClampSeg(counts[send_chunk], soff, seg);
        int64_t rn = ClampSeg(counts[recv_chunk], soff, seg);
        char* rc = tmp[s & 1].data();
        if (!ctx.ExchangeOn(
                ring, group,
                buf + (offsets[send_chunk] +
                       SegOff(counts[send_chunk], soff)) * elem,
                sn * elem, rc, rn * elem)) {
          worker.Drain();
          return RingLost(ctx, "ring reduce-scatter exchange failed");
        }
        m.pipeline_segments_total.fetch_add(1, std::memory_order_relaxed);
        if (rn > 0) {
          char* dst = buf + (offsets[recv_chunk] + soff) * elem;
          worker.Submit([dst, rc, rn, dtype] {
            ReduceSum(dst, rc, rn, dtype);
          });
        }
      }
      worker.Drain();
    }
    return Status::OK();
  }
  std::vector<char> tmp(static_cast<std::size_t>(MaxChunk(counts)) * elem);
  for (int step = 0; step < n - 1; ++step) {
    int send_chunk = (rank - step + n) % n;
    int recv_chunk = (rank - step - 1 + n) % n;
    if (!ctx.ExchangeOn(ring, group, buf + offsets[send_chunk] * elem,
                        counts[send_chunk] * elem, tmp.data(),
                        counts[recv_chunk] * elem)) {
      return RingLost(ctx, "ring reduce-scatter exchange failed");
    }
    ReduceSum(buf + offsets[recv_chunk] * elem, tmp.data(), counts[recv_chunk],
              dtype);
  }
  return Status::OK();
}

// Allgather leg: circulates the fully-reduced chunks (owned per the
// reduce-scatter leg above) until every ring member has all of them.
//
// Compressed variant: each owner encodes its reduced chunk ONCE (per
// segment), decodes its own copy back (so the owner holds exactly what
// everyone else will decode), and the ring then forwards the encoded
// payloads VERBATIM — no per-hop requantization, so there is no
// hop-count-dependent drift and every rank ends with bitwise-identical
// chunk values. With pipe_bytes > 0 the decode of segment s overlaps
// the transport of segment s+1 (the uncompressed leg has no compute to
// overlap and stays unsliced).
static Status RingAllgatherPhaseOn(TcpContext& ctx, Ring ring, char* buf,
                                   const std::vector<int64_t>& counts,
                                   const std::vector<int64_t>& offsets,
                                   DataType dtype, CompressionMode cmp,
                                   int64_t pipe_bytes, uint32_t group = 0) {
  int n = ctx.RingSizeOn(ring, group);
  int rank = ctx.RingRankOn(ring, group);
  std::size_t elem = DataTypeSize(dtype);
  if (cmp != CompressionMode::NONE) {
    float* f = reinterpret_cast<float*>(buf);
    int owned = (rank + 1) % n;
    int64_t seg = SegmentElems(pipe_bytes, elem, cmp);
    int64_t nseg = SegmentCount(counts, seg);
    if (nseg > 1) {
      // Encoded chunks live as nseg fixed-stride slots so forwarding a
      // segment is a pure slice; every rank computes identical slot
      // layout from (counts, seg).
      std::size_t slot = CompressedSize(seg, cmp);
      std::vector<char> cur(static_cast<std::size_t>(nseg) * slot);
      std::vector<char> nxt(static_cast<std::size_t>(nseg) * slot);
      SegmentWorker worker;
      Metrics& m = GlobalMetrics();
      for (int64_t s = 0; s < nseg; ++s) {
        int64_t soff = s * seg;
        int64_t sn = ClampSeg(counts[owned], soff, seg);
        if (sn <= 0) continue;
        CompressBuffer(f + offsets[owned] + soff, sn, cmp,
                       cur.data() + s * slot);
        DecompressBuffer(cur.data() + s * slot, sn, cmp,
                         f + offsets[owned] + soff);
      }
      for (int step = 0; step < n - 1; ++step) {
        int send_chunk = (rank + 1 - step + n) % n;
        int recv_chunk = (rank - step + n) % n;
        for (int64_t s = 0; s < nseg; ++s) {
          int64_t soff = s * seg;
          int64_t sn = ClampSeg(counts[send_chunk], soff, seg);
          int64_t rn = ClampSeg(counts[recv_chunk], soff, seg);
          char* rc = nxt.data() + s * slot;
          if (!ctx.ExchangeOn(ring, group, cur.data() + s * slot,
                              CompressedSize(sn, cmp), rc,
                              CompressedSize(rn, cmp))) {
            worker.Drain();
            return RingLost(ctx, "ring allgather exchange failed");
          }
          m.pipeline_segments_total.fetch_add(1, std::memory_order_relaxed);
          if (rn > 0) {
            float* dst = f + offsets[recv_chunk] + soff;
            worker.Submit([rc, rn, cmp, dst] {
              DecompressBuffer(rc, rn, cmp, dst);
            });
          }
        }
        // Decode jobs read `nxt`; the swap hands it to the next hop's
        // send side, so they must retire first.
        worker.Drain();
        std::swap(cur, nxt);
      }
      return Status::OK();
    }
    // Unsliced: two rotating payload buffers — step s only ever
    // forwards the chunk received at step s-1, so O(1) encoded chunks
    // suffice (matching the uncompressed path's single tmp), not one
    // per rank.
    int64_t max_chunk = MaxChunk(counts);
    std::vector<char> send_c(CompressedSize(max_chunk, cmp));
    std::vector<char> recv_c(CompressedSize(max_chunk, cmp));
    CompressBuffer(f + offsets[owned], counts[owned], cmp, send_c.data());
    DecompressBuffer(send_c.data(), counts[owned], cmp, f + offsets[owned]);
    for (int step = 0; step < n - 1; ++step) {
      int send_chunk = (rank + 1 - step + n) % n;
      int recv_chunk = (rank - step + n) % n;
      if (!ctx.ExchangeOn(ring, group, send_c.data(),
                          CompressedSize(counts[send_chunk], cmp),
                          recv_c.data(),
                          CompressedSize(counts[recv_chunk], cmp))) {
        return RingLost(ctx, "ring allgather exchange failed");
      }
      DecompressBuffer(recv_c.data(), counts[recv_chunk], cmp,
                       f + offsets[recv_chunk]);
      std::swap(send_c, recv_c);
    }
    return Status::OK();
  }
  for (int step = 0; step < n - 1; ++step) {
    int send_chunk = (rank + 1 - step + n) % n;
    int recv_chunk = (rank - step + n) % n;
    if (!ctx.ExchangeOn(ring, group, buf + offsets[send_chunk] * elem,
                        counts[send_chunk] * elem,
                        buf + offsets[recv_chunk] * elem,
                        counts[recv_chunk] * elem)) {
      return RingLost(ctx, "ring allgather exchange failed");
    }
  }
  return Status::OK();
}

Status RingAllreduceOn(TcpContext& ctx, Ring ring, void* buffer, int64_t count,
                       DataType dtype, CompressionMode cmp,
                       int64_t pipe_bytes, uint32_t group) {
  int n = ctx.RingSizeOn(ring, group);
  if (n == 1 || count == 0) return Status::OK();
  std::vector<int64_t> counts, offsets;
  PartitionChunks(count, n, &counts, &offsets);
  char* buf = static_cast<char*>(buffer);
  Status s = RingReduceScatterOn(ctx, ring, buf, counts, offsets, dtype, cmp,
                                 pipe_bytes, group);
  if (!s.ok()) return s;
  return RingAllgatherPhaseOn(ctx, ring, buf, counts, offsets, dtype, cmp,
                              pipe_bytes, group);
}

// Lazily builds (or reuses) the group's data ring before a group op
// executes; a failure is a transport loss (generation restart).
static Status EnsureGroup(TcpContext& ctx, HorovodGlobalState* state,
                          uint32_t group) {
  if (group == 0) return Status::OK();
  std::vector<int> members = state->group_table.Members(group);
  if (members.empty()) {
    return Status::PreconditionError(
        "unknown process group " + std::to_string(group) +
        " at execution time; create it with hvd.new_group on every rank");
  }
  if (!ctx.EnsureGroupRing(group, members)) {
    return RingLost(ctx, "group ring rendezvous failed");
  }
  return Status::OK();
}

bool CpuRingAllreduce::Enabled(const std::vector<TensorTableEntry>& entries,
                               const Response& response) const {
  return entries[0].device == HOST_DEVICE_ID;
}

Status CpuRingAllreduce::ReduceBuffer(void* buffer, int64_t count,
                                      DataType dtype, CompressionMode cmp,
                                      uint32_t group) {
  return RingAllreduceOn(ctx_, Ring::GLOBAL, buffer, count, dtype, cmp,
                         global_state_->parameter_manager
                             .PipelineChunkBytes(),
                         group);
}

Status CpuRingAllreduce::Execute(std::vector<TensorTableEntry>& entries,
                                 const Response& response) {
  auto& timeline = global_state_->timeline;
  void* buffer = nullptr;
  std::size_t buffer_len = 0;
  int64_t total_elements = NumElements(entries);
  const uint32_t group = response.group_id();
  {
    Status s = EnsureGroup(ctx_, global_state_, group);
    if (!s.ok()) return s;
  }

  if (entries.size() > 1) {
    std::vector<std::string> names = response.tensor_names();
    timeline.ActivityStartAll(names, "MEMCPY_IN_FUSION_BUFFER");
    Status s = MemcpyInFusionBuffer(entries, &buffer, &buffer_len);
    timeline.ActivityEndAll(names);
    if (!s.ok()) return s;
  } else {
    auto& e = entries[0];
    if (e.output != e.data) {
      std::memcpy(e.output, e.data, e.SizeBytes());
    }
    buffer = e.output;
    buffer_len = e.SizeBytes();
  }

  // Per-entry prescale on its segment (factors may differ across fused
  // tensors; scaling commutes with the sum).
  {
    char* p = static_cast<char*>(buffer);
    for (auto& e : entries) {
      if (e.prescale_factor != 1.0) {
        ScaleBuffer(p, e.NumElements(), e.dtype, e.prescale_factor);
      }
      p += e.SizeBytes();
    }
  }

  // Belt-and-braces dtype filter: the negotiated mode is already
  // effective (dtype-filtered at enqueue), and fused responses only
  // merge same-mode tensors.
  CompressionMode cmp = EffectiveCompression(
      static_cast<CompressionMode>(response.compression()),
      entries[0].dtype);
  {
    Metrics& m = GlobalMetrics();
    if (cmp == CompressionMode::BF16) {
      m.allreduce_bf16_total.fetch_add(1, std::memory_order_relaxed);
    } else if (cmp == CompressionMode::INT8) {
      m.allreduce_int8_total.fetch_add(1, std::memory_order_relaxed);
    } else {
      m.allreduce_uncompressed_total.fetch_add(1,
                                               std::memory_order_relaxed);
    }
  }

  timeline.ActivityStartAll(response.tensor_names(), ActivityName());
  Status s = ReduceBuffer(buffer, total_elements, entries[0].dtype, cmp,
                          group);
  timeline.ActivityEndAll(response.tensor_names());
  if (!s.ok()) return s;

  {
    char* p = static_cast<char*>(buffer);
    for (auto& e : entries) {
      if (e.postscale_factor != 1.0) {
        ScaleBuffer(p, e.NumElements(), e.dtype, e.postscale_factor);
      }
      p += e.SizeBytes();
    }
  }

  if (entries.size() > 1) {
    timeline.ActivityStartAll(response.tensor_names(),
                              "MEMCPY_OUT_FUSION_BUFFER");
    MemcpyOutFusionBuffer(buffer, entries);
    timeline.ActivityEndAll(response.tensor_names());
  }
  return Status::OK();
}

bool CpuHierarchicalAllreduce::Enabled(
    const std::vector<TensorTableEntry>& entries,
    const Response& response) const {
  // World group: the classic gate. Subgroups additionally qualify when
  // their member set forms a uniform (local, cross) grid — the decision
  // is a pure function of (members, world grid, synchronized knob), so
  // it can never diverge across ranks (docs/TRANSPORT.md).
  if (entries[0].device != HOST_DEVICE_ID ||
      !ctx_.hierarchical_possible() ||
      !global_state_->parameter_manager.HierarchicalAllreduce()) {
    return false;
  }
  if (response.group_id() == 0) return true;
  return ctx_.GroupHierarchicalPossible(
      global_state_->group_table.Members(response.group_id()));
}

Status CpuHierarchicalAllreduce::ReduceBuffer(void* buffer, int64_t count,
                                              DataType dtype,
                                              CompressionMode cmp,
                                              uint32_t group) {
  // Two-level composite (reference: nccl_operations.cc:150-346):
  //   1. local-ring reduce-scatter — local rank lr ends up owning chunk
  //      (lr+1) % ls, reduced over the local group;
  //   2. cross-ring allreduce of the owned chunk (one participant per
  //      local_rank, riding the inter-host links only);
  //   3. local-ring allgather of the now globally-reduced chunks.
  // Group-scoped: the same three stages over the group's sub-rings
  // (local position / per-host member count replace local_rank /
  // local_size; the intra-host legs ride shm when negotiated).
  int ls, lr;
  if (group != 0) {
    std::vector<int> members = global_state_->group_table.Members(group);
    if (!ctx_.EnsureGroupSubRings(group, members)) {
      return RingLost(ctx_, "group sub-ring rendezvous failed");
    }
    ls = ctx_.RingSizeOn(Ring::LOCAL, group);
    lr = ctx_.RingRankOn(Ring::LOCAL, group);
  } else {
    ls = ctx_.local_size();
    lr = ctx_.local_rank();
  }
  if (count == 0) return Status::OK();
  std::size_t elem = DataTypeSize(dtype);
  int64_t pipe = global_state_->parameter_manager.PipelineChunkBytes();

  std::vector<int64_t> counts, offsets;
  PartitionChunks(count, ls, &counts, &offsets);
  char* buf = static_cast<char*>(buffer);

  Status s = RingReduceScatterOn(ctx_, Ring::LOCAL, buf, counts, offsets,
                                 dtype, cmp, pipe, group);
  if (!s.ok()) return s;

  int owned = (lr + 1) % ls;
  s = RingAllreduceOn(ctx_, Ring::CROSS, buf + offsets[owned] * elem,
                      counts[owned], dtype, cmp, pipe, group);
  if (!s.ok()) return s;

  return RingAllgatherPhaseOn(ctx_, Ring::LOCAL, buf, counts, offsets, dtype,
                              cmp, pipe, group);
}

bool CpuRingReduceScatter::Enabled(
    const std::vector<TensorTableEntry>& entries,
    const Response& response) const {
  return entries[0].device == HOST_DEVICE_ID;
}

Status CpuRingReduceScatter::Execute(std::vector<TensorTableEntry>& entries,
                                     const Response& response) {
  // The reduce-scatter leg of the ring as a standalone op (docs/ZERO.md):
  // rank r's output receives logical chunk r of the PartitionChunks
  // partition over the flattened tensor, summed across all ranks. Wire
  // compression applies per hop exactly as in the fused allreduce leg
  // (the f32 accumulator never lives in the narrow format). The
  // controller never fuses REDUCESCATTER responses — sharded callers
  // fuse at the source instead (one flat gradient buffer whose offsets
  // ARE the shard boundaries), so entries is normally a single tensor.
  // Group-scoped: chunks partition over the GROUP and "rank" is the
  // group position (shard i goes to member i).
  const uint32_t group = response.group_id();
  {
    Status s = EnsureGroup(ctx_, global_state_, group);
    if (!s.ok()) return s;
  }
  int n = group ? ctx_.GroupSize(group) : ctx_.size();
  int rank = group ? ctx_.GroupRank(group) : ctx_.rank();
  auto& timeline = global_state_->timeline;
  CompressionMode cmp = EffectiveCompression(
      static_cast<CompressionMode>(response.compression()),
      entries[0].dtype);
  int64_t pipe = global_state_->parameter_manager.PipelineChunkBytes();
  Metrics& m = GlobalMetrics();
  timeline.ActivityStartAll(response.tensor_names(), "REDUCE_SCATTER_RING");
  for (auto& e : entries) {
    int64_t count = e.NumElements();
    std::size_t elem = DataTypeSize(e.dtype);
    std::vector<int64_t> counts, offsets;
    PartitionChunks(count, n, &counts, &offsets);
    m.reduce_scatter_total.fetch_add(1, std::memory_order_relaxed);
    m.reduce_scatter_bytes_total.fetch_add(
        static_cast<uint64_t>(count) * elem, std::memory_order_relaxed);
    if (count == 0) continue;
    if (n == 1) {
      if (e.output != e.data) std::memcpy(e.output, e.data, e.SizeBytes());
      ScaleBuffer(e.output, count, e.dtype,
                  e.prescale_factor * e.postscale_factor);
      continue;
    }
    // The ring leg leaves ring-rank r owning ring chunk (r+1)%n; rank r
    // must own LOGICAL chunk r, so ring chunk j maps onto logical chunk
    // (j+n-1)%n — a pure relabeling (offsets stay the contiguous
    // PartitionChunks layout, identical on every rank).
    std::vector<int64_t> ring_counts(n), ring_offsets(n);
    for (int j = 0; j < n; ++j) {
      int logical = (j + n - 1) % n;
      ring_counts[j] = counts[logical];
      ring_offsets[j] = offsets[logical];
    }
    // Work in a scratch copy: the entry's output buffer is shard-sized
    // (counts[rank] elements), not full-tensor-sized.
    std::vector<char> work(static_cast<std::size_t>(count) * elem);
    std::memcpy(work.data(), e.data, work.size());
    if (e.prescale_factor != 1.0) {
      ScaleBuffer(work.data(), count, e.dtype, e.prescale_factor);
    }
    Status s = RingReduceScatterOn(ctx_, Ring::GLOBAL, work.data(),
                                   ring_counts, ring_offsets, e.dtype, cmp,
                                   pipe, group);
    if (!s.ok()) {
      timeline.ActivityEndAll(response.tensor_names());
      return s;
    }
    std::memcpy(e.output, work.data() + offsets[rank] * elem,
                static_cast<std::size_t>(counts[rank]) * elem);
    if (e.postscale_factor != 1.0) {
      ScaleBuffer(e.output, counts[rank], e.dtype, e.postscale_factor);
    }
  }
  timeline.ActivityEndAll(response.tensor_names());
  return Status::OK();
}

// ---------------------------------------------------------------------------
// Hierarchical reduce-scatter (docs/ZERO.md + docs/AUTOTUNE.md): intra-host
// reduce -> inter-host ring -> shard distribution, so sharded_update jobs
// get the same two-level treatment allreduce/allgather already have. The
// inter-host links carry each byte once per HOST instead of once per rank.
// ---------------------------------------------------------------------------

// One contiguous span of the flattened tensor belonging to a local
// rank's chunk group.
struct GroupSeg {
  int64_t off;  // elements
  int64_t cnt;  // elements
};

// Reduces decoded elements [a, b) of a group's packed layout into the
// scattered destination spans. Runs on the segment worker thread; the
// destination spans are disjoint from anything the main thread touches
// during the same hop.
static void ReduceScattered(char* buf, const std::vector<GroupSeg>& segs,
                            const char* decoded, int64_t a, int64_t b,
                            std::size_t elem, DataType dtype) {
  int64_t pos = 0;
  for (const auto& s : segs) {
    int64_t s_end = pos + s.cnt;
    if (s_end <= a) {
      pos = s_end;
      continue;
    }
    if (pos >= b) break;
    int64_t lo = std::max(a, pos), hi = std::min(b, s_end);
    if (hi > lo) {
      ReduceSum(buf + (s.off + (lo - pos)) * elem,
                decoded + (lo - a) * elem, hi - lo, dtype);
    }
    pos = s_end;
  }
}

// Ring reduce-scatter over chunk GROUPS: ring position m ends up owning
// ring group (m+1) % n, reduced over the ring — the grouped analogue of
// RingReduceScatterOn for stage 1 of the hierarchical reduce-scatter,
// where one local rank's "chunk" is the set of logical chunks of its
// cross-ring column (scattered spans, so hops stage through a packed
// buffer). Segmented-pipelined exactly like the flat legs: decode +
// scatter-reduce of segment s overlaps the pack/encode/transport of
// segment s+1.
static Status GroupedRingReduceScatter(
    TcpContext& ctx, Ring ring, char* buf,
    const std::vector<std::vector<GroupSeg>>& ring_groups, DataType dtype,
    CompressionMode cmp, int64_t pipe_bytes, uint32_t group = 0) {
  int n = ctx.RingSizeOn(ring, group);
  int rank = ctx.RingRankOn(ring, group);
  std::size_t elem = DataTypeSize(dtype);
  std::vector<int64_t> group_elems(n, 0);
  for (int j = 0; j < n; ++j) {
    for (const auto& s : ring_groups[j]) group_elems[j] += s.cnt;
  }
  int64_t seg = SegmentElems(pipe_bytes, elem, cmp);
  int64_t nseg = SegmentCount(group_elems, seg);
  int64_t max_group = MaxChunk(group_elems);
  if (max_group == 0) return Status::OK();
  if (seg <= 0 || nseg <= 1) {
    seg = max_group;
    nseg = 1;
  }

  std::vector<char> pack(static_cast<std::size_t>(max_group) * elem);
  bool compressed = cmp != CompressionMode::NONE;
  std::vector<char> send_c(compressed ? CompressedSize(seg, cmp) : 0);
  std::vector<char> recv_c[2] = {
      std::vector<char>(compressed ? CompressedSize(seg, cmp)
                                   : static_cast<std::size_t>(seg) * elem),
      std::vector<char>(compressed ? CompressedSize(seg, cmp)
                                   : static_cast<std::size_t>(seg) * elem)};
  std::vector<float> dec[2] = {
      std::vector<float>(compressed ? static_cast<std::size_t>(seg) : 0),
      std::vector<float>(compressed ? static_cast<std::size_t>(seg) : 0)};
  SegmentWorker worker;
  Metrics& m = GlobalMetrics();

  for (int step = 0; step < n - 1; ++step) {
    int send_g = (rank - step + n) % n;
    int recv_g = (rank - step - 1 + n) % n;
    // Pack the outgoing group (it carries every reduction applied so
    // far — the group received and reduced last hop is the one
    // forwarded this hop, as in the flat ring).
    {
      char* p = pack.data();
      for (const auto& s : ring_groups[send_g]) {
        std::memcpy(p, buf + s.off * elem,
                    static_cast<std::size_t>(s.cnt) * elem);
        p += s.cnt * elem;
      }
    }
    const std::vector<GroupSeg>& recv_segs = ring_groups[recv_g];
    for (int64_t s = 0; s < nseg; ++s) {
      int64_t soff = s * seg;
      int64_t sn = ClampSeg(group_elems[send_g], soff, seg);
      int64_t rn = ClampSeg(group_elems[recv_g], soff, seg);
      bool ok;
      char* rc = recv_c[s & 1].data();
      if (compressed) {
        CompressBuffer(
            reinterpret_cast<const float*>(pack.data()) + soff, sn, cmp,
            send_c.data());
        ok = ctx.ExchangeOn(ring, group, send_c.data(),
                            CompressedSize(sn, cmp), rc,
                            CompressedSize(rn, cmp));
      } else {
        ok = ctx.ExchangeOn(ring, group, pack.data() + soff * elem,
                            sn * elem, rc, rn * elem);
      }
      if (!ok) {
        worker.Drain();
        return RingLost(ctx, "hierarchical reduce-scatter local leg failed");
      }
      if (nseg > 1) {
        m.pipeline_segments_total.fetch_add(1, std::memory_order_relaxed);
      }
      if (rn > 0) {
        if (compressed) {
          float* dbuf = dec[s & 1].data();
          worker.Submit([buf, &recv_segs, rc, dbuf, soff, rn, cmp, elem,
                         dtype] {
            DecompressBuffer(rc, rn, cmp, dbuf);
            ReduceScattered(buf, recv_segs,
                            reinterpret_cast<const char*>(dbuf), soff,
                            soff + rn, elem, dtype);
          });
        } else {
          worker.Submit([buf, &recv_segs, rc, soff, rn, elem, dtype] {
            ReduceScattered(buf, recv_segs, rc, soff, soff + rn, elem,
                            dtype);
          });
        }
      }
    }
    // Hop barrier: the pack of the next hop reads what this hop reduced.
    worker.Drain();
  }
  return Status::OK();
}

bool CpuHierarchicalReduceScatter::Enabled(
    const std::vector<TensorTableEntry>& entries,
    const Response& response) const {
  // World group, or a subgroup whose member set forms a uniform
  // (local, cross) grid (docs/TRANSPORT.md) — the decision is a pure
  // function of (members, world grid, synchronized knob) on every rank.
  if (entries[0].device != HOST_DEVICE_ID ||
      !ctx_.hierarchical_possible() ||
      !global_state_->parameter_manager.HierarchicalReduceScatter()) {
    return false;
  }
  if (response.group_id() == 0) return true;
  return ctx_.GroupHierarchicalPossible(
      global_state_->group_table.Members(response.group_id()));
}

Status CpuHierarchicalReduceScatter::Execute(
    std::vector<TensorTableEntry>& entries, const Response& response) {
  // Three stages (grid (local_rank, cross_rank) -> global rank via
  // RankAt; logical chunk r belongs to global rank r):
  //   1. intra-host grouped reduce-scatter: local rank j ends up owning
  //      group_j = { chunk of RankAt(j, c) for every host c }, reduced
  //      over this host's ranks;
  //   2. inter-host ring reduce-scatter of group_j over the cross ring
  //      at local_rank j (relabeled so cross rank c lands on the chunk
  //      of RankAt(j, c) — i.e. every rank ends holding ITS OWN logical
  //      chunk, fully reduced);
  //   3. shard distribution: copy the owned chunk into the shard-sized
  //      output and postscale.
  // Group-scoped (docs/TRANSPORT.md): chunks partition over the GROUP,
  // "rank" is the group position, the stages ride the group's
  // local/cross sub-rings, and the grid lookup maps (local slot, host)
  // to group positions via the uniform-grid table.
  const uint32_t group = response.group_id();
  TcpContext::GroupGrid grid;
  if (group != 0) {
    std::vector<int> members = global_state_->group_table.Members(group);
    if (!ctx_.EnsureGroupSubRings(group, members)) {
      return RingLost(ctx_, "group sub-ring rendezvous failed");
    }
    grid = ctx_.GroupGridOf(members);
  }
  int n = group ? static_cast<int>(grid.pos_grid.size()) : ctx_.size();
  int rank = group
                 ? global_state_->group_table.IndexOf(group, ctx_.rank())
                 : ctx_.rank();
  int ls = group ? grid.local_size : ctx_.local_size();
  int lr = group ? grid.local_pos : ctx_.local_rank();
  int cs = group ? grid.cross_size : ctx_.cross_size();
  auto rank_at = [&](int j, int c) {
    return group ? grid.pos_grid[static_cast<std::size_t>(c) * ls + j]
                 : ctx_.RankAt(j, c);
  };
  auto& timeline = global_state_->timeline;
  CompressionMode cmp = EffectiveCompression(
      static_cast<CompressionMode>(response.compression()),
      entries[0].dtype);
  int64_t pipe = global_state_->parameter_manager.PipelineChunkBytes();
  Metrics& m = GlobalMetrics();
  timeline.ActivityStartAll(response.tensor_names(),
                            "REDUCE_SCATTER_HIERARCHICAL");
  for (auto& e : entries) {
    int64_t count = e.NumElements();
    std::size_t elem = DataTypeSize(e.dtype);
    std::vector<int64_t> counts, offsets;
    PartitionChunks(count, n, &counts, &offsets);
    m.reduce_scatter_total.fetch_add(1, std::memory_order_relaxed);
    m.reduce_scatter_bytes_total.fetch_add(
        static_cast<uint64_t>(count) * elem, std::memory_order_relaxed);
    m.reduce_scatter_hierarchical_total.fetch_add(1,
                                                  std::memory_order_relaxed);
    if (count == 0) continue;

    std::vector<char> work(static_cast<std::size_t>(count) * elem);
    std::memcpy(work.data(), e.data, work.size());
    if (e.prescale_factor != 1.0) {
      ScaleBuffer(work.data(), count, e.dtype, e.prescale_factor);
    }

    // Stage 1 groups, ring-relabeled exactly like the flat op's chunks:
    // ring position m ends owning ring group (m+1)%ls, so ring group m
    // = group (m+ls-1)%ls leaves local rank j with group_j.
    std::vector<std::vector<GroupSeg>> ring_groups(ls);
    for (int mpos = 0; mpos < ls; ++mpos) {
      int j = (mpos + ls - 1) % ls;
      for (int c = 0; c < cs; ++c) {
        int g = rank_at(j, c);
        ring_groups[mpos].push_back({offsets[g], counts[g]});
      }
    }
    Status s = GroupedRingReduceScatter(ctx_, Ring::LOCAL, work.data(),
                                        ring_groups, e.dtype, cmp, pipe,
                                        group);
    if (!s.ok()) {
      timeline.ActivityEndAll(response.tensor_names());
      return s;
    }

    // Stage 2: cross-ring reduce-scatter of my group's per-host chunks
    // (each contiguous; ring chunk m relabeled so cross rank c ends on
    // the chunk of RankAt(lr, c)).
    std::vector<int64_t> ring_counts(cs), ring_offsets(cs);
    for (int mpos = 0; mpos < cs; ++mpos) {
      int g = rank_at(lr, (mpos + cs - 1) % cs);
      ring_counts[mpos] = counts[g];
      ring_offsets[mpos] = offsets[g];
    }
    s = RingReduceScatterOn(ctx_, Ring::CROSS, work.data(), ring_counts,
                            ring_offsets, e.dtype, cmp, pipe, group);
    if (!s.ok()) {
      timeline.ActivityEndAll(response.tensor_names());
      return s;
    }

    // Stage 3: shard distribution.
    std::memcpy(e.output, work.data() + offsets[rank] * elem,
                static_cast<std::size_t>(counts[rank]) * elem);
    if (e.postscale_factor != 1.0) {
      ScaleBuffer(e.output, counts[rank], e.dtype, e.postscale_factor);
    }
  }
  timeline.ActivityEndAll(response.tensor_names());
  return Status::OK();
}

bool CpuRingAllgather::Enabled(const std::vector<TensorTableEntry>& entries,
                               const Response& response) const {
  return entries[0].device == HOST_DEVICE_ID;
}

Status CpuRingAllgather::Execute(std::vector<TensorTableEntry>& entries,
                                 const Response& response) {
  // Group-scoped: blocks lay out in GROUP order and circulate the
  // group's ring; response.tensor_sizes() is indexed by group position.
  const uint32_t group = response.group_id();
  {
    Status s = EnsureGroup(ctx_, global_state_, group);
    if (!s.ok()) return s;
  }
  int n = group ? ctx_.GroupSize(group) : ctx_.size();
  int rank = group ? ctx_.GroupRank(group) : ctx_.rank();
  auto& timeline = global_state_->timeline;
  timeline.ActivityStartAll(response.tensor_names(), "ALLGATHER_RING");
  for (auto& e : entries) {
    const auto& first_dims = response.tensor_sizes();
    if (static_cast<int>(first_dims.size()) != n) {
      return Status::UnknownError("allgather sizes missing");
    }
    int64_t slice_elems = 1;
    for (int d = 1; d < e.shape.ndims(); ++d) slice_elems *= e.shape.dim_size(d);
    std::size_t elem = DataTypeSize(e.dtype);

    std::vector<int64_t> block_bytes(n), block_offsets(n);
    int64_t total_bytes = 0;
    for (int r = 0; r < n; ++r) {
      block_bytes[r] = first_dims[r] * slice_elems * static_cast<int64_t>(elem);
      block_offsets[r] = total_bytes;
      total_bytes += block_bytes[r];
    }
    e.gathered = std::make_shared<std::vector<char>>(
        static_cast<std::size_t>(total_bytes));
    e.gathered_sizes =
        std::make_shared<std::vector<int64_t>>(first_dims);
    char* out = e.gathered->data();
    std::memcpy(out + block_offsets[rank], e.data,
                static_cast<std::size_t>(block_bytes[rank]));
    // Ring circulation: at step s, forward the block originally owned by
    // (rank - s) and receive the block owned by (rank - s - 1).
    for (int step = 0; step < n - 1; ++step) {
      int send_block = (rank - step + n) % n;
      int recv_block = (rank - step - 1 + n) % n;
      if (!ctx_.ExchangeOn(
              Ring::GLOBAL, group, out + block_offsets[send_block],
              static_cast<std::size_t>(block_bytes[send_block]),
              out + block_offsets[recv_block],
              static_cast<std::size_t>(block_bytes[recv_block]))) {
        timeline.ActivityEndAll(response.tensor_names());
        return RingLost(ctx_, "ring allgather exchange failed");
      }
    }
  }
  timeline.ActivityEndAll(response.tensor_names());
  return Status::OK();
}

bool CpuHierarchicalAllgather::Enabled(
    const std::vector<TensorTableEntry>& entries,
    const Response& response) const {
  return entries[0].device == HOST_DEVICE_ID &&
         response.group_id() == 0 &&
         ctx_.hierarchical_possible() &&
         global_state_->parameter_manager.HierarchicalAllgather();
}

Status CpuHierarchicalAllgather::Execute(
    std::vector<TensorTableEntry>& entries, const Response& response) {
  // Two-stage allgatherv (role parity with the reference's shared-memory
  // hierarchical allgather, mpi_operations.cc:168-321): blocks circulate
  // the intra-host local ring first, then whole host block-sets circulate
  // the cross ring, so the inter-host links carry each byte once per host
  // instead of once per rank.
  int n = ctx_.size();
  int ls = ctx_.local_size(), lr = ctx_.local_rank();
  int cs = ctx_.cross_size(), cr = ctx_.cross_rank();
  auto& timeline = global_state_->timeline;
  timeline.ActivityStartAll(response.tensor_names(), "ALLGATHER_HIERARCHICAL");
  for (auto& e : entries) {
    const auto& first_dims = response.tensor_sizes();
    if (static_cast<int>(first_dims.size()) != n) {
      timeline.ActivityEndAll(response.tensor_names());
      return Status::UnknownError("allgather sizes missing");
    }
    int64_t slice_elems = 1;
    for (int d = 1; d < e.shape.ndims(); ++d) slice_elems *= e.shape.dim_size(d);
    std::size_t elem = DataTypeSize(e.dtype);

    std::vector<int64_t> block_bytes(n), block_offsets(n);
    int64_t total_bytes = 0;
    for (int r = 0; r < n; ++r) {
      block_bytes[r] = first_dims[r] * slice_elems * static_cast<int64_t>(elem);
      block_offsets[r] = total_bytes;
      total_bytes += block_bytes[r];
    }
    e.gathered = std::make_shared<std::vector<char>>(
        static_cast<std::size_t>(total_bytes));
    e.gathered_sizes = std::make_shared<std::vector<int64_t>>(first_dims);
    char* out = e.gathered->data();
    std::memcpy(out + block_offsets[ctx_.rank()], e.data,
                static_cast<std::size_t>(block_bytes[ctx_.rank()]));

    // Stage 1: circulate single-rank blocks around the CROSS ring (my
    // local_rank's column), writing each at its final (global-rank)
    // offset. Each cross ring carries only its own column, so every byte
    // crosses the inter-host links exactly once in total.
    for (int step = 0; step < cs - 1; ++step) {
      int gs = ctx_.RankAt(lr, (cr - step + cs) % cs);
      int gr = ctx_.RankAt(lr, (cr - step - 1 + cs) % cs);
      if (!ctx_.RingExchangeOn(
              Ring::CROSS, out + block_offsets[gs],
              static_cast<std::size_t>(block_bytes[gs]),
              out + block_offsets[gr],
              static_cast<std::size_t>(block_bytes[gr]))) {
        timeline.ActivityEndAll(response.tensor_names());
        return RingLost(ctx_, "hierarchical allgather cross leg failed");
      }
    }

    // Stage 2: circulate whole column-sets (one local_rank's blocks from
    // every host) around the intra-host local ring. Columns are not
    // contiguous in the global layout, so stage through pack/unpack
    // buffers — cheap, since this leg never leaves the host.
    std::vector<int64_t> col_bytes(ls, 0);
    int64_t max_col = 0;
    for (int j = 0; j < ls; ++j) {
      for (int c = 0; c < cs; ++c) col_bytes[j] += block_bytes[ctx_.RankAt(j, c)];
      max_col = std::max(max_col, col_bytes[j]);
    }
    std::vector<char> tmp_send(static_cast<std::size_t>(max_col));
    std::vector<char> tmp_recv(static_cast<std::size_t>(max_col));
    for (int step = 0; step < ls - 1; ++step) {
      int send_col = (lr - step + ls) % ls;
      int recv_col = (lr - step - 1 + ls) % ls;
      char* p = tmp_send.data();
      for (int c = 0; c < cs; ++c) {
        int g = ctx_.RankAt(send_col, c);
        std::memcpy(p, out + block_offsets[g],
                    static_cast<std::size_t>(block_bytes[g]));
        p += block_bytes[g];
      }
      if (!ctx_.RingExchangeOn(
              Ring::LOCAL, tmp_send.data(),
              static_cast<std::size_t>(col_bytes[send_col]), tmp_recv.data(),
              static_cast<std::size_t>(col_bytes[recv_col]))) {
        timeline.ActivityEndAll(response.tensor_names());
        return RingLost(ctx_, "hierarchical allgather local leg failed");
      }
      const char* q = tmp_recv.data();
      for (int c = 0; c < cs; ++c) {
        int g = ctx_.RankAt(recv_col, c);
        std::memcpy(out + block_offsets[g], q,
                    static_cast<std::size_t>(block_bytes[g]));
        q += block_bytes[g];
      }
    }
  }
  timeline.ActivityEndAll(response.tensor_names());
  return Status::OK();
}

bool CpuBroadcast::Enabled(const std::vector<TensorTableEntry>& entries,
                           const Response& response) const {
  return entries[0].device == HOST_DEVICE_ID;
}

Status CpuBroadcast::Execute(std::vector<TensorTableEntry>& entries,
                             const Response& response) {
  auto& timeline = global_state_->timeline;
  timeline.ActivityStartAll(response.tensor_names(), "BROADCAST_RING");
  const uint32_t group = response.group_id();
  {
    Status s = EnsureGroup(ctx_, global_state_, group);
    if (!s.ok()) {
      timeline.ActivityEndAll(response.tensor_names());
      return s;
    }
  }
  int rank = ctx_.rank();
  for (auto& e : entries) {
    std::size_t len = e.SizeBytes();
    // Cut-through pipelined broadcast over the global ring (or, for a
    // group collective, the group's ring with the root remapped to its
    // group position): every byte crosses each link once and
    // intermediate ranks forward as they receive, replacing the former
    // star fan-out that serialized N-1 full copies through rank 0.
    if (rank == e.root_rank && e.output != e.data) {
      std::memcpy(e.output, e.data, len);
    }
    bool ok;
    if (group != 0) {
      int root_pos = global_state_->group_table.IndexOf(group, e.root_rank);
      ok = root_pos >= 0 &&
           ctx_.GroupBroadcast(group, e.output, len, root_pos);
    } else {
      ok = ctx_.RingBroadcast(e.output, len, e.root_rank);
    }
    if (!ok) {
      timeline.ActivityEndAll(response.tensor_names());
      return RingLost(ctx_, "ring broadcast failed");
    }
  }
  timeline.ActivityEndAll(response.tensor_names());
  return Status::OK();
}

}  // namespace hvdtpu
