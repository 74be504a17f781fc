// Cross-rank distributed tracing + always-on flight recorder
// (docs/TRACING.md). Three pieces share one fixed-size ring of binary
// span records:
//
//  1. A per-rank, always-on span recorder instrumenting the full tensor
//     lifecycle (enqueue -> negotiation wait -> fuse -> exec -> per-hop
//     wire/encode/decode -> callback) plus serve-plane requests. The
//     hot path is lock-light in the metrics.h sense: one relaxed
//     fetch_add to claim a slot plus relaxed stores to publish it — a
//     seqlock variant where EVERY slot field is an atomic, so a reader
//     racing a wraparound sees a torn *sequence check*, never a torn
//     read (TSAN-clean by construction). Overruns drop spans and count
//     them (spans_dropped); recording never blocks.
//
//  2. NTP-style clock alignment: the worker stamps T1/T4 around its
//     FinishCycle gather/broadcast pair and the coordinator piggybacks
//     its own T2/T3 stamps on the ResponseList tail (message.cc), giving
//     offset = ((T2-T1)+(T3-T4))/2 with uncertainty = ((T4-T1)-(T3-T2))/2
//     — the classic symmetric-delay bound. Rank 0 is the reference
//     (offset 0 by definition); a new sample is adopted when its
//     uncertainty beats the current one or the current one is stale.
//     bin/hvd-trace uses the per-shard offsets to merge all ranks onto
//     rank 0's timebase.
//
//  3. A flight recorder: on stall escalation, divergence, connection
//     loss, drain, or a fatal signal, DumpBundle() writes ring contents
//     + metrics snapshot + pending-negotiation table + the last
//     kControlFrameLog control-frame headers + the clock offset to
//     HVD_TPU_BUNDLE_DIR as one JSON file. The launcher lists bundle
//     paths in its failure summary.
//
// Env: HVD_TPU_TRACE=0 disables recording (default on),
// HVD_TPU_TRACE_RING=N ring capacity (power of two, default 32768),
// HVD_TPU_TRACE_DIR=<dir> stream spans to <dir>/trace_rank<r>.jsonl,
// HVD_TPU_BUNDLE_DIR=<dir> where post-mortem bundles land (the launcher
// injects a default under its log dir).
#ifndef HVD_TPU_TRACE_H
#define HVD_TPU_TRACE_H

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace hvdtpu {

// Span phases, ordered by lifecycle position. Values are wire/shard
// format (bin/hvd-trace decodes them) — append only.
enum TracePhase : int {
  TRACE_ENQUEUE = 0,   // instant: tensor handed to the background queue
  TRACE_NEGOTIATE = 1, // enqueue -> response performed (the wait)
  TRACE_FUSE = 2,      // memcpy into the fusion buffer
  TRACE_EXEC = 3,      // ExecuteOperation (the collective itself)
  TRACE_WIRE_HOP = 4,  // one PairExchange leg (tcp or shm)
  TRACE_ENCODE = 5,    // compression encode call
  TRACE_DECODE = 6,    // compression decode call
  TRACE_CALLBACK = 7,  // user completion callback
  TRACE_REQUEST = 8,   // serve plane: one batched forward
};
const char* TracePhaseName(int p);

// One ring slot. Every field is an atomic so the drainer/bundle reader
// can race a wraparound without a data race; `seq` is the seqlock word:
// kSlotBusy while a writer is mid-publish, claim_index+1 once published.
// The name is stored as 6 relaxed 64-bit words (47 chars + NUL).
struct TraceSlot {
  static constexpr int kNameWords = 6;
  static constexpr uint64_t kBusy = ~0ull;
  std::atomic<uint64_t> seq{0};
  std::atomic<int64_t> t_start{0};
  std::atomic<int64_t> t_end{0};
  std::atomic<uint64_t> cycle{0};
  // phase(8) | flags(8) | group(16) | peer-as-u32(32).
  std::atomic<uint64_t> meta{0};
  std::atomic<int64_t> bytes{0};
  std::atomic<uint64_t> name[kNameWords] = {};
};

// A decoded (untorn) slot, for the drainer / bundle writer / tests.
struct TraceSpan {
  char name[TraceSlot::kNameWords * 8];
  int phase = 0;
  uint8_t flags = 0;
  uint32_t group = 0;
  int peer = -1;
  uint64_t cycle = 0;
  int64_t bytes = 0;
  int64_t t_start = 0;
  int64_t t_end = 0;
};

// Span flag bits.
constexpr uint8_t TRACE_FLAG_SHM = 1;  // wire hop rode a shm segment

class Trace {
 public:
  static constexpr int kControlFrameLog = 64;
  static constexpr int kMaxBundles = 8;

  Trace();

  // Generation (re)start: reads env, sizes the ring on first call
  // (capacity is fixed for the process lifetime — monotonic counters
  // and the shard file survive elastic re-init like metrics.h).
  void Configure(int rank, int world_size, int64_t generation);
  // Final shard drain + drainer join. Safe to call repeatedly.
  void Shutdown();

  bool enabled() const { return enabled_.load(std::memory_order_relaxed); }
  int rank() const { return rank_.load(std::memory_order_relaxed); }

  // Monotonic ns since this process's trace epoch (steady_clock; the
  // clock offset below maps it onto rank 0's epoch).
  int64_t NowNs() const;

  // Hot path: claim a slot, publish a span. Never blocks; when the ring
  // has wrapped past the drainer the overwritten spans count as drops.
  void Record(const char* name, int phase, int64_t start_ns, int64_t end_ns,
              int64_t bytes = 0, uint32_t group = 0, int peer = -1,
              uint64_t cycle = 0, uint8_t flags = 0);

  // Open-span table for the negotiation wait (enqueue -> perform spans
  // cross threads, so they can't live on the recording thread's stack).
  // Key convention: "<group>/<tensor name>".
  void OpenSpan(const std::string& key, int64_t start_ns);
  int64_t CloseSpan(const std::string& key);  // -1 = never opened

  // Last-N control-frame header log for bundles (tag is the frame's
  // 4-byte type tag; called from the control send/recv wrappers).
  void NoteControlFrame(uint32_t tag, bool send, uint64_t bytes);

  // Clock alignment (worker side; rank 0 never calls it — its offset is
  // 0 by definition). All stamps are NowNs() values from the respective
  // rank. Adopts the sample if its uncertainty beats the current
  // estimate or the estimate is older than kClockStaleNs.
  void UpdateClockSample(int64_t t1, int64_t t2, int64_t t3, int64_t t4);
  int64_t clock_offset_ns() const {
    return clock_offset_ns_.load(std::memory_order_relaxed);
  }
  // -1 until the first sample lands.
  int64_t clock_uncertainty_ns() const {
    return clock_uncertainty_ns_.load(std::memory_order_relaxed);
  }

  // Flight recorder: write one post-mortem bundle (ring + metrics
  // snapshot + `pending_json` + control frames + clock) to
  // HVD_TPU_BUNDLE_DIR. Returns the path, or "" when no dir is
  // configured / the per-process cap is hit / the write failed.
  // Callable from any thread; best-effort from fatal-signal context.
  std::string DumpBundle(const char* reason, const std::string& pending_json);

  // Push ring contents to the shard file now (shutdown/bundle points).
  void FlushShard();

  // Decode the currently-readable ring contents (oldest first) without
  // advancing the drain cursor. Bundle writer + tests.
  std::vector<TraceSpan> SnapshotSpans() const;

  // --- monotonic counters (summary wire: trace_spans_total etc.) ---
  std::atomic<uint64_t> spans_total{0};
  std::atomic<uint64_t> spans_dropped{0};
  std::atomic<uint64_t> bundles_written{0};

 private:
  static constexpr int64_t kClockStaleNs = 30ll * 1000 * 1000 * 1000;

  void DrainerLoop();
  // Drain published slots [cursor_, head) to the shard file; counts
  // overrun drops. Caller holds shard_mutex_.
  void DrainLocked();
  void WriteShardHeaderLocked();
  // Read slot at claim index `idx`; false on unpublished/torn.
  bool ReadSlot(uint64_t idx, TraceSpan* out) const;

  std::atomic<bool> enabled_{false};
  std::atomic<int> rank_{-1};
  std::atomic<int> world_size_{0};
  std::atomic<int64_t> generation_{-1};
  std::chrono::steady_clock::time_point epoch_;

  // Ring storage; allocated once, capacity fixed thereafter.
  std::unique_ptr<TraceSlot[]> ring_;
  uint64_t ring_mask_ = 0;       // capacity - 1 (set once at first Configure)
  std::atomic<uint64_t> head_{0};  // next claim index (monotonic)

  // Clock estimate (worker). Offset maps local NowNs onto rank 0's:
  // t_rank0 = t_local + offset.
  std::atomic<int64_t> clock_offset_ns_{0};
  std::atomic<int64_t> clock_uncertainty_ns_{-1};
  std::atomic<int64_t> clock_sampled_at_ns_{0};

  mutable std::mutex open_mutex_;
  std::unordered_map<std::string, int64_t> open_spans_;  // guarded_by(open_mutex_)

  mutable std::mutex frame_mutex_;
  struct FrameNote {
    int64_t t_ns;
    uint32_t tag;
    bool send;
    uint64_t bytes;
  };
  std::deque<FrameNote> control_frames_;  // guarded_by(frame_mutex_)

  mutable std::mutex shard_mutex_;
  std::FILE* shard_file_ = nullptr;        // guarded_by(shard_mutex_)
  uint64_t drain_cursor_ = 0;              // guarded_by(shard_mutex_)
  int64_t last_clock_emitted_ = -2;        // guarded_by(shard_mutex_)
  std::string trace_dir_;                  // guarded_by(shard_mutex_)
  std::thread drainer_thread_;             // guarded_by(shard_mutex_)
  bool drainer_running_ = false;           // guarded_by(shard_mutex_)
  std::atomic<bool> drainer_stop_{false};

  std::mutex bundle_mutex_;
  std::string bundle_dir_;  // guarded_by(bundle_mutex_)
};

// Process-wide recorder. A leaked singleton like GlobalMetrics() so leaf
// components without a state pointer (the transport pair-exchange, the
// fatal-signal handler) reach it directly; global_state.h holds a
// reference for everything that does carry state.
Trace& GlobalTrace();

}  // namespace hvdtpu

#endif  // HVD_TPU_TRACE_H
