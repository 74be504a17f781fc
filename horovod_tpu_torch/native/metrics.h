// Live metrics plane: a lock-light registry of counters, gauges, and
// fixed-bucket histograms populated from the coordination hot paths
// (SURVEY 5.5 names the gap: "No metrics-server/Prometheus-style
// subsystem" in the reference — its only observability is the post-hoc
// timeline file and log-only stall warnings).
//
// Concurrency model: hot-path writes are single atomic RMWs with relaxed
// ordering (the background coordination thread and enqueue threads never
// take a lock here); snapshot readers (the C API / the Python scraper
// thread) read the same atomics. The only mutex guards the COLD per-rank
// state on the coordinator: worker summaries ingested once per piggyback
// (~1/s) and the per-rank announce-lag accumulators (once per tensor
// completion). `make check-tsan` runs the negotiation fuzz with an active
// scraper thread to prove the discipline.
//
// Counters are MONOTONIC for the life of the process (Prometheus
// convention) — unlike the per-generation protocol counters
// (tcp_context.h), they deliberately survive elastic re-init so a scrape
// never sees a counter go backwards. Gauges and rank-scoped state reset
// with each generation (Configure()).
#ifndef HVD_TPU_METRICS_H
#define HVD_TPU_METRICS_H

#include <atomic>
#include <chrono>
#include <cstdint>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace hvdtpu {

// Fixed upper-bound-bucket histogram (atomics only; +Inf bucket implicit
// as counts[bounds.size()]). `scale` converts the observed double into
// the integer units the sum accumulates in (1e6 for seconds -> the sum
// stays exact to the microsecond without atomic<double>).
class MetricHistogram {
 public:
  MetricHistogram(std::vector<double> bounds, double scale);

  void Observe(double v);

  struct Snapshot {
    std::vector<double> bounds;
    std::vector<uint64_t> counts;  // bounds.size() + 1 (last = overflow)
    double sum = 0.0;
    uint64_t count = 0;
  };
  Snapshot snapshot() const;
  double sum() const;
  uint64_t count() const { return count_.load(std::memory_order_relaxed); }

 private:
  std::vector<double> bounds_;
  double scale_;
  std::unique_ptr<std::atomic<uint64_t>[]> counts_;
  std::atomic<int64_t> sum_scaled_{0};
  std::atomic<uint64_t> count_{0};
};

// Compact per-rank summary piggybacked on the RequestList wire (the same
// channel PR 2 used for call digests). Wire order == enum order; the
// count prefix makes additions forward-compatible (an older decoder
// ignores the tail, a newer one zero-fills).
enum SummaryField : int {
  SUM_CYCLES_TOTAL = 0,
  SUM_CYCLES_FAST,
  SUM_CYCLES_FULL,
  SUM_CYCLE_SECONDS_SUM,
  SUM_TENSORS_ENQUEUED,
  SUM_TENSORS_PERFORMED,
  SUM_RESPONSES_PERFORMED,
  SUM_BYTES_PERFORMED,
  SUM_FUSED_TENSORS,
  SUM_FUSED_BYTES,
  SUM_CACHE_HIT,
  SUM_CACHE_MISS,
  SUM_QUEUE_DEPTH,
  SUM_STALL_WARNINGS,
  SUM_DIVERGENCE_ERRORS,
  SUM_NEGOTIATION_SECONDS_SUM,
  SUM_NEGOTIATION_COUNT,
  // Transport robustness (PR 4, docs/CHAOS.md). Appended AFTER the
  // original 17 fields — the count prefix keeps the wire
  // forward-compatible with pre-chaos decoders.
  SUM_NET_CRC_ERRORS,
  SUM_NET_TIMEOUTS,
  SUM_NET_RECONNECTS,
  SUM_FAULTS_INJECTED,
  // Durable checkpoints (docs/ELASTIC.md "Durability"). Appended after
  // the chaos fields, same forward-compatibility rule.
  SUM_CKPT_WRITES,
  SUM_CKPT_WRITE_FAILURES,
  SUM_LAST_DURABLE_STEP,
  // Wire compression (docs/COMPRESSION.md). Appended after the durable
  // fields; an older worker's summary simply lacks the tail and the job
  // view / hvd-top render "-" for it instead of misaligning.
  SUM_COMPRESSION_BYTES_IN,
  SUM_COMPRESSION_BYTES_OUT,
  SUM_NET_RING_BYTES_SENT,
  // Graceful drain (docs/FLEET.md). Appended after the compression
  // fields, same forward-compatibility rule: drain requests this worker
  // honored and whether it is currently draining (1) / surviving a
  // peer's drain (0) / has never seen one (-1).
  SUM_DRAINS_REQUESTED,
  SUM_DRAINING,
  // Sharded weight update (docs/ZERO.md). Appended after the drain
  // fields: executed reduce-scatter collectives and this rank's reported
  // optimizer-state bytes (-1 = never reported); older decoders ignore
  // the tail.
  SUM_REDUCE_SCATTER,
  SUM_OPT_STATE_BYTES,
  // Always-on closed-loop autotune (docs/AUTOTUNE.md). Appended after
  // the sharded fields: whether this rank's tuner is actively sampling
  // (1) or converged (0) and how many times it re-armed; the hvd-top
  // `tun` column renders them ('-' for a pre-autotune worker's summary).
  SUM_AUTOTUNE_ACTIVE,
  SUM_AUTOTUNE_REARMS,
  // Process groups (docs/GROUPS.md). Appended after the autotune
  // fields: registered groups on this rank and group-scoped tensors it
  // executed; the hvd-top `grp` column renders them ('-' for a
  // pre-groups worker's summary).
  SUM_GROUPS,
  SUM_GROUP_TENSORS,
  // Shared-memory data plane (docs/TRANSPORT.md). Appended last: live
  // attached segments on this rank and payload bytes its ring legs
  // moved through shared memory instead of loopback TCP; the hvd-top
  // `shm` column renders them ('-' for a pre-shm worker's summary).
  SUM_SHM_SEGMENTS,
  SUM_SHM_BYTES_SENT,
  // Distributed tracing + flight recorder (docs/TRACING.md). Appended
  // after the shm fields: spans recorded / spans lost to ring overrun
  // on this rank, and post-mortem bundles it wrote; the hvd-top `trc`
  // column renders them ('-' for a pre-trace worker's summary). The
  // values live in the Trace singleton (trace.h) — Summary() reads
  // them through GlobalTrace() like any other registry field.
  SUM_TRACE_SPANS,
  SUM_TRACE_SPANS_DROPPED,
  SUM_BUNDLES_WRITTEN,
  SUM_FIELD_COUNT
};
const char* SummaryFieldName(int field);

class Metrics {
 public:
  Metrics();

  // --- hot-path counters (background thread + enqueue threads) ---
  std::atomic<uint64_t> cycles_total{0};
  std::atomic<uint64_t> cycles_fast_total{0};
  std::atomic<uint64_t> cycles_full_total{0};
  std::atomic<uint64_t> tensors_enqueued_total{0};
  std::atomic<uint64_t> responses_performed_total{0};
  std::atomic<uint64_t> tensors_performed_total{0};
  std::atomic<uint64_t> bytes_performed_total{0};
  std::atomic<uint64_t> fused_tensors_total{0};
  std::atomic<uint64_t> fused_bytes_total{0};
  std::atomic<uint64_t> cache_hit_total{0};
  std::atomic<uint64_t> cache_miss_total{0};
  std::atomic<uint64_t> cache_invalid_total{0};
  std::atomic<uint64_t> stall_warnings_total{0};
  std::atomic<uint64_t> stall_missing_rank_micros_total{0};
  std::atomic<uint64_t> divergence_errors_total{0};
  std::atomic<uint64_t> error_responses_total{0};
  std::atomic<uint64_t> init_total{0};

  // --- transport robustness (net.cc / tcp_context.cc / fault.cc) ---
  std::atomic<uint64_t> net_crc_errors_total{0};       // checksum mismatches
  std::atomic<uint64_t> net_recv_timeouts_total{0};    // SO_RCVTIMEO expiry
  std::atomic<uint64_t> net_send_timeouts_total{0};    // SO_SNDTIMEO expiry
  std::atomic<uint64_t> net_oversize_frames_total{0};  // > MAX_FRAME_BYTES
  std::atomic<uint64_t> net_reconnect_attempts_total{0};
  std::atomic<uint64_t> net_reconnects_total{0};       // successful resumes
  std::atomic<uint64_t> faults_injected_total{0};      // all injected faults
  std::atomic<uint64_t> fault_drop_total{0};
  std::atomic<uint64_t> fault_delay_total{0};
  std::atomic<uint64_t> fault_corrupt_total{0};
  std::atomic<uint64_t> fault_close_total{0};
  std::atomic<uint64_t> fault_stall_total{0};

  // --- wire compression (compression.cc / cpu_operations.cc) ---
  // Codec throughput: f32 bytes entering the compressor vs bytes put on
  // the wire (the ratio is the live compression factor), plus encode-op
  // counts per mode and allreduce executions per negotiated mode.
  std::atomic<uint64_t> compression_bytes_in_total{0};
  std::atomic<uint64_t> compression_bytes_out_total{0};
  std::atomic<uint64_t> compression_bf16_total{0};   // encode calls
  std::atomic<uint64_t> compression_int8_total{0};   // encode calls
  std::atomic<uint64_t> allreduce_uncompressed_total{0};
  std::atomic<uint64_t> allreduce_bf16_total{0};
  std::atomic<uint64_t> allreduce_int8_total{0};
  // Data-ring wire accounting (frame headers included): the quantity
  // the compression stage shrinks, measured at the transport layer —
  // bench.py --compression reads the A/B from these. Counts data-plane
  // bytes WHATEVER the transport (loopback TCP or an intra-host shm
  // ring), so a compression ratio A/B is transport-independent; the
  // net_shm_* counters below split out the shm share.
  std::atomic<uint64_t> net_ring_bytes_sent_total{0};
  std::atomic<uint64_t> net_ring_bytes_recv_total{0};

  // --- shared-memory data plane (tcp_context.cc / docs/TRANSPORT.md) ---
  // Payload+header bytes ring legs moved through shared-memory segments
  // (also counted in net_ring_bytes_* above — these isolate the shm
  // share so bench.py --shm can prove the plane engaged).
  std::atomic<uint64_t> net_shm_bytes_sent_total{0};
  std::atomic<uint64_t> net_shm_bytes_recv_total{0};

  // --- durable checkpoints (elastic/durable.py via the C API) ---
  std::atomic<uint64_t> ckpt_writes_total{0};          // published snapshots
  std::atomic<uint64_t> ckpt_write_failures_total{0};  // degraded writes
  std::atomic<uint64_t> ckpt_bytes_total{0};           // shard bytes written
  std::atomic<uint64_t> ckpt_restores_total{0};        // successful restores
  std::atomic<uint64_t> ckpt_restore_failures_total{0};

  // --- graceful drain (elastic/run.py via the C API; docs/FLEET.md) ---
  std::atomic<uint64_t> drains_requested_total{0};  // agreed drain epochs

  // --- sharded weight update (cpu_operations.cc / docs/ZERO.md) ---
  std::atomic<uint64_t> reduce_scatter_total{0};  // executed reduce-scatters
  // Full-tensor payload bytes entering reduce-scatter executions (the
  // shard each rank keeps is 1/N of this).
  std::atomic<uint64_t> reduce_scatter_bytes_total{0};
  // Reduce-scatters that took the two-level (intra-host reduce ->
  // inter-host ring -> shard distribution) composite path.
  std::atomic<uint64_t> reduce_scatter_hierarchical_total{0};

  // --- pipelined ring transport (cpu_operations.cc / docs/AUTOTUNE.md) ---
  // Segment exchanges issued by the double-buffered pipelined hops (a
  // hop that ran unsliced contributes nothing here).
  std::atomic<uint64_t> pipeline_segments_total{0};

  // --- always-on closed-loop autotune (parameter_manager / operations.cc) ---
  std::atomic<uint64_t> autotune_rearms_total{0};

  // --- process groups (controller.cc / operations.cc; docs/GROUPS.md) ---
  // Group-scoped tensors this rank EXECUTED (non-members of a group
  // skip its responses and contribute nothing).
  std::atomic<uint64_t> group_tensors_total{0};
  // Coordinator-side per-group negotiation counters, rendered as
  // group-labeled Prometheus families. Fixed slots: group ids 1..16
  // are tracked individually; higher ids still count into
  // group_negotiated_overflow_total (no silent drop).
  static constexpr int kGroupStatSlots = 16;
  std::atomic<uint64_t> group_negotiated_total[kGroupStatSlots] = {};
  std::atomic<uint64_t> group_negotiated_overflow_total{0};
  void AddGroupNegotiated(uint32_t group_id, uint64_t tensors) {
    if (group_id >= 1 &&
        group_id <= static_cast<uint32_t>(kGroupStatSlots)) {
      group_negotiated_total[group_id - 1].fetch_add(
          tensors, std::memory_order_relaxed);
    } else {
      group_negotiated_overflow_total.fetch_add(tensors,
                                                std::memory_order_relaxed);
    }
  }

  // --- gauges (instantaneous; reset per generation) ---
  std::atomic<int64_t> queue_depth{0};
  std::atomic<int64_t> pending_negotiation{0};
  std::atomic<int64_t> elastic_generation{0};
  std::atomic<int64_t> world_size{0};
  std::atomic<int64_t> rank{-1};
  std::atomic<int64_t> fusion_threshold_bytes{0};
  // Newest step known durable on THIS rank's storage view (-1 = none).
  // Deliberately survives Configure(): an elastic re-init does not
  // un-write a checkpoint.
  std::atomic<int64_t> last_durable_step{-1};
  // Drain posture: -1 = never saw a drain, 1 = this worker is the
  // victim of the current drain epoch (about to durable-commit and
  // exit), 0 = it survived a peer's drain. Survives Configure() like
  // last_durable_step — a post-drain re-init does not erase history.
  std::atomic<int64_t> draining{-1};
  // Optimizer-state bytes held by THIS rank, reported by the sharded
  // optimizer wrappers (docs/ZERO.md; -1 = never reported). Reset per
  // generation: an elastic resize re-shards the state and re-reports.
  std::atomic<int64_t> opt_state_bytes{-1};
  // Live tuner posture: 1 while actively sampling, 0 once converged
  // (docs/AUTOTUNE.md). Updated from the background loop each cycle.
  std::atomic<int64_t> autotune_active{0};
  // Pipelined-ring segment size currently in force (0 = slicing off).
  std::atomic<int64_t> pipeline_chunk_bytes{0};
  // Registered process groups (group_table.h; reset per generation —
  // re-init clears the table and Python re-creates the mesh groups).
  std::atomic<int64_t> groups{0};
  // Live attached shared-memory segments (writer + reader side both
  // count; maintained by ShmSegmentTable, shm_context.cc). A fresh
  // value is stored on every attach/close, so it tracks re-inits
  // naturally.
  std::atomic<int64_t> shm_segments_active{0};

  // --- histograms ---
  MetricHistogram cycle_seconds;        // background work-cycle duration
  MetricHistogram negotiation_seconds;  // coordinator: first announce -> response
  MetricHistogram cycle_tensors;        // tensors executed per work cycle
  MetricHistogram cycle_bytes;          // payload bytes executed per work cycle
  MetricHistogram fusion_fill_ratio;    // fused payload / fusion threshold
  MetricHistogram ckpt_write_seconds;   // durable shard write+publish time
  MetricHistogram compression_seconds;  // one encode/decode call's CPU time

  // Whether the metrics PLANE (wire piggyback, forced sync cycles, HTTP
  // serving) is live — HVD_TPU_METRICS=1 or HVD_TPU_METRICS_PORT set.
  // The registry itself always counts (single relaxed atomics, the same
  // cost class as the pre-existing perf counters).
  void set_enabled(bool v) { enabled_.store(v, std::memory_order_relaxed); }
  bool enabled() const { return enabled_.load(std::memory_order_relaxed); }

  // Generation (re)start: sizes the per-rank state, resets gauges and
  // rank-scoped accumulators. Counters deliberately persist.
  void Configure(int world_size, int rank);

  // Coordinator: rank announced a pending tensor `seconds` after its
  // first announcement (0 for the first announcer). The accumulated
  // per-rank lag is the straggler signal: the rank the job spends the
  // most time waiting on has the largest total. Takes the rank mutex —
  // callers gate on the metrics plane being enabled so metrics-off jobs
  // never touch it from the negotiation path.
  void AddRankLag(int rank, double seconds);

  // This rank's compact summary (SummaryField order).
  std::vector<double> Summary() const;
  // Coordinator: ingest a worker's piggybacked summary.
  void SetRankSummary(int rank, const std::vector<double>& values);

  // Full registry snapshot of THIS worker, as JSON (consumed by
  // hvd.metrics() and the Prometheus renderer in Python).
  std::string SnapshotJson() const;
  // Coordinator job view: per-rank summaries (+ own, fresh), summary
  // staleness, and the per-rank announce-lag table. "{}" off-coordinator.
  std::string JobJson() const;

 private:
  using Clock = std::chrono::steady_clock;

  std::atomic<bool> enabled_{false};

  mutable std::mutex rank_mutex_;
  // Announce-lag accumulators, indexed by rank (coordinator only).
  std::vector<double> rank_lag_seconds_;    // guarded_by(rank_mutex_)
  std::vector<uint64_t> rank_lag_count_;    // guarded_by(rank_mutex_)
  // Latest ingested summary per rank + receive time (coordinator only).
  std::vector<std::vector<double>> rank_summaries_;      // guarded_by(rank_mutex_)
  std::vector<Clock::time_point> rank_summary_time_;     // guarded_by(rank_mutex_)
  bool is_coordinator_ = false;
};

// Process-wide registry. A singleton (not a HorovodGlobalState member
// value) so leaf components without a state pointer — the stall
// inspector, the C snapshot API — reach it directly; global_state.h
// holds a reference for everything that does carry state.
Metrics& GlobalMetrics();

}  // namespace hvdtpu

#endif  // HVD_TPU_METRICS_H
