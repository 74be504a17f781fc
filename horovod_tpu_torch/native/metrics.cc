#include "metrics.h"

#include <cmath>
#include <cstdio>
#include <sstream>

#include "trace.h"

namespace hvdtpu {

MetricHistogram::MetricHistogram(std::vector<double> bounds, double scale)
    : bounds_(std::move(bounds)),
      scale_(scale),
      counts_(new std::atomic<uint64_t>[bounds_.size() + 1]) {
  for (std::size_t i = 0; i <= bounds_.size(); ++i) counts_[i].store(0);
}

void MetricHistogram::Observe(double v) {
  std::size_t i = 0;
  while (i < bounds_.size() && v > bounds_[i]) ++i;
  counts_[i].fetch_add(1, std::memory_order_relaxed);
  sum_scaled_.fetch_add(static_cast<int64_t>(std::llround(v * scale_)),
                        std::memory_order_relaxed);
  count_.fetch_add(1, std::memory_order_relaxed);
}

MetricHistogram::Snapshot MetricHistogram::snapshot() const {
  Snapshot s;
  s.bounds = bounds_;
  s.counts.resize(bounds_.size() + 1);
  for (std::size_t i = 0; i <= bounds_.size(); ++i) {
    s.counts[i] = counts_[i].load(std::memory_order_relaxed);
  }
  s.sum = sum();
  s.count = count_.load(std::memory_order_relaxed);
  return s;
}

double MetricHistogram::sum() const {
  return static_cast<double>(sum_scaled_.load(std::memory_order_relaxed)) /
         scale_;
}

const char* SummaryFieldName(int field) {
  switch (field) {
    case SUM_CYCLES_TOTAL: return "cycles_total";
    case SUM_CYCLES_FAST: return "cycles_fast_total";
    case SUM_CYCLES_FULL: return "cycles_full_total";
    case SUM_CYCLE_SECONDS_SUM: return "cycle_seconds_sum";
    case SUM_TENSORS_ENQUEUED: return "tensors_enqueued_total";
    case SUM_TENSORS_PERFORMED: return "tensors_performed_total";
    case SUM_RESPONSES_PERFORMED: return "responses_performed_total";
    case SUM_BYTES_PERFORMED: return "bytes_performed_total";
    case SUM_FUSED_TENSORS: return "fused_tensors_total";
    case SUM_FUSED_BYTES: return "fused_bytes_total";
    case SUM_CACHE_HIT: return "cache_hit_total";
    case SUM_CACHE_MISS: return "cache_miss_total";
    case SUM_QUEUE_DEPTH: return "queue_depth";
    case SUM_STALL_WARNINGS: return "stall_warnings_total";
    case SUM_DIVERGENCE_ERRORS: return "divergence_errors_total";
    case SUM_NEGOTIATION_SECONDS_SUM: return "negotiation_seconds_sum";
    case SUM_NEGOTIATION_COUNT: return "negotiation_count";
    case SUM_NET_CRC_ERRORS: return "net_crc_errors_total";
    case SUM_NET_TIMEOUTS: return "net_timeouts_total";
    case SUM_NET_RECONNECTS: return "net_reconnects_total";
    case SUM_FAULTS_INJECTED: return "faults_injected_total";
    case SUM_CKPT_WRITES: return "ckpt_writes_total";
    case SUM_CKPT_WRITE_FAILURES: return "ckpt_write_failures_total";
    case SUM_LAST_DURABLE_STEP: return "last_durable_step";
    case SUM_COMPRESSION_BYTES_IN: return "compression_bytes_in_total";
    case SUM_COMPRESSION_BYTES_OUT: return "compression_bytes_out_total";
    case SUM_NET_RING_BYTES_SENT: return "net_ring_bytes_sent_total";
    case SUM_DRAINS_REQUESTED: return "drains_requested_total";
    case SUM_DRAINING: return "draining";
    case SUM_REDUCE_SCATTER: return "reduce_scatter_total";
    case SUM_OPT_STATE_BYTES: return "opt_state_bytes";
    case SUM_AUTOTUNE_ACTIVE: return "autotune_active";
    case SUM_AUTOTUNE_REARMS: return "autotune_rearms_total";
    case SUM_GROUPS: return "groups";
    case SUM_GROUP_TENSORS: return "group_tensors_total";
    case SUM_SHM_SEGMENTS: return "shm_segments_active";
    case SUM_SHM_BYTES_SENT: return "net_shm_bytes_sent_total";
    case SUM_TRACE_SPANS: return "trace_spans_total";
    case SUM_TRACE_SPANS_DROPPED: return "trace_spans_dropped_total";
    case SUM_BUNDLES_WRITTEN: return "bundles_written_total";
  }
  return "unknown";
}

// Bucket ladders: latencies cover 100us..10s (one cycle at default 5ms
// pacing up to a stall); tensors/bytes per cycle cover a lone scalar up
// to a full gradient bucket.
Metrics::Metrics()
    : cycle_seconds({1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                     5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0},
                    1e6),
      negotiation_seconds({1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                           2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0},
                          1e6),
      cycle_tensors({1, 2, 4, 8, 16, 32, 64, 128, 256, 512}, 1.0),
      cycle_bytes({1024, 16384, 262144, 1048576, 4194304, 16777216, 67108864,
                   268435456},
                  1.0),
      fusion_fill_ratio({0.1, 0.25, 0.5, 0.75, 0.9, 1.0}, 1e6),
      // Durable writes run in a background thread against real storage:
      // 1ms (page-cache local disk) up to minutes (an overloaded object
      // store with injected slow-fsync faults).
      ckpt_write_seconds({1e-3, 5e-3, 2.5e-2, 0.1, 0.5, 1.0, 2.5, 5.0,
                          10.0, 30.0, 60.0, 120.0},
                         1e6),
      // One encode/decode call spans a ring chunk: ~us for KB chunks up
      // to ~100ms for a full 64MB fusion buffer on one core.
      compression_seconds({1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2,
                           5e-2, 0.1, 0.5, 1.0},
                          1e9) {}

void Metrics::Configure(int world_size_in, int rank_in) {
  world_size.store(world_size_in, std::memory_order_relaxed);
  rank.store(rank_in, std::memory_order_relaxed);
  queue_depth.store(0, std::memory_order_relaxed);
  pending_negotiation.store(0, std::memory_order_relaxed);
  opt_state_bytes.store(-1, std::memory_order_relaxed);
  // Groups are per-generation (the registry clears on re-init and
  // Python re-creates the mesh groups after it).
  groups.store(0, std::memory_order_relaxed);
  std::lock_guard<std::mutex> lk(rank_mutex_);
  is_coordinator_ = rank_in == 0;
  rank_lag_seconds_.assign(world_size_in, 0.0);
  rank_lag_count_.assign(world_size_in, 0);
  rank_summaries_.assign(world_size_in, {});
  rank_summary_time_.assign(world_size_in, Clock::time_point{});
}

void Metrics::AddRankLag(int r, double seconds) {
  std::lock_guard<std::mutex> lk(rank_mutex_);
  if (r < 0 || r >= static_cast<int>(rank_lag_seconds_.size())) return;
  rank_lag_seconds_[r] += seconds;
  rank_lag_count_[r] += 1;
}

std::vector<double> Metrics::Summary() const {
  std::vector<double> v(SUM_FIELD_COUNT, 0.0);
  v[SUM_CYCLES_TOTAL] = static_cast<double>(cycles_total.load());
  v[SUM_CYCLES_FAST] = static_cast<double>(cycles_fast_total.load());
  v[SUM_CYCLES_FULL] = static_cast<double>(cycles_full_total.load());
  v[SUM_CYCLE_SECONDS_SUM] = cycle_seconds.sum();
  v[SUM_TENSORS_ENQUEUED] = static_cast<double>(tensors_enqueued_total.load());
  v[SUM_TENSORS_PERFORMED] =
      static_cast<double>(tensors_performed_total.load());
  v[SUM_RESPONSES_PERFORMED] =
      static_cast<double>(responses_performed_total.load());
  v[SUM_BYTES_PERFORMED] = static_cast<double>(bytes_performed_total.load());
  v[SUM_FUSED_TENSORS] = static_cast<double>(fused_tensors_total.load());
  v[SUM_FUSED_BYTES] = static_cast<double>(fused_bytes_total.load());
  v[SUM_CACHE_HIT] = static_cast<double>(cache_hit_total.load());
  v[SUM_CACHE_MISS] = static_cast<double>(cache_miss_total.load());
  v[SUM_QUEUE_DEPTH] = static_cast<double>(queue_depth.load());
  v[SUM_STALL_WARNINGS] = static_cast<double>(stall_warnings_total.load());
  v[SUM_DIVERGENCE_ERRORS] =
      static_cast<double>(divergence_errors_total.load());
  v[SUM_NEGOTIATION_SECONDS_SUM] = negotiation_seconds.sum();
  v[SUM_NEGOTIATION_COUNT] =
      static_cast<double>(negotiation_seconds.count());
  v[SUM_NET_CRC_ERRORS] = static_cast<double>(net_crc_errors_total.load());
  v[SUM_NET_TIMEOUTS] =
      static_cast<double>(net_recv_timeouts_total.load() +
                          net_send_timeouts_total.load());
  v[SUM_NET_RECONNECTS] = static_cast<double>(net_reconnects_total.load());
  v[SUM_FAULTS_INJECTED] = static_cast<double>(faults_injected_total.load());
  v[SUM_CKPT_WRITES] = static_cast<double>(ckpt_writes_total.load());
  v[SUM_CKPT_WRITE_FAILURES] =
      static_cast<double>(ckpt_write_failures_total.load());
  v[SUM_LAST_DURABLE_STEP] = static_cast<double>(last_durable_step.load());
  v[SUM_COMPRESSION_BYTES_IN] =
      static_cast<double>(compression_bytes_in_total.load());
  v[SUM_COMPRESSION_BYTES_OUT] =
      static_cast<double>(compression_bytes_out_total.load());
  v[SUM_NET_RING_BYTES_SENT] =
      static_cast<double>(net_ring_bytes_sent_total.load());
  v[SUM_DRAINS_REQUESTED] =
      static_cast<double>(drains_requested_total.load());
  v[SUM_DRAINING] = static_cast<double>(draining.load());
  v[SUM_REDUCE_SCATTER] = static_cast<double>(reduce_scatter_total.load());
  v[SUM_OPT_STATE_BYTES] = static_cast<double>(opt_state_bytes.load());
  v[SUM_AUTOTUNE_ACTIVE] = static_cast<double>(autotune_active.load());
  v[SUM_AUTOTUNE_REARMS] =
      static_cast<double>(autotune_rearms_total.load());
  v[SUM_GROUPS] = static_cast<double>(groups.load());
  v[SUM_GROUP_TENSORS] = static_cast<double>(group_tensors_total.load());
  v[SUM_SHM_SEGMENTS] = static_cast<double>(shm_segments_active.load());
  v[SUM_SHM_BYTES_SENT] =
      static_cast<double>(net_shm_bytes_sent_total.load());
  {
    // The trace recorder owns its counters (trace.h); the summary wire
    // carries them like any registry field so hvd-top's `trc` column
    // and the job view see every rank's span/drop/bundle totals.
    const Trace& t = GlobalTrace();
    v[SUM_TRACE_SPANS] = static_cast<double>(t.spans_total.load());
    v[SUM_TRACE_SPANS_DROPPED] =
        static_cast<double>(t.spans_dropped.load());
    v[SUM_BUNDLES_WRITTEN] = static_cast<double>(t.bundles_written.load());
  }
  return v;
}

void Metrics::SetRankSummary(int r, const std::vector<double>& values) {
  std::lock_guard<std::mutex> lk(rank_mutex_);
  if (r < 0 || r >= static_cast<int>(rank_summaries_.size())) return;
  rank_summaries_[r] = values;
  rank_summary_time_[r] = Clock::now();
}

namespace {

// Integral values (the counters, which can pass 1e10 on a real job)
// render exactly via the integer path; everything else gets %.17g,
// enough digits for a lossless double round trip.
void AppendNum(std::string* out, double v) {
  char buf[40];
  if (v == static_cast<double>(static_cast<int64_t>(v)) &&
      std::fabs(v) < 9.2e18) {
    std::snprintf(buf, sizeof(buf), "%lld",
                  static_cast<long long>(v));
  } else {
    std::snprintf(buf, sizeof(buf), "%.17g", v);
  }
  out->append(buf);
}

void AppendKV(std::string* out, const char* key, double v, bool* first) {
  if (!*first) out->append(",");
  *first = false;
  out->append("\"");
  out->append(key);
  out->append("\":");
  AppendNum(out, v);
}

void AppendHistogram(std::string* out, const char* name,
                     const MetricHistogram& h, bool* first) {
  if (!*first) out->append(",");
  *first = false;
  MetricHistogram::Snapshot s = h.snapshot();
  out->append("\"");
  out->append(name);
  out->append("\":{\"bounds\":[");
  for (std::size_t i = 0; i < s.bounds.size(); ++i) {
    if (i) out->append(",");
    AppendNum(out, s.bounds[i]);
  }
  out->append("],\"counts\":[");
  for (std::size_t i = 0; i < s.counts.size(); ++i) {
    if (i) out->append(",");
    AppendNum(out, static_cast<double>(s.counts[i]));
  }
  out->append("],\"sum\":");
  AppendNum(out, s.sum);
  out->append(",\"count\":");
  AppendNum(out, static_cast<double>(s.count));
  out->append("}");
}

}  // namespace

std::string Metrics::SnapshotJson() const {
  std::string out;
  out.reserve(2048);
  out.append("{\"counters\":{");
  bool first = true;
  AppendKV(&out, "cycles_total", cycles_total.load(), &first);
  AppendKV(&out, "cycles_fast_total", cycles_fast_total.load(), &first);
  AppendKV(&out, "cycles_full_total", cycles_full_total.load(), &first);
  AppendKV(&out, "tensors_enqueued_total", tensors_enqueued_total.load(),
           &first);
  AppendKV(&out, "responses_performed_total", responses_performed_total.load(),
           &first);
  AppendKV(&out, "tensors_performed_total", tensors_performed_total.load(),
           &first);
  AppendKV(&out, "bytes_performed_total", bytes_performed_total.load(),
           &first);
  AppendKV(&out, "fused_tensors_total", fused_tensors_total.load(), &first);
  AppendKV(&out, "fused_bytes_total", fused_bytes_total.load(), &first);
  AppendKV(&out, "cache_hit_total", cache_hit_total.load(), &first);
  AppendKV(&out, "cache_miss_total", cache_miss_total.load(), &first);
  AppendKV(&out, "cache_invalid_total", cache_invalid_total.load(), &first);
  AppendKV(&out, "stall_warnings_total", stall_warnings_total.load(), &first);
  AppendKV(&out, "stall_missing_rank_seconds_total",
           static_cast<double>(stall_missing_rank_micros_total.load()) / 1e6,
           &first);
  AppendKV(&out, "divergence_errors_total", divergence_errors_total.load(),
           &first);
  AppendKV(&out, "error_responses_total", error_responses_total.load(),
           &first);
  AppendKV(&out, "init_total", init_total.load(), &first);
  AppendKV(&out, "net_crc_errors_total", net_crc_errors_total.load(),
           &first);
  AppendKV(&out, "net_recv_timeouts_total", net_recv_timeouts_total.load(),
           &first);
  AppendKV(&out, "net_send_timeouts_total", net_send_timeouts_total.load(),
           &first);
  AppendKV(&out, "net_oversize_frames_total",
           net_oversize_frames_total.load(), &first);
  AppendKV(&out, "net_reconnect_attempts_total",
           net_reconnect_attempts_total.load(), &first);
  AppendKV(&out, "net_reconnects_total", net_reconnects_total.load(),
           &first);
  AppendKV(&out, "faults_injected_total", faults_injected_total.load(),
           &first);
  AppendKV(&out, "fault_drop_total", fault_drop_total.load(), &first);
  AppendKV(&out, "fault_delay_total", fault_delay_total.load(), &first);
  AppendKV(&out, "fault_corrupt_total", fault_corrupt_total.load(), &first);
  AppendKV(&out, "fault_close_total", fault_close_total.load(), &first);
  AppendKV(&out, "fault_stall_total", fault_stall_total.load(), &first);
  AppendKV(&out, "compression_bytes_in_total",
           compression_bytes_in_total.load(), &first);
  AppendKV(&out, "compression_bytes_out_total",
           compression_bytes_out_total.load(), &first);
  AppendKV(&out, "compression_bf16_total", compression_bf16_total.load(),
           &first);
  AppendKV(&out, "compression_int8_total", compression_int8_total.load(),
           &first);
  AppendKV(&out, "allreduce_uncompressed_total",
           allreduce_uncompressed_total.load(), &first);
  AppendKV(&out, "allreduce_bf16_total", allreduce_bf16_total.load(),
           &first);
  AppendKV(&out, "allreduce_int8_total", allreduce_int8_total.load(),
           &first);
  AppendKV(&out, "net_ring_bytes_sent_total",
           net_ring_bytes_sent_total.load(), &first);
  AppendKV(&out, "net_ring_bytes_recv_total",
           net_ring_bytes_recv_total.load(), &first);
  AppendKV(&out, "net_shm_bytes_sent_total",
           net_shm_bytes_sent_total.load(), &first);
  AppendKV(&out, "net_shm_bytes_recv_total",
           net_shm_bytes_recv_total.load(), &first);
  AppendKV(&out, "ckpt_writes_total", ckpt_writes_total.load(), &first);
  AppendKV(&out, "ckpt_write_failures_total",
           ckpt_write_failures_total.load(), &first);
  AppendKV(&out, "ckpt_bytes_total", ckpt_bytes_total.load(), &first);
  AppendKV(&out, "ckpt_restores_total", ckpt_restores_total.load(), &first);
  AppendKV(&out, "ckpt_restore_failures_total",
           ckpt_restore_failures_total.load(), &first);
  AppendKV(&out, "drains_requested_total", drains_requested_total.load(),
           &first);
  AppendKV(&out, "reduce_scatter_total", reduce_scatter_total.load(),
           &first);
  AppendKV(&out, "reduce_scatter_bytes_total",
           reduce_scatter_bytes_total.load(), &first);
  AppendKV(&out, "reduce_scatter_hierarchical_total",
           reduce_scatter_hierarchical_total.load(), &first);
  AppendKV(&out, "pipeline_segments_total",
           pipeline_segments_total.load(), &first);
  AppendKV(&out, "autotune_rearms_total",
           autotune_rearms_total.load(), &first);
  AppendKV(&out, "group_tensors_total", group_tensors_total.load(), &first);
  AppendKV(&out, "group_negotiated_overflow_total",
           group_negotiated_overflow_total.load(), &first);
  AppendKV(&out, "trace_spans_total", GlobalTrace().spans_total.load(),
           &first);
  AppendKV(&out, "trace_spans_dropped_total",
           GlobalTrace().spans_dropped.load(), &first);
  AppendKV(&out, "bundles_written_total",
           GlobalTrace().bundles_written.load(), &first);
  out.append("},\"gauges\":{");
  first = true;
  AppendKV(&out, "queue_depth", static_cast<double>(queue_depth.load()),
           &first);
  AppendKV(&out, "pending_negotiation",
           static_cast<double>(pending_negotiation.load()), &first);
  AppendKV(&out, "elastic_generation",
           static_cast<double>(elastic_generation.load()), &first);
  AppendKV(&out, "world_size", static_cast<double>(world_size.load()),
           &first);
  AppendKV(&out, "rank", static_cast<double>(rank.load()), &first);
  AppendKV(&out, "fusion_threshold_bytes",
           static_cast<double>(fusion_threshold_bytes.load()), &first);
  AppendKV(&out, "last_durable_step",
           static_cast<double>(last_durable_step.load()), &first);
  AppendKV(&out, "draining", static_cast<double>(draining.load()), &first);
  AppendKV(&out, "opt_state_bytes",
           static_cast<double>(opt_state_bytes.load()), &first);
  AppendKV(&out, "autotune_active",
           static_cast<double>(autotune_active.load()), &first);
  AppendKV(&out, "pipeline_chunk_bytes",
           static_cast<double>(pipeline_chunk_bytes.load()), &first);
  AppendKV(&out, "groups", static_cast<double>(groups.load()), &first);
  AppendKV(&out, "shm_segments_active",
           static_cast<double>(shm_segments_active.load()), &first);
  out.append("},\"per_group\":{");
  // Group-labeled negotiation counters (docs/GROUPS.md): one entry per
  // tracked group id with at least one negotiated tensor. The Python
  // renderer turns these into
  // hvdtpu_group_negotiated_total{group="<id>"} families.
  first = true;
  for (int g = 0; g < kGroupStatSlots; ++g) {
    uint64_t n = group_negotiated_total[g].load(std::memory_order_relaxed);
    if (n == 0) continue;
    if (!first) out.append(",");
    first = false;
    out.append("\"");
    out.append(std::to_string(g + 1));
    out.append("\":{\"negotiated_total\":");
    AppendNum(&out, static_cast<double>(n));
    out.append("}");
  }
  out.append("},\"histograms\":{");
  first = true;
  AppendHistogram(&out, "cycle_seconds", cycle_seconds, &first);
  AppendHistogram(&out, "negotiation_seconds", negotiation_seconds, &first);
  AppendHistogram(&out, "cycle_tensors", cycle_tensors, &first);
  AppendHistogram(&out, "cycle_bytes", cycle_bytes, &first);
  AppendHistogram(&out, "fusion_fill_ratio", fusion_fill_ratio, &first);
  AppendHistogram(&out, "ckpt_write_seconds", ckpt_write_seconds, &first);
  AppendHistogram(&out, "compression_seconds", compression_seconds, &first);
  out.append("},\"rank_lag_seconds\":[");
  {
    std::lock_guard<std::mutex> lk(rank_mutex_);
    for (std::size_t i = 0; i < rank_lag_seconds_.size(); ++i) {
      if (i) out.append(",");
      AppendNum(&out, rank_lag_seconds_[i]);
    }
    out.append("],\"rank_lag_count\":[");
    for (std::size_t i = 0; i < rank_lag_count_.size(); ++i) {
      if (i) out.append(",");
      AppendNum(&out, static_cast<double>(rank_lag_count_[i]));
    }
  }
  out.append("],\"enabled\":");
  out.append(enabled() ? "true" : "false");
  out.append("}");
  return out;
}

std::string Metrics::JobJson() const {
  std::vector<double> own = Summary();
  std::string out;
  std::lock_guard<std::mutex> lk(rank_mutex_);
  if (!is_coordinator_) return "{}";
  auto now = Clock::now();
  out.reserve(2048);
  out.append("{\"size\":");
  AppendNum(&out, static_cast<double>(world_size.load()));
  out.append(",\"generation\":");
  AppendNum(&out, static_cast<double>(elastic_generation.load()));
  out.append(",\"per_rank\":{");
  bool first_rank = true;
  for (std::size_t r = 0; r < rank_summaries_.size(); ++r) {
    const std::vector<double>& vals = r == 0 ? own : rank_summaries_[r];
    if (vals.empty()) continue;
    if (!first_rank) out.append(",");
    first_rank = false;
    out.append("\"");
    AppendNum(&out, static_cast<double>(r));
    out.append("\":{");
    bool first = true;
    for (std::size_t f = 0; f < vals.size() && f < SUM_FIELD_COUNT; ++f) {
      AppendKV(&out, SummaryFieldName(static_cast<int>(f)), vals[f], &first);
    }
    out.append("}");
  }
  out.append("},\"age_seconds\":{");
  bool first = true;
  for (std::size_t r = 0; r < rank_summaries_.size(); ++r) {
    if (rank_summaries_[r].empty() && r != 0) continue;
    double age =
        r == 0 ? 0.0
               : std::chrono::duration<double>(now - rank_summary_time_[r])
                     .count();
    if (!first) out.append(",");
    first = false;
    out.append("\"");
    AppendNum(&out, static_cast<double>(r));
    out.append("\":");
    AppendNum(&out, age);
  }
  out.append("},\"rank_lag_seconds\":[");
  for (std::size_t i = 0; i < rank_lag_seconds_.size(); ++i) {
    if (i) out.append(",");
    AppendNum(&out, rank_lag_seconds_[i]);
  }
  out.append("]}");
  return out;
}

Metrics& GlobalMetrics() {
  static Metrics* metrics = new Metrics();  // leaked: outlives all threads
  return *metrics;
}

}  // namespace hvdtpu
