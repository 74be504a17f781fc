#include "parameter_manager.h"

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>

#include "bayesian_optimization.h"
#include "common.h"
#include "logging.h"

namespace hvdtpu {

static double NowMicros() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Continuous search bounds. The pipeline-chunk bounds depend on the
// workload profile: with wire compression active every element ships
// 2-4x fewer bytes, so the slice that keeps the socket busy is
// proportionally smaller.
static constexpr double kFusionLo = 0.0, kFusionHi = 64.0;
static constexpr double kCycleLo = 1.0, kCycleHi = 100.0;
static constexpr double kChunkLoKb = 64.0, kChunkHiKb = 4096.0;
static constexpr double kChunkLoKbCompressed = 16.0,
                        kChunkHiKbCompressed = 1024.0;

// Wire word layout: (rearm_epoch << 8) | profile bits.
static constexpr uint64_t kProfileCompression = 1;
static constexpr uint64_t kProfileReduceScatter = 2;
static constexpr uint64_t kProfileGroups = 4;
static constexpr uint64_t kProfileShm = 8;

ParameterManager::ParameterManager() = default;
ParameterManager::~ParameterManager() = default;

void ParameterManager::Initialize(int32_t rank,
                                  const std::string& autotune_log_file) {
  std::lock_guard<std::mutex> lk(mu_);
  rank_ = rank;
  seed_salt_ = static_cast<uint64_t>(EnvInt64("HVD_TPU_GENERATION", 0));
  // Sampling pace / drift knobs (env-overridable so tests and bench can
  // converge in seconds instead of minutes; docs/AUTOTUNE.md).
  cycles_per_sample_ = std::max(
      1, static_cast<int>(EnvInt64("HVD_TPU_AUTOTUNE_CYCLES_PER_SAMPLE", 10)));
  max_samples_ = std::max(
      1, static_cast<int>(EnvInt64("HVD_TPU_AUTOTUNE_MAX_SAMPLES", 40)));
  warmup_samples_ = std::max(
      0, static_cast<int>(EnvInt64("HVD_TPU_AUTOTUNE_WARMUP", 3)));
  drift_threshold_ =
      std::max(1.01, EnvDouble("HVD_TPU_AUTOTUNE_DRIFT", 2.0));
  drift_window_cycles_ =
      std::max(4, static_cast<int>(EnvInt64("HVD_TPU_AUTOTUNE_DRIFT_WINDOW", 40)));
  // Generation (re)start: every rank — survivor or fresh — resets the
  // re-arm epoch to 0 so the wire bootstrap only signals genuine
  // intra-generation re-arms (a survivor carrying an old epoch into a
  // new generation would make fresh workers re-arm out of lockstep).
  // rearms_total_ deliberately survives: it is a monotonic counter.
  rearm_epoch_ = 0;
  rearm_pending_ = false;
  armed_once_ = false;  // re-opened by the generation's SetAutoTuning
  profile_compression_ = false;
  profile_reduce_scatter_ = false;
  profile_groups_ = false;
  profile_shm_ = false;
  if (rank == 0 && !autotune_log_file.empty()) {
    log_.open(autotune_log_file, std::ios::out | std::ios::trunc);
    if (log_.is_open()) {
      log_ << "fusion_mb,cycle_time_ms,pipeline_chunk_kb,cache_enabled,"
              "hierarchical_allreduce,hierarchical_allgather,"
              "hierarchical_reduce_scatter,shm_transport,"
              "score_bytes_per_us,event\n";
    }
  }
  BuildSearchSpace();
}

// lockorder: requires(mu_)
void ParameterManager::BuildSearchSpace() {
  // Categorical combos to sweep: (cache, hier_allreduce, hier_allgather,
  // hier_reduce_scatter). Fixed knobs collapse their dimension, and the
  // reduce-scatter knob only opens when the job actually executes
  // reduce-scatters (sharded-update-aware: tuning it on an allreduce-only
  // job would score identical configurations).
  categorical_combos_.clear();
  std::vector<bool> cache_opts =
      cache_fixed_ ? std::vector<bool>{cache_enabled_}
                   : std::vector<bool>{true, false};
  std::vector<bool> har_opts =
      hier_ar_fixed_ ? std::vector<bool>{hierarchical_allreduce_}
                     : std::vector<bool>{false, true};
  std::vector<bool> hag_opts =
      hier_ag_fixed_ ? std::vector<bool>{hierarchical_allgather_}
                     : std::vector<bool>{false, true};
  std::vector<bool> hrs_opts =
      (hier_rs_fixed_ || !profile_reduce_scatter_)
          ? std::vector<bool>{hierarchical_reduce_scatter_}
          : std::vector<bool>{false, true};
  // The shm dimension only opens on an shm-capable topology (profile
  // bit): on a flat single-rank-per-host job every sample would score
  // an identical configuration.
  std::vector<bool> shm_opts =
      (shm_fixed_ || !profile_shm_) ? std::vector<bool>{shm_transport_}
                                    : std::vector<bool>{true, false};
  for (bool c : cache_opts) {
    for (bool ar : har_opts) {
      for (bool ag : hag_opts) {
        for (bool rs : hrs_opts) {
          for (bool sm : shm_opts) {
            categorical_combos_.push_back({c, ar, ag, rs, sm});
          }
        }
      }
    }
  }
  // Budget-aware combo depth: every combo gets at least two samples,
  // and the sample budget grows to cover the whole sweep when the
  // categorical space is large (16 combos on a hierarchical sharded
  // job) — a silently unvisited tail would make those configurations
  // unadoptable.
  int combos = static_cast<int>(categorical_combos_.size());
  samples_per_combo_ = std::max(2, max_samples_ / combos);
  max_samples_ = std::max(max_samples_, combos * samples_per_combo_);
  double chunk_lo = profile_compression_ ? kChunkLoKbCompressed : kChunkLoKb;
  double chunk_hi = profile_compression_ ? kChunkHiKbCompressed : kChunkHiKb;
  optimizers_.clear();
  for (std::size_t i = 0; i < categorical_combos_.size(); ++i) {
    // Seeds are salted by (elastic generation, re-arm epoch): every
    // tuning pass explores FRESH sample points for its regime instead
    // of re-walking the previous pass's trajectory — while staying
    // deterministic across ranks (both salts are synchronized state),
    // so the bootstrap's first sample is identical everywhere.
    optimizers_.push_back(std::make_unique<BayesianOptimizer>(
        std::vector<std::pair<double, double>>{{kFusionLo, kFusionHi},
                                               {kCycleLo, kCycleHi},
                                               {chunk_lo, chunk_hi}},
        /*seed=*/1234 + i + 1000003ull * seed_salt_ +
            7919ull * rearm_epoch_));
  }
}

// lockorder: requires(mu_)
void ParameterManager::Arm() {
  armed_once_ = true;
  active_ = true;
  warmup_remaining_ = warmup_samples_;
  cycles_in_sample_ = 0;
  bytes_in_sample_ = 0;
  sample_count_ = 0;
  combo_index_ = 0;
  samples_in_combo_ = 0;
  best_score_ = 0.0;
  baseline_pending_ = false;
  drift_bytes_acc_ = 0;
  drift_tensors_acc_ = 0;
  drift_cycles_acc_ = 0;
  BuildSearchSpace();
  ReadyTune();
}

void ParameterManager::SetAutoTuning(bool active) {
  std::lock_guard<std::mutex> lk(mu_);
  if (active) {
    Arm();
  } else {
    active_ = false;
  }
}

bool ParameterManager::IsAutoTuning() const {
  std::lock_guard<std::mutex> lk(mu_);
  return active_;
}

int64_t ParameterManager::TensorFusionThresholdBytes() const {
  std::lock_guard<std::mutex> lk(mu_);
  return static_cast<int64_t>(fusion_mb_ * 1024.0 * 1024.0);
}

void ParameterManager::SetTensorFusionThresholdBytes(int64_t threshold,
                                                     bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  fusion_mb_ = static_cast<double>(threshold) / (1024.0 * 1024.0);
  fusion_fixed_ = fusion_fixed_ || fixed;
}

double ParameterManager::CycleTimeMs() const {
  std::lock_guard<std::mutex> lk(mu_);
  return cycle_time_ms_;
}

void ParameterManager::SetCycleTimeMs(double cycle_time_ms, bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  cycle_time_ms_ = cycle_time_ms;
  cycle_fixed_ = cycle_fixed_ || fixed;
}

bool ParameterManager::CacheEnabled() const {
  std::lock_guard<std::mutex> lk(mu_);
  return cache_enabled_;
}

void ParameterManager::SetCacheEnabled(bool enabled, bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  cache_enabled_ = enabled;
  cache_fixed_ = cache_fixed_ || fixed;
}

bool ParameterManager::HierarchicalAllreduce() const {
  std::lock_guard<std::mutex> lk(mu_);
  return hierarchical_allreduce_;
}

void ParameterManager::SetHierarchicalAllreduce(bool enabled, bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  hierarchical_allreduce_ = enabled;
  hier_ar_fixed_ = hier_ar_fixed_ || fixed;
}

bool ParameterManager::HierarchicalAllgather() const {
  std::lock_guard<std::mutex> lk(mu_);
  return hierarchical_allgather_;
}

void ParameterManager::SetHierarchicalAllgather(bool enabled, bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  hierarchical_allgather_ = enabled;
  hier_ag_fixed_ = hier_ag_fixed_ || fixed;
}

bool ParameterManager::HierarchicalReduceScatter() const {
  std::lock_guard<std::mutex> lk(mu_);
  return hierarchical_reduce_scatter_;
}

void ParameterManager::SetHierarchicalReduceScatter(bool enabled, bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  hierarchical_reduce_scatter_ = enabled;
  hier_rs_fixed_ = hier_rs_fixed_ || fixed;
}

bool ParameterManager::ShmTransport() const {
  std::lock_guard<std::mutex> lk(mu_);
  return shm_transport_;
}

void ParameterManager::SetShmTransport(bool enabled, bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  shm_transport_ = enabled;
  shm_fixed_ = shm_fixed_ || fixed;
}

int64_t ParameterManager::PipelineChunkBytes() const {
  std::lock_guard<std::mutex> lk(mu_);
  if (pipeline_chunk_kb_ <= 0.0) return 0;
  return static_cast<int64_t>(pipeline_chunk_kb_ * 1024.0);
}

void ParameterManager::SetPipelineChunkBytes(int64_t bytes, bool fixed) {
  std::lock_guard<std::mutex> lk(mu_);
  pipeline_chunk_kb_ = static_cast<double>(bytes) / 1024.0;
  pipeline_fixed_ = pipeline_fixed_ || fixed;
}

void ParameterManager::ObserveWorkload(bool compression_active,
                                       bool reduce_scatter_active,
                                       bool groups_active,
                                       bool shm_capable) {
  std::lock_guard<std::mutex> lk(mu_);
  // Sticky: once a capability is seen the search space stays shaped for
  // it (a job that did one sharded step will do more; a job that did
  // one subgroup collective is running a mesh).
  bool comp_changed = compression_active && !profile_compression_;
  bool rs_changed = reduce_scatter_active && !profile_reduce_scatter_;
  bool grp_changed = groups_active && !profile_groups_;
  bool shm_changed = shm_capable && !profile_shm_;
  if (!comp_changed && !rs_changed && !grp_changed && !shm_changed) return;
  profile_compression_ = profile_compression_ || compression_active;
  profile_reduce_scatter_ = profile_reduce_scatter_ || reduce_scatter_active;
  profile_groups_ = profile_groups_ || groups_active;
  profile_shm_ = profile_shm_ || shm_capable;
  TriggerRearm(rs_changed ? "profile-reduce-scatter"
                          : (comp_changed ? "profile-compression"
                                          : (grp_changed ? "profile-groups"
                                                         : "profile-shm")));
}

// lockorder: requires(mu_)
bool ParameterManager::TriggerRearm(const char* reason) {
  // Caller holds mu_. Re-arm subsumes any in-flight tuning pass: the
  // measurement regime just changed, so its samples are stale. Before
  // the first Arm() (the env-seeding window at init) there is nothing
  // to re-enter — the seed shapes the initial search space instead.
  if (rearm_pending_ || !armed_once_) return false;
  rearm_pending_ = true;
  last_rearm_reason_ = reason;
  LOG(INFO) << "autotune re-arm pending (" << reason << ")";
  return true;
}

bool ParameterManager::RearmPending() const {
  std::lock_guard<std::mutex> lk(mu_);
  return rearm_pending_;
}

uint64_t ParameterManager::WireEpochForBroadcast() {
  std::lock_guard<std::mutex> lk(mu_);
  if (rearm_pending_) {
    rearm_pending_ = false;
    ++rearm_epoch_;
    ++rearms_total_;
    LOG(INFO) << "autotune re-armed (epoch " << rearm_epoch_ << ", "
              << last_rearm_reason_ << ")";
    LogSample(0.0, last_rearm_reason_.empty() ? "rearm"
                                              : last_rearm_reason_.c_str());
    Arm();
  }
  uint64_t profile = (profile_compression_ ? kProfileCompression : 0) |
                     (profile_reduce_scatter_ ? kProfileReduceScatter : 0) |
                     (profile_groups_ ? kProfileGroups : 0) |
                     (profile_shm_ ? kProfileShm : 0);
  return (static_cast<uint64_t>(rearm_epoch_) << 8) | profile;
}

void ParameterManager::NoteWireEpoch(uint64_t wire) {
  std::lock_guard<std::mutex> lk(mu_);
  uint32_t epoch = static_cast<uint32_t>(wire >> 8);
  if (epoch == rearm_epoch_) return;
  rearm_epoch_ = epoch;
  ++rearms_total_;
  profile_compression_ = (wire & kProfileCompression) != 0;
  profile_reduce_scatter_ = (wire & kProfileReduceScatter) != 0;
  profile_groups_ = (wire & kProfileGroups) != 0;
  profile_shm_ = (wire & kProfileShm) != 0;
  // Deterministic mirror of the coordinator's Arm(): fresh optimizers
  // with fixed seeds propose the same first sample, so every rank holds
  // identical knob values from this cycle on.
  Arm();
}

uint32_t ParameterManager::rearm_epoch() const {
  std::lock_guard<std::mutex> lk(mu_);
  return rearm_epoch_;
}

uint64_t ParameterManager::rearms_total() const {
  std::lock_guard<std::mutex> lk(mu_);
  return rearms_total_;
}

// lockorder: requires(mu_)
void ParameterManager::ReadyTune() {
  // Apply the next sample point of the current categorical combo.
  if (combo_index_ >= categorical_combos_.size()) return;
  const auto& combo = categorical_combos_[combo_index_];
  if (!cache_fixed_) cache_enabled_ = combo[0];
  if (!hier_ar_fixed_) hierarchical_allreduce_ = combo[1];
  if (!hier_ag_fixed_) hierarchical_allgather_ = combo[2];
  if (!hier_rs_fixed_ && profile_reduce_scatter_) {
    hierarchical_reduce_scatter_ = combo[3];
  }
  if (!shm_fixed_ && profile_shm_) shm_transport_ = combo[4];
  auto next = optimizers_[combo_index_]->NextSample();
  if (!fusion_fixed_) fusion_mb_ = next[0];
  if (!cycle_fixed_) cycle_time_ms_ = next[1];
  if (!pipeline_fixed_) pipeline_chunk_kb_ = next[2];
}

// lockorder: requires(mu_)
void ParameterManager::LogSample(double score, const char* event) {
  if (!log_.is_open()) return;
  log_ << fusion_mb_ << "," << cycle_time_ms_ << "," << pipeline_chunk_kb_
       << "," << cache_enabled_ << "," << hierarchical_allreduce_ << ","
       << hierarchical_allgather_ << "," << hierarchical_reduce_scatter_
       << "," << shm_transport_ << "," << score << "," << event << "\n";
  log_.flush();
}

bool ParameterManager::Update(int64_t tensors, int64_t bytes) {
  std::lock_guard<std::mutex> lk(mu_);
  if (!active_) {
    // Closed-loop drift watch. Idle heartbeat cycles carry no workload
    // signal and are excluded. The FIRST window after convergence only
    // CAPTURES the baseline: per-cycle bytes depend on the knobs in
    // force (a 100ms probe cycle batches far more than a 1ms one for a
    // free-running producer), so a baseline averaged over the tuning
    // pass's heterogeneous samples would misread a steady workload as
    // drifted and re-arm forever. Measuring it under the ADOPTED knobs
    // makes the comparison knobs-consistent.
    if (tensors <= 0 && bytes <= 0) return false;
    drift_bytes_acc_ += bytes;
    drift_tensors_acc_ += tensors;
    if (++drift_cycles_acc_ < drift_window_cycles_) return false;
    double mean_bytes =
        static_cast<double>(drift_bytes_acc_) / drift_cycles_acc_;
    double mean_tensors =
        static_cast<double>(drift_tensors_acc_) / drift_cycles_acc_;
    drift_bytes_acc_ = 0;
    drift_tensors_acc_ = 0;
    drift_cycles_acc_ = 0;
    if (baseline_pending_) {
      baseline_bytes_per_cycle_ = mean_bytes;
      baseline_tensors_per_cycle_ = mean_tensors;
      baseline_pending_ = false;
      return false;
    }
    auto drifted = [&](double cur, double base) {
      if (base <= 0.0) return cur > 0.0;
      double ratio = cur / base;
      return ratio > drift_threshold_ || ratio < 1.0 / drift_threshold_;
    };
    if (drifted(mean_bytes, baseline_bytes_per_cycle_) ||
        drifted(mean_tensors, baseline_tensors_per_cycle_)) {
      TriggerRearm("workload-shift");
    }
    return false;
  }
  // Sampling only advances on work cycles: an always-on tuner paced by
  // idle heartbeats would churn knobs under a job that has not even
  // started training yet.
  if (tensors <= 0 && bytes <= 0) return false;
  if (cycles_in_sample_ == 0 && bytes_in_sample_ == 0) {
    sample_start_us_ = NowMicros();
  }
  bytes_in_sample_ += bytes;
  ++cycles_in_sample_;
  if (cycles_in_sample_ < cycles_per_sample_) return false;

  double elapsed_us = NowMicros() - sample_start_us_;
  double score = elapsed_us > 0
                     ? static_cast<double>(bytes_in_sample_) / elapsed_us
                     : 0.0;
  cycles_in_sample_ = 0;
  bytes_in_sample_ = 0;

  if (warmup_remaining_ > 0) {
    --warmup_remaining_;
    return false;
  }
  return Tune(score);
}

// lockorder: requires(mu_)
bool ParameterManager::Tune(double score) {
  LogSample(score, "sample");
  if (score > best_score_) {
    best_score_ = score;
    best_fusion_mb_ = fusion_mb_;
    best_cycle_ms_ = cycle_time_ms_;
    best_pipeline_kb_ = pipeline_chunk_kb_;
    best_cache_ = cache_enabled_;
    best_hier_ar_ = hierarchical_allreduce_;
    best_hier_ag_ = hierarchical_allgather_;
    best_hier_rs_ = hierarchical_reduce_scatter_;
    best_shm_ = shm_transport_;
  }
  optimizers_[combo_index_]->AddSample(
      {fusion_mb_, cycle_time_ms_, pipeline_chunk_kb_}, score);
  ++sample_count_;
  ++samples_in_combo_;
  if (samples_in_combo_ >= samples_per_combo_) {
    samples_in_combo_ = 0;
    ++combo_index_;
  }
  if (sample_count_ >= max_samples_ ||
      combo_index_ >= categorical_combos_.size()) {
    // Converged: adopt the best configuration, capture the workload
    // baseline the drift watch compares against, and stop tuning (the
    // drift watch / profile observer re-arms when the job changes).
    if (!fusion_fixed_) fusion_mb_ = best_fusion_mb_;
    if (!cycle_fixed_) cycle_time_ms_ = best_cycle_ms_;
    if (!pipeline_fixed_) pipeline_chunk_kb_ = best_pipeline_kb_;
    if (!cache_fixed_) cache_enabled_ = best_cache_;
    if (!hier_ar_fixed_) hierarchical_allreduce_ = best_hier_ar_;
    if (!hier_ag_fixed_) hierarchical_allgather_ = best_hier_ag_;
    if (!hier_rs_fixed_ && profile_reduce_scatter_) {
      hierarchical_reduce_scatter_ = best_hier_rs_;
    }
    if (!shm_fixed_ && profile_shm_) shm_transport_ = best_shm_;
    // The drift baseline is captured by the FIRST converged window
    // (see Update), under the knobs just adopted.
    baseline_pending_ = true;
    baseline_bytes_per_cycle_ = 0.0;
    baseline_tensors_per_cycle_ = 0.0;
    drift_bytes_acc_ = 0;
    drift_tensors_acc_ = 0;
    drift_cycles_acc_ = 0;
    active_ = false;
    LogSample(best_score_, "converged");
    LOG(INFO) << "autotune converged: fusion_mb=" << fusion_mb_
              << " cycle_ms=" << cycle_time_ms_
              << " pipeline_kb=" << pipeline_chunk_kb_
              << " cache=" << cache_enabled_
              << " hier_rs=" << hierarchical_reduce_scatter_
              << " shm=" << shm_transport_
              << " score=" << best_score_ << " bytes/us";
    return true;
  }
  ReadyTune();
  return true;
}

// lockorder: requires(mu_)
ParameterManager::Params ParameterManager::GetParamsLocked() const {
  Params p;
  p.fusion_mb = fusion_mb_;
  p.cycle_time_ms = cycle_time_ms_;
  p.pipeline_chunk_kb = pipeline_chunk_kb_;
  p.cache_enabled = cache_enabled_ ? 1 : 0;
  p.hierarchical_allreduce = hierarchical_allreduce_ ? 1 : 0;
  p.hierarchical_allgather = hierarchical_allgather_ ? 1 : 0;
  p.hierarchical_reduce_scatter = hierarchical_reduce_scatter_ ? 1 : 0;
  p.shm_transport = shm_transport_ ? 1 : 0;
  p.active = active_ ? 1 : 0;
  return p;
}

ParameterManager::Params ParameterManager::GetParams() const {
  std::lock_guard<std::mutex> lk(mu_);
  return GetParamsLocked();
}

void ParameterManager::SetParams(const Params& p) {
  std::lock_guard<std::mutex> lk(mu_);
  fusion_mb_ = p.fusion_mb;
  cycle_time_ms_ = p.cycle_time_ms;
  pipeline_chunk_kb_ = p.pipeline_chunk_kb;
  cache_enabled_ = p.cache_enabled != 0;
  hierarchical_allreduce_ = p.hierarchical_allreduce != 0;
  hierarchical_allgather_ = p.hierarchical_allgather != 0;
  hierarchical_reduce_scatter_ = p.hierarchical_reduce_scatter != 0;
  // Workers honor their own env pin: a rank launched with HVD_TPU_SHM=0
  // never negotiated segments, and adopting "on" from the coordinator
  // must not make its PEERS (who did negotiate with other ranks) expect
  // a transport this rank can't speak — fixed knobs are pinned on every
  // rank identically when env is job-wide, which SetShmTransport's
  // fixed flag enforces here.
  if (!shm_fixed_) shm_transport_ = p.shm_transport != 0;
  active_ = p.active != 0;
}

std::string ParameterManager::Json() const {
  std::lock_guard<std::mutex> lk(mu_);
  char buf[1024];
  std::snprintf(
      buf, sizeof(buf),
      "{\"active\":%s,\"rearm_epoch\":%u,\"rearms_total\":%llu,"
      "\"samples\":%d,\"best_score_bytes_per_us\":%.6g,"
      "\"last_rearm_reason\":\"%s\","
      "\"params\":{\"fusion_mb\":%.17g,\"cycle_time_ms\":%.17g,"
      "\"pipeline_chunk_kb\":%.17g,\"cache_enabled\":%s,"
      "\"hierarchical_allreduce\":%s,\"hierarchical_allgather\":%s,"
      "\"hierarchical_reduce_scatter\":%s,\"shm_transport\":%s},"
      "\"fixed\":{\"fusion\":%s,\"cycle\":%s,\"pipeline_chunk\":%s,"
      "\"cache\":%s,\"hierarchical_allreduce\":%s,"
      "\"hierarchical_allgather\":%s,\"hierarchical_reduce_scatter\":%s,"
      "\"shm_transport\":%s},"
      "\"profile\":{\"compression\":%s,\"reduce_scatter\":%s,"
      "\"groups\":%s,\"shm\":%s},"
      "\"baseline\":{\"bytes_per_cycle\":%.6g,\"tensors_per_cycle\":%.6g}}",
      active_ ? "true" : "false", rearm_epoch_,
      static_cast<unsigned long long>(rearms_total_), sample_count_,
      best_score_, last_rearm_reason_.c_str(), fusion_mb_, cycle_time_ms_,
      pipeline_chunk_kb_, cache_enabled_ ? "true" : "false",
      hierarchical_allreduce_ ? "true" : "false",
      hierarchical_allgather_ ? "true" : "false",
      hierarchical_reduce_scatter_ ? "true" : "false",
      shm_transport_ ? "true" : "false",
      fusion_fixed_ ? "true" : "false", cycle_fixed_ ? "true" : "false",
      pipeline_fixed_ ? "true" : "false", cache_fixed_ ? "true" : "false",
      hier_ar_fixed_ ? "true" : "false", hier_ag_fixed_ ? "true" : "false",
      hier_rs_fixed_ ? "true" : "false", shm_fixed_ ? "true" : "false",
      profile_compression_ ? "true" : "false",
      profile_reduce_scatter_ ? "true" : "false",
      profile_groups_ ? "true" : "false",
      profile_shm_ ? "true" : "false", baseline_bytes_per_cycle_,
      baseline_tensors_per_cycle_);
  return buf;
}

}  // namespace hvdtpu
