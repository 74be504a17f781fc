// Always-on closed-loop autotuner for the runtime knobs that govern
// negotiation and data-plane efficiency:
//   - tensor fusion threshold (MB, continuous in [0, 64])
//   - cycle time (ms, continuous in [1, 100])
//   - pipelined-ring chunk size (KB, continuous; bounds shrink when wire
//     compression is active — the wire payload per element shrinks, so
//     smaller slices saturate the socket)
//   - response cache enabled (categorical)
//   - hierarchical allreduce / allgather / reduce-scatter (categorical;
//     collapsed on flat topologies, and the reduce-scatter knob only
//     opens once the job actually executes reduce-scatters)
// Joint search: for each categorical combination, Bayesian optimization
// (Gaussian process + expected improvement) over the continuous knobs.
// Score = bytes processed per microsecond over a sampling window; warmup
// discards the first samples. Best parameters are broadcast from rank 0
// via Controller::SynchronizeParameters.
//
// Closed loop (docs/AUTOTUNE.md): after convergence the manager keeps
// watching the per-cycle bytes/tensors distributions; when the workload
// drifts past HVD_TPU_AUTOTUNE_DRIFT of the converged baseline (or the
// job's capability profile changes — compression engages, reduce-scatter
// appears), it RE-ARMS. The re-arm is bootstrapped through the
// ResponseList wire (a (epoch, profile) tail on the next full-cycle
// broadcast) so every rank re-enters tuning at the same cycle; elastic
// re-initialization re-arms naturally because tuning defaults on.
//
// Concurrency: all tuning decisions happen on the background
// coordination thread. A single mutex makes the knob reads/writes safe
// against the C snapshot API (horovod_tpu_autotune_json), which any
// thread may call at any time.
//
// Capability parity with /root/reference
// horovod/common/parameter_manager.{h,cc} + optim/bayesian_optimization.cc;
// fresh implementation with hand-rolled small-matrix GP math (no Eigen).
#ifndef HVD_TPU_PARAMETER_MANAGER_H
#define HVD_TPU_PARAMETER_MANAGER_H

#include <array>
#include <cstdint>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace hvdtpu {

class BayesianOptimizer;

class ParameterManager {
 public:
  ParameterManager();
  ~ParameterManager();

  void Initialize(int32_t rank, const std::string& autotune_log_file);
  void SetAutoTuning(bool active);
  bool IsAutoTuning() const;

  int64_t TensorFusionThresholdBytes() const;
  void SetTensorFusionThresholdBytes(int64_t threshold, bool fixed = false);
  double CycleTimeMs() const;
  void SetCycleTimeMs(double cycle_time_ms, bool fixed = false);
  bool CacheEnabled() const;
  void SetCacheEnabled(bool enabled, bool fixed = false);
  bool HierarchicalAllreduce() const;
  void SetHierarchicalAllreduce(bool enabled, bool fixed = false);
  bool HierarchicalAllgather() const;
  void SetHierarchicalAllgather(bool enabled, bool fixed = false);
  bool HierarchicalReduceScatter() const;
  void SetHierarchicalReduceScatter(bool enabled, bool fixed = false);
  // Shared-memory transport for intra-host ring legs (docs/TRANSPORT.md):
  // categorical auto/on/off — HVD_TPU_SHM=0/1 pins it, unset leaves it
  // to the tuner (default on). Applied cycle-synchronized via
  // TcpContext::SetShmUse; the dimension only opens in the search space
  // when the topology is shm-capable (profile bit, like
  // reduce-scatter's).
  bool ShmTransport() const;
  void SetShmTransport(bool enabled, bool fixed = false);
  // Pipelined-ring segment size in bytes (0 = slicing disabled). The
  // data-plane ops read this per execution; the tuner searches it in KB.
  int64_t PipelineChunkBytes() const;
  void SetPipelineChunkBytes(int64_t bytes, bool fixed = false);

  // Capability profile of the running job, observed by the coordinator
  // from negotiated responses (and seeded from env before the first
  // cycle). A profile change after convergence triggers a re-arm so the
  // search space is rebuilt compression-, sharded-update-, and
  // group-aware (a first subgroup collective changes the traffic mix
  // the knobs were scored under — the tuner must re-score under it).
  void ObserveWorkload(bool compression_active, bool reduce_scatter_active,
                       bool groups_active = false,
                       bool shm_capable = false);

  // Called once per cycle on the coordinator with the tensors/bytes the
  // cycle executed. Advances sampling while tuning; tracks workload
  // drift while converged (re-arming past the threshold). Returns true
  // when tuned parameter values changed (caller re-syncs ranks).
  bool Update(int64_t tensors, int64_t bytes);

  // --- closed-loop re-arm protocol (controller.cc) ---
  // True while a re-arm awaits its wire bootstrap; the coordinator
  // forces full negotiation cycles until delivered.
  bool RearmPending() const;
  // Coordinator, at full-cycle serialize time: consume a pending re-arm
  // (bump epoch, rebuild the search space, apply the first sample).
  // Always returns the current wire word: (epoch << 8) | profile bits.
  uint64_t WireEpochForBroadcast();
  // Worker, at full-cycle parse time: adopt a changed wire word — apply
  // the profile and re-enter tuning at the same cycle the coordinator
  // did. The search-space rebuild and first sample are deterministic
  // (fixed seeds), so every rank lands on identical knob values.
  void NoteWireEpoch(uint64_t wire);

  uint32_t rearm_epoch() const;
  uint64_t rearms_total() const;

  // POD snapshot for cross-rank parameter broadcast.
  struct Params {
    double fusion_mb;
    double cycle_time_ms;
    double pipeline_chunk_kb;
    uint8_t cache_enabled;
    uint8_t hierarchical_allreduce;
    uint8_t hierarchical_allgather;
    uint8_t hierarchical_reduce_scatter;
    uint8_t shm_transport;
    uint8_t active;
  };
  Params GetParams() const;
  void SetParams(const Params& p);

  // Live tuner state as JSON (the horovod_tpu_autotune_json C export →
  // hvd.autotune()). Safe from any thread.
  std::string Json() const;

 private:
  bool Tune(double score);
  void ReadyTune();
  void LogSample(double score, const char* event);
  void BuildSearchSpace();  // combos + optimizers from profile/fixed flags
  void Arm();               // reset sampling state, BuildSearchSpace, ReadyTune
  Params GetParamsLocked() const;
  bool TriggerRearm(const char* reason);

  mutable std::mutex mu_;

  // Current values.
  double fusion_mb_ = 64.0;           // guarded_by(mu_)
  double cycle_time_ms_ = 5.0;        // guarded_by(mu_)
  double pipeline_chunk_kb_ = 1024.0; // guarded_by(mu_)
  bool cache_enabled_ = true;
  bool hierarchical_allreduce_ = false;
  bool hierarchical_allgather_ = false;
  bool hierarchical_reduce_scatter_ = false;
  bool shm_transport_ = true;

  // Fixed-by-env flags exclude a knob from tuning.
  bool fusion_fixed_ = false;
  bool cycle_fixed_ = false;
  bool pipeline_fixed_ = false;
  bool cache_fixed_ = false;
  bool hier_ar_fixed_ = false;
  bool hier_ag_fixed_ = false;
  bool hier_rs_fixed_ = false;
  bool shm_fixed_ = false;

  // Workload profile (search-space shaping + re-arm trigger).
  bool profile_compression_ = false;
  bool profile_reduce_scatter_ = false;
  bool profile_groups_ = false;
  bool profile_shm_ = false;

  bool active_ = false;
  int32_t rank_ = -1;
  uint64_t seed_salt_ = 0;  // elastic generation, set at Initialize
  int warmup_remaining_ = 3;
  int cycles_in_sample_ = 0;
  int64_t bytes_in_sample_ = 0;
  double sample_start_us_ = 0.0;
  int sample_count_ = 0;
  // Sampling pace (env-overridable for tests/bench: see Initialize).
  int cycles_per_sample_ = 10;
  int max_samples_ = 40;
  int warmup_samples_ = 3;

  // Best seen (this arm).
  double best_score_ = 0.0;
  double best_fusion_mb_ = 64.0;
  double best_cycle_ms_ = 5.0;
  double best_pipeline_kb_ = 1024.0;
  bool best_cache_ = true;
  bool best_hier_ar_ = false;
  bool best_hier_ag_ = false;
  bool best_hier_rs_ = false;
  bool best_shm_ = true;

  // Categorical sweep state: index into combos; each combo gets its own
  // BO over the continuous knobs (cache, hier_ar, hier_ag, hier_rs,
  // shm_transport).
  std::vector<std::array<bool, 5>> categorical_combos_;
  std::size_t combo_index_ = 0;
  int samples_in_combo_ = 0;
  int samples_per_combo_ = 10;

  // --- closed loop ---
  // Converged-workload baseline (work cycles only) + rolling window.
  double baseline_bytes_per_cycle_ = 0.0;
  double baseline_tensors_per_cycle_ = 0.0;
  // First post-convergence window captures the baseline (knobs-
  // consistent measurement) instead of checking drift against it.
  bool baseline_pending_ = false;
  int64_t drift_bytes_acc_ = 0;
  int64_t drift_tensors_acc_ = 0;
  int drift_cycles_acc_ = 0;
  int drift_window_cycles_ = 40;
  double drift_threshold_ = 2.0;  // re-arm past x2 / below 1/x2
  bool rearm_pending_ = false;
  bool armed_once_ = false;
  uint32_t rearm_epoch_ = 0;
  uint64_t rearms_total_ = 0;
  std::string last_rearm_reason_;

  std::vector<std::unique_ptr<BayesianOptimizer>> optimizers_;
  std::ofstream log_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_PARAMETER_MANAGER_H
