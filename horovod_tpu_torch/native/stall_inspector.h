// Coordinator-side distributed-straggler detector: records when each tensor
// was first requested and by which ranks; warns when a tensor has been
// waiting on missing ranks longer than the check interval, and optionally
// triggers a coordinated shutdown past the shutdown threshold.
//
// Capability parity with /root/reference horovod/common/stall_inspector.{h,cc}.
#ifndef HVD_TPU_STALL_INSPECTOR_H
#define HVD_TPU_STALL_INSPECTOR_H

#include <chrono>
#include <cstdint>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace hvdtpu {

class ResponseCache;

class StallInspector {
 public:
  void SetStallWarningTimeSeconds(int seconds) { warning_seconds_ = seconds; }
  void SetStallShutdownTimeSeconds(int seconds) { shutdown_seconds_ = seconds; }
  int stall_warning_time_seconds() const { return warning_seconds_; }
  int stall_shutdown_time_seconds() const { return shutdown_seconds_; }

  // Coordinator: a rank announced readiness for this tensor. `members`,
  // when non-null, scopes the tensor to a process group — only those
  // ranks are ever reported missing (docs/GROUPS.md).
  void RecordUncachedTensorStart(const std::string& tensor_name, int rank,
                                 int global_size,
                                 const std::vector<int>* members = nullptr);
  // Coordinator: tensor completed negotiation — forget it.
  void RemoveUncachedTensor(const std::string& tensor_name);

  // Worker-side accounting for cached tensors (they bypass the coordinator).
  void RecordCachedTensorStart(const std::string& tensor_name);
  void RemoveCachedTensor(const std::string& tensor_name);

  // Scans for stalls; logs warnings listing missing ranks. Returns true if
  // the shutdown threshold was crossed (caller propagates shutdown).
  bool CheckForStalledTensors(int global_size);
  // Invalidates cache entries for stalled cached tensors so they renegotiate;
  // fills `invalid_bits` for the cache coordinator.
  void InvalidateStalledCachedTensors(ResponseCache& cache,
                                      std::vector<uint32_t>& invalid_bits);

  bool ShouldPerformCheck();
  void UpdateCheckTime();

 private:
  using Clock = std::chrono::steady_clock;
  int warning_seconds_ = 60;
  int shutdown_seconds_ = 0;  // 0 = never shut down
  // name -> (first-request time, set of ready ranks, expected member
  // ranks — empty = every rank in 0..global_size)
  struct Uncached {
    Clock::time_point first;
    std::unordered_set<int> ready;
    std::vector<int> members;
  };
  std::unordered_map<std::string, Uncached> uncached_;
  std::unordered_map<std::string, Clock::time_point> cached_;
  Clock::time_point last_check_ = Clock::now();
  // Missing-rank sets already warned about, with repeat counts: identical
  // sets across consecutive checks log one compact line instead of the
  // full per-tensor listing (spam rate-limit; suppressed repeats still
  // count into the stall_warnings_total metric).
  std::unordered_map<std::string, uint64_t> warned_sets_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_STALL_INSPECTOR_H
