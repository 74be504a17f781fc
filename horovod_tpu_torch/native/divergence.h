// Runtime divergence detection — the dynamic complement of hvd-lint.
//
// The stall inspector is time-based and reactive: it can say "tensor X is
// waiting on rank 1" only after a long timeout, and never *which call site*
// rank 1 took instead. This module makes divergence a first-class protocol
// signal:
//
// * CallTracker (every rank): folds the process's collective call sequence
//   (op, dtype, shape-rank, name) into a monotonically increasing seq, a
//   rolling FNV-1a digest, and a bounded ring of recent call descriptors.
//   The seq/digest ride each worker RequestList (and are exposed to Python
//   via horovod_tpu_call_digest for hvd.jax.assert_synchronized).
//
// * DivergenceDetector (coordinator): cross-checks the per-rank streams
//   against the pending negotiation table and proves divergence two ways —
//     progress rule: a rank missing from a pending tensor has submitted
//       >= `progress_calls` other collectives since the tensor was first
//       announced (it is demonstrably past that call site);
//     cross-stall rule: a pending tensor has aged past `grace_seconds`
//       and every missing rank is itself waiting on a *different* aged
//       tensor (mutual wait on diverged call sites).
//   A proven divergence fails the tensor with an ERROR response naming the
//   diverging call sites, instead of hanging until the stall timeout.
#ifndef HVD_TPU_DIVERGENCE_H
#define HVD_TPU_DIVERGENCE_H

#include <chrono>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "group_table.h"
#include "message.h"

namespace hvdtpu {

class CallTracker {
 public:
  // Called from user threads on every enqueue (allreduce/allgather/
  // broadcast, any binding — everything funnels through EnqueueTensor).
  void Record(uint8_t op, uint8_t dtype, int ndim, const std::string& name);

  // Current (seq, digest) — the value Python's assert_synchronized
  // compares across ranks.
  void Snapshot(uint64_t* seq, uint64_t* digest) const;

  // Records with after_seq < seq <= up_to_seq, oldest first, capped at
  // `limit` most-recent entries (the ring itself holds kRingCapacity).
  // `up_to_seq` lets the controller ship exactly the calls covered by a
  // cycle-start snapshot, never ones recorded mid-cycle.
  std::vector<CallRecord> RecordsSince(uint64_t after_seq,
                                       std::size_t limit,
                                       uint64_t up_to_seq) const;

  // Generation reset (elastic re-init): every member restarts the
  // sequence so survivors and fresh workers agree again.
  void Reset();

  static constexpr std::size_t kRingCapacity = 256;

 private:
  mutable std::mutex mutex_;
  uint64_t seq_ = 0;     // guarded_by(mutex_)
  // FNV-1a offset basis
  uint64_t digest_ = 14695981039346656037ULL;  // guarded_by(mutex_)
  std::deque<CallRecord> ring_;                // guarded_by(mutex_)
};

class DivergenceDetector {
 public:
  struct Diagnosis {
    std::string key;          // pending-table key (GroupQualifiedName)
    std::string tensor_name;  // bare tensor name (entry lookup on ranks)
    uint32_t group_id = 0;
    std::string message;
  };

  // progress_calls == 0 disables the progress rule; grace_seconds <= 0
  // disables the cross-stall rule.
  void Configure(int world_size, int64_t progress_calls,
                 double grace_seconds);

  // Ingests one rank's (seq, digest, recent records) from its RequestList
  // (the coordinator feeds its own tracker state through here too).
  void Observe(int rank, uint64_t seq, uint64_t digest,
               const std::vector<CallRecord>& recent);

  // True when some pending tensor has aged enough that the coordinator
  // should force a full negotiation cycle (so quiescent, all-blocked
  // ranks still ship their seq/digest for cross-checking). Rate-limited
  // internally.
  bool ShouldForceFullCycle(
      const std::unordered_map<std::string, std::vector<Request>>& pending);

  // Cross-checks the pending table; returns proven divergences. The
  // caller (controller) erases the tensors and emits ERROR responses.
  // `groups` scopes the missing-rank set: a tensor pending in a process
  // group is only waited on by that group's MEMBERS, and its diagnosis
  // names the group — a rank-divergent collective inside one group must
  // never read as the whole world hanging.
  std::vector<Diagnosis> Check(
      const std::unordered_map<std::string, std::vector<Request>>& pending,
      const GroupTable* groups = nullptr);

  uint64_t last_seq(int rank) const {
    return rank < static_cast<int>(ranks_.size()) ? ranks_[rank].seq : 0;
  }

 private:
  using Clock = std::chrono::steady_clock;

  struct RankState {
    uint64_t seq = 0;
    uint64_t digest = 0;
    std::deque<CallRecord> log;  // merged recent records, bounded
  };

  struct PendingState {
    Clock::time_point first_seen;
    std::vector<uint64_t> seq_at_announce;  // per rank, at first sight
  };

  std::string DescribeRecentCalls(int rank, uint64_t after_seq,
                                  std::size_t max_shown) const;

  int world_size_ = 1;
  int64_t progress_calls_ = 0;
  double grace_seconds_ = 0.0;
  std::vector<RankState> ranks_;
  std::unordered_map<std::string, PendingState> pending_;
  Clock::time_point last_forced_{};
};

}  // namespace hvdtpu

#endif  // HVD_TPU_DIVERGENCE_H
