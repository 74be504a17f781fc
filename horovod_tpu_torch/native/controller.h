// Coordinator/worker negotiation protocol.
//
// The protocol (capability parity with /root/reference
// horovod/common/controller.{h,cc}, documented there at controller.h:62-97):
// every cycle, all ranks synchronously:
//   a) check queued requests against the response cache and agree on globally
//      cached-and-ready tensors with one bitwise-AND bit-vector allreduce;
//   b) if everything queued was cached everywhere, execute straight from the
//      cache (fast path — no coordinator round trip);
//   c) otherwise workers send their ready-tensor RequestLists to rank 0,
//      which counts readiness per tensor name; when a tensor has been
//      announced by all ranks it is ready;
//   d) rank 0 validates (shape/dtype/op/root-rank consistency), fuses small
//      responses up to the fusion threshold, and broadcasts the final
//      ResponseList; every rank executes the same responses in order.
//
// Subclasses provide the rank-discovery and the four cross-rank primitives
// (gather / broadcast / bitwise AND / bitwise OR). TcpController implements
// them over the host network; a single-process build short-circuits.
#ifndef HVD_TPU_CONTROLLER_H
#define HVD_TPU_CONTROLLER_H

#include <atomic>
#include <chrono>
#include <cstdint>
#include <deque>
#include <memory>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

#include "divergence.h"
#include "group_table.h"
#include "message.h"
#include "response_cache.h"
#include "stall_inspector.h"
#include "tensor_queue.h"
#include "timeline.h"

namespace hvdtpu {

class ParameterManager;

// Thrown by transport-backed controllers when a cross-rank primitive fails
// mid-protocol (peer EOF / reset). The background loop catches it and fails
// outstanding handles with a RECOVERABLE connection-lost status — the
// process survives and can re-initialize for a new generation (elastic
// membership change), instead of aborting the whole job.
class ConnectionLostError : public std::runtime_error {
 public:
  explicit ConnectionLostError(const std::string& what)
      : std::runtime_error(what) {}
};

class Controller {
 public:
  Controller(ResponseCache& response_cache, TensorQueue& tensor_queue,
             Timeline& timeline, ParameterManager& parameter_manager);
  virtual ~Controller() = default;

  // Rank discovery / communicator construction.
  virtual void Initialize() = 0;

  virtual int rank() const { return rank_; }
  virtual int local_rank() const { return local_rank_; }
  virtual int cross_rank() const { return cross_rank_; }
  virtual int size() const { return size_; }
  virtual int local_size() const { return local_size_; }
  virtual int cross_size() const { return cross_size_; }
  bool is_coordinator() const { return rank_ == 0; }
  bool is_homogeneous() const { return is_homogeneous_; }
  const std::vector<int>& local_sizes() const { return local_sizes_; }

  // The per-cycle negotiation. Returns the agreed list of operations to
  // perform this cycle (identical on every rank, in identical order).
  ResponseList ComputeResponseList(bool this_process_requested_shutdown);

  // Fusion threshold rounded so fused allreduce buffers divide evenly across
  // local ranks (needed by hierarchical ops).
  int64_t TensorFusionThresholdBytes() const;

  // Broadcasts autotuned parameters from rank 0 (wraps Bcast).
  void SynchronizeParameters();

  StallInspector& stall_inspector() { return stall_inspector_; }

  // Coordinator: the pending-negotiation table as JSON — every tensor
  // still waiting on announcements, which ranks reported it and which
  // are missing (group members for group tensors, world otherwise).
  // The flight recorder embeds it in post-mortem bundles (trace.h) so a
  // bundle names the missing rank and the in-flight tensors. "{}" off
  // the coordinator.
  std::string PendingNegotiationJson() const;

  // --- divergence cross-check (divergence.h) ---
  // The process-wide call tracker feeds each cycle's RequestList with this
  // rank's (seq, digest, recent calls); on the coordinator the detector
  // cross-checks them against the pending table and fails provably
  // diverged tensors with ERROR responses naming the offending call site.
  void SetCallTracker(CallTracker* tracker) { call_tracker_ = tracker; }

  // --- process groups (group_table.h / docs/GROUPS.md) ---
  // The registry the coordinator validates group requests against:
  // readiness counts are sized to the GROUP (a tensor is ready when all
  // MEMBERS announced, regardless of the other ranks), membership
  // digests are cross-checked, and non-member announcements are
  // rejected by name.
  void SetGroupTable(const GroupTable* table) { group_table_ = table; }
  // Call after Initialize() (needs size_). progress_calls==0 and
  // grace_seconds<=0 disable the respective rules.
  void ConfigureDivergence(int64_t progress_calls, double grace_seconds) {
    divergence_.Configure(size_, progress_calls, grace_seconds);
  }

  // --- metrics plane (metrics.h) ---
  // When enabled, workers attach their compact counter summary to the
  // RequestList at most once per `sync_seconds`, and the coordinator
  // forces a full negotiation cycle on the same cadence so summaries
  // keep flowing through all-cached steady state and total quiescence
  // (the exact windows where live metrics matter most).
  void ConfigureMetrics(bool enabled, double sync_seconds) {
    metrics_plane_enabled_ = enabled;
    metrics_sync_seconds_ = sync_seconds;
  }

  // --- negotiation-cycle accounting (fast path vs full round trip) ---
  // fast  = all-cached cycles that produced work from the bit-vector
  //         sync alone (no coordinator round trip);
  // full  = FinishCycle round trips (request gather + response bcast).
  uint64_t cycles_fast() const { return cycles_fast_.load(); }
  uint64_t cycles_full() const { return cycles_full_.load(); }
  void ResetCycleCounters() {
    cycles_fast_.store(0);
    cycles_full_.store(0);
  }

  // --- cross-rank primitives, implemented per transport ---
  // Gathers every rank's serialized blob at rank 0 (out: indexed by rank).
  virtual void GatherBlobs(const std::string& mine,
                           std::vector<std::string>* all) = 0;
  // Rank 0 sends `blob` to everyone; other ranks receive into `blob`.
  virtual void BroadcastBlob(std::string* blob) = 0;
  virtual void CrossRankBitwiseAnd(std::vector<uint64_t>& bits) = 0;
  virtual void CrossRankBitwiseOr(std::vector<uint64_t>& bits) = 0;
  virtual void Barrier() = 0;

 protected:
  // Coordinator: record that `rank` reported readiness of msg's tensor.
  // Returns true when all of the tensor's GROUP members have reported it
  // (all world ranks for group 0) — or immediately when the report is
  // provably bad (unknown group / non-member / membership-digest
  // mismatch), so ConstructResponse can reject it by name instead of
  // letting the count hang forever.
  bool IncrementTensorCount(const Request& msg, int rank);

  // Coordinator: build the validated Response for a fully-ready tensor,
  // checking cross-rank consistency of shape/dtype/op/root rank and
  // group membership. `key` is the pending-table key
  // (GroupQualifiedName); the response carries the bare tensor name.
  Response ConstructResponse(const std::string& key);

  // Coordinator: fuse eligible same-type/dtype responses under the threshold.
  void FuseResponses(std::deque<Response>& responses, ResponseList& out);

  // The negotiation round-trip (request gather -> validate/fuse -> response
  // broadcast). `responses` seeds the list with globally-cached responses.
  ResponseList FinishCycle(std::deque<Response> responses,
                           std::vector<Request>& non_cached_messages,
                           bool should_shut_down);

  int rank_ = 0;
  int local_rank_ = 0;
  int cross_rank_ = 0;
  int size_ = 1;
  int local_size_ = 1;
  int cross_size_ = 1;
  bool is_homogeneous_ = true;
  std::vector<int> local_sizes_;

  // Coordinator-side table: GroupQualifiedName(group, tensor name) ->
  // one Request per reported rank. The composite key keeps the same
  // tensor name active in two groups at once (the 2-D mesh's per-column
  // gradient reduce) as two independent negotiations.
  std::unordered_map<std::string, std::vector<Request>> message_table_;
  const GroupTable* group_table_ = nullptr;

  ResponseCache& response_cache_;
  TensorQueue& tensor_queue_;
  Timeline& timeline_;
  ParameterManager& parameter_manager_;
  StallInspector stall_inspector_;
  CallTracker* call_tracker_ = nullptr;
  DivergenceDetector divergence_;

  // Metrics plane: summary-attach / forced-sync pacing and the
  // coordinator's per-tensor first-announce clock (negotiation latency
  // histogram + per-rank announce lag — the straggler signal).
  bool metrics_plane_enabled_ = false;
  double metrics_sync_seconds_ = 1.0;
  std::chrono::steady_clock::time_point last_summary_attach_{};
  std::chrono::steady_clock::time_point last_metrics_force_{};
  std::unordered_map<std::string, std::chrono::steady_clock::time_point>
      negotiate_started_;
  // Highest tracker seq already shipped (worker) / self-observed
  // (coordinator); records above it ride the next RequestList.
  uint64_t reported_call_seq_ = 0;
  // Tracker snapshot taken at the TOP of ComputeResponseList, BEFORE the
  // message-queue pop. Ordering invariant for the progress rule: a call
  // enters the tracker only after its Request is queued, so every call
  // counted by this snapshot has its Request in this cycle's pop (or an
  // earlier one) — the reported seq can never run ahead of the shipped
  // requests, which is what made a mid-burst rank look "provably past"
  // a tensor it was still about to submit.
  uint64_t cycle_call_seq_ = 0;
  uint64_t cycle_call_digest_ = 0;

  std::atomic<uint64_t> cycles_fast_{0};
  std::atomic<uint64_t> cycles_full_{0};

  // Coordinator: ResponseList::kFlagDumpBundle et al, armed by a stall
  // escalation / divergence this cycle and shipped on the next
  // FinishCycle broadcast so every worker dumps a flight-recorder
  // bundle while the evidence is still in its ring (trace.h).
  uint8_t pending_trace_flags_ = 0;

  uint32_t cache_capacity_ = 1024;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_CONTROLLER_H
