#include "controller.h"

#include <algorithm>
#include <cassert>
#include <cstdio>
#include <cstring>
#include <sstream>
#include <unordered_set>

#include "compression.h"
#include "logging.h"
#include "metrics.h"
#include "parameter_manager.h"
#include "trace.h"

namespace hvdtpu {

// Fused buffers are carved at 64-byte granularity so hierarchical ops can
// split them evenly across local ranks without misaligned segments.
static constexpr int64_t kFusionBufferAtomicUnit = 64;

Controller::Controller(ResponseCache& response_cache, TensorQueue& tensor_queue,
                       Timeline& timeline, ParameterManager& parameter_manager)
    : response_cache_(response_cache),
      tensor_queue_(tensor_queue),
      timeline_(timeline),
      parameter_manager_(parameter_manager) {}

int64_t Controller::TensorFusionThresholdBytes() const {
  int64_t proposed = parameter_manager_.TensorFusionThresholdBytes();
  if (proposed <= 0) return 0;
  // Round so a fused buffer splits into local_size_ aligned chunks.
  int64_t unit = kFusionBufferAtomicUnit * local_size_;
  if (parameter_manager_.HierarchicalAllreduce() && proposed % unit != 0) {
    proposed = std::max<int64_t>(unit, (proposed / unit) * unit);
  }
  return proposed;
}

void Controller::SynchronizeParameters() {
  ParameterManager::Params params;
  std::memset(&params, 0, sizeof(params));
  if (is_coordinator()) params = parameter_manager_.GetParams();
  std::string blob(reinterpret_cast<char*>(&params), sizeof(params));
  BroadcastBlob(&blob);
  if (!is_coordinator() && blob.size() == sizeof(params)) {
    std::memcpy(&params, blob.data(), sizeof(params));
    parameter_manager_.SetParams(params);
  }
}

bool Controller::IncrementTensorCount(const Request& msg, int rank) {
  // Pending-table key is group-qualified: the same tensor name active
  // in two groups at once is two independent negotiations.
  const std::string key =
      GroupQualifiedName(msg.group_id(), msg.tensor_name());
  auto it = message_table_.find(key);
  auto now = std::chrono::steady_clock::now();
  if (it == message_table_.end()) {
    timeline_.NegotiateStart(key, msg.request_type());
    it = message_table_.emplace(key, std::vector<Request>()).first;
    negotiate_started_[key] = now;
    if (metrics_plane_enabled_) GlobalMetrics().AddRankLag(rank, 0.0);
  } else if (metrics_plane_enabled_) {
    // Announce lag: how long this rank kept the tensor waiting after its
    // first announcement. Per-rank accumulation is the straggler signal
    // the job view surfaces (the slow rank's total dominates). Gated on
    // the plane: AddRankLag takes the registry's rank mutex (shared with
    // snapshot builds), which metrics-off jobs must never touch.
    auto started = negotiate_started_.find(key);
    if (started != negotiate_started_.end()) {
      GlobalMetrics().AddRankLag(
          rank, std::chrono::duration<double>(now - started->second).count());
    }
  }
  timeline_.NegotiateRankReady(key, rank);
  // Readiness threshold: ALL ranks for the world group, the MEMBER set
  // for a process group (the bitmap sized to the group). Provably-bad
  // group reports (unknown id / non-member announcer / membership-digest
  // mismatch) go ready IMMEDIATELY so ConstructResponse rejects them by
  // name instead of leaving the count stuck below threshold forever.
  int expected = size_;
  std::vector<int> members;
  bool poisoned = false;
  if (msg.group_id() != 0) {
    if (group_table_ == nullptr) {
      poisoned = true;  // no registry at all: can never resolve
    } else {
      members = group_table_->Members(msg.group_id());
      if (members.empty()) {
        // Not registered in THIS process yet: new_group is per-process
        // and unsynchronized, so another rank's announcement can arrive
        // before the coordinator's own call lands. Leave the tensor
        // pending — the late-registration sweep in FinishCycle marks it
        // ready once the id resolves (a genuinely unknown id then ends
        // in the divergence/stall path, by name).
        expected = -1;
      } else {
        expected = static_cast<int>(members.size());
        poisoned =
            !std::binary_search(members.begin(), members.end(), rank) ||
            msg.group_digest() != group_table_->Digest(msg.group_id());
      }
    }
  }
  stall_inspector_.RecordUncachedTensorStart(
      key, rank, size_, members.empty() ? nullptr : &members);
  it->second.push_back(msg);
  return poisoned || static_cast<int>(it->second.size()) == expected;
}

Response Controller::ConstructResponse(const std::string& key) {
  auto it = message_table_.find(key);
  assert(it != message_table_.end());
  std::vector<Request> requests = std::move(it->second);
  message_table_.erase(it);
  stall_inspector_.RemoveUncachedTensor(key);
  timeline_.NegotiateEnd(key);
  auto started = negotiate_started_.find(key);
  if (started != negotiate_started_.end()) {
    GlobalMetrics().negotiation_seconds.Observe(
        std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                      started->second)
            .count());
    negotiate_started_.erase(started);
  }

  const Request& first = requests[0];
  const uint32_t gid = first.group_id();
  std::vector<int> members;
  if (gid != 0 && group_table_ != nullptr) {
    members = group_table_->Members(gid);
  }
  std::ostringstream error;
  bool error_found = false;

  // Group validation first: a membership problem explains every other
  // mismatch, so it must own the error message.
  if (gid != 0) {
    if (members.empty()) {
      error << "Unknown process group " << gid << " for tensor '"
            << first.tensor_name()
            << "'; every rank must create groups with hvd.new_group(...) "
            << "in the same order before using them.";
      error_found = true;
    } else {
      uint64_t digest = group_table_->Digest(gid);
      for (const auto& req : requests) {
        if (req.group_digest() != digest) {
          error << "Mixed membership for process group " << gid
                << ": rank " << req.request_rank()
                << " created it with a different rank list than this "
                << "coordinator's " << group_table_->DescribeMembers(gid)
                << "; every rank must pass the identical ranks to "
                << "hvd.new_group.";
          error_found = true;
          break;
        }
        if (!std::binary_search(members.begin(), members.end(),
                                req.request_rank())) {
          error << "rank " << req.request_rank() << " announced tensor '"
                << first.tensor_name() << "' in process group " << gid
                << " whose members are "
                << group_table_->DescribeMembers(gid)
                << "; only members may submit group collectives.";
          error_found = true;
          break;
        }
      }
    }
  }

  // All ranks must agree on op type, dtype, and scaling.
  for (const auto& req : requests) {
    if (error_found) break;
    if (req.request_type() != first.request_type()) {
      error << "Mismatched collective operations: rank "
            << first.request_rank() << " did "
            << Request::RequestTypeName(first.request_type())
            << " while rank " << req.request_rank() << " did "
            << Request::RequestTypeName(req.request_type()) << ".";
      // A sharded-vs-replicated split is the mixed-execution-mode case
      // (docs/ZERO.md): name both ranks AND both modes, exactly like
      // mixed compression, so the fix is obvious from the message.
      auto is_pair = [&](Request::RequestType a, Request::RequestType b) {
        return (first.request_type() == a && req.request_type() == b) ||
               (first.request_type() == b && req.request_type() == a);
      };
      if (is_pair(Request::ALLREDUCE, Request::REDUCESCATTER)) {
        int sharded_rank = first.request_type() == Request::REDUCESCATTER
                               ? first.request_rank()
                               : req.request_rank();
        int replicated_rank = first.request_type() == Request::ALLREDUCE
                                  ? first.request_rank()
                                  : req.request_rank();
        error << " Mixed execution modes: rank " << sharded_rank
              << " runs sharded_update (reduce-scatter) while rank "
              << replicated_rank
              << " runs the replicated update (allreduce); pass the same "
              << "sharded_update= (or HVD_TPU_SHARDED_UPDATE) on every "
              << "rank.";
      }
      error_found = true;
      break;
    }
    if ((req.device() == HOST_DEVICE_ID) !=
        (first.device() == HOST_DEVICE_ID)) {
      // One rank's tensor in host memory and another's on its GPU: the
      // host op cannot read device pointers and the device op cannot
      // read host ones, so reject by name, naming both ranks and both
      // devices (GPU ordinals may differ across ranks: one GPU each).
      auto where = [](int32_t device) {
        return device == HOST_DEVICE_ID
                   ? std::string("the host")
                   : "GPU " + std::to_string(device);
      };
      error << "Mismatched devices: rank " << first.request_rank()
            << " enqueued tensor '" << first.tensor_name() << "' on "
            << where(first.device()) << " while rank "
            << req.request_rank() << " enqueued it on "
            << where(req.device())
            << "; every rank must pass a tensor on the same kind of "
            << "device (all host tensors or all CUDA tensors).";
      error_found = true;
      break;
    }
    if (req.tensor_type() != first.tensor_type()) {
      error << "Mismatched data types: one rank had "
            << DataTypeName(first.tensor_type()) << " while another had "
            << DataTypeName(req.tensor_type()) << ".";
      error_found = true;
      break;
    }
    if (req.prescale_factor() != first.prescale_factor() ||
        req.postscale_factor() != first.postscale_factor()) {
      error << "Mismatched prescale/postscale factors across ranks.";
      error_found = true;
      break;
    }
    if (req.compression() != first.compression()) {
      // Lossy codecs must be job-uniform: a rank decoding bf16 frames
      // as raw f32 would be silent corruption, so reject by name,
      // naming BOTH ranks and their modes.
      error << "Mismatched compression modes: rank " << first.request_rank()
            << " requested "
            << CompressionModeName(
                   static_cast<CompressionMode>(first.compression()))
            << " while rank " << req.request_rank() << " requested "
            << CompressionModeName(
                   static_cast<CompressionMode>(req.compression()))
            << "; pass the same compression= (or HVD_TPU_COMPRESSION) on "
            << "every rank.";
      error_found = true;
      break;
    }
  }

  if (!error_found && (first.request_type() == Request::ALLREDUCE ||
                       first.request_type() == Request::BROADCAST ||
                       first.request_type() == Request::REDUCESCATTER)) {
    for (const auto& req : requests) {
      if (req.tensor_shape() != first.tensor_shape()) {
        TensorShape a(first.tensor_shape()), b(req.tensor_shape());
        error << "Mismatched " << Request::RequestTypeName(first.request_type())
              << " tensor shapes: one rank sent " << a.DebugString()
              << " while another sent " << b.DebugString() << ".";
        error_found = true;
        break;
      }
    }
  }

  if (!error_found && first.request_type() == Request::BROADCAST) {
    for (const auto& req : requests) {
      if (req.root_rank() != first.root_rank()) {
        error << "Mismatched broadcast root ranks: one rank specified "
              << first.root_rank() << " while another specified "
              << req.root_rank() << ".";
        error_found = true;
        break;
      }
    }
    if (!error_found && gid != 0 &&
        !std::binary_search(members.begin(), members.end(),
                            first.root_rank())) {
      error << "Broadcast root rank " << first.root_rank()
            << " is not a member of process group " << gid << " "
            << group_table_->DescribeMembers(gid) << ".";
      error_found = true;
    }
  }

  std::vector<int64_t> tensor_sizes;
  if (!error_found && first.request_type() == Request::ALLGATHER) {
    // All dims but the first must match; gather per-rank first dims —
    // indexed by GROUP position for group collectives (the executing
    // ring lays blocks out in group order).
    tensor_sizes.resize(requests.size(), 0);
    for (const auto& req : requests) {
      if (req.tensor_shape().size() != first.tensor_shape().size() ||
          req.tensor_shape().empty()) {
        error << "Mismatched allgather tensor ranks (dimensionality).";
        error_found = true;
        break;
      }
      for (std::size_t d = 1; d < req.tensor_shape().size(); ++d) {
        if (req.tensor_shape()[d] != first.tensor_shape()[d]) {
          error << "Mismatched allgather non-first dimensions.";
          error_found = true;
          break;
        }
      }
      if (error_found) break;
      int slot = req.request_rank();
      if (gid != 0) {
        slot = group_table_ != nullptr
                   ? group_table_->IndexOf(gid, req.request_rank())
                   : -1;
      }
      if (slot < 0 || slot >= static_cast<int>(tensor_sizes.size())) {
        error << "Invalid request rank " << req.request_rank() << ".";
        error_found = true;
        break;
      }
      tensor_sizes[slot] = req.tensor_shape()[0];
    }
  }

  Response response;
  response.add_tensor_name(first.tensor_name());
  response.set_group_id(gid);
  if (error_found) {
    response.set_response_type(Response::ERROR);
    if (gid != 0 && group_table_ != nullptr) {
      // Every group-scoped rejection names the group — the fix is
      // almost always a membership or scoping mistake.
      error << " [process group " << gid << ", ranks "
            << group_table_->DescribeMembers(gid) << "]";
    }
    response.set_error_message(error.str());
    return response;
  }
  if (gid != 0) {
    GlobalMetrics().AddGroupNegotiated(gid, 1);
  }
  response.set_tensor_type(first.tensor_type());
  response.set_devices(first.device());
  response.set_compression(first.compression());
  switch (first.request_type()) {
    case Request::ALLREDUCE: {
      response.set_response_type(Response::ALLREDUCE);
      TensorShape shape(first.tensor_shape());
      response.add_tensor_size(shape.num_elements());
      break;
    }
    case Request::ALLGATHER:
      response.set_response_type(Response::ALLGATHER);
      response.set_tensor_sizes(tensor_sizes);
      break;
    case Request::BROADCAST: {
      response.set_response_type(Response::BROADCAST);
      TensorShape shape(first.tensor_shape());
      response.add_tensor_size(shape.num_elements());
      break;
    }
    case Request::REDUCESCATTER: {
      // Total element count rides the response; the executing op and
      // the Python binding derive the per-rank shard partition from it
      // with the same PartitionChunks math (shard i owns chunk i).
      response.set_response_type(Response::REDUCESCATTER);
      TensorShape shape(first.tensor_shape());
      response.add_tensor_size(shape.num_elements());
      break;
    }
  }
  return response;
}

void Controller::FuseResponses(std::deque<Response>& responses,
                               ResponseList& response_list) {
  int64_t threshold = TensorFusionThresholdBytes();
  while (!responses.empty()) {
    Response response = std::move(responses.front());
    responses.pop_front();
    if (response.response_type() == Response::ALLREDUCE && threshold > 0) {
      int64_t dtype_size =
          static_cast<int64_t>(DataTypeSize(response.tensor_type()));
      int64_t total_bytes = 0;
      for (int64_t n : response.tensor_sizes()) total_bytes += n * dtype_size;
      // Look-ahead scan: merge any later allreduce with identical
      // (dtype, devices) while under threshold; preserve order of the rest.
      std::deque<Response> skipped;
      while (!responses.empty()) {
        Response next = std::move(responses.front());
        responses.pop_front();
        bool merged = false;
        if (next.response_type() == Response::ALLREDUCE &&
            next.tensor_type() == response.tensor_type() &&
            next.compression() == response.compression() &&
            // Tensors only fuse WITHIN a group: a fused buffer rides one
            // ring, and different groups ride different rings.
            next.group_id() == response.group_id() &&
            next.devices() == response.devices()) {
          int64_t next_bytes = 0;
          for (int64_t n : next.tensor_sizes()) next_bytes += n * dtype_size;
          if (total_bytes + next_bytes <= threshold) {
            total_bytes += next_bytes;
            for (const auto& nm : next.tensor_names())
              response.add_tensor_name(nm);
            for (int64_t n : next.tensor_sizes()) response.add_tensor_size(n);
            merged = true;
          }
        }
        if (!merged) skipped.push_back(std::move(next));
      }
      responses = std::move(skipped);
    }
    response_list.add_response(std::move(response));
  }
}

ResponseList Controller::FinishCycle(std::deque<Response> responses,
                                     std::vector<Request>& non_cached_messages,
                                     bool should_shut_down) {
  // Counted below only when the cycle carried work: idle empty-queue
  // cycles also pass through here (the round trip still happens as the
  // readiness heartbeat), and counting them would make the fast/full
  // split report pacing, not workload (cycles_fast_ likewise counts
  // only op-carrying fast cycles).
  const bool had_local_work = !responses.empty() ||
                              !non_cached_messages.empty();
  ResponseList response_list;
  if (is_coordinator()) {
    std::vector<std::string> ready_names;
    for (auto& msg : non_cached_messages) {
      if (IncrementTensorCount(msg, rank_)) {
        ready_names.push_back(
            GroupQualifiedName(msg.group_id(), msg.tensor_name()));
      }
    }
    // The coordinator's own call stream enters the detector directly (its
    // RequestList is never serialized).
    if (call_tracker_ != nullptr) {
      divergence_.Observe(rank_, cycle_call_seq_, cycle_call_digest_,
                          call_tracker_->RecordsSince(reported_call_seq_, 32,
                                                      cycle_call_seq_));
      reported_call_seq_ = cycle_call_seq_;
    }
    // Gather worker RequestLists (rank 0's own slot is unused).
    std::vector<std::string> blobs;
    GatherBlobs(std::string(), &blobs);
    // Clock-alignment T2: the reference clock's reading right after the
    // gather returned (the workers stamped T1 just before sending).
    const int64_t clock_t2 = GlobalTrace().NowNs();
    for (int r = 1; r < size_; ++r) {
      RequestList list;
      if (!list.ParseFrom(blobs[r].data(), blobs[r].size())) {
        LOG(ERROR) << "Failed to parse RequestList from rank " << r;
        continue;
      }
      if (list.shutdown()) should_shut_down = true;
      divergence_.Observe(r, list.call_seq(), list.call_digest(),
                          list.recent_calls());
      if (!list.metrics_summary().empty()) {
        GlobalMetrics().SetRankSummary(r, list.metrics_summary());
      }
      for (const auto& msg : list.requests()) {
        if (IncrementTensorCount(msg, r)) {
          ready_names.push_back(
              GroupQualifiedName(msg.group_id(), msg.tensor_name()));
        }
      }
    }
    // Late-registration sweep: group tensors whose id was unknown when
    // their announcements arrived (see IncrementTensorCount) go ready
    // as soon as this process's registry resolves the id and every
    // member has announced. ShouldForceFullCycle keeps full cycles
    // coming while anything is pending, so the sweep always gets to
    // run even after the announcements went quiet.
    for (const auto& kv : message_table_) {
      const Request& first = kv.second.front();
      if (first.group_id() == 0 || group_table_ == nullptr) continue;
      int gsize = group_table_->Size(first.group_id());
      if (gsize > 0 && static_cast<int>(kv.second.size()) >= gsize) {
        ready_names.push_back(kv.first);
      }
    }
    for (const auto& key : ready_names) {
      // A key can go ready twice in one cycle (two provably-bad group
      // reports poisoning it, or the announcement path plus the sweep);
      // the first ConstructResponse consumed it.
      if (message_table_.count(key) == 0) continue;
      responses.push_back(ConstructResponse(key));
    }
    // Workload profile for the autotuner's search space: did this cycle
    // negotiate wire compression, a reduce-scatter, or a subgroup
    // collective? A first sighting after convergence triggers a re-arm
    // (parameter_manager.h) so tuning re-scores under the new regime.
    {
      bool comp = false, rs = false, grp = false;
      for (const auto& resp : responses) {
        comp = comp || resp.compression() != 0;
        rs = rs || resp.response_type() == Response::REDUCESCATTER;
        grp = grp || resp.group_id() != 0;
      }
      if (comp || rs || grp) {
        parameter_manager_.ObserveWorkload(comp, rs, grp);
      }
    }
    // Divergence cross-check: fail provably diverged pending tensors NOW
    // with a named call site, instead of letting them hang to the stall
    // timeout (divergence.h documents the two proof rules).
    bool diverged = false;
    for (const auto& diag : divergence_.Check(message_table_,
                                              group_table_)) {
      diverged = true;
      LOG(ERROR) << diag.message;
      GlobalMetrics().divergence_errors_total.fetch_add(
          1, std::memory_order_relaxed);
      message_table_.erase(diag.key);
      stall_inspector_.RemoveUncachedTensor(diag.key);
      timeline_.NegotiateEnd(diag.key);
      negotiate_started_.erase(diag.key);
      // The ERROR response carries the BARE tensor name plus the group
      // id — entry lookup on every rank is (name, group)-scoped.
      Response error;
      error.add_tensor_name(diag.tensor_name);
      error.set_group_id(diag.group_id);
      error.set_response_type(Response::ERROR);
      error.set_error_message(diag.message);
      responses.push_back(std::move(error));
    }
    if (diverged) {
      // Flight recorder: the coordinator holds the proof (pending table
      // + call records); the workers hold their own in-flight evidence
      // — dump here, flag them to dump on parse.
      GlobalTrace().DumpBundle("divergence", PendingNegotiationJson());
      pending_trace_flags_ |= ResponseList::kFlagDumpBundle;
    }
    response_list.set_shutdown(should_shut_down);
    FuseResponses(responses, response_list);
    // Autotune bootstrap: consume any pending re-arm NOW (after fusion,
    // before the broadcast) and stamp the (epoch, profile) word on the
    // list — workers mirror the re-arm at parse time in this same
    // cycle, so the whole ring re-enters tuning in lockstep.
    response_list.set_autotune_wire(
        parameter_manager_.WireEpochForBroadcast());
    // Clock-alignment T3 (right before the broadcast) + any armed
    // bundle-dump flag ride the same tail.
    response_list.set_clock(clock_t2, GlobalTrace().NowNs());
    response_list.set_trace_flags(pending_trace_flags_);
    pending_trace_flags_ = 0;
    std::string blob;
    response_list.SerializeTo(&blob);
    BroadcastBlob(&blob);
  } else {
    RequestList message_list;
    message_list.set_shutdown(should_shut_down);
    if (call_tracker_ != nullptr) {
      message_list.set_call_seq(cycle_call_seq_);
      message_list.set_call_digest(cycle_call_digest_);
      message_list.set_recent_calls(
          call_tracker_->RecordsSince(reported_call_seq_, 32,
                                      cycle_call_seq_));
      reported_call_seq_ = cycle_call_seq_;
    }
    if (metrics_plane_enabled_) {
      auto now = std::chrono::steady_clock::now();
      if (std::chrono::duration<double>(now - last_summary_attach_).count() >=
          metrics_sync_seconds_) {
        message_list.set_metrics_summary(GlobalMetrics().Summary());
        last_summary_attach_ = now;
      }
    }
    for (auto& msg : non_cached_messages) {
      message_list.add_request(msg);
    }
    std::string blob;
    message_list.SerializeTo(&blob);
    // Clock-alignment T1/T4 bracket the gather+broadcast round trip;
    // the coordinator's T2/T3 stamps ride the ResponseList tail back.
    Trace& trace = GlobalTrace();
    const int64_t clock_t1 = trace.NowNs();
    GatherBlobs(blob, nullptr);
    std::string response_blob;
    BroadcastBlob(&response_blob);
    const int64_t clock_t4 = trace.NowNs();
    if (!response_list.ParseFrom(response_blob.data(), response_blob.size())) {
      LOG(FATAL) << "Failed to parse ResponseList from coordinator";
    }
    if (response_list.autotune_wire() != ResponseList::kAutotuneAbsent) {
      parameter_manager_.NoteWireEpoch(response_list.autotune_wire());
    }
    if (response_list.clock_t2() >= 0 && response_list.clock_t3() >= 0) {
      trace.UpdateClockSample(clock_t1, response_list.clock_t2(),
                              response_list.clock_t3(), clock_t4);
    }
    if (response_list.trace_flags() & ResponseList::kFlagDumpBundle) {
      // The coordinator saw a stall escalation / divergence this cycle;
      // dump while the evidence is still in this rank's ring.
      trace.DumpBundle("escalation", std::string());
    }
  }
  // Work on ANY rank makes this a full work cycle (the final list is
  // identical everywhere; a worker whose own queue was empty still
  // executed a real negotiation for the ranks that had work).
  if (had_local_work || !response_list.responses().empty()) {
    cycles_full_ += 1;
    GlobalMetrics().cycles_full_total.fetch_add(1, std::memory_order_relaxed);
  }
  GlobalMetrics().pending_negotiation.store(
      static_cast<int64_t>(message_table_.size()), std::memory_order_relaxed);
  return response_list;
}

ResponseList Controller::ComputeResponseList(
    bool this_process_requested_shutdown) {
  CacheCoordinator cache_coordinator(response_cache_.num_active_bits());

  // Snapshot BEFORE the queue pop (see cycle_call_seq_ in controller.h:
  // the pop then provably contains every call the snapshot counts).
  if (call_tracker_ != nullptr) {
    call_tracker_->Snapshot(&cycle_call_seq_, &cycle_call_digest_);
  }

  std::deque<Request> message_queue_tmp;
  tensor_queue_.PopMessagesFromQueue(message_queue_tmp);
  Metrics& metrics = GlobalMetrics();
  metrics.queue_depth.store(static_cast<int64_t>(message_queue_tmp.size()),
                            std::memory_order_relaxed);

  std::vector<Request> non_cached_messages;
  // bit -> locally-hit message, pending global agreement.
  std::unordered_map<uint32_t, Request> hit_messages;

  bool cache_on = response_cache_.capacity() > 0 &&
                  parameter_manager_.CacheEnabled();
  for (auto& message : message_queue_tmp) {
    if (cache_on) {
      auto state = response_cache_.cached(message);
      if (state == ResponseCache::CacheState::HIT) {
        uint32_t bit = response_cache_.peek_cache_bit(message);
        cache_coordinator.record_hit(bit);
        metrics.cache_hit_total.fetch_add(1, std::memory_order_relaxed);
        stall_inspector_.RecordCachedTensorStart(GroupQualifiedName(
            message.group_id(), message.tensor_name()));
        hit_messages.emplace(bit, std::move(message));
        continue;
      }
      if (state == ResponseCache::CacheState::INVALID) {
        uint32_t bit = response_cache_.peek_cache_bit(message);
        cache_coordinator.record_invalid_bit(bit);
        metrics.cache_invalid_total.fetch_add(1, std::memory_order_relaxed);
      } else {
        metrics.cache_miss_total.fetch_add(1, std::memory_order_relaxed);
      }
    }
    cache_coordinator.set_uncached_in_queue(true);
    non_cached_messages.push_back(std::move(message));
  }
  // Process groups (docs/GROUPS.md): every cached tensor belonging to a
  // group this rank is NOT a member of is vacuously ready here — record
  // its bit as a hit so the cross-rank AND reduces to an AND over the
  // group's actual members. Without this, a group tensor could never
  // take the fast path (non-members would always zero its bit).
  if (cache_on) {
    std::vector<uint32_t> foreign_bits;
    response_cache_.NonMemberBits(&foreign_bits);
    for (uint32_t bit : foreign_bits) cache_coordinator.record_hit(bit);
  }
  // Periodic stall inspection — must run every cycle type (stalls surface
  // precisely when no negotiation is happening): warn about tensors waiting
  // on missing ranks, invalidate stalled cached tensors so they renegotiate,
  // and escalate to coordinated shutdown past the threshold.
  if (stall_inspector_.ShouldPerformCheck()) {
    if (cache_on) {
      std::vector<uint32_t> stalled_bits;
      stall_inspector_.InvalidateStalledCachedTensors(response_cache_,
                                                      stalled_bits);
      for (uint32_t bit : stalled_bits) {
        cache_coordinator.record_invalid_bit(bit);
      }
    }
    if (is_coordinator() &&
        stall_inspector_.CheckForStalledTensors(size_)) {
      this_process_requested_shutdown = true;
      // Flight recorder: capture the pending table (missing ranks by
      // name) before the coordinated shutdown tears it down, and arm
      // the broadcast flag so every worker dumps too.
      GlobalTrace().DumpBundle("stall_escalation", PendingNegotiationJson());
      pending_trace_flags_ |= ResponseList::kFlagDumpBundle;
    }
    stall_inspector_.UpdateCheckTime();
  }
  // An armed bundle flag rides full-cycle broadcasts only — break the
  // all-cached fast path until FinishCycle ships it.
  if (is_coordinator() && pending_trace_flags_ != 0) {
    cache_coordinator.set_uncached_in_queue(true);
  }
  // Quiescent-stall escape hatch: when every rank is blocked waiting, no
  // rank has uncached work, so cycles ride the fast bit-sync and the
  // coordinator would never see fresh seq/digest reports to cross-check.
  // An aged pending tensor makes the coordinator force a full round trip
  // (the flag is OR-synced, so all ranks follow); workers then ship their
  // call-tracker state on otherwise-empty RequestLists. Rate-limited
  // inside ShouldForceFullCycle.
  if (is_coordinator() &&
      divergence_.ShouldForceFullCycle(message_table_)) {
    cache_coordinator.set_uncached_in_queue(true);
  }
  // Autotune re-arm delivery: the bootstrap word rides full-cycle
  // broadcasts only, so a pending re-arm must break the all-cached fast
  // path until the next FinishCycle ships it.
  if (is_coordinator() && parameter_manager_.RearmPending()) {
    cache_coordinator.set_uncached_in_queue(true);
  }
  // Metrics freshness: all-cached steady state (and total quiescence)
  // never sends RequestLists, so piggybacked summaries would freeze at
  // their last full cycle — precisely when a live job view matters. The
  // coordinator forces one full round trip per sync interval; the
  // OR-synced uncached flag brings every rank along, and workers attach
  // their summaries to the otherwise-empty lists.
  if (is_coordinator() && metrics_plane_enabled_ && size_ > 1) {
    auto now = std::chrono::steady_clock::now();
    if (std::chrono::duration<double>(now - last_metrics_force_).count() >=
        metrics_sync_seconds_) {
      cache_coordinator.set_uncached_in_queue(true);
      last_metrics_force_ = now;
    }
  }

  cache_coordinator.set_should_shut_down(this_process_requested_shutdown);

  bool should_shut_down = this_process_requested_shutdown;
  std::deque<Response> cached_responses;
  bool all_cached = false;

  if (cache_on) {
    cache_coordinator.sync(this, timeline_.Initialized());
    should_shut_down = cache_coordinator.should_shut_down();

    // Locally-hit tensors that lost the global AND wait for the other ranks:
    // re-queue them for a later cycle. Invalidated ones renegotiate now.
    for (auto& kv : hit_messages) {
      if (cache_coordinator.cache_hits().count(kv.first)) continue;
      if (cache_coordinator.invalid_bits().count(kv.first)) {
        stall_inspector_.RemoveCachedTensor(GroupQualifiedName(
            kv.second.group_id(), kv.second.tensor_name()));
        non_cached_messages.push_back(std::move(kv.second));
      } else {
        tensor_queue_.PushMessageToQueue(kv.second);
      }
    }

    // Materialize + LRU-touch globally-hit responses before any erase can
    // perturb bit numbering. Identical motion on every rank keeps future
    // evictions consistent.
    for (uint32_t bit : cache_coordinator.cache_hits()) {
      cached_responses.push_back(response_cache_.get_response(bit));
      stall_inspector_.RemoveCachedTensor(GroupQualifiedName(
          cached_responses.back().group_id(),
          cached_responses.back().tensor_names()[0]));
    }

    // Drop invalidated entries identically on every rank, then re-pack bits.
    std::vector<uint32_t> invalid(cache_coordinator.invalid_bits().begin(),
                                  cache_coordinator.invalid_bits().end());
    std::sort(invalid.rbegin(), invalid.rend());
    for (uint32_t bit : invalid) response_cache_.erase_response(bit);
    response_cache_.update_cache_bits();

    // A cycle that invalidated bits anywhere must run the FULL
    // negotiation: invalidated local hits were just moved into
    // non_cached_messages to renegotiate, and the fast-path return
    // below would silently DROP them — the op's rank never reaches
    // the coordinator's count and the job livelocks with a permanent
    // "missing ranks" stall (hit live: a stall-inspector cache
    // invalidation during a straggler wait; reference analogue of the
    // invalid_in_queue gate in common/response_cache.cc's
    // CoordinateCacheAndState flow).
    all_cached = !cache_coordinator.uncached_in_queue() &&
                 !cache_coordinator.invalid_in_queue();
  }

  if (cache_on && all_cached) {
    // Fast path: everything queued this cycle was globally cached; no
    // coordinator round trip. Every rank builds the identical list locally.
    if (!cached_responses.empty()) {
      cycles_fast_ += 1;
      metrics.cycles_fast_total.fetch_add(1, std::memory_order_relaxed);
    }
    ResponseList response_list;
    response_list.set_shutdown(should_shut_down);
    FuseResponses(cached_responses, response_list);
    return response_list;
  }

  return FinishCycle(std::move(cached_responses), non_cached_messages,
                     should_shut_down);
}

std::string Controller::PendingNegotiationJson() const {
  if (!is_coordinator()) return "{}";
  auto now = std::chrono::steady_clock::now();
  std::string out = "{\"pending\":[";
  bool first_entry = true;
  for (const auto& kv : message_table_) {
    if (!first_entry) out += ',';
    first_entry = false;
    out += "{\"name\":\"";
    for (char c : kv.first) {
      if (c == '"' || c == '\\') out += '\\';
      out += c;
    }
    out += "\",\"reported\":[";
    std::unordered_set<int> reported;
    bool first_rank = true;
    for (const auto& req : kv.second) {
      reported.insert(req.request_rank());
      if (!first_rank) out += ',';
      first_rank = false;
      out += std::to_string(req.request_rank());
    }
    out += "],\"missing\":[";
    const Request& head = kv.second.front();
    std::vector<int> members;
    if (head.group_id() != 0 && group_table_ != nullptr) {
      members = group_table_->Members(head.group_id());
    }
    if (members.empty()) {
      for (int r = 0; r < size_; ++r) members.push_back(r);
    }
    first_rank = true;
    for (int r : members) {
      if (reported.count(r)) continue;
      if (!first_rank) out += ',';
      first_rank = false;
      out += std::to_string(r);
    }
    out += "],\"age_seconds\":";
    double age = 0.0;
    auto it = negotiate_started_.find(kv.first);
    if (it != negotiate_started_.end()) {
      age = std::chrono::duration<double>(now - it->second).count();
    }
    char buf[32];
    std::snprintf(buf, sizeof(buf), "%.3f", age);
    out += buf;
    out += '}';
  }
  out += "]}";
  return out;
}

}  // namespace hvdtpu
