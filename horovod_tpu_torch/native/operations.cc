// Core runtime entry points: the process-wide singleton state, the
// background coordination thread (the only thread that talks cross-rank),
// the enqueue API, and the extern "C" surface loaded by Python via ctypes.
//
// Capability parity with /root/reference horovod/common/operations.cc
// (InitializeHorovodOnce / BackgroundThreadLoop / RunLoopOnce /
// PerformOperation / EnqueueTensor* / horovod_* C API), redesigned for the
// TPU build: completion is handle-based (HandleManager, mirroring the
// reference torch binding's handle_manager.h) so no foreign thread re-enters
// Python, and the data plane is the host TCP ring — TPU-resident tensors
// ride XLA collectives inside jit and never enter this core.
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <csignal>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>

#include "bayesian_optimization.h"
#include "collective_operations.h"
#include "common.h"
#include "compression.h"
#include "controller.h"
#include "cpu_operations.h"
#include "global_state.h"
#include "logging.h"
#include "tcp_controller.h"
#include "trace.h"

namespace hvdtpu {

HorovodGlobalState::~HorovodGlobalState() {
  // A joinable std::thread member would std::terminate the process at
  // static destruction (e.g. interpreter exit without hvd.shutdown()).
  shut_down.store(true);
  if (background_thread.joinable()) {
    background_thread.join();
  }
}

namespace {

HorovodGlobalState g_state;
std::mutex g_init_mutex;

// ---------------- HandleManager ----------------

struct HandleEntry {
  bool done = false;
  Status status;
  std::shared_ptr<std::vector<char>> gathered;
  std::shared_ptr<std::vector<int64_t>> gathered_sizes;
};

class HandleManager {
 public:
  int AllocateHandle() {
    std::lock_guard<std::mutex> lk(mutex_);
    int handle = next_handle_++;
    entries_[handle] = std::make_shared<HandleEntry>();
    return handle;
  }

  void MarkDone(int handle, const Status& status,
                std::shared_ptr<std::vector<char>> gathered = nullptr,
                std::shared_ptr<std::vector<int64_t>> sizes = nullptr) {
    {
      std::lock_guard<std::mutex> lk(mutex_);
      auto it = entries_.find(handle);
      if (it == entries_.end()) return;
      it->second->done = true;
      it->second->status = status;
      it->second->gathered = std::move(gathered);
      it->second->gathered_sizes = std::move(sizes);
    }
    cv_.notify_all();
  }

  bool Poll(int handle) {
    std::lock_guard<std::mutex> lk(mutex_);
    auto it = entries_.find(handle);
    return it == entries_.end() || it->second->done;
  }

  std::shared_ptr<HandleEntry> Wait(int handle) {
    std::unique_lock<std::mutex> lk(mutex_);
    auto it = entries_.find(handle);
    if (it == entries_.end()) return nullptr;
    auto entry = it->second;
    cv_.wait(lk, [&] { return entry->done; });
    return entry;
  }

  std::shared_ptr<HandleEntry> Get(int handle) {
    std::lock_guard<std::mutex> lk(mutex_);
    auto it = entries_.find(handle);
    return it == entries_.end() ? nullptr : it->second;
  }

  void Release(int handle) {
    std::lock_guard<std::mutex> lk(mutex_);
    entries_.erase(handle);
  }

  void FailAll(const Status& status) {
    {
      std::lock_guard<std::mutex> lk(mutex_);
      for (auto& kv : entries_) {
        if (!kv.second->done) {
          kv.second->done = true;
          kv.second->status = status;
        }
      }
    }
    cv_.notify_all();
  }

 private:
  std::mutex mutex_;
  std::condition_variable cv_;
  int next_handle_ = 0;  // guarded_by(mutex_)
  std::map<int, std::shared_ptr<HandleEntry>> entries_;  // guarded_by(mutex_)
};

HandleManager g_handles;

// ---------------- fatal-signal flight recorder ----------------
// A crashing rank is about to lose its buffered evidence: the trace ring,
// a possibly-unflushed shard, and an unterminated timeline JSON array.
// Dump a best-effort bundle and finalize the timeline, then restore the
// previous disposition and re-raise so the exit (core dump, abort status)
// is unchanged. Formally async-signal-unsafe (locks, allocation) — but the
// process is dying anyway, and a rare self-deadlock here costs nothing the
// crash wasn't already taking.

struct sigaction g_prev_sigactions[NSIG];
std::atomic<bool> g_fatal_dump_done{false};

void FatalSignalHandler(int sig) {
  // Restore the previous disposition FIRST: if the dump itself faults,
  // the re-entered signal takes the old path and the process still dies.
  if (sig >= 0 && sig < NSIG) {
    sigaction(sig, &g_prev_sigactions[sig], nullptr);
  }
  if (!g_fatal_dump_done.exchange(true)) {
    char reason[32];
    std::snprintf(reason, sizeof(reason), "fatal_signal_%d", sig);
    // No PendingNegotiationJson here: the controller's tables belong to
    // the background thread and are not guarded against this (arbitrary)
    // crashing thread.
    GlobalTrace().DumpBundle(reason, std::string());
    g_state.timeline.EmergencyFinalize();
  }
  raise(sig);
}

void InstallFatalSignalHandlers() {
  static std::atomic<bool> installed{false};
  if (installed.exchange(true)) return;
  struct sigaction sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sa_handler = FatalSignalHandler;
  sigemptyset(&sa.sa_mask);
  for (int sig : {SIGSEGV, SIGABRT, SIGBUS, SIGFPE}) {
    sigaction(sig, &sa, &g_prev_sigactions[sig]);
  }
  // SIGTERM only when nothing else claimed it: Python/launcher handlers
  // keep precedence, but a default-disposition TERM (the launcher's kill
  // path) should finalize the timeline before the process goes.
  struct sigaction cur;
  if (sigaction(SIGTERM, nullptr, &cur) == 0 && cur.sa_handler == SIG_DFL &&
      (cur.sa_flags & SA_SIGINFO) == 0) {
    sigaction(SIGTERM, &sa, &g_prev_sigactions[SIGTERM]);
  }
}

// ---------------- background loop ----------------
// (env parsing lives in common.h EnvInt64/EnvDouble/EnvBool)

// Returns (tensors, payload bytes) executed so RunLoopOnce can feed the
// per-cycle histograms.
std::pair<int64_t, int64_t> PerformOperation(HorovodGlobalState& state,
                                             const Response& response) {
  // Cache the negotiated response while entries are still in the table.
  // EVERY rank mirrors EVERY response (non-members store foreign
  // placeholder entries) so cache-bit positions stay rank-identical —
  // the bit-vector fast path depends on it (response_cache.h).
  if (response.response_type() != Response::ERROR) {
    state.response_cache.put(response, state.tensor_queue,
                             &state.group_table,
                             state.controller->rank());
  }
  std::vector<TensorTableEntry> entries;
  state.tensor_queue.GetTensorEntriesFromResponse(response, entries);
  if (entries.empty()) return {0, 0};
  if (response.group_id() != 0) {
    state.metrics.group_tensors_total.fetch_add(
        entries.size(), std::memory_order_relaxed);
  }
  // Fusion diagnostics: responses vs tensors executed (a fused response
  // carries several tensors; with fusion off the counts are equal).
  state.responses_performed.fetch_add(1);
  state.tensors_performed.fetch_add(
      static_cast<int64_t>(entries.size()));
  int64_t bytes = 0;
  for (const auto& e : entries) bytes += static_cast<int64_t>(e.SizeBytes());
  Metrics& metrics = state.metrics;
  metrics.responses_performed_total.fetch_add(1, std::memory_order_relaxed);
  metrics.tensors_performed_total.fetch_add(entries.size(),
                                            std::memory_order_relaxed);
  metrics.bytes_performed_total.fetch_add(static_cast<uint64_t>(bytes),
                                          std::memory_order_relaxed);
  if (response.response_type() == Response::ERROR) {
    metrics.error_responses_total.fetch_add(1, std::memory_order_relaxed);
  }
  if (entries.size() > 1) {
    metrics.fused_tensors_total.fetch_add(entries.size(),
                                          std::memory_order_relaxed);
    metrics.fused_bytes_total.fetch_add(static_cast<uint64_t>(bytes),
                                        std::memory_order_relaxed);
    int64_t threshold = state.controller->TensorFusionThresholdBytes();
    if (threshold > 0) {
      double fill = static_cast<double>(bytes) /
                    static_cast<double>(threshold);
      metrics.fusion_fill_ratio.Observe(fill > 1.0 ? 1.0 : fill);
    }
  }
  Trace& trace = state.trace;
  const int64_t t_exec_start = trace.NowNs();
  if (trace.enabled()) {
    // Close the negotiation-wait span opened at enqueue: the gap from
    // submission to execution is what the cross-rank agreement (and any
    // straggler) cost this tensor.
    for (const auto& e : entries) {
      int64_t opened = trace.CloseSpan(
          GroupQualifiedName(response.group_id(), e.tensor_name));
      if (opened >= 0) {
        trace.Record(e.tensor_name.c_str(), TRACE_NEGOTIATE, opened,
                     t_exec_start, static_cast<int64_t>(e.SizeBytes()),
                     response.group_id());
      }
    }
  }
  for (const auto& e : entries) {
    state.timeline.Start(e.tensor_name, response.response_type());
  }
  Status status;
  try {
    status = state.op_manager->ExecuteOperation(entries, response);
  } catch (const std::exception& ex) {
    status = Status::UnknownError(ex.what());
  }
  // The device op handed the response to the binding's executor: its
  // entries complete through horovod_tpu_device_done, not here.
  const bool handed_off = status.in_progress();
  // One exec span per response: a fused response executes as one wire
  // operation, named by its first tensor.
  const int64_t t_exec_end = trace.NowNs();
  trace.Record(entries[0].tensor_name.c_str(), TRACE_EXEC, t_exec_start,
               t_exec_end, bytes, response.group_id());
  for (auto& e : entries) {
    state.timeline.End(e.tensor_name, status.ok() || handed_off);
    if (e.callback && !handed_off) e.callback(status, e);
  }
  trace.Record(entries[0].tensor_name.c_str(), TRACE_CALLBACK, t_exec_end,
               trace.NowNs(), 0, response.group_id());
  // A data-plane transport loss (ring EOF / checksum mismatch / deadline
  // — cpu_operations.cc RingLost) leaves the ring desynced: later
  // exchanges would pair mismatched steps. Escalate to the same
  // connection-lost shutdown a control-plane failure takes, AFTER the
  // failed tensors' callbacks have delivered the attributable status.
  if (!status.ok() &&
      status.reason().compare(0, CONNECTION_LOST_ERROR.size(),
                              CONNECTION_LOST_ERROR) == 0) {
    throw ConnectionLostError(status.reason());
  }
  return {static_cast<int64_t>(entries.size()), bytes};
}

bool RunLoopOnce(HorovodGlobalState& state,
                 std::chrono::steady_clock::time_point& last_cycle_start) {
  // Pace the cycle.
  auto cycle =
      std::chrono::duration<double, std::milli>(
          state.parameter_manager.CycleTimeMs());
  auto next_start = last_cycle_start +
                    std::chrono::duration_cast<std::chrono::steady_clock::duration>(cycle);
  auto now = std::chrono::steady_clock::now();
  if (next_start > now) {
    std::this_thread::sleep_for(next_start - now);
  }
  last_cycle_start = std::chrono::steady_clock::now();

  if (state.mark_cycles_in_timeline) {
    state.timeline.MarkCycleStart();
  }

  bool was_tuning = state.parameter_manager.IsAutoTuning();

  ResponseList response_list =
      state.controller->ComputeResponseList(state.shut_down.load());

  int64_t cycle_tensors = 0;
  int64_t cycle_bytes = 0;
  for (const auto& response : response_list.responses()) {
    auto executed = PerformOperation(state, response);
    cycle_tensors += executed.first;
    cycle_bytes += executed.second;
  }
  Metrics& metrics = state.metrics;
  metrics.cycles_total.fetch_add(1, std::memory_order_relaxed);
  metrics.cycle_seconds.Observe(
      std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                    last_cycle_start)
          .count());
  if (cycle_tensors > 0) {
    metrics.cycle_tensors.Observe(static_cast<double>(cycle_tensors));
    metrics.cycle_bytes.Observe(static_cast<double>(cycle_bytes));
  }
  metrics.fusion_threshold_bytes.store(
      state.controller->TensorFusionThresholdBytes(),
      std::memory_order_relaxed);

  // Closed-loop tuner (docs/AUTOTUNE.md): the coordinator's Update runs
  // EVERY cycle — it advances sampling while tuning and watches for
  // workload drift while converged (a drift re-arm is bootstrapped to
  // the workers through the next full-cycle ResponseList). The per-cycle
  // parameter broadcast still runs only while every rank knows tuning is
  // live (`was_tuning` is synchronized state), keeping knob application
  // in lockstep across ranks.
  if (state.controller->is_coordinator()) {
    state.parameter_manager.Update(cycle_tensors, cycle_bytes);
  }
  if (was_tuning) {
    state.controller->SynchronizeParameters();
  }
  metrics.autotune_active.store(
      state.parameter_manager.IsAutoTuning() ? 1 : 0,
      std::memory_order_relaxed);
  metrics.pipeline_chunk_bytes.store(
      state.parameter_manager.PipelineChunkBytes(),
      std::memory_order_relaxed);
  // Apply the (cycle-synchronized) shm_transport knob at the cycle
  // boundary: every rank runs this line between the same two response
  // lists, so both ends of any negotiated segment flip together and an
  // exchange can never pair an shm writer with a TCP reader.
  state.tcp_context.SetShmUse(state.parameter_manager.ShmTransport());
  uint64_t rearms = state.parameter_manager.rearms_total();
  uint64_t seen = metrics.autotune_rearms_total.load(
      std::memory_order_relaxed);
  if (rearms > seen) {
    metrics.autotune_rearms_total.fetch_add(rearms - seen,
                                            std::memory_order_relaxed);
  }

  return !response_list.shutdown();
}

void BackgroundThreadLoop(HorovodGlobalState& state) {
  // Generation reset: a re-init after an elastic membership change (or a
  // plain shutdown/init cycle) must not carry over negotiation state from
  // the previous communicator — cached responses reference the old size
  // and bit layout, and the protocol counters would mix generations.
  state.connection_lost.store(false);
  state.response_cache.clear();
  // Groups reference the old membership's ranks; Python re-creates the
  // mesh groups after every (re-)init (docs/GROUPS.md).
  state.group_table.Clear();
  state.tcp_context.ResetProtocolCounters();
  state.responses_performed.store(0);
  state.tensors_performed.store(0);
  // Call-sequence tracking restarts with the generation: survivors of an
  // elastic shrink/regrow and fresh workers must agree on seq 0.
  state.call_tracker.Reset();
  state.device_queue.Open();

  if (!state.tcp_context.Initialize()) {
    state.device_queue.Close(std::chrono::milliseconds(0));
    state.tcp_context.Finalize();  // release sockets for a re-init retry
    state.initialization_failed.store(true);
    state.initialization_done.store(true);
    return;
  }

  state.controller = std::make_unique<TcpController>(
      state.response_cache, state.tensor_queue, state.timeline,
      state.parameter_manager, state.tcp_context);
  state.controller->Initialize();

  // Runtime knobs (env; autotuner may override non-fixed ones later).
  bool fixed;
  int64_t fusion_threshold =
      EnvInt64(HVD_TPU_FUSION_THRESHOLD, 64 * 1024 * 1024, &fixed);
  state.parameter_manager.SetTensorFusionThresholdBytes(fusion_threshold,
                                                        fixed);
  double cycle_time = EnvDouble(HVD_TPU_CYCLE_TIME, 5.0, &fixed);
  state.parameter_manager.SetCycleTimeMs(cycle_time, fixed);
  int64_t cache_capacity = EnvInt64(HVD_TPU_CACHE_CAPACITY, 1024, &fixed);
  state.response_cache.set_capacity(static_cast<uint32_t>(cache_capacity));
  state.parameter_manager.SetCacheEnabled(cache_capacity > 0, fixed);
  if (state.tcp_context.hierarchical_possible()) {
    bool hier_ar = EnvBool(HVD_TPU_HIERARCHICAL_ALLREDUCE, false, &fixed);
    state.parameter_manager.SetHierarchicalAllreduce(hier_ar, fixed);
    bool hier_ag = EnvBool(HVD_TPU_HIERARCHICAL_ALLGATHER, false, &fixed);
    state.parameter_manager.SetHierarchicalAllgather(hier_ag, fixed);
    bool hier_rs =
        EnvBool(HVD_TPU_HIERARCHICAL_REDUCESCATTER, false, &fixed);
    state.parameter_manager.SetHierarchicalReduceScatter(hier_rs, fixed);
  } else {
    // Flat topology: pin the knobs off and fixed so the autotuner doesn't
    // waste its categorical budget scoring identical configurations.
    state.parameter_manager.SetHierarchicalAllreduce(false, true);
    state.parameter_manager.SetHierarchicalAllgather(false, true);
    state.parameter_manager.SetHierarchicalReduceScatter(false, true);
  }
  // Pipelined ring segment size: env pins it (0 = unsliced); unset
  // leaves the knob to the autotuner, starting at 1 MiB.
  int64_t pipeline_chunk =
      EnvInt64(HVD_TPU_PIPELINE_CHUNK_BYTES, 1 << 20, &fixed);
  state.parameter_manager.SetPipelineChunkBytes(pipeline_chunk, fixed);
  // Shared-memory transport knob (docs/TRANSPORT.md): HVD_TPU_SHM=0/1
  // pins it off/on; unset (or "auto") defaults on and leaves it to the
  // autotuner on shm-capable topologies.
  {
    const char* shm_env = std::getenv("HVD_TPU_SHM");
    if (shm_env != nullptr && (shm_env[0] == '0' || shm_env[0] == '1') &&
        shm_env[1] == '\0') {
      state.parameter_manager.SetShmTransport(shm_env[0] == '1', true);
    } else {
      state.parameter_manager.SetShmTransport(true, false);
    }
  }

  state.controller->stall_inspector().SetStallWarningTimeSeconds(
      static_cast<int>(EnvInt64(HVD_TPU_STALL_CHECK_TIME, 60)));
  state.controller->stall_inspector().SetStallShutdownTimeSeconds(
      static_cast<int>(EnvInt64(HVD_TPU_STALL_SHUTDOWN_TIME, 0)));

  // Metrics plane (metrics.h / docs/METRICS.md): the registry always
  // counts; the PLANE (wire summaries + forced sync cycles + the Python
  // HTTP endpoint keying off the same env) engages when explicitly
  // enabled, so metrics-off jobs see zero wire or cycle-shape change.
  bool metrics_plane = EnvBool(HVD_TPU_METRICS, false) ||
                       std::getenv(HVD_TPU_METRICS_PORT) != nullptr;
  state.metrics.Configure(state.controller->size(),
                          state.controller->rank());
  state.metrics.set_enabled(metrics_plane);
  state.metrics.elastic_generation.store(
      EnvInt64(HVD_TPU_GENERATION_ENV, 0), std::memory_order_relaxed);
  state.metrics.init_total.fetch_add(1, std::memory_order_relaxed);
  state.controller->ConfigureMetrics(
      metrics_plane, EnvDouble(HVD_TPU_METRICS_SYNC, 1.0));

  // Divergence cross-check (divergence.h): progress rule fires after a
  // missing rank advances this many calls past a pending tensor (0 = off);
  // the cross-stall rule after a pending tensor ages this many seconds
  // with every missing rank waiting elsewhere (<=0 = off). Both default
  // on — they only trigger on protocol-divergent programs, which would
  // otherwise hang to the stall timeout.
  state.controller->SetCallTracker(&state.call_tracker);
  state.controller->SetGroupTable(&state.group_table);
  state.controller->ConfigureDivergence(
      EnvInt64(HVD_TPU_DIVERGENCE_CALLS, 64),
      EnvDouble(HVD_TPU_DIVERGENCE_GRACE, 5.0));

  // Span recorder + flight recorder (trace.h, docs/TRACING.md): always on
  // unless HVD_TPU_TRACE=0. The generation tags shard files and bundles so
  // merged traces keep elastic re-inits apart. Fatal-signal hooks ride the
  // same init so a crashing rank still flushes its evidence.
  state.trace.Configure(state.controller->rank(), state.controller->size(),
                        EnvInt64(HVD_TPU_GENERATION_ENV, 0));
  InstallFatalSignalHandlers();

  const char* timeline_path = std::getenv(HVD_TPU_TIMELINE);
  if (timeline_path != nullptr) {
    state.timeline.Initialize(timeline_path,
                              static_cast<unsigned>(state.controller->rank()));
    state.timeline.SetMarkCycles(
        EnvBool(HVD_TPU_TIMELINE_MARK_CYCLES, false));
    state.mark_cycles_in_timeline =
        EnvBool(HVD_TPU_TIMELINE_MARK_CYCLES, false);
  }

  const char* autotune_log = std::getenv(HVD_TPU_AUTOTUNE_LOG);
  state.parameter_manager.Initialize(state.controller->rank(),
                                     autotune_log ? autotune_log : "");
  // Search-space profile seed, identical on every rank (both values come
  // from job-wide env): the coordinator's live observation of negotiated
  // responses refines it later (controller.cc) and re-arms on change.
  state.parameter_manager.ObserveWorkload(
      ParseCompressionMode(std::getenv(HVD_TPU_COMPRESSION_ENV)) !=
          CompressionMode::NONE,
      EnvBool(HVD_TPU_SHARDED_UPDATE_ENV, false),
      /*groups_active=*/false,
      // shm capability is a pure function of (HVD_TPU_SHM, the full
      // address list) — identical on every rank, like the env seeds.
      state.tcp_context.shm_topology_possible());
  // Always-on closed loop (docs/AUTOTUNE.md): tuning defaults ON and
  // re-arms on every generation (this code path runs per elastic
  // re-init) plus on observed workload shifts. HVD_TPU_AUTOTUNE=0 — or
  // single-rank jobs, where every knob scores identically — opts out.
  if (EnvBool(HVD_TPU_AUTOTUNE, state.controller->size() > 1)) {
    state.parameter_manager.SetAutoTuning(true);
  }

  // Data-plane op registry: first Enabled() op per type executes. Ordered
  // most-specific first, CPU ring last, mirroring the reference's registry
  // construction (operations.cc:137-207). The device op comes first: a
  // response on GPU tensors goes to the binding's executor (NCCL on the
  // card) and never to the host ring.
  std::vector<std::shared_ptr<AllreduceOp>> allreduce_ops = {
      std::make_shared<DeviceAllreduce>(&state),
      std::make_shared<CpuHierarchicalAllreduce>(state.tcp_context, &state),
      std::make_shared<CpuRingAllreduce>(state.tcp_context, &state)};
  std::vector<std::shared_ptr<AllgatherOp>> allgather_ops = {
      std::make_shared<DeviceAllgather>(&state),
      std::make_shared<CpuHierarchicalAllgather>(state.tcp_context, &state),
      std::make_shared<CpuRingAllgather>(state.tcp_context, &state)};
  std::vector<std::shared_ptr<BroadcastOp>> broadcast_ops = {
      std::make_shared<DeviceBroadcast>(&state),
      std::make_shared<CpuBroadcast>(state.tcp_context, &state)};
  std::vector<std::shared_ptr<ReduceScatterOp>> reducescatter_ops = {
      std::make_shared<DeviceReduceScatter>(&state),
      std::make_shared<CpuHierarchicalReduceScatter>(state.tcp_context,
                                                     &state),
      std::make_shared<CpuRingReduceScatter>(state.tcp_context, &state)};
  state.op_manager = std::make_unique<OperationManager>(
      std::move(allreduce_ops), std::move(allgather_ops),
      std::move(broadcast_ops), std::move(reducescatter_ops),
      std::make_shared<ErrorOp>(&state));

  state.initialization_done.store(true);
  LOG(DEBUG) << "background loop starting";

  auto last_cycle_start = std::chrono::steady_clock::now();
  try {
    while (RunLoopOnce(state, last_cycle_start)) {
    }
  } catch (const ConnectionLostError& ex) {
    // A peer died mid-protocol. Recoverable: the process survives, and a
    // later shutdown()+init() joins the next elastic generation. Dump the
    // flight recorder first — on the coordinator the pending table names
    // the missing rank and the in-flight tensors.
    LOG(ERROR) << "peer connection lost: " << ex.what();
    state.connection_lost.store(true);
    std::string bundle = state.trace.DumpBundle(
        "connection_lost", state.controller->PendingNegotiationJson());
    if (!bundle.empty()) {
      LOG(ERROR) << "post-mortem bundle: " << bundle;
    }
  } catch (const std::exception& ex) {
    LOG(ERROR) << "background loop terminated: " << ex.what();
  }

  LOG(DEBUG) << "background loop shutting down";
  state.shut_down.store(true);
  const Status fail_status =
      state.connection_lost.load()
          ? Status::UnknownError(CONNECTION_LOST_ERROR)
          : Status::Aborted(SHUT_DOWN_ERROR);
  // Responses on GPU tensors that every rank negotiated run to their end
  // first: the peers' executors run them too, and would wait on this rank
  // in the collective.
  state.device_queue.Close(std::chrono::seconds(30));
  state.tensor_queue.FinalizeTensorQueue(fail_status);
  g_handles.FailAll(fail_status);
  state.timeline.Shutdown();
  // Drain the ring to the shard file; the drainer thread itself survives
  // the generation (process-lifetime singleton, like the metrics registry)
  // so an elastic re-init just re-Configures.
  state.trace.FlushShard();
  state.tcp_context.Finalize();
}

bool InitializeHorovodOnce() {
  std::lock_guard<std::mutex> lk(g_init_mutex);
  if (!g_state.initialize_flag.load()) {
    g_state.initialize_flag.store(true);
    g_state.shut_down.store(false);
    g_state.initialization_done.store(false);
    g_state.initialization_failed.store(false);
    g_state.background_thread =
        std::thread(BackgroundThreadLoop, std::ref(g_state));
  }
  while (!g_state.initialization_done.load()) {
    // Deliberately under g_init_mutex: the lock IS the once-guard —
    // a concurrent initializer must block until the first init fully
    // resolves (done or failed), and the background thread it waits
    // on never takes g_init_mutex, so this cannot deadlock.
    // lockorder: allow(blocking-call-under-lock)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  if (g_state.initialization_failed.load()) {
    // Leave the state re-initializable: reap the dead thread and clear
    // the flag so a later init() (e.g. with corrected env) can retry.
    if (g_state.background_thread.joinable()) {
      g_state.background_thread.join();
    }
    g_state.initialize_flag.store(false);
    return false;
  }
  return true;
}

Status EnqueueTensor(Request::RequestType type, const char* name,
                     const void* data, void* output, int ndim,
                     const int64_t* shape, int dtype, int root_rank,
                     double prescale, double postscale, int compression,
                     int group, int device, int handle) {
  if (!g_state.initialization_done.load() ||
      g_state.initialization_failed.load()) {
    return Status::PreconditionError("Horovod-TPU has not been initialized.");
  }
  if (g_state.shut_down.load()) {
    // After a peer loss the queue is closed but the condition is
    // recoverable — report it as such so callers roll back instead of
    // treating it like a requested shutdown.
    return g_state.connection_lost.load()
               ? Status::UnknownError(CONNECTION_LOST_ERROR)
               : Status::Aborted(SHUT_DOWN_ERROR);
  }
  // Group scoping (docs/GROUPS.md): validate HERE, on the calling
  // thread, so a scoping mistake surfaces as an immediate Python error
  // instead of a negotiation-time rejection (or a hang).
  uint64_t group_digest = 0;
  if (group < 0) {
    return Status::InvalidArgument("process group id must be >= 0");
  }
  if (group > 0) {
    int my_rank = g_state.controller->rank();
    if (g_state.group_table.Size(static_cast<uint32_t>(group)) == 0) {
      return Status::InvalidArgument(
          "unknown process group " + std::to_string(group) +
          "; create it with hvd.new_group(ranks) on EVERY rank first");
    }
    if (!g_state.group_table.Contains(static_cast<uint32_t>(group),
                                      my_rank)) {
      return Status::InvalidArgument(
          "rank " + std::to_string(my_rank) +
          " is not a member of process group " + std::to_string(group) +
          " " +
          g_state.group_table.DescribeMembers(
              static_cast<uint32_t>(group)) +
          "; only members may submit its collectives");
    }
    if (type == Request::BROADCAST &&
        !g_state.group_table.Contains(static_cast<uint32_t>(group),
                                      root_rank)) {
      return Status::InvalidArgument(
          "broadcast root rank " + std::to_string(root_rank) +
          " is not a member of process group " + std::to_string(group) +
          " " +
          g_state.group_table.DescribeMembers(
              static_cast<uint32_t>(group)));
    }
    group_digest = g_state.group_table.Digest(static_cast<uint32_t>(group));
  }
  TensorShape tensor_shape;
  for (int i = 0; i < ndim; ++i) tensor_shape.AddDim(shape[i]);

  // The EFFECTIVE mode enters negotiation: non-f32 payloads ride
  // uncompressed, computed identically on every rank from the dtype, so
  // a bf16 request for an int64 tensor cannot desync the ring.
  uint8_t effective = static_cast<uint8_t>(EffectiveCompression(
      static_cast<CompressionMode>(compression),
      static_cast<DataType>(dtype)));

  Request message;
  message.set_request_rank(g_state.controller->rank());
  message.set_request_type(type);
  message.set_tensor_name(name);
  message.set_tensor_type(static_cast<DataType>(dtype));
  message.set_tensor_shape(tensor_shape.dims());
  message.set_root_rank(root_rank);
  message.set_device(device < 0 ? HOST_DEVICE_ID : device);
  message.set_prescale_factor(prescale);
  message.set_postscale_factor(postscale);
  message.set_compression(effective);
  message.set_group_id(static_cast<uint32_t>(group));
  message.set_group_digest(group_digest);

  TensorTableEntry entry;
  entry.tensor_name = name;
  entry.data = data;
  entry.output = output;
  entry.dtype = static_cast<DataType>(dtype);
  entry.shape = tensor_shape;
  entry.root_rank = root_rank;
  entry.prescale_factor = prescale;
  entry.postscale_factor = postscale;
  entry.compression = effective;
  entry.group_id = static_cast<uint32_t>(group);
  entry.device = device < 0 ? HOST_DEVICE_ID : device;
  entry.handle = handle;
  entry.callback = [handle](const Status& status,
                            const TensorTableEntry& done_entry) {
    LOG(TRACE) << "done " << done_entry.tensor_name << " handle " << handle
               << " status " << static_cast<int>(status.type());
    g_handles.MarkDone(handle, status, done_entry.gathered,
                       done_entry.gathered_sizes);
  };
  LOG(TRACE) << "enqueue " << name << " handle " << handle;
  const int64_t payload_bytes = static_cast<int64_t>(entry.SizeBytes());
  Status status = g_state.tensor_queue.AddToTensorQueue(std::move(entry),
                                                        std::move(message));
  // Only ADMITTED calls enter the fingerprint: a rejected enqueue (e.g.
  // DUPLICATE_NAME while the prior async op is in flight) never reaches
  // negotiation, and counting it would diverge this rank's seq/digest
  // from peers on a protocol-consistent program.
  if (status.ok()) {
    // Group-qualified tracker name: the call fingerprint (and the
    // divergence reports built from it) must distinguish the same
    // tensor name used in different groups.
    g_state.call_tracker.Record(
        static_cast<uint8_t>(type), static_cast<uint8_t>(dtype), ndim,
        GroupQualifiedName(static_cast<uint32_t>(group), name));
    g_state.metrics.tensors_enqueued_total.fetch_add(
        1, std::memory_order_relaxed);
    Trace& trace = g_state.trace;
    if (trace.enabled()) {
      // Instant enqueue span + the open negotiation-wait span
      // PerformOperation closes when this tensor finally executes.
      const int64_t now = trace.NowNs();
      trace.Record(name, TRACE_ENQUEUE, now, now, payload_bytes,
                   static_cast<uint32_t>(group));
      trace.OpenSpan(GroupQualifiedName(static_cast<uint32_t>(group), name),
                     now);
    }
  }
  return status;
}

}  // namespace

}  // namespace hvdtpu

// ---------------- extern "C" API ----------------

using namespace hvdtpu;

extern "C" {

int horovod_tpu_init() { return InitializeHorovodOnce() ? 1 : 0; }

void horovod_tpu_request_shutdown() { g_state.shut_down.store(true); }

void horovod_tpu_shutdown() {
  std::lock_guard<std::mutex> lk(g_init_mutex);
  if (!g_state.initialize_flag.load()) return;
  g_state.shut_down.store(true);
  if (g_state.background_thread.joinable()) {
    g_state.background_thread.join();
  }
  g_state.initialize_flag.store(false);
  g_state.initialization_done.store(false);
}

int horovod_tpu_initialized() {
  return g_state.initialization_done.load() &&
                 !g_state.initialization_failed.load()
             ? 1
             : 0;
}

// True when the background loop died because a peer connection was lost
// (elastic-recoverable), as opposed to a requested shutdown. Python's
// elastic layer uses this to decide between rollback-and-reinit and a
// plain teardown.
int horovod_tpu_connection_lost() {
  return g_state.connection_lost.load() ? 1 : 0;
}

int horovod_tpu_rank() {
  return g_state.controller ? g_state.controller->rank() : -1;
}
int horovod_tpu_local_rank() {
  return g_state.controller ? g_state.controller->local_rank() : -1;
}
int horovod_tpu_cross_rank() {
  return g_state.controller ? g_state.controller->cross_rank() : -1;
}
int horovod_tpu_size() {
  return g_state.controller ? g_state.controller->size() : -1;
}
int horovod_tpu_local_size() {
  return g_state.controller ? g_state.controller->local_size() : -1;
}
int horovod_tpu_cross_size() {
  return g_state.controller ? g_state.controller->cross_size() : -1;
}
int horovod_tpu_is_homogeneous() {
  return g_state.controller && g_state.controller->is_homogeneous() ? 1 : 0;
}

// Build/capability probes (reference: horovod_mpi_built etc.).
int horovod_tpu_tcp_built() { return 1; }
int horovod_tpu_cpu_ops_built() { return 1; }
// The device op: responses on GPU tensors go to the binding's executor.
int horovod_tpu_device_op_built() { return 1; }

// Fusion diagnostics: executed responses vs tensors (tensors >
// responses means fusion grouped tensors into shared cycles), and the
// controller's effective (divisibility-rounded) fusion threshold.
void horovod_tpu_perf_counters(int64_t* responses, int64_t* tensors) {
  if (responses) *responses = g_state.responses_performed.load();
  if (tensors) *tensors = g_state.tensors_performed.load();
}
int64_t horovod_tpu_effective_fusion_threshold() {
  return g_state.controller
             ? g_state.controller->TensorFusionThresholdBytes()
             : -1;
}

// Protocol-level negotiation accounting: control-star bytes/messages
// this rank moved (12-byte frame headers included; data-plane ring
// traffic excluded; idle heartbeat cycles contribute bytes but not
// cycle counts) and work-cycle counts by kind. Measures the quantity
// the response cache exists to shrink — negotiation traffic —
// directly (reference design: response_cache.cc:308-409).
// out[0]=ctrl_bytes_sent out[1]=ctrl_bytes_recv out[2]=ctrl_msgs
// out[3]=cycles_fast     out[4]=cycles_full
void horovod_tpu_protocol_counters(uint64_t* out) {
  if (!out) return;
  out[0] = g_state.tcp_context.ctrl_bytes_sent();
  out[1] = g_state.tcp_context.ctrl_bytes_recv();
  out[2] = g_state.tcp_context.ctrl_msgs();
  out[3] = g_state.controller ? g_state.controller->cycles_fast() : 0;
  out[4] = g_state.controller ? g_state.controller->cycles_full() : 0;
}

// Live metrics snapshots (metrics.h / docs/METRICS.md). Callable from
// any thread at any time — before init, mid-run, after shutdown; the
// registry is a process singleton of atomics. thread_local storage so
// concurrent scrapers never share a buffer.
const char* horovod_tpu_metrics_json() {
  static thread_local std::string out;
  out = GlobalMetrics().SnapshotJson();
  return out.c_str();
}

// Rank 0's job-wide view: every rank's piggybacked summary + the
// per-rank announce-lag table (straggler identification). "{}" on
// non-coordinator ranks.
const char* horovod_tpu_job_metrics_json() {
  static thread_local std::string out;
  out = GlobalMetrics().JobJson();
  return out.c_str();
}

// Durable-checkpoint accounting (elastic/durable.py's writer thread
// reports through here so the ckpt_* counters ride the same registry,
// wire summaries, /job view, and hvd-top column as everything else).
// All arguments are DELTAS except last_step (absolute; < 0 = no
// update) and write_seconds (one histogram observation; < 0 = none).
// Relaxed atomics — safe from any thread, any time.
void horovod_tpu_ckpt_metrics(int64_t writes, int64_t failures,
                              int64_t bytes, int64_t restores,
                              int64_t restore_failures, int64_t last_step,
                              double write_seconds) {
  auto& m = GlobalMetrics();
  if (writes > 0) m.ckpt_writes_total.fetch_add(
      static_cast<uint64_t>(writes), std::memory_order_relaxed);
  if (failures > 0) m.ckpt_write_failures_total.fetch_add(
      static_cast<uint64_t>(failures), std::memory_order_relaxed);
  if (bytes > 0) m.ckpt_bytes_total.fetch_add(
      static_cast<uint64_t>(bytes), std::memory_order_relaxed);
  if (restores > 0) m.ckpt_restores_total.fetch_add(
      static_cast<uint64_t>(restores), std::memory_order_relaxed);
  if (restore_failures > 0) m.ckpt_restore_failures_total.fetch_add(
      static_cast<uint64_t>(restore_failures), std::memory_order_relaxed);
  if (last_step >= 0) {
    // Monotonic max: a late-finishing older write must not move the
    // gauge backwards past a newer one.
    int64_t cur = m.last_durable_step.load(std::memory_order_relaxed);
    while (last_step > cur &&
           !m.last_durable_step.compare_exchange_weak(
               cur, last_step, std::memory_order_relaxed)) {
    }
  }
  if (write_seconds >= 0.0) m.ckpt_write_seconds.Observe(write_seconds);
}

// Graceful-drain accounting (elastic/run.py's drain handler reports
// through here; docs/FLEET.md). `requested` is a delta; `draining` is
// the absolute posture gauge (1 = victim, 0 = survivor, < -1 is
// ignored so callers can update one without the other). Relaxed
// atomics — safe from any thread, any time.
void horovod_tpu_drain_metrics(int64_t requested, int64_t draining) {
  auto& m = GlobalMetrics();
  if (requested > 0) m.drains_requested_total.fetch_add(
      static_cast<uint64_t>(requested), std::memory_order_relaxed);
  if (draining >= -1) m.draining.store(draining, std::memory_order_relaxed);
  if (draining == 1) {
    // A drain victim is about to leave the job: preserve its evidence
    // window while the ring still holds the final cycles.
    GlobalTrace().DumpBundle("drain", std::string());
  }
}

// This rank's collective call-sequence fingerprint: seq = number of
// collectives enqueued since init, digest = rolling FNV-1a over each
// call's (op, dtype, shape-rank, name). Ranks that executed identical
// call sequences have identical (seq, digest) — the runtime divergence
// assertion (hvd.jax.assert_synchronized) compares them across ranks.
void horovod_tpu_call_digest(uint64_t* seq, uint64_t* digest) {
  g_state.call_tracker.Snapshot(seq, digest);
}

void horovod_tpu_protocol_counters_reset() {
  g_state.tcp_context.ResetProtocolCounters();
  if (g_state.controller) g_state.controller->ResetCycleCounters();
}

// BayesianOptimizer handle API: unit-tests the autotune math from
// Python (not part of the training path).
void* horovod_tpu_bo_create(double lo0, double hi0, double lo1, double hi1,
                            uint64_t seed) {
  return new BayesianOptimizer({{lo0, hi0}, {lo1, hi1}}, seed);
}
void horovod_tpu_bo_next(void* bo, double* out2) {
  auto next = static_cast<BayesianOptimizer*>(bo)->NextSample();
  out2[0] = next[0];
  out2[1] = next[1];
}
void horovod_tpu_bo_add(void* bo, const double* x2, double y) {
  static_cast<BayesianOptimizer*>(bo)->AddSample({x2[0], x2[1]}, y);
}
void horovod_tpu_bo_best(void* bo, double* out2, double* best_y) {
  auto* opt = static_cast<BayesianOptimizer*>(bo);
  auto best = opt->BestSample();
  out2[0] = best.size() > 0 ? best[0] : 0.0;
  out2[1] = best.size() > 1 ? best[1] : 0.0;
  *best_y = opt->BestValue();
}
void horovod_tpu_bo_destroy(void* bo) {
  delete static_cast<BayesianOptimizer*>(bo);
}

// Live closed-loop tuner state (docs/AUTOTUNE.md) as JSON — knobs,
// fixed flags, workload profile, re-arm counters, convergence baseline.
// Callable from any thread at any time (the manager is mutex-guarded);
// thread_local storage so concurrent scrapers never share a buffer.
const char* horovod_tpu_autotune_json() {
  static thread_local std::string out;
  out = g_state.parameter_manager.Json();
  return out.c_str();
}

// Autotune introspection (tests + diagnostics): current synchronized
// knob values and whether tuning is still active.
void horovod_tpu_autotune_params(double* fusion_mb, double* cycle_ms,
                                 int* cache_enabled, int* hier_allreduce,
                                 int* hier_allgather, int* active) {
  ParameterManager::Params p = g_state.parameter_manager.GetParams();
  if (fusion_mb) *fusion_mb = p.fusion_mb;
  if (cycle_ms) *cycle_ms = p.cycle_time_ms;
  if (cache_enabled) *cache_enabled = p.cache_enabled;
  if (hier_allreduce) *hier_allreduce = p.hierarchical_allreduce;
  if (hier_allgather) *hier_allgather = p.hierarchical_allgather;
  if (active) *active = p.active;
}

int horovod_tpu_enqueue_allreduce(const char* name, const void* data,
                                  void* output, int ndim, const int64_t* shape,
                                  int dtype, double prescale,
                                  double postscale, int compression) {
  int handle = g_handles.AllocateHandle();
  Status s = EnqueueTensor(Request::ALLREDUCE, name, data, output, ndim, shape,
                           dtype, 0, prescale, postscale, compression,
                           /*group=*/0, HOST_DEVICE_ID, handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

// ---------------- process groups (docs/GROUPS.md) ----------------

// Registers a process group over `ranks` (strictly ascending world
// ranks). COLLECTIVE BY CONVENTION: every rank — members and
// non-members alike — must call it with the identical list in the
// identical order; ids come from a per-process counter, so the same
// call sequence yields the same ids everywhere (mismatched membership
// is additionally rejected at negotiation via the group digest).
// Returns the group id (>= 1) or a negative error code.
int horovod_tpu_new_group(const int32_t* ranks, int nranks) {
  if (!g_state.initialization_done.load() ||
      g_state.initialization_failed.load() || !g_state.controller) {
    return -1;  // not initialized
  }
  if (ranks == nullptr || nranks <= 0) return -2;
  int world = g_state.controller->size();
  std::vector<int> members(ranks, ranks + nranks);
  for (int r : members) {
    if (r < 0 || r >= world) return -3;  // rank out of range
  }
  uint32_t id = g_state.group_table.Register(std::move(members));
  if (id == 0) return -4;  // not strictly ascending / duplicates
  GlobalMetrics().groups.store(
      static_cast<int64_t>(g_state.group_table.Count()),
      std::memory_order_relaxed);
  return static_cast<int>(id);
}

int horovod_tpu_group_size(int group) {
  if (group == 0) {
    return g_state.controller ? g_state.controller->size() : -1;
  }
  int n = g_state.group_table.Size(static_cast<uint32_t>(group));
  return n == 0 ? -1 : n;
}

// This rank's position in the group's ring order; -1 when not a member.
int horovod_tpu_group_rank(int group) {
  if (!g_state.controller) return -1;
  if (group == 0) return g_state.controller->rank();
  return g_state.group_table.IndexOf(static_cast<uint32_t>(group),
                                     g_state.controller->rank());
}

int horovod_tpu_group_count() {
  return static_cast<int>(g_state.group_table.Count());
}

// Enqueue in a process group (0: the world) on a device: `device` is
// HOST_DEVICE_ID (-1) for host memory or the tensor's CUDA ordinal. The
// device enters the request (validated across ranks, part of the cache
// key) and the entry (the device op takes it).
int horovod_tpu_enqueue_allreduce_grp(const char* name, const void* data,
                                      void* output, int ndim,
                                      const int64_t* shape, int dtype,
                                      double prescale, double postscale,
                                      int compression, int group,
                                      int device) {
  int handle = g_handles.AllocateHandle();
  Status s = EnqueueTensor(Request::ALLREDUCE, name, data, output, ndim,
                           shape, dtype, 0, prescale, postscale, compression,
                           group, device, handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

int horovod_tpu_enqueue_reduce_scatter_grp(const char* name,
                                           const void* data, void* output,
                                           int ndim, const int64_t* shape,
                                           int dtype, double prescale,
                                           double postscale, int compression,
                                           int group, int device) {
  int handle = g_handles.AllocateHandle();
  Status s = EnqueueTensor(Request::REDUCESCATTER, name, data, output, ndim,
                           shape, dtype, 0, prescale, postscale, compression,
                           group, device, handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

int horovod_tpu_enqueue_allgather_grp(const char* name, const void* data,
                                      int ndim, const int64_t* shape,
                                      int dtype, int group, int device) {
  int handle = g_handles.AllocateHandle();
  Status s = EnqueueTensor(Request::ALLGATHER, name, data, nullptr, ndim,
                           shape, dtype, 0, 1.0, 1.0, 0, group, device,
                           handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

int horovod_tpu_enqueue_broadcast_grp(const char* name, const void* data,
                                      void* output, int ndim,
                                      const int64_t* shape, int dtype,
                                      int root_rank, int group,
                                      int device) {
  int handle = g_handles.AllocateHandle();
  Status s = EnqueueTensor(Request::BROADCAST, name, data, output, ndim,
                           shape, dtype, root_rank, 1.0, 1.0, 0, group,
                           device, handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

// Compression-mode helpers for the Python binding: parse the canonical
// spelling ("none"/"bf16"/"int8"; numeric strings accepted) and expose
// the mode a given dtype would actually ride the wire with.
int horovod_tpu_parse_compression(const char* s) {
  return static_cast<int>(ParseCompressionMode(s));
}
// The HVD_TPU_COMPRESSION job default, for bindings without their own
// per-call compression plumbing (tf_ops.cc, torch_cext.c). Read fresh
// each call — negotiation validates it cross-rank anyway.
int horovod_tpu_default_compression() {
  return static_cast<int>(
      ParseCompressionMode(std::getenv(HVD_TPU_COMPRESSION_ENV)));
}
int horovod_tpu_effective_compression(int compression, int dtype) {
  return static_cast<int>(
      EffectiveCompression(static_cast<CompressionMode>(compression),
                           static_cast<DataType>(dtype)));
}
// Wire bytes `count` f32 elements occupy under `compression`
// (compression.cc layout — tests pin the size math against this).
int64_t horovod_tpu_compressed_size(int64_t count, int compression) {
  return static_cast<int64_t>(CompressedSize(
      count, static_cast<CompressionMode>(compression)));
}

// Reduce-scatter enqueue (docs/ZERO.md): `output` must hold this rank's
// shard — PartitionChunks over the flattened element count (chunk r to
// rank r; Python mirrors the math in common/ops.py shard_partition).
// Compression rides the negotiation exactly like allreduce.
int horovod_tpu_enqueue_reduce_scatter(const char* name, const void* data,
                                       void* output, int ndim,
                                       const int64_t* shape, int dtype,
                                       double prescale, double postscale,
                                       int compression) {
  int handle = g_handles.AllocateHandle();
  Status s = EnqueueTensor(Request::REDUCESCATTER, name, data, output, ndim,
                           shape, dtype, 0, prescale, postscale, compression,
                           /*group=*/0, HOST_DEVICE_ID, handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

// The HVD_TPU_SHARDED_UPDATE job default, read fresh each call (the
// negotiation validates the mode cross-rank anyway).
int horovod_tpu_sharded_update_default() {
  const char* v = std::getenv(HVD_TPU_SHARDED_UPDATE_ENV);
  return v != nullptr && std::strtol(v, nullptr, 10) != 0 ? 1 : 0;
}

// Sharded-optimizer accounting (docs/ZERO.md): the absolute number of
// optimizer-state bytes this rank holds (gauge; < 0 leaves it
// unchanged). Reported by the framework wrappers on init and resize so
// the memory claim is observable (hvd-top, bench A/B).
void horovod_tpu_opt_state_metrics(int64_t bytes) {
  if (bytes >= 0) {
    GlobalMetrics().opt_state_bytes.store(bytes, std::memory_order_relaxed);
  }
}

int horovod_tpu_enqueue_allgather(const char* name, const void* data, int ndim,
                                  const int64_t* shape, int dtype) {
  int handle = g_handles.AllocateHandle();
  // The op writes the gathered result into core-owned buffers; the entry
  // callback surfaces them through the handle for copy-out.
  Status s = EnqueueTensor(Request::ALLGATHER, name, data, nullptr, ndim,
                           shape, dtype, 0, 1.0, 1.0, 0, /*group=*/0,
                           HOST_DEVICE_ID, handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

int horovod_tpu_enqueue_broadcast(const char* name, const void* data,
                                  void* output, int ndim, const int64_t* shape,
                                  int dtype, int root_rank) {
  int handle = g_handles.AllocateHandle();
  Status s = EnqueueTensor(Request::BROADCAST, name, data, output, ndim, shape,
                           dtype, root_rank, 1.0, 1.0, 0, /*group=*/0,
                           HOST_DEVICE_ID, handle);
  if (!s.ok()) {
    g_handles.MarkDone(handle, s);
  }
  return handle;
}

// ---------------- CUDA tensors (the device op) ----------------

// The executor's side of the device op. It blocks here, outside the GIL,
// for the next handed-off response: its id, 0 after timeout_ms with none,
// -1 once the core has stopped (and nothing is left).
int64_t horovod_tpu_device_next(int timeout_ms) {
  return g_state.device_queue.Next(timeout_ms);
}

// A taken response: out[0] response type (message.h), [1] dtype, [2]
// entries, [3] broadcast root (a world rank), [4] compression mode, [5]
// group id, [6] allgather sizes (one a member), [7] the first entry's
// device. 0 for an unknown id.
int horovod_tpu_device_work_info(int64_t id, int64_t* out) {
  auto work = g_state.device_queue.Get(id);
  if (work == nullptr || work->entries.empty()) return 0;
  const TensorTableEntry& first = work->entries[0];
  out[0] = static_cast<int64_t>(work->response.response_type());
  out[1] = static_cast<int64_t>(first.dtype);
  out[2] = static_cast<int64_t>(work->entries.size());
  out[3] = first.root_rank;
  out[4] = work->response.compression();
  out[5] = work->response.group_id();
  out[6] = static_cast<int64_t>(work->response.tensor_sizes().size());
  out[7] = first.device;
  return 1;
}

// Entry i of a taken response, in the coordinator's order: ids[0] its
// handle, ids[1] its element count; scales[0] prescale, [1] postscale.
int horovod_tpu_device_work_entry(int64_t id, int i, int64_t* ids,
                                  double* scales) {
  auto work = g_state.device_queue.Get(id);
  if (work == nullptr || i < 0 ||
      i >= static_cast<int>(work->entries.size())) {
    return 0;
  }
  const TensorTableEntry& e = work->entries[i];
  ids[0] = e.handle;
  ids[1] = e.NumElements();
  scales[0] = e.prescale_factor;
  scales[1] = e.postscale_factor;
  return 1;
}

// An allgather's first dimensions, one a member in group order.
int horovod_tpu_device_work_sizes(int64_t id, int64_t* out) {
  auto work = g_state.device_queue.Get(id);
  if (work == nullptr) return 0;
  const auto& sizes = work->response.tensor_sizes();
  std::copy(sizes.begin(), sizes.end(), out);
  return 1;
}

// Completes every entry of a taken response: status 0 once the device
// has finished writing the results, else an error carrying `message` on
// every handle. 0 for an unknown id.
int horovod_tpu_device_done(int64_t id, int status, const char* message) {
  auto work = g_state.device_queue.Take(id);
  if (work == nullptr) return 0;
  Status s = status == 0
                 ? Status::OK()
                 : Status::UnknownError(
                       message != nullptr && message[0] != '\0'
                           ? message
                           : "the device collective failed");
  for (auto& e : work->entries) {
    if (e.callback) e.callback(s, e);
  }
  g_state.device_queue.Finished();
  return 1;
}

int horovod_tpu_poll(int handle) { return g_handles.Poll(handle) ? 1 : 0; }

int horovod_tpu_wait(int handle) {
  auto entry = g_handles.Wait(handle);
  if (entry == nullptr) return static_cast<int>(StatusType::INVALID_ARGUMENT);
  return static_cast<int>(entry->status.type());
}

const char* horovod_tpu_error_string(int handle) {
  static thread_local std::string err;
  auto entry = g_handles.Get(handle);
  err = entry ? entry->status.reason() : "unknown handle";
  return err.c_str();
}

int64_t horovod_tpu_allgather_bytes(int handle) {
  auto entry = g_handles.Get(handle);
  if (entry == nullptr || entry->gathered == nullptr) return -1;
  return static_cast<int64_t>(entry->gathered->size());
}

int64_t horovod_tpu_allgather_rank_dim(int handle, int rank) {
  auto entry = g_handles.Get(handle);
  if (entry == nullptr || entry->gathered_sizes == nullptr ||
      rank >= static_cast<int>(entry->gathered_sizes->size())) {
    return -1;
  }
  return (*entry->gathered_sizes)[rank];
}

int horovod_tpu_allgather_copy(int handle, void* out) {
  auto entry = g_handles.Get(handle);
  if (entry == nullptr || entry->gathered == nullptr) return 0;
  std::memcpy(out, entry->gathered->data(), entry->gathered->size());
  return 1;
}

// Zero-copy access: the returned pointer stays valid until
// horovod_tpu_release(handle) (the Python side wraps it in a numpy view
// whose finalizer performs the release).
const void* horovod_tpu_allgather_data(int handle) {
  auto entry = g_handles.Get(handle);
  if (entry == nullptr || entry->gathered == nullptr) return nullptr;
  return entry->gathered->data();
}

void horovod_tpu_release(int handle) { g_handles.Release(handle); }

// ---------------- distributed tracing (trace.h / docs/TRACING.md) ------

// Monotonic trace-clock ns (per-process epoch): Python-emitted spans land
// on the same clock the native ring uses.
int64_t horovod_tpu_trace_now_ns() { return GlobalTrace().NowNs(); }

// Record a span from Python (serve plane, tests). `phase` takes the wire
// values from trace.h (TRACE_ENQUEUE..TRACE_REQUEST); group 0 = world.
// No-op until init configures the recorder or when HVD_TPU_TRACE=0.
void horovod_tpu_trace_record(const char* name, int phase, int64_t start_ns,
                              int64_t end_ns, int64_t bytes, int group) {
  GlobalTrace().Record(name == nullptr ? "" : name, phase, start_ns, end_ns,
                       bytes, group < 0 ? 0u : static_cast<uint32_t>(group));
}

// Force a flight-recorder bundle (drain handlers, tests). Returns the
// bundle path, or "" when HVD_TPU_BUNDLE_DIR is unset / the per-process
// cap is hit. Pending-negotiation state is deliberately omitted: this is
// callable from any thread, and the controller's tables belong to the
// background thread.
const char* horovod_tpu_trace_dump_bundle(const char* reason) {
  static thread_local std::string out;
  out = GlobalTrace().DumpBundle(reason == nullptr ? "manual" : reason,
                                 std::string());
  return out.c_str();
}

// out[0]=spans recorded  out[1]=spans dropped (ring overrun)  out[2]=bundles
void horovod_tpu_trace_counters(uint64_t* out) {
  if (out == nullptr) return;
  Trace& t = GlobalTrace();
  out[0] = t.spans_total.load(std::memory_order_relaxed);
  out[1] = t.spans_dropped.load(std::memory_order_relaxed);
  out[2] = t.bundles_written.load(std::memory_order_relaxed);
}

}  // extern "C"
