// Process-wide singleton state for the coordination runtime: the background
// thread, its components, and the knobs they share.
// Capability parity with /root/reference horovod/common/global_state.h.
#ifndef HVD_TPU_GLOBAL_STATE_H
#define HVD_TPU_GLOBAL_STATE_H

#include <atomic>
#include <cstdint>
#include <memory>
#include <thread>

#include "collective_operations.h"
#include "divergence.h"
#include "fusion_buffer_manager.h"
#include "group_table.h"
#include "metrics.h"
#include "parameter_manager.h"
#include "response_cache.h"
#include "tcp_context.h"
#include "tensor_queue.h"
#include "timeline.h"
#include "trace.h"

namespace hvdtpu {

class Controller;

struct HorovodGlobalState {
  // Background coordination thread (the only thread that talks cross-rank).
  std::thread background_thread;
  std::atomic<bool> initialize_flag{false};
  std::atomic<bool> initialization_done{false};
  std::atomic<bool> initialization_failed{false};
  std::atomic<bool> shut_down{false};
  // Set when the background loop died because a peer connection was lost
  // (vs a requested shutdown) — outstanding and future work then fails
  // with the recoverable CONNECTION_LOST_ERROR so Python can roll back
  // and re-initialize (elastic recovery).
  std::atomic<bool> connection_lost{false};

  // Fusion diagnostics (see PerformOperation).
  std::atomic<int64_t> responses_performed{0};
  std::atomic<int64_t> tensors_performed{0};

  TcpContext tcp_context;
  TensorQueue tensor_queue;
  Timeline timeline;
  bool mark_cycles_in_timeline = false;
  ParameterManager parameter_manager;
  ResponseCache response_cache;
  // Every rank's collective call sequence (seq / rolling digest / recent
  // ring) — fed by EnqueueTensor, cross-checked by the coordinator's
  // DivergenceDetector and exposed to Python via horovod_tpu_call_digest.
  CallTracker call_tracker;
  // Process-group registry (docs/GROUPS.md): written by
  // horovod_tpu_new_group on API threads, read by the controller and
  // the data-plane ops on the background thread; mutex inside.
  GroupTable group_table;
  FusionBufferManager fusion_buffer;
  // Live metrics registry (metrics.h). A reference to the process
  // singleton: leaf components without a state pointer (stall inspector,
  // the C snapshot API) reach the same registry via GlobalMetrics().
  Metrics& metrics = GlobalMetrics();
  // Always-on span recorder + flight recorder (trace.h). Same singleton
  // pattern as metrics: leaf components reach it via GlobalTrace().
  Trace& trace = GlobalTrace();
  std::unique_ptr<Controller> controller;
  std::unique_ptr<OperationManager> op_manager;
  // Responses on GPU tensors handed to the binding's executor (the
  // device op, collective_operations.h).
  DeviceQueue device_queue;

  ~HorovodGlobalState();
};

}  // namespace hvdtpu

#endif  // HVD_TPU_GLOBAL_STATE_H
