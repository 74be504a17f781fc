// Core shared types for the TPU-native runtime: Status, TensorShape,
// TensorTableEntry, and well-known constants.
//
// Capability parity with the reference core types (/root/reference
// horovod/common/common.h:95-244), redesigned for a host-buffer data path:
// the C API hands the core raw host pointers (NumPy / dlpack-exported
// buffers); completion is handle-based (HandleManager) rather than
// callback-based so no foreign thread ever has to re-enter Python.
#ifndef HVD_TPU_COMMON_H
#define HVD_TPU_COMMON_H

#include <cstdint>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "message.h"

namespace hvdtpu {

// Well-known env vars (runtime knobs; see SURVEY.md §5.6 for the reference's
// canonical list in horovod/common/common.h:60-84).
#define HVD_TPU_FUSION_THRESHOLD "HVD_TPU_FUSION_THRESHOLD"
#define HVD_TPU_CYCLE_TIME "HVD_TPU_CYCLE_TIME"
#define HVD_TPU_CACHE_CAPACITY "HVD_TPU_CACHE_CAPACITY"
#define HVD_TPU_TIMELINE "HVD_TPU_TIMELINE"
#define HVD_TPU_TIMELINE_MARK_CYCLES "HVD_TPU_TIMELINE_MARK_CYCLES"
#define HVD_TPU_AUTOTUNE "HVD_TPU_AUTOTUNE"
#define HVD_TPU_AUTOTUNE_LOG "HVD_TPU_AUTOTUNE_LOG"
#define HVD_TPU_STALL_CHECK_TIME "HVD_TPU_STALL_CHECK_TIME_SECONDS"
#define HVD_TPU_STALL_SHUTDOWN_TIME "HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS"
#define HVD_TPU_DIVERGENCE_CALLS "HVD_TPU_DIVERGENCE_CALLS"
#define HVD_TPU_DIVERGENCE_GRACE "HVD_TPU_DIVERGENCE_GRACE_SECONDS"
#define HVD_TPU_HIERARCHICAL_ALLREDUCE "HVD_TPU_HIERARCHICAL_ALLREDUCE"
#define HVD_TPU_HIERARCHICAL_ALLGATHER "HVD_TPU_HIERARCHICAL_ALLGATHER"
#define HVD_TPU_HIERARCHICAL_REDUCESCATTER "HVD_TPU_HIERARCHICAL_REDUCESCATTER"
// Pipelined ring transport (docs/AUTOTUNE.md): slice every ring hop's
// payload into segments of this many bytes with double-buffered
// send/recv so encode, transport, and ReduceSum overlap within the hop.
// 0 disables slicing; unset leaves the knob to the autotuner.
#define HVD_TPU_PIPELINE_CHUNK_BYTES "HVD_TPU_PIPELINE_CHUNK_BYTES"
// Metrics plane (metrics.h / docs/METRICS.md): HVD_TPU_METRICS=1 turns on
// the wire piggyback + coordinator job view without HTTP serving;
// HVD_TPU_METRICS_PORT additionally makes Python serve Prometheus text at
// port+rank. SYNC bounds how often per-rank summaries ride the wire.
#define HVD_TPU_METRICS "HVD_TPU_METRICS"
#define HVD_TPU_METRICS_PORT "HVD_TPU_METRICS_PORT"
#define HVD_TPU_METRICS_SYNC "HVD_TPU_METRICS_SYNC_SECONDS"
#define HVD_TPU_GENERATION_ENV "HVD_TPU_GENERATION"
// Chaos-hardened transport knobs (net.cc / tcp_context.cc / fault.cc;
// docs/CHAOS.md): frame checksums are on by default (NET_CRC=0 disables,
// job-wide); NET_TIMEOUT bounds every blocking send/recv (default: the
// control poll window, 60 s); KEEPALIVE detects powered-off hosts in
// ~2*idle seconds (0 disables); MAX_FRAME_BYTES bounds a single frame
// allocation (default 1 GiB); RECONNECT_SECONDS is the window a broken
// worker->coordinator control connection may take to resume with capped
// exponential backoff (0 disables reconnect); FAULT_SPEC arms the
// deterministic fault injector (never set it on a production job).
#define HVD_TPU_NET_CRC_ENV "HVD_TPU_NET_CRC"
#define HVD_TPU_NET_TIMEOUT_ENV "HVD_TPU_NET_TIMEOUT_SECONDS"
#define HVD_TPU_NET_KEEPALIVE_ENV "HVD_TPU_NET_KEEPALIVE_SECONDS"
#define HVD_TPU_MAX_FRAME_BYTES_ENV "HVD_TPU_MAX_FRAME_BYTES"
#define HVD_TPU_RECONNECT_ENV "HVD_TPU_RECONNECT_SECONDS"
#define HVD_TPU_FAULT_SPEC_ENV "HVD_TPU_FAULT_SPEC"
// Wire-compression default for host-plane allreduces (compression.h /
// docs/COMPRESSION.md): "none" (default), "bf16", or "int8". Per-call
// compression= arguments override it; Python resolves the env once per
// call so the mode rides the Request and is validated cross-rank.
#define HVD_TPU_COMPRESSION_ENV "HVD_TPU_COMPRESSION"
// Job-wide sharded-weight-update default (docs/ZERO.md): "1" makes
// DistributedOptimizer wrappers that were not given an explicit
// sharded_update= argument reduce-scatter gradients and shard optimizer
// state 1/N per rank. Per-call arguments override it; negotiation
// validates the mode cross-rank (mixed sharded/replicated ranks are
// rejected by name, like mixed compression).
#define HVD_TPU_SHARDED_UPDATE_ENV "HVD_TPU_SHARDED_UPDATE"

enum class StatusType : int32_t {
  OK = 0,
  UNKNOWN_ERROR = 1,
  PRECONDITION_ERROR = 2,
  ABORTED = 3,
  INVALID_ARGUMENT = 4,
  IN_PROGRESS = 5,
};

// Device id for host-memory tensors. Any other id is a CUDA ordinal: the
// device op (collective_operations.h) hands such a response to the
// binding's executor, which runs it on the card; the CPU ops never touch
// device memory.
constexpr int32_t HOST_DEVICE_ID = -1;

extern const std::string SHUT_DOWN_ERROR;
extern const std::string DUPLICATE_NAME_ERROR;
extern const std::string CONNECTION_LOST_ERROR;

// Shared env parsing (single definition so every consumer agrees on
// strtoll/strtod semantics). `present`, when non-null, reports whether
// the variable was set at all — the autotuner treats an env-present
// knob as FIXED (excluded from the search).
int64_t EnvInt64(const char* name, int64_t dflt, bool* present = nullptr);
double EnvDouble(const char* name, double dflt, bool* present = nullptr);
bool EnvBool(const char* name, bool dflt, bool* present = nullptr);

class Status {
 public:
  Status() = default;
  static Status OK() { return Status(); }
  static Status UnknownError(const std::string& msg) {
    return Status(StatusType::UNKNOWN_ERROR, msg);
  }
  static Status PreconditionError(const std::string& msg) {
    return Status(StatusType::PRECONDITION_ERROR, msg);
  }
  static Status Aborted(const std::string& msg) {
    return Status(StatusType::ABORTED, msg);
  }
  static Status InvalidArgument(const std::string& msg) {
    return Status(StatusType::INVALID_ARGUMENT, msg);
  }
  static Status InProgress() { return Status(StatusType::IN_PROGRESS, ""); }

  bool ok() const { return type_ == StatusType::OK; }
  bool in_progress() const { return type_ == StatusType::IN_PROGRESS; }
  StatusType type() const { return type_; }
  const std::string& reason() const { return reason_; }

 private:
  Status(StatusType type, std::string reason)
      : type_(type), reason_(std::move(reason)) {}
  StatusType type_ = StatusType::OK;
  std::string reason_;
};

class TensorShape {
 public:
  TensorShape() = default;
  explicit TensorShape(std::vector<int64_t> dims) : dims_(std::move(dims)) {}
  void AddDim(int64_t d) { dims_.push_back(d); }
  int ndims() const { return static_cast<int>(dims_.size()); }
  int64_t dim_size(int i) const { return dims_[i]; }
  const std::vector<int64_t>& dims() const { return dims_; }
  int64_t num_elements() const {
    int64_t n = 1;
    for (auto d : dims_) n *= d;
    return n;
  }
  bool operator==(const TensorShape& o) const { return dims_ == o.dims_; }
  bool operator!=(const TensorShape& o) const { return dims_ != o.dims_; }
  std::string DebugString() const;

 private:
  std::vector<int64_t> dims_;
};

struct TensorTableEntry;
// Completion callback: receives the final status and the executed entry
// (whose `gathered` buffers carry allgather results).
using StatusCallback =
    std::function<void(const Status&, const TensorTableEntry&)>;

// One queued collective on one rank. `data` is the caller-owned input
// buffer, `output` the caller-owned output buffer (may alias `data` for
// in-place ops). For allgather the output buffer is allocated lazily by the
// caller after negotiation reports the gathered first-dim sizes — the core
// writes the result into `gathered` storage it owns, which the C API then
// exposes for copy-out (see operations.cc).
struct TensorTableEntry {
  std::string tensor_name;
  const void* data = nullptr;
  void* output = nullptr;
  DataType dtype = DataType::HVD_FLOAT32;
  TensorShape shape;
  int32_t device = HOST_DEVICE_ID;
  int32_t root_rank = 0;
  double prescale_factor = 1.0;
  double postscale_factor = 1.0;
  // Effective wire-compression mode (compression.h CompressionMode as
  // u8; already dtype-filtered at enqueue).
  uint8_t compression = 0;
  // Process group the collective is scoped to (group_table.h; 0 =
  // world). Responses only claim entries of their own group, so the
  // same tensor name active in two groups at once never cross-executes.
  uint32_t group_id = 0;
  // The C API's handle of this entry: the device op's executor finds the
  // caller's tensors by it.
  int32_t handle = -1;
  // Allgather result storage (core-owned) — set after execution.
  std::shared_ptr<std::vector<char>> gathered;
  std::shared_ptr<std::vector<int64_t>> gathered_sizes;
  StatusCallback callback;

  int64_t NumElements() const { return shape.num_elements(); }
  std::size_t SizeBytes() const {
    return static_cast<std::size_t>(NumElements()) * DataTypeSize(dtype);
  }
};

}  // namespace hvdtpu

#endif  // HVD_TPU_COMMON_H
