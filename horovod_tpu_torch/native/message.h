// In-memory control-plane message model: Request / RequestList / Response /
// ResponseList plus the DataType enum, with a compact length-prefixed binary
// wire format (no flatbuffers dependency).
//
// Capability parity with the reference message model (/root/reference
// horovod/common/message.{h,cc} and wire/message.fbs); the wire format here is
// a fresh TPU-build design: little-endian, varint-free, length-prefixed.
#ifndef HVD_TPU_MESSAGE_H
#define HVD_TPU_MESSAGE_H

#include <cstdint>
#include <string>
#include <vector>

namespace hvdtpu {

enum class DataType : uint8_t {
  HVD_UINT8 = 0,
  HVD_INT8 = 1,
  HVD_UINT16 = 2,
  HVD_INT16 = 3,
  HVD_INT32 = 4,
  HVD_INT64 = 5,
  HVD_FLOAT16 = 6,
  HVD_FLOAT32 = 7,
  HVD_FLOAT64 = 8,
  HVD_BOOL = 9,
  HVD_BFLOAT16 = 10,
};

const char* DataTypeName(DataType dt);
std::size_t DataTypeSize(DataType dt);

// A Request is one rank announcing "tensor <name> is ready on my side".
class Request {
 public:
  enum RequestType : uint8_t {
    ALLREDUCE = 0,
    ALLGATHER = 1,
    BROADCAST = 2,
    // Sharded weight update (docs/ZERO.md): the reduce-scatter leg of the
    // ring as a first-class negotiated op — each rank receives its own
    // 1/N shard of the summed tensor instead of the full result.
    REDUCESCATTER = 3,
  };

  static const char* RequestTypeName(RequestType t);

  int32_t request_rank() const { return request_rank_; }
  void set_request_rank(int32_t rank) { request_rank_ = rank; }

  RequestType request_type() const { return request_type_; }
  void set_request_type(RequestType t) { request_type_ = t; }

  DataType tensor_type() const { return tensor_type_; }
  void set_tensor_type(DataType dt) { tensor_type_ = dt; }

  const std::string& tensor_name() const { return tensor_name_; }
  void set_tensor_name(const std::string& name) { tensor_name_ = name; }

  int32_t root_rank() const { return root_rank_; }
  void set_root_rank(int32_t r) { root_rank_ = r; }

  int32_t device() const { return device_; }
  void set_device(int32_t d) { device_ = d; }

  const std::vector<int64_t>& tensor_shape() const { return tensor_shape_; }
  void set_tensor_shape(const std::vector<int64_t>& s) { tensor_shape_ = s; }
  void add_tensor_shape(int64_t dim) { tensor_shape_.push_back(dim); }

  // Prescale/postscale factors fold averaging into the collective.
  double prescale_factor() const { return prescale_factor_; }
  void set_prescale_factor(double f) { prescale_factor_ = f; }
  double postscale_factor() const { return postscale_factor_; }
  void set_postscale_factor(double f) { postscale_factor_ = f; }

  // Wire-compression mode (compression.h CompressionMode as u8). Part of
  // the negotiated contract: the coordinator rejects mixed-mode ranks by
  // name, and the response cache treats a mode change as a miss.
  uint8_t compression() const { return compression_; }
  void set_compression(uint8_t c) { compression_ = c; }

  // Process group this collective is scoped to (group_table.h; 0 = the
  // world). The coordinator counts readiness against the GROUP's member
  // set, the response cache keys on it, and the executing op rides the
  // group's ring. group_digest is the sender's membership digest for the
  // id — the coordinator rejects mixed-membership groups by name.
  uint32_t group_id() const { return group_id_; }
  void set_group_id(uint32_t g) { group_id_ = g; }
  uint64_t group_digest() const { return group_digest_; }
  void set_group_digest(uint64_t d) { group_digest_ = d; }

  void SerializeTo(std::string* out) const;
  // Returns bytes consumed, 0 on error.
  std::size_t ParseFrom(const char* data, std::size_t len);

 private:
  int32_t request_rank_ = 0;
  RequestType request_type_ = ALLREDUCE;
  DataType tensor_type_ = DataType::HVD_FLOAT32;
  int32_t root_rank_ = 0;
  int32_t device_ = -1;  // -1 == host
  std::string tensor_name_;
  std::vector<int64_t> tensor_shape_;
  double prescale_factor_ = 1.0;
  double postscale_factor_ = 1.0;
  uint8_t compression_ = 0;  // CompressionMode::NONE
  uint32_t group_id_ = 0;    // 0 = world
  uint64_t group_digest_ = 0;
};

// One entry of a rank's collective call history (divergence.h): enough to
// name the call site in a cross-rank divergence report without shipping
// the full Request.
struct CallRecord {
  uint64_t seq = 0;   // 1-based position in the rank's call sequence
  uint8_t op = 0;     // Request::RequestType
  uint8_t dtype = 0;  // DataType
  uint8_t ndim = 0;   // shape rank
  std::string name;
};

class RequestList {
 public:
  const std::vector<Request>& requests() const { return requests_; }
  void add_request(const Request& r) { requests_.push_back(r); }

  bool shutdown() const { return shutdown_; }
  void set_shutdown(bool v) { shutdown_ = v; }

  // Divergence-tracker piggyback (divergence.h): the sending rank's call
  // sequence position, rolling digest, and records since its last report.
  uint64_t call_seq() const { return call_seq_; }
  void set_call_seq(uint64_t v) { call_seq_ = v; }
  uint64_t call_digest() const { return call_digest_; }
  void set_call_digest(uint64_t v) { call_digest_ = v; }
  const std::vector<CallRecord>& recent_calls() const {
    return recent_calls_;
  }
  void set_recent_calls(std::vector<CallRecord> v) {
    recent_calls_ = std::move(v);
  }

  // Metrics-plane piggyback (metrics.h, SummaryField order): the sending
  // rank's compact counter summary. Empty when the metrics plane is off
  // or the attach interval hasn't elapsed — the wire carries one extra
  // u32 (count 0) then, nothing more.
  const std::vector<double>& metrics_summary() const {
    return metrics_summary_;
  }
  void set_metrics_summary(std::vector<double> v) {
    metrics_summary_ = std::move(v);
  }

  void SerializeTo(std::string* out) const;
  bool ParseFrom(const char* data, std::size_t len);

 private:
  std::vector<Request> requests_;
  bool shutdown_ = false;
  uint64_t call_seq_ = 0;
  uint64_t call_digest_ = 0;
  std::vector<CallRecord> recent_calls_;
  std::vector<double> metrics_summary_;
};

// A Response is the coordinator's verdict: do this (possibly fused) op now,
// or report an error for these tensors.
class Response {
 public:
  enum ResponseType : uint8_t {
    ALLREDUCE = 0,
    ALLGATHER = 1,
    BROADCAST = 2,
    ERROR = 3,
    // Appended after ERROR so pre-sharded decoders keep their numbering.
    REDUCESCATTER = 4,
  };

  static const char* ResponseTypeName(ResponseType t);

  ResponseType response_type() const { return response_type_; }
  void set_response_type(ResponseType t) { response_type_ = t; }

  const std::vector<std::string>& tensor_names() const { return tensor_names_; }
  std::vector<std::string>& mutable_tensor_names() { return tensor_names_; }
  void add_tensor_name(const std::string& n) { tensor_names_.push_back(n); }
  std::string tensor_names_string() const;

  const std::string& error_message() const { return error_message_; }
  void set_error_message(const std::string& m) { error_message_ = m; }

  DataType tensor_type() const { return tensor_type_; }
  void set_tensor_type(DataType dt) { tensor_type_ = dt; }

  // For allgather: first-dimension size contributed by every rank.
  const std::vector<int64_t>& tensor_sizes() const { return tensor_sizes_; }
  void set_tensor_sizes(const std::vector<int64_t>& s) { tensor_sizes_ = s; }
  void add_tensor_size(int64_t s) { tensor_sizes_.push_back(s); }

  int32_t devices() const { return devices_; }
  void set_devices(int32_t d) { devices_ = d; }

  // Negotiated wire-compression mode the executing ops apply per hop
  // (compression.h). Fusion only merges same-mode responses.
  uint8_t compression() const { return compression_; }
  void set_compression(uint8_t c) { compression_ = c; }

  // Process group scope (0 = world). Executing ranks ride the group's
  // ring; ranks outside the group skip the response (no table entry)
  // but still mirror it into their response cache so cache bits stay
  // rank-identical (response_cache.h). Fusion only merges same-group
  // responses.
  uint32_t group_id() const { return group_id_; }
  void set_group_id(uint32_t g) { group_id_ = g; }

  void SerializeTo(std::string* out) const;
  std::size_t ParseFrom(const char* data, std::size_t len);

 private:
  ResponseType response_type_ = ALLREDUCE;
  std::vector<std::string> tensor_names_;
  std::string error_message_;
  std::vector<int64_t> tensor_sizes_;
  DataType tensor_type_ = DataType::HVD_FLOAT32;
  int32_t devices_ = -1;
  uint8_t compression_ = 0;  // CompressionMode::NONE
  uint32_t group_id_ = 0;    // 0 = world
};

class ResponseList {
 public:
  // Autotune bootstrap word: (rearm_epoch << 8) | profile bits, attached
  // by the coordinator to every full-cycle broadcast so workers re-enter
  // tuning at the same cycle the coordinator re-arms
  // (parameter_manager.h). kAutotuneAbsent marks a list that never
  // crossed the wire (fast-path local lists) or an older serializer.
  static constexpr uint64_t kAutotuneAbsent = ~0ull;

  const std::vector<Response>& responses() const { return responses_; }
  std::vector<Response>& mutable_responses() { return responses_; }
  void add_response(const Response& r) { responses_.push_back(r); }

  bool shutdown() const { return shutdown_; }
  void set_shutdown(bool v) { shutdown_ = v; }

  uint64_t autotune_wire() const { return autotune_wire_; }
  void set_autotune_wire(uint64_t v) { autotune_wire_ = v; }

  // Clock-alignment piggyback (trace.h, docs/TRACING.md): the
  // coordinator's trace-clock stamps taken right after its gather
  // returned (T2) and right before its broadcast (T3), appended AFTER
  // the autotune word — pre-trace decoders stop at the shorter blob and
  // see -1 ("no sample"). The worker combines them with its own
  // T1(pre-gather)/T4(post-broadcast) stamps into an NTP offset sample.
  int64_t clock_t2() const { return clock_t2_; }
  int64_t clock_t3() const { return clock_t3_; }
  void set_clock(int64_t t2, int64_t t3) {
    clock_t2_ = t2;
    clock_t3_ = t3;
  }
  // Coordinator->worker flag bits on the same tail. Bit 0: every rank
  // dumps a flight-recorder bundle this cycle (stall escalation /
  // divergence — the coordinator saw it, the workers hold the evidence).
  static constexpr uint8_t kFlagDumpBundle = 1;
  uint8_t trace_flags() const { return trace_flags_; }
  void set_trace_flags(uint8_t f) { trace_flags_ = f; }

  void SerializeTo(std::string* out) const;
  bool ParseFrom(const char* data, std::size_t len);

 private:
  std::vector<Response> responses_;
  bool shutdown_ = false;
  uint64_t autotune_wire_ = kAutotuneAbsent;
  int64_t clock_t2_ = -1;
  int64_t clock_t3_ = -1;
  uint8_t trace_flags_ = 0;
};

// --- low-level wire helpers (shared with net.cc) ---
namespace wire {
void PutU8(std::string* out, uint8_t v);
void PutU32(std::string* out, uint32_t v);
void PutI32(std::string* out, int32_t v);
void PutI64(std::string* out, int64_t v);
void PutF64(std::string* out, double v);
void PutStr(std::string* out, const std::string& s);

class Reader {
 public:
  Reader(const char* data, std::size_t len) : p_(data), end_(data + len) {}
  bool GetU8(uint8_t* v);
  bool GetU32(uint32_t* v);
  bool GetI32(int32_t* v);
  bool GetI64(int64_t* v);
  bool GetF64(double* v);
  bool GetStr(std::string* s);
  std::size_t consumed(const char* start) const { return p_ - start; }
  bool ok() const { return p_ <= end_; }

 private:
  const char* p_;
  const char* end_;
};
}  // namespace wire

}  // namespace hvdtpu

#endif  // HVD_TPU_MESSAGE_H
