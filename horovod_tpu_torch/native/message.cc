#include "message.h"

#include <cstring>
#include <sstream>

namespace hvdtpu {

const char* DataTypeName(DataType dt) {
  switch (dt) {
    case DataType::HVD_UINT8: return "uint8";
    case DataType::HVD_INT8: return "int8";
    case DataType::HVD_UINT16: return "uint16";
    case DataType::HVD_INT16: return "int16";
    case DataType::HVD_INT32: return "int32";
    case DataType::HVD_INT64: return "int64";
    case DataType::HVD_FLOAT16: return "float16";
    case DataType::HVD_FLOAT32: return "float32";
    case DataType::HVD_FLOAT64: return "float64";
    case DataType::HVD_BOOL: return "bool";
    case DataType::HVD_BFLOAT16: return "bfloat16";
  }
  return "unknown";
}

std::size_t DataTypeSize(DataType dt) {
  switch (dt) {
    case DataType::HVD_UINT8:
    case DataType::HVD_INT8:
    case DataType::HVD_BOOL:
      return 1;
    case DataType::HVD_UINT16:
    case DataType::HVD_INT16:
    case DataType::HVD_FLOAT16:
    case DataType::HVD_BFLOAT16:
      return 2;
    case DataType::HVD_INT32:
    case DataType::HVD_FLOAT32:
      return 4;
    case DataType::HVD_INT64:
    case DataType::HVD_FLOAT64:
      return 8;
  }
  return 0;
}

const char* Request::RequestTypeName(RequestType t) {
  switch (t) {
    case ALLREDUCE: return "ALLREDUCE";
    case ALLGATHER: return "ALLGATHER";
    case BROADCAST: return "BROADCAST";
    case REDUCESCATTER: return "REDUCESCATTER";
  }
  return "?";
}

const char* Response::ResponseTypeName(ResponseType t) {
  switch (t) {
    case ALLREDUCE: return "ALLREDUCE";
    case ALLGATHER: return "ALLGATHER";
    case BROADCAST: return "BROADCAST";
    case ERROR: return "ERROR";
    case REDUCESCATTER: return "REDUCESCATTER";
  }
  return "?";
}

namespace wire {

void PutU8(std::string* out, uint8_t v) {
  out->push_back(static_cast<char>(v));
}
void PutU32(std::string* out, uint32_t v) {
  char b[4];
  std::memcpy(b, &v, 4);
  out->append(b, 4);
}
void PutI32(std::string* out, int32_t v) {
  char b[4];
  std::memcpy(b, &v, 4);
  out->append(b, 4);
}
void PutI64(std::string* out, int64_t v) {
  char b[8];
  std::memcpy(b, &v, 8);
  out->append(b, 8);
}
void PutF64(std::string* out, double v) {
  char b[8];
  std::memcpy(b, &v, 8);
  out->append(b, 8);
}
void PutStr(std::string* out, const std::string& s) {
  PutU32(out, static_cast<uint32_t>(s.size()));
  out->append(s);
}

bool Reader::GetU8(uint8_t* v) {
  if (p_ + 1 > end_) return false;
  *v = static_cast<uint8_t>(*p_++);
  return true;
}
bool Reader::GetU32(uint32_t* v) {
  if (p_ + 4 > end_) return false;
  std::memcpy(v, p_, 4);
  p_ += 4;
  return true;
}
bool Reader::GetI32(int32_t* v) {
  if (p_ + 4 > end_) return false;
  std::memcpy(v, p_, 4);
  p_ += 4;
  return true;
}
bool Reader::GetI64(int64_t* v) {
  if (p_ + 8 > end_) return false;
  std::memcpy(v, p_, 8);
  p_ += 8;
  return true;
}
bool Reader::GetF64(double* v) {
  if (p_ + 8 > end_) return false;
  std::memcpy(v, p_, 8);
  p_ += 8;
  return true;
}
bool Reader::GetStr(std::string* s) {
  uint32_t n;
  if (!GetU32(&n)) return false;
  if (p_ + n > end_) return false;
  s->assign(p_, n);
  p_ += n;
  return true;
}

}  // namespace wire

using namespace wire;

void Request::SerializeTo(std::string* out) const {
  PutI32(out, request_rank_);
  PutU8(out, static_cast<uint8_t>(request_type_));
  PutU8(out, static_cast<uint8_t>(tensor_type_));
  PutI32(out, root_rank_);
  PutI32(out, device_);
  PutStr(out, tensor_name_);
  PutU32(out, static_cast<uint32_t>(tensor_shape_.size()));
  for (int64_t d : tensor_shape_) PutI64(out, d);
  PutF64(out, prescale_factor_);
  PutF64(out, postscale_factor_);
  PutU8(out, compression_);
  PutU32(out, group_id_);
  PutI64(out, static_cast<int64_t>(group_digest_));
}

std::size_t Request::ParseFrom(const char* data, std::size_t len) {
  Reader r(data, len);
  uint8_t rt, tt;
  uint32_t ndim;
  if (!r.GetI32(&request_rank_) || !r.GetU8(&rt) || !r.GetU8(&tt) ||
      !r.GetI32(&root_rank_) || !r.GetI32(&device_) ||
      !r.GetStr(&tensor_name_) || !r.GetU32(&ndim))
    return 0;
  request_type_ = static_cast<RequestType>(rt);
  tensor_type_ = static_cast<DataType>(tt);
  tensor_shape_.clear();
  for (uint32_t i = 0; i < ndim; ++i) {
    int64_t d;
    if (!r.GetI64(&d)) return 0;
    tensor_shape_.push_back(d);
  }
  if (!r.GetF64(&prescale_factor_) || !r.GetF64(&postscale_factor_)) return 0;
  if (!r.GetU8(&compression_)) return 0;
  int64_t digest;
  if (!r.GetU32(&group_id_) || !r.GetI64(&digest)) return 0;
  group_digest_ = static_cast<uint64_t>(digest);
  return r.consumed(data);
}

void RequestList::SerializeTo(std::string* out) const {
  PutU8(out, shutdown_ ? 1 : 0);
  PutU32(out, static_cast<uint32_t>(requests_.size()));
  for (const auto& req : requests_) req.SerializeTo(out);
  PutI64(out, static_cast<int64_t>(call_seq_));
  PutI64(out, static_cast<int64_t>(call_digest_));
  PutU32(out, static_cast<uint32_t>(recent_calls_.size()));
  for (const auto& rec : recent_calls_) {
    PutI64(out, static_cast<int64_t>(rec.seq));
    PutU8(out, rec.op);
    PutU8(out, rec.dtype);
    PutU8(out, rec.ndim);
    PutStr(out, rec.name);
  }
  PutU32(out, static_cast<uint32_t>(metrics_summary_.size()));
  for (double v : metrics_summary_) PutF64(out, v);
}

bool RequestList::ParseFrom(const char* data, std::size_t len) {
  Reader r(data, len);
  uint8_t sd;
  uint32_t n;
  if (!r.GetU8(&sd) || !r.GetU32(&n)) return false;
  shutdown_ = sd != 0;
  requests_.clear();
  std::size_t off = r.consumed(data);
  for (uint32_t i = 0; i < n; ++i) {
    Request req;
    std::size_t used = req.ParseFrom(data + off, len - off);
    if (used == 0) return false;
    off += used;
    requests_.push_back(std::move(req));
  }
  Reader tail(data + off, len - off);
  int64_t seq, digest;
  uint32_t nrec;
  if (!tail.GetI64(&seq) || !tail.GetI64(&digest) || !tail.GetU32(&nrec))
    return false;
  call_seq_ = static_cast<uint64_t>(seq);
  call_digest_ = static_cast<uint64_t>(digest);
  recent_calls_.clear();
  for (uint32_t i = 0; i < nrec; ++i) {
    CallRecord rec;
    int64_t rseq;
    if (!tail.GetI64(&rseq) || !tail.GetU8(&rec.op) ||
        !tail.GetU8(&rec.dtype) || !tail.GetU8(&rec.ndim) ||
        !tail.GetStr(&rec.name))
      return false;
    rec.seq = static_cast<uint64_t>(rseq);
    recent_calls_.push_back(std::move(rec));
  }
  // Metrics summary tail: absent on a short (older-writer) blob — treat
  // as "no summary attached", not a parse error.
  metrics_summary_.clear();
  uint32_t nsum;
  if (tail.GetU32(&nsum)) {
    for (uint32_t i = 0; i < nsum; ++i) {
      double v;
      if (!tail.GetF64(&v)) return false;
      metrics_summary_.push_back(v);
    }
  }
  return true;
}

std::string Response::tensor_names_string() const {
  std::ostringstream os;
  for (std::size_t i = 0; i < tensor_names_.size(); ++i) {
    if (i > 0) os << ", ";
    os << tensor_names_[i];
  }
  return os.str();
}

void Response::SerializeTo(std::string* out) const {
  PutU8(out, static_cast<uint8_t>(response_type_));
  PutU8(out, static_cast<uint8_t>(tensor_type_));
  PutU8(out, compression_);
  PutU32(out, group_id_);
  PutI32(out, devices_);
  PutStr(out, error_message_);
  PutU32(out, static_cast<uint32_t>(tensor_names_.size()));
  for (const auto& n : tensor_names_) PutStr(out, n);
  PutU32(out, static_cast<uint32_t>(tensor_sizes_.size()));
  for (int64_t s : tensor_sizes_) PutI64(out, s);
}

std::size_t Response::ParseFrom(const char* data, std::size_t len) {
  Reader r(data, len);
  uint8_t rt, tt;
  uint32_t nn, ns;
  if (!r.GetU8(&rt) || !r.GetU8(&tt) || !r.GetU8(&compression_) ||
      !r.GetU32(&group_id_) || !r.GetI32(&devices_) ||
      !r.GetStr(&error_message_) || !r.GetU32(&nn))
    return 0;
  response_type_ = static_cast<ResponseType>(rt);
  tensor_type_ = static_cast<DataType>(tt);
  tensor_names_.clear();
  for (uint32_t i = 0; i < nn; ++i) {
    std::string s;
    if (!r.GetStr(&s)) return 0;
    tensor_names_.push_back(std::move(s));
  }
  if (!r.GetU32(&ns)) return 0;
  tensor_sizes_.clear();
  for (uint32_t i = 0; i < ns; ++i) {
    int64_t v;
    if (!r.GetI64(&v)) return 0;
    tensor_sizes_.push_back(v);
  }
  return r.consumed(data);
}

void ResponseList::SerializeTo(std::string* out) const {
  PutU8(out, shutdown_ ? 1 : 0);
  PutU32(out, static_cast<uint32_t>(responses_.size()));
  for (const auto& resp : responses_) resp.SerializeTo(out);
  PutI64(out, static_cast<int64_t>(autotune_wire_));
  // Clock-alignment tail (after the autotune word; same
  // forward-compatibility rule — older decoders ignore it).
  PutI64(out, clock_t2_);
  PutI64(out, clock_t3_);
  PutU8(out, trace_flags_);
}

bool ResponseList::ParseFrom(const char* data, std::size_t len) {
  Reader r(data, len);
  uint8_t sd;
  uint32_t n;
  if (!r.GetU8(&sd) || !r.GetU32(&n)) return false;
  shutdown_ = sd != 0;
  responses_.clear();
  std::size_t off = r.consumed(data);
  for (uint32_t i = 0; i < n; ++i) {
    Response resp;
    std::size_t used = resp.ParseFrom(data + off, len - off);
    if (used == 0) return false;
    off += used;
    responses_.push_back(std::move(resp));
  }
  // Autotune bootstrap tail: absent on a short (older-writer) blob —
  // "no information", not a parse error.
  Reader tail(data + off, len - off);
  int64_t wire;
  autotune_wire_ = tail.GetI64(&wire) ? static_cast<uint64_t>(wire)
                                      : kAutotuneAbsent;
  // Clock-alignment tail (trace.h): continue reading the same tail —
  // absent on a pre-trace writer's blob means "no sample", not an
  // error.
  int64_t t2, t3;
  uint8_t tf;
  if (tail.GetI64(&t2) && tail.GetI64(&t3)) {
    clock_t2_ = t2;
    clock_t3_ = t3;
  } else {
    clock_t2_ = -1;
    clock_t3_ = -1;
  }
  trace_flags_ = tail.GetU8(&tf) ? tf : 0;
  return true;
}

}  // namespace hvdtpu
