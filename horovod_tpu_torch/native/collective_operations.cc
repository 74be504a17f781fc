#include "collective_operations.h"

#include <cstring>

#include "global_state.h"
#include "logging.h"

namespace hvdtpu {

int64_t HorovodOp::NumElements(
    const std::vector<TensorTableEntry>& entries) const {
  int64_t n = 0;
  for (const auto& e : entries) n += e.NumElements();
  return n;
}

Status HorovodOp::MemcpyInFusionBuffer(std::vector<TensorTableEntry>& entries,
                                       void** buffer_data,
                                       std::size_t* buffer_len) {
  Trace& trace = global_state_->trace;
  const int64_t t_fuse_start = trace.NowNs();
  std::size_t total = 0;
  for (const auto& e : entries) total += e.SizeBytes();
  Status status = global_state_->fusion_buffer.InitializeBuffer(
      static_cast<int64_t>(total), /*key=*/0);
  if (!status.ok()) return status;
  char* buf = static_cast<char*>(global_state_->fusion_buffer.GetBuffer(0));
  std::size_t offset = 0;
  for (const auto& e : entries) {
    std::memcpy(buf + offset, e.data, e.SizeBytes());
    offset += e.SizeBytes();
  }
  *buffer_data = buf;
  *buffer_len = total;
  trace.Record(entries.empty() ? "fuse" : entries[0].tensor_name.c_str(),
               TRACE_FUSE, t_fuse_start, trace.NowNs(),
               static_cast<int64_t>(total),
               entries.empty() ? 0 : entries[0].group_id);
  return Status::OK();
}

void HorovodOp::MemcpyOutFusionBuffer(const void* buffer_data,
                                      std::vector<TensorTableEntry>& entries) {
  const char* buf = static_cast<const char*>(buffer_data);
  std::size_t offset = 0;
  for (auto& e : entries) {
    std::memcpy(e.output, buf + offset, e.SizeBytes());
    offset += e.SizeBytes();
  }
}

template <typename Op>
Status OperationManager::ExecuteFirstEnabled(
    const std::vector<std::shared_ptr<Op>>& ops,
    std::vector<TensorTableEntry>& entries, const Response& response) {
  for (const auto& op : ops) {
    if (op->Enabled(entries, response)) {
      return op->Execute(entries, response);
    }
  }
  return Status::PreconditionError(
      "No enabled operation found to execute response of type " +
      std::string(Response::ResponseTypeName(response.response_type())));
}

Status OperationManager::ExecuteOperation(
    std::vector<TensorTableEntry>& entries, const Response& response) {
  switch (response.response_type()) {
    case Response::ALLREDUCE:
      return ExecuteFirstEnabled(allreduce_ops_, entries, response);
    case Response::ALLGATHER:
      return ExecuteFirstEnabled(allgather_ops_, entries, response);
    case Response::BROADCAST:
      return ExecuteFirstEnabled(broadcast_ops_, entries, response);
    case Response::REDUCESCATTER:
      return ExecuteFirstEnabled(reducescatter_ops_, entries, response);
    case Response::ERROR:
      return error_op_->Execute(entries, response);
  }
  return Status::UnknownError("unknown response type");
}

}  // namespace hvdtpu
