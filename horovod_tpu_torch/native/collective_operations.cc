#include "collective_operations.h"

#include <chrono>
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

void DeviceQueue::Open() {
  std::lock_guard<std::mutex> lk(mutex_);
  closed_ = false;
  closing_ = false;
  finishing_ = 0;
  pending_.clear();
  taken_.clear();
}

void DeviceQueue::Close(std::chrono::milliseconds drain) {
  std::unique_lock<std::mutex> lk(mutex_);
  closing_ = true;
  cv_.wait_for(lk, drain, [&] {
    return pending_.empty() && taken_.empty() && finishing_ == 0;
  });
  closed_ = true;
  pending_.clear();
  lk.unlock();
  cv_.notify_all();
}

int64_t DeviceQueue::Push(std::vector<TensorTableEntry> entries,
                          const Response& response) {
  auto work = std::make_shared<DeviceWork>();
  work->response = response;
  work->entries = std::move(entries);
  int64_t id;
  {
    std::lock_guard<std::mutex> lk(mutex_);
    id = work->id = next_id_++;
    pending_.push_back(std::move(work));
  }
  cv_.notify_all();
  return id;
}

int64_t DeviceQueue::Next(int timeout_ms) {
  std::unique_lock<std::mutex> lk(mutex_);
  cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms),
               [&] { return closed_ || !pending_.empty(); });
  if (pending_.empty()) return closed_ ? -1 : 0;
  auto work = std::move(pending_.front());
  pending_.pop_front();
  taken_[work->id] = work;
  if (closing_) cv_.notify_all();
  return work->id;
}

std::shared_ptr<DeviceWork> DeviceQueue::Get(int64_t id) {
  std::lock_guard<std::mutex> lk(mutex_);
  auto it = taken_.find(id);
  return it == taken_.end() ? nullptr : it->second;
}

std::shared_ptr<DeviceWork> DeviceQueue::Take(int64_t id) {
  std::lock_guard<std::mutex> lk(mutex_);
  auto it = taken_.find(id);
  if (it == taken_.end()) return nullptr;
  auto work = std::move(it->second);
  taken_.erase(it);
  ++finishing_;
  return work;
}

void DeviceQueue::Finished() {
  std::lock_guard<std::mutex> lk(mutex_);
  --finishing_;
  if (closing_) cv_.notify_all();
}

bool OnDevice(const std::vector<TensorTableEntry>& entries) {
  return !entries.empty() && entries[0].device != HOST_DEVICE_ID;
}

Status HandOffToDevice(HorovodGlobalState* state,
                       std::vector<TensorTableEntry>& entries,
                       const Response& response) {
  state->device_queue.Push(entries, response);
  return Status::InProgress();
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
