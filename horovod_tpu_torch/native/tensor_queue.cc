#include "tensor_queue.h"

namespace hvdtpu {

Status TensorQueue::AddToTensorQueue(TensorTableEntry entry, Request message) {
  std::lock_guard<std::mutex> lk(mutex_);
  if (tensor_table_.find(entry.tensor_name) != tensor_table_.end()) {
    return Status::InvalidArgument(DUPLICATE_NAME_ERROR);
  }
  tensor_table_.emplace(entry.tensor_name, std::move(entry));
  message_queue_.push_back(std::move(message));
  return Status::OK();
}

void TensorQueue::PopMessagesFromQueue(std::deque<Request>& messages) {
  std::lock_guard<std::mutex> lk(mutex_);
  while (!message_queue_.empty()) {
    messages.push_back(std::move(message_queue_.front()));
    message_queue_.pop_front();
  }
}

void TensorQueue::PushMessageToQueue(const Request& message) {
  std::lock_guard<std::mutex> lk(mutex_);
  message_queue_.push_back(message);
}

void TensorQueue::GetTensorEntriesFromResponse(
    const Response& response, std::vector<TensorTableEntry>& entries) {
  std::lock_guard<std::mutex> lk(mutex_);
  for (const auto& name : response.tensor_names()) {
    auto it = tensor_table_.find(name);
    if (it == tensor_table_.end()) continue;
    // Group scoping: a response only claims entries of ITS group — a
    // rank holding "grad.0" pending in group 2 must not execute it
    // against group 1's response for the same name (the 2-D mesh's
    // per-column gradient reduce is exactly this shape).
    if (it->second.group_id != response.group_id()) continue;
    entries.push_back(std::move(it->second));
    tensor_table_.erase(it);
  }
}

const TensorTableEntry& TensorQueue::GetTensorEntry(
    const std::string& name) const {
  std::lock_guard<std::mutex> lk(mutex_);
  return tensor_table_.at(name);
}

bool TensorQueue::HasEntry(const std::string& name) const {
  std::lock_guard<std::mutex> lk(mutex_);
  return tensor_table_.find(name) != tensor_table_.end();
}

void TensorQueue::FinalizeTensorQueue(const Status& status) {
  std::lock_guard<std::mutex> lk(mutex_);
  for (auto& kv : tensor_table_) {
    if (kv.second.callback) kv.second.callback(status, kv.second);
  }
  tensor_table_.clear();
  message_queue_.clear();
}

int64_t TensorQueue::GetTensorDataForAutotuner(
    const std::deque<Request>& messages, int64_t& total_bytes) {
  std::lock_guard<std::mutex> lk(mutex_);
  int64_t count = 0;
  total_bytes = 0;
  for (const auto& msg : messages) {
    auto it = tensor_table_.find(msg.tensor_name());
    if (it == tensor_table_.end()) continue;
    total_bytes += static_cast<int64_t>(it->second.SizeBytes());
    ++count;
  }
  return count;
}

}  // namespace hvdtpu
