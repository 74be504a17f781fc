// Thread-safe table of pending TensorTableEntry + FIFO of outgoing Requests.
// Producer side: framework API threads enqueue; consumer side: the single
// background coordination thread pops per cycle.
//
// Capability parity with /root/reference horovod/common/tensor_queue.{h,cc}.
#ifndef HVD_TPU_TENSOR_QUEUE_H
#define HVD_TPU_TENSOR_QUEUE_H

#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "message.h"

namespace hvdtpu {

class TensorQueue {
 public:
  // Rejects duplicate names (DUPLICATE_NAME_ERROR).
  Status AddToTensorQueue(TensorTableEntry entry, Request message);

  // Pops every queued Request accumulated since last cycle.
  void PopMessagesFromQueue(std::deque<Request>& messages);

  // Re-queues a message (e.g. tensor deferred because a peer isn't ready).
  void PushMessageToQueue(const Request& message);

  void GetTensorEntriesFromResponse(const Response& response,
                                    std::vector<TensorTableEntry>& entries);

  const TensorTableEntry& GetTensorEntry(const std::string& name) const;
  bool HasEntry(const std::string& name) const;

  // On shutdown: fails every pending entry's callback with `status`.
  void FinalizeTensorQueue(const Status& status);

  int64_t GetTensorDataForAutotuner(const std::deque<Request>& messages,
                                    int64_t& total_bytes);

 private:
  mutable std::mutex mutex_;
  std::unordered_map<std::string, TensorTableEntry>
      tensor_table_;               // guarded_by(mutex_)
  std::deque<Request> message_queue_;  // guarded_by(mutex_)
};

}  // namespace hvdtpu

#endif  // HVD_TPU_TENSOR_QUEUE_H
