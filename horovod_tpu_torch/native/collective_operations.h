// Op base classes + fusion-buffer pack/unpack helpers, and the
// OperationManager registry (ordered per-op-type lists; the first op whose
// Enabled() returns true executes the response).
//
// Capability parity with /root/reference
// horovod/common/ops/collective_operations.{h,cc} and
// ops/operation_manager.{h,cc}.
#ifndef HVD_TPU_COLLECTIVE_OPERATIONS_H
#define HVD_TPU_COLLECTIVE_OPERATIONS_H

#include <chrono>
#include <condition_variable>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <vector>

#include "common.h"
#include "message.h"

namespace hvdtpu {

struct HorovodGlobalState;

class HorovodOp {
 public:
  explicit HorovodOp(HorovodGlobalState* state) : global_state_(state) {}
  virtual ~HorovodOp() = default;

  virtual bool Enabled(const std::vector<TensorTableEntry>& entries,
                       const Response& response) const = 0;
  virtual Status Execute(std::vector<TensorTableEntry>& entries,
                         const Response& response) = 0;

 protected:
  int64_t NumElements(const std::vector<TensorTableEntry>& entries) const;
  // Packs every entry's input into the fusion buffer; returns buffer + bytes.
  Status MemcpyInFusionBuffer(std::vector<TensorTableEntry>& entries,
                              void** buffer_data, std::size_t* buffer_len);
  // Unpacks the fusion buffer back into every entry's output.
  void MemcpyOutFusionBuffer(const void* buffer_data,
                             std::vector<TensorTableEntry>& entries);

  HorovodGlobalState* global_state_;
};

class AllreduceOp : public HorovodOp {
 public:
  using HorovodOp::HorovodOp;
};

class AllgatherOp : public HorovodOp {
 public:
  using HorovodOp::HorovodOp;
};

class BroadcastOp : public HorovodOp {
 public:
  using HorovodOp::HorovodOp;
};

// Reduce-scatter (docs/ZERO.md): the sum lands SHARDED — rank r's output
// buffer receives logical chunk r of the PartitionChunks partition over
// the flattened tensor (the same partition the Python binding's
// shard_partition computes).
class ReduceScatterOp : public HorovodOp {
 public:
  using HorovodOp::HorovodOp;
};

class ErrorOp : public HorovodOp {
 public:
  using HorovodOp::HorovodOp;
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override {
    return true;
  }
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override {
    return Status::PreconditionError(response.error_message());
  }
};

// ---------------- the device op ----------------
// A response whose entries live in GPU memory is not run by the core:
// the device op hands it, whole, to the binding's executor (the port's
// common/device_plane.py), which runs it on the card with NCCL and
// completes every entry later through horovod_tpu_device_done. The
// core's cycle never waits on the device.

// One handed-off response: the fused entries in the coordinator's order
// (their callbacks complete the handles) and the response itself (op,
// dtype, compression, group, allgather sizes).
struct DeviceWork {
  int64_t id = 0;
  Response response;
  std::vector<TensorTableEntry> entries;
};

// Responses waiting for the executor, in the coordinator's order (the
// same on every rank), and those it has taken and not yet completed.
// The executor blocks in Next() with the GIL released; Close() (the end
// of the background loop) wakes it for good.
class DeviceQueue {
 public:
  // Reopens the queue for a new generation of the core.
  void Open();
  // Closes it at the end of the background loop: the executor first runs
  // what every rank negotiated (its peers run the same responses), for
  // at most `drain`; then Next() returns -1. Entries not completed by
  // then are failed by the core's shutdown.
  void Close(std::chrono::milliseconds drain);
  int64_t Push(std::vector<TensorTableEntry> entries,
               const Response& response);
  // The next response's id: 0 after timeout_ms with none, -1 once the
  // queue is closed and empty.
  int64_t Next(int timeout_ms);
  // A taken response (nullptr for an unknown id).
  std::shared_ptr<DeviceWork> Get(int64_t id);
  // Removes a taken response and returns it (nullptr when unknown) for
  // its entries' completion; Finished() once their callbacks have run.
  // Close() waits for both, so the shutdown's failure of every pending
  // handle never overtakes a response the executor has completed.
  std::shared_ptr<DeviceWork> Take(int64_t id);
  void Finished();

 private:
  std::mutex mutex_;
  std::condition_variable cv_;
  bool closed_ = true;                                // guarded_by(mutex_)
  bool closing_ = false;                              // guarded_by(mutex_)
  int finishing_ = 0;  // taken, callbacks running     // guarded_by(mutex_)
  int64_t next_id_ = 1;                               // guarded_by(mutex_)
  std::deque<std::shared_ptr<DeviceWork>> pending_;   // guarded_by(mutex_)
  std::map<int64_t, std::shared_ptr<DeviceWork>> taken_;  // guarded_by
};

// Enabled for entries off the host (a CUDA ordinal); ahead of the CPU
// ops in every chain. Execute hands the response to the executor and
// returns IN_PROGRESS: PerformOperation then leaves the callbacks to
// horovod_tpu_device_done.
Status HandOffToDevice(HorovodGlobalState* state,
                       std::vector<TensorTableEntry>& entries,
                       const Response& response);
bool OnDevice(const std::vector<TensorTableEntry>& entries);

template <typename Base>
class DeviceOp : public Base {
 public:
  using Base::Base;
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override {
    return OnDevice(entries);
  }
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override {
    return HandOffToDevice(this->global_state_, entries, response);
  }
};

using DeviceAllreduce = DeviceOp<AllreduceOp>;
using DeviceAllgather = DeviceOp<AllgatherOp>;
using DeviceBroadcast = DeviceOp<BroadcastOp>;
using DeviceReduceScatter = DeviceOp<ReduceScatterOp>;

class OperationManager {
 public:
  OperationManager(std::vector<std::shared_ptr<AllreduceOp>> allreduce_ops,
                   std::vector<std::shared_ptr<AllgatherOp>> allgather_ops,
                   std::vector<std::shared_ptr<BroadcastOp>> broadcast_ops,
                   std::vector<std::shared_ptr<ReduceScatterOp>>
                       reducescatter_ops,
                   std::shared_ptr<ErrorOp> error_op)
      : allreduce_ops_(std::move(allreduce_ops)),
        allgather_ops_(std::move(allgather_ops)),
        broadcast_ops_(std::move(broadcast_ops)),
        reducescatter_ops_(std::move(reducescatter_ops)),
        error_op_(std::move(error_op)) {}

  Status ExecuteOperation(std::vector<TensorTableEntry>& entries,
                          const Response& response);

 private:
  template <typename Op>
  Status ExecuteFirstEnabled(
      const std::vector<std::shared_ptr<Op>>& ops,
      std::vector<TensorTableEntry>& entries, const Response& response);

  std::vector<std::shared_ptr<AllreduceOp>> allreduce_ops_;
  std::vector<std::shared_ptr<AllgatherOp>> allgather_ops_;
  std::vector<std::shared_ptr<BroadcastOp>> broadcast_ops_;
  std::vector<std::shared_ptr<ReduceScatterOp>> reducescatter_ops_;
  std::shared_ptr<ErrorOp> error_op_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_COLLECTIVE_OPERATIONS_H
