// Op base classes + fusion-buffer pack/unpack helpers, and the
// OperationManager registry (ordered per-op-type lists; the first op whose
// Enabled() returns true executes the response).
//
// Capability parity with /root/reference
// horovod/common/ops/collective_operations.{h,cc} and
// ops/operation_manager.{h,cc}.
#ifndef HVD_TPU_COLLECTIVE_OPERATIONS_H
#define HVD_TPU_COLLECTIVE_OPERATIONS_H

#include <memory>
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
