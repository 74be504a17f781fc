// Host-CPU collective op implementations over the TCP data rings:
//   - CpuRingAllreduce: bandwidth-optimal ring (reduce-scatter + allgather)
//     over the fused buffer, dtype-aware reduction (16-bit floats accumulate
//     in fp32).
//   - CpuHierarchicalAllreduce: two-level composite — local-ring
//     reduce-scatter, cross-ring allreduce of the owned chunk, local-ring
//     allgather. The TCP analogue of the reference's NCCL ReduceScatter ->
//     cross-node MPI allreduce -> AllGather composite
//     (/root/reference horovod/common/ops/nccl_operations.cc:150-346).
//   - CpuRingAllgather: ring allgatherv with per-rank first-dim sizes.
//   - CpuHierarchicalAllgather: cross-ring circulation of each local_rank's
//     block column (inter-host links carry every byte exactly once), then
//     local-ring circulation of whole column-sets (role parity with the
//     reference's shared-memory hierarchical allgather,
//     ops/mpi_operations.cc:168-321).
//   - CpuBroadcast: chunk-streamed pipelined broadcast over the global ring.
//
// Role parity with /root/reference horovod/common/ops/mpi_operations.cc and
// gloo_operations.cc (the host data plane); the TPU in-jit data plane rides
// XLA collectives and never enters this code.
#ifndef HVD_TPU_CPU_OPERATIONS_H
#define HVD_TPU_CPU_OPERATIONS_H

#include <vector>

#include "collective_operations.h"
#include "compression.h"
#include "tcp_context.h"

namespace hvdtpu {

class CpuRingAllreduce : public AllreduceOp {
 public:
  CpuRingAllreduce(TcpContext& ctx, HorovodGlobalState* state)
      : AllreduceOp(state), ctx_(ctx) {}
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override;
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override;

 protected:
  // In-place reduction of the fused buffer; overridden by the hierarchical
  // variant. Named activity is used for the timeline. `cmp` is the
  // negotiated wire-compression mode: the buffer stays f32; each ring
  // hop encodes only the bytes it puts on the wire (compression.h).
  // `group` != 0 runs the reduction over that process group's ring
  // (group positions replace world ranks; docs/GROUPS.md).
  virtual Status ReduceBuffer(void* buffer, int64_t count, DataType dtype,
                              CompressionMode cmp, uint32_t group);
  virtual const char* ActivityName() const { return "ALLREDUCE_RING"; }

  TcpContext& ctx_;
};

class CpuHierarchicalAllreduce : public CpuRingAllreduce {
 public:
  using CpuRingAllreduce::CpuRingAllreduce;
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override;

 protected:
  Status ReduceBuffer(void* buffer, int64_t count, DataType dtype,
                      CompressionMode cmp, uint32_t group) override;
  const char* ActivityName() const override {
    return "ALLREDUCE_HIERARCHICAL";
  }
};

// Standalone reduce-scatter (docs/ZERO.md): the ring's reduce-scatter
// leg as a first-class negotiated op. Rank r's (shard-sized) output
// buffer receives logical chunk r of the flattened tensor's
// PartitionChunks partition, summed across ranks; wire compression
// applies per hop unchanged.
class CpuRingReduceScatter : public ReduceScatterOp {
 public:
  CpuRingReduceScatter(TcpContext& ctx, HorovodGlobalState* state)
      : ReduceScatterOp(state), ctx_(ctx) {}
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override;
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override;

 protected:
  TcpContext& ctx_;
};

// Two-level reduce-scatter (intra-host grouped reduce -> inter-host ring
// -> shard distribution), gated on the topology being hierarchical AND
// the autotuned HierarchicalReduceScatter knob — sharded_update's data
// leg gets the same inter-host byte economy the hierarchical allreduce/
// allgather have (each byte crosses the host boundary once per HOST).
class CpuHierarchicalReduceScatter : public CpuRingReduceScatter {
 public:
  using CpuRingReduceScatter::CpuRingReduceScatter;
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override;
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override;
};

class CpuRingAllgather : public AllgatherOp {
 public:
  CpuRingAllgather(TcpContext& ctx, HorovodGlobalState* state)
      : AllgatherOp(state), ctx_(ctx) {}
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override;
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override;

 protected:
  TcpContext& ctx_;
};

class CpuHierarchicalAllgather : public CpuRingAllgather {
 public:
  using CpuRingAllgather::CpuRingAllgather;
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override;
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override;
};

class CpuBroadcast : public BroadcastOp {
 public:
  CpuBroadcast(TcpContext& ctx, HorovodGlobalState* state)
      : BroadcastOp(state), ctx_(ctx) {}
  bool Enabled(const std::vector<TensorTableEntry>& entries,
               const Response& response) const override;
  Status Execute(std::vector<TensorTableEntry>& entries,
                 const Response& response) override;

 private:
  TcpContext& ctx_;
};

// Elementwise `dst += src` with dtype dispatch (fp16/bf16 via fp32).
void ReduceSum(void* dst, const void* src, int64_t count, DataType dtype);
// Elementwise scale in place (used for prescale/postscale/average).
void ScaleBuffer(void* buf, int64_t count, DataType dtype, double factor);
// In-place ring allreduce of `count` elements on the chosen ring, with
// per-hop wire compression (cmp != NONE requires dtype == f32 — the
// negotiation's EffectiveCompression guarantees it). pipe_bytes > 0
// slices each hop into double-buffered pipeline segments of that many
// (uncompressed-equivalent) bytes so codec + transport + reduction
// overlap within the hop; 0 keeps the original unsliced exchange.
// group != 0 rides that process group's ring instead of the enum ring
// (the ring must already be built — TcpContext::EnsureGroupRing).
Status RingAllreduceOn(TcpContext& ctx, Ring ring, void* buffer, int64_t count,
                       DataType dtype,
                       CompressionMode cmp = CompressionMode::NONE,
                       int64_t pipe_bytes = 0, uint32_t group = 0);

}  // namespace hvdtpu

#endif  // HVD_TPU_CPU_OPERATIONS_H
