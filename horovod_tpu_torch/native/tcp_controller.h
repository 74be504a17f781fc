// Controller implementation over the host-network TcpContext.
// Role parity with /root/reference horovod/common/gloo/gloo_controller.{h,cc}
// and mpi/mpi_controller.{h,cc}: rank discovery + the four cross-rank
// negotiation primitives, with size==1 short-circuits.
#ifndef HVD_TPU_TCP_CONTROLLER_H
#define HVD_TPU_TCP_CONTROLLER_H

#include "controller.h"
#include "tcp_context.h"

namespace hvdtpu {

class TcpController : public Controller {
 public:
  TcpController(ResponseCache& response_cache, TensorQueue& tensor_queue,
                Timeline& timeline, ParameterManager& parameter_manager,
                TcpContext& tcp_context)
      : Controller(response_cache, tensor_queue, timeline, parameter_manager),
        tcp_context_(tcp_context) {}

  void Initialize() override;

  void GatherBlobs(const std::string& mine,
                   std::vector<std::string>* all) override;
  void BroadcastBlob(std::string* blob) override;
  void CrossRankBitwiseAnd(std::vector<uint64_t>& bits) override;
  void CrossRankBitwiseOr(std::vector<uint64_t>& bits) override;
  void Barrier() override;

 private:
  TcpContext& tcp_context_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_TCP_CONTROLLER_H
