// Lazily-allocated persistent fusion buffers, one per (device, stream) key.
// Small tensors agreed in one fused Response are packed into this buffer so
// the collective runs once over one large payload.
//
// Capability parity with /root/reference
// horovod/common/fusion_buffer_manager.{h,cc}; the TPU-build core owns host
// memory directly (no framework AllocatePersistent indirection needed).
#ifndef HVD_TPU_FUSION_BUFFER_MANAGER_H
#define HVD_TPU_FUSION_BUFFER_MANAGER_H

#include <cstdint>
#include <map>
#include <memory>
#include <vector>

#include "common.h"

namespace hvdtpu {

class FusionBufferManager {
 public:
  // Ensures the buffer for `key` is at least `threshold` bytes.
  Status InitializeBuffer(int64_t threshold, int32_t key);
  void* GetBuffer(int32_t key);
  int64_t GetSize(int32_t key);

 private:
  std::map<int32_t, std::shared_ptr<std::vector<char>>> buffers_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_FUSION_BUFFER_MANAGER_H
