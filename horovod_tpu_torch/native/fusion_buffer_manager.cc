#include "fusion_buffer_manager.h"

namespace hvdtpu {

Status FusionBufferManager::InitializeBuffer(int64_t threshold, int32_t key) {
  auto& buf = buffers_[key];
  if (buf == nullptr || static_cast<int64_t>(buf->size()) < threshold) {
    try {
      buf = std::make_shared<std::vector<char>>(
          static_cast<std::size_t>(threshold));
    } catch (const std::bad_alloc&) {
      return Status::UnknownError("failed to allocate fusion buffer");
    }
  }
  return Status::OK();
}

void* FusionBufferManager::GetBuffer(int32_t key) {
  auto it = buffers_.find(key);
  return it == buffers_.end() ? nullptr : it->second->data();
}

int64_t FusionBufferManager::GetSize(int32_t key) {
  auto it = buffers_.find(key);
  return it == buffers_.end() ? 0 : static_cast<int64_t>(it->second->size());
}

}  // namespace hvdtpu
