#include "common.h"

#include <cstdlib>
#include <sstream>

namespace hvdtpu {

int64_t EnvInt64(const char* name, int64_t dflt, bool* present) {
  const char* v = std::getenv(name);
  if (present != nullptr) *present = v != nullptr;
  return v == nullptr ? dflt : std::strtoll(v, nullptr, 10);
}

double EnvDouble(const char* name, double dflt, bool* present) {
  const char* v = std::getenv(name);
  if (present != nullptr) *present = v != nullptr;
  return v == nullptr ? dflt : std::strtod(v, nullptr);
}

bool EnvBool(const char* name, bool dflt, bool* present) {
  const char* v = std::getenv(name);
  if (present != nullptr) *present = v != nullptr;
  if (v == nullptr) return dflt;
  return std::strtol(v, nullptr, 10) != 0;
}

const std::string SHUT_DOWN_ERROR =
    "Horovod-TPU has been shut down. This was caused by an exception on one "
    "of the ranks or an attempt to enqueue a collective after one of the "
    "ranks finished execution.";

const std::string DUPLICATE_NAME_ERROR =
    "Requested to collect a tensor with the same name as another tensor that "
    "is currently being processed. If you want to request another tensor, "
    "use a different tensor name.";

const std::string CONNECTION_LOST_ERROR =
    "Horovod-TPU connection to a peer was lost (a worker likely failed or "
    "was preempted). The job can recover elastically: roll back to the "
    "last committed state and re-initialize (hvd.elastic.run does this "
    "automatically).";

std::string TensorShape::DebugString() const {
  std::ostringstream os;
  os << "[";
  for (std::size_t i = 0; i < dims_.size(); ++i) {
    if (i > 0) os << ", ";
    os << dims_[i];
  }
  os << "]";
  return os.str();
}

}  // namespace hvdtpu
