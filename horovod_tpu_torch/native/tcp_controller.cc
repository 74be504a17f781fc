#include "tcp_controller.h"

#include "logging.h"

namespace hvdtpu {

void TcpController::Initialize() {
  rank_ = tcp_context_.rank();
  size_ = tcp_context_.size();
  local_rank_ = tcp_context_.local_rank();
  local_size_ = tcp_context_.local_size();
  cross_rank_ = tcp_context_.cross_rank();
  cross_size_ = tcp_context_.cross_size();

  // Gather every rank's local_size to detect heterogeneous placements
  // (affects hierarchical op eligibility, mirroring the reference's
  // homogeneity check in mpi_controller.cc:25-81).
  std::string mine = std::to_string(local_size_);
  std::vector<std::string> all;
  if (is_coordinator()) {
    tcp_context_.GatherBlobs(mine, &all);
    all[0] = mine;
    std::string packed;
    for (auto& s : all) {
      packed += s;
      packed.push_back(',');
    }
    tcp_context_.BroadcastBlob(&packed);
    local_sizes_.clear();
    for (auto& s : SplitString(packed, ',')) {
      if (!s.empty()) local_sizes_.push_back(std::atoi(s.c_str()));
    }
  } else {
    tcp_context_.GatherBlobs(mine, nullptr);
    std::string packed;
    tcp_context_.BroadcastBlob(&packed);
    local_sizes_.clear();
    for (auto& s : SplitString(packed, ',')) {
      if (!s.empty()) local_sizes_.push_back(std::atoi(s.c_str()));
    }
  }
  is_homogeneous_ = true;
  for (int ls : local_sizes_) {
    if (ls != local_size_) is_homogeneous_ = false;
  }
  LOG(DEBUG) << "TcpController initialized: rank " << rank_ << " size "
             << size_ << " local " << local_rank_ << "/" << local_size_
             << " cross " << cross_rank_ << "/" << cross_size_;
}

// Control-plane failures mean a peer went away mid-protocol (EOF/reset on
// the star) — or, post-chaos-hardening, that a frame failed its checksum
// or an I/O deadline expired. Throwing ConnectionLostError (instead of
// the previous LOG(FATAL) abort) lets the background loop fail
// outstanding work with a recoverable status so Python can roll back and
// re-initialize for a new generation — the core of elastic fault
// tolerance. The message NAMES the transport-level cause
// (tcp_context.last_error) so a chaos run's failure is attributable.

namespace {
std::string WithCause(const char* what, const TcpContext& ctx) {
  std::string msg(what);
  if (!ctx.last_error().empty()) {
    msg += ": ";
    msg += ctx.last_error();
  }
  return msg;
}
}  // namespace

void TcpController::GatherBlobs(const std::string& mine,
                                std::vector<std::string>* all) {
  if (!tcp_context_.GatherBlobs(mine, all)) {
    throw ConnectionLostError(
        WithCause("control-plane gather failed", tcp_context_));
  }
}

void TcpController::BroadcastBlob(std::string* blob) {
  if (!tcp_context_.BroadcastBlob(blob)) {
    throw ConnectionLostError(
        WithCause("control-plane broadcast failed", tcp_context_));
  }
}

void TcpController::CrossRankBitwiseAnd(std::vector<uint64_t>& bits) {
  if (!tcp_context_.BitwiseSync(bits, /*is_or=*/false)) {
    throw ConnectionLostError(
        WithCause("bitwise AND sync failed", tcp_context_));
  }
}

void TcpController::CrossRankBitwiseOr(std::vector<uint64_t>& bits) {
  if (!tcp_context_.BitwiseSync(bits, /*is_or=*/true)) {
    throw ConnectionLostError(
        WithCause("bitwise OR sync failed", tcp_context_));
  }
}

void TcpController::Barrier() {
  if (!tcp_context_.Barrier()) {
    throw ConnectionLostError(WithCause("barrier failed", tcp_context_));
  }
}

}  // namespace hvdtpu
