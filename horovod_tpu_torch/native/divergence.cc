#include "divergence.h"

#include <algorithm>
#include <set>
#include <sstream>

#include "logging.h"

namespace hvdtpu {

namespace {

constexpr uint64_t kFnvPrime = 1099511628211ULL;

uint64_t FoldByte(uint64_t h, uint8_t b) { return (h ^ b) * kFnvPrime; }

uint64_t FoldCall(uint64_t digest, uint8_t op, uint8_t dtype, uint8_t ndim,
                  const std::string& name) {
  uint64_t h = digest;
  h = FoldByte(h, op);
  h = FoldByte(h, dtype);
  h = FoldByte(h, ndim);
  for (char c : name) h = FoldByte(h, static_cast<uint8_t>(c));
  return FoldByte(h, 0xFFu);  // terminator: "ab"+"c" != "a"+"bc"
}

const char* OpName(uint8_t op) {
  return Request::RequestTypeName(static_cast<Request::RequestType>(op));
}

std::string JoinRanks(const std::set<int>& ranks) {
  std::ostringstream os;
  bool first = true;
  for (int r : ranks) {
    if (!first) os << ", ";
    os << r;
    first = false;
  }
  return os.str();
}

}  // namespace

// ---------------- CallTracker ----------------

void CallTracker::Record(uint8_t op, uint8_t dtype, int ndim,
                         const std::string& name) {
  std::lock_guard<std::mutex> lk(mutex_);
  seq_ += 1;
  digest_ = FoldCall(digest_, op, dtype, static_cast<uint8_t>(ndim), name);
  CallRecord rec;
  rec.seq = seq_;
  rec.op = op;
  rec.dtype = dtype;
  rec.ndim = static_cast<uint8_t>(ndim);
  rec.name = name;
  ring_.push_back(std::move(rec));
  if (ring_.size() > kRingCapacity) ring_.pop_front();
}

void CallTracker::Snapshot(uint64_t* seq, uint64_t* digest) const {
  std::lock_guard<std::mutex> lk(mutex_);
  if (seq != nullptr) *seq = seq_;
  if (digest != nullptr) *digest = digest_;
}

std::vector<CallRecord> CallTracker::RecordsSince(uint64_t after_seq,
                                                  std::size_t limit,
                                                  uint64_t up_to_seq) const {
  std::lock_guard<std::mutex> lk(mutex_);
  std::vector<CallRecord> out;
  for (const auto& rec : ring_) {
    if (rec.seq > after_seq && rec.seq <= up_to_seq) out.push_back(rec);
  }
  if (out.size() > limit) {  // keep the most recent `limit`
    out.erase(out.begin(), out.end() - limit);
  }
  return out;
}

void CallTracker::Reset() {
  std::lock_guard<std::mutex> lk(mutex_);
  seq_ = 0;
  digest_ = 14695981039346656037ULL;
  ring_.clear();
}

// ---------------- DivergenceDetector ----------------

void DivergenceDetector::Configure(int world_size, int64_t progress_calls,
                                   double grace_seconds) {
  world_size_ = world_size;
  progress_calls_ = progress_calls;
  grace_seconds_ = grace_seconds;
  ranks_.assign(static_cast<std::size_t>(world_size), RankState());
  pending_.clear();
}

void DivergenceDetector::Observe(int rank, uint64_t seq, uint64_t digest,
                                 const std::vector<CallRecord>& recent) {
  if (rank < 0 || rank >= static_cast<int>(ranks_.size())) return;
  RankState& st = ranks_[rank];
  if (seq >= st.seq) {  // ignore stale reports (digest must match seq)
    st.seq = seq;
    st.digest = digest;
  }
  for (const auto& rec : recent) {
    if (!st.log.empty() && rec.seq <= st.log.back().seq) continue;
    st.log.push_back(rec);
  }
  while (st.log.size() > CallTracker::kRingCapacity) st.log.pop_front();
}

bool DivergenceDetector::ShouldForceFullCycle(
    const std::unordered_map<std::string, std::vector<Request>>& pending) {
  if (grace_seconds_ <= 0.0 && progress_calls_ <= 0) return false;
  if (pending.empty()) return false;
  auto now = Clock::now();
  // Forcing is rate-limited: while stalled, one extra round trip every
  // 200ms keeps the seq/digest view fresh without turning the idle cycle
  // pace into a busy loop.
  if (now - last_forced_ < std::chrono::milliseconds(200)) return false;
  double age_floor =
      grace_seconds_ > 0.0 ? std::min(grace_seconds_ / 2.0, 1.0) : 1.0;
  for (const auto& kv : pending) {
    auto it = pending_.find(kv.first);
    if (it == pending_.end()) continue;
    double age = std::chrono::duration<double>(now - it->second.first_seen)
                     .count();
    if (age >= age_floor) {
      last_forced_ = now;
      return true;
    }
  }
  return false;
}

std::vector<DivergenceDetector::Diagnosis> DivergenceDetector::Check(
    const std::unordered_map<std::string, std::vector<Request>>& pending,
    const GroupTable* groups) {
  std::vector<Diagnosis> out;
  if (ranks_.empty()) return out;
  auto now = Clock::now();

  // Sync the pending bookkeeping with the live table: first sight stamps
  // the clock and snapshots every rank's known seq.
  for (const auto& kv : pending) {
    if (pending_.count(kv.first)) continue;
    PendingState st;
    st.first_seen = now;
    st.seq_at_announce.reserve(ranks_.size());
    for (const auto& rank : ranks_) st.seq_at_announce.push_back(rank.seq);
    pending_.emplace(kv.first, std::move(st));
  }
  for (auto it = pending_.begin(); it != pending_.end();) {
    if (pending.count(it->first) == 0) {
      it = pending_.erase(it);
    } else {
      ++it;
    }
  }

  // Submitter / missing sets per pending tensor.
  std::unordered_map<std::string, std::set<int>> submitters;
  for (const auto& kv : pending) {
    std::set<int>& s = submitters[kv.first];
    for (const auto& req : kv.second) s.insert(req.request_rank());
  }

  for (const auto& kv : pending) {
    const std::string& name = kv.first;
    const PendingState& st = pending_.at(name);
    const std::set<int>& sub = submitters[name];
    const Request& first = kv.second.front();
    double age =
        std::chrono::duration<double>(now - st.first_seen).count();

    // Group scope: only the GROUP's members owe this tensor. A
    // group-scoped divergence must name the group and its members, not
    // implicate (or wait on) the rest of the world.
    const uint32_t gid = first.group_id();
    std::string scope;
    std::set<int> missing;
    if (gid != 0 && groups != nullptr) {
      std::vector<int> members = groups->Members(gid);
      if (members.empty()) {
        // The id never registered HERE. The controller's
        // late-registration sweep covers the benign race (this
        // process's new_group just hasn't run yet); once the tensor has
        // aged past the grace window it is provably NOT that race —
        // this process skipped the new_group call entirely (a
        // registration-order divergence). Error by name instead of
        // hanging forever.
        if (grace_seconds_ > 0.0 && age >= grace_seconds_) {
          std::ostringstream msg;
          msg << "collective protocol divergence at '" << name << "' ("
              << OpName(static_cast<uint8_t>(first.request_type())) << " "
              << DataTypeName(first.tensor_type())
              << "): submitted by rank(s) [" << JoinRanks(sub)
              << "] in process group " << gid << ", but this coordinator "
              << "never registered that group after " << static_cast<int>(age)
              << "s — some rank skipped (or reordered) its hvd.new_group "
              << "call; every rank must create groups with the identical "
              << "rank lists in the identical order (docs/GROUPS.md).";
          out.push_back({name, first.tensor_name(), gid, msg.str()});
        }
        continue;
      }
      for (int r : members) {
        if (sub.count(r) == 0) missing.insert(r);
      }
      scope = " in process group " + std::to_string(gid) + " " +
              groups->DescribeMembers(gid);
    } else {
      for (int r = 0; r < world_size_; ++r) {
        if (sub.count(r) == 0) missing.insert(r);
      }
    }
    if (missing.empty()) continue;

    // Progress rule: a missing rank kept submitting other collectives.
    for (int r : missing) {
      uint64_t at = st.seq_at_announce.size() > static_cast<std::size_t>(r)
                        ? st.seq_at_announce[r]
                        : 0;
      if (progress_calls_ > 0 &&
          ranks_[r].seq >= at + static_cast<uint64_t>(progress_calls_)) {
        std::ostringstream msg;
        msg << "collective protocol divergence at '" << name << "' ("
            << OpName(static_cast<uint8_t>(first.request_type())) << " "
            << DataTypeName(first.tensor_type()) << scope
            << "): submitted by rank(s) ["
            << JoinRanks(sub) << "] but rank " << r << " proceeded through "
            << (ranks_[r].seq - at)
            << " other collectives without submitting it; rank " << r
            << " went on to: " << DescribeRecentCalls(r, at, 4)
            << ". A rank-conditional collective or mismatched call order is "
               "the usual cause (run hvd-lint on the training script).";
        out.push_back({name, first.tensor_name(), gid, msg.str()});
        break;
      }
    }
    if (!out.empty() && out.back().key == name) continue;

    // Cross-stall rule: tensor aged past the grace window and every
    // missing rank is itself a submitter of a *different* aged pending
    // tensor — a mutual wait on diverged call sites, not mere slowness.
    if (grace_seconds_ <= 0.0 || age < grace_seconds_) continue;
    bool all_evidenced = true;
    std::ostringstream waits;
    for (int r : missing) {
      const std::string* waiting_on = nullptr;
      for (const auto& other : pending) {
        if (other.first == name) continue;
        if (submitters[other.first].count(r) == 0) continue;
        double other_age = std::chrono::duration<double>(
                               now - pending_.at(other.first).first_seen)
                               .count();
        if (other_age >= grace_seconds_) {
          waiting_on = &other.first;
          break;
        }
      }
      if (waiting_on == nullptr) {
        all_evidenced = false;
        break;
      }
      waits << " rank " << r << " is waiting on '" << *waiting_on << "';";
    }
    if (!all_evidenced) continue;
    std::ostringstream msg;
    msg << "collective protocol divergence at '" << name << "' ("
        << OpName(static_cast<uint8_t>(first.request_type())) << " "
        << DataTypeName(first.tensor_type()) << scope << "): rank(s) ["
        << JoinRanks(sub) << "] have waited " << static_cast<int>(age)
        << "s while the missing rank(s) wait on different collectives:"
        << waits.str()
        << " the ranks' collective call sequences have diverged "
           "(rank-conditional collective or mismatched call order; run "
           "hvd-lint on the training script).";
    out.push_back({name, first.tensor_name(), gid, msg.str()});
  }
  return out;
}

std::string DivergenceDetector::DescribeRecentCalls(
    int rank, uint64_t after_seq, std::size_t max_shown) const {
  const RankState& st = ranks_[rank];
  std::ostringstream os;
  std::size_t shown = 0;
  for (const auto& rec : st.log) {
    if (rec.seq <= after_seq) continue;
    if (shown == max_shown) {
      os << ", ...";
      break;
    }
    if (shown > 0) os << ", ";
    os << OpName(rec.op) << " '" << rec.name << "' ("
       << DataTypeName(static_cast<DataType>(rec.dtype)) << ", ndim "
       << static_cast<int>(rec.ndim) << ")";
    shown += 1;
  }
  if (shown == 0) return "(no recent call records received)";
  return os.str();
}

}  // namespace hvdtpu
