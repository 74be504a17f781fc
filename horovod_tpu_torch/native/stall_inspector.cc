#include "stall_inspector.h"

#include <algorithm>
#include <map>
#include <sstream>

#include "logging.h"
#include "metrics.h"
#include "response_cache.h"

namespace hvdtpu {

void StallInspector::RecordUncachedTensorStart(
    const std::string& tensor_name, int rank, int global_size,
    const std::vector<int>* members) {
  auto it = uncached_.find(tensor_name);
  if (it == uncached_.end()) {
    Uncached u;
    u.first = Clock::now();
    u.ready.insert(rank);
    if (members != nullptr) u.members = *members;
    uncached_.emplace(tensor_name, std::move(u));
  } else {
    it->second.ready.insert(rank);
    // Backfill the group scope: the FIRST announcement can precede this
    // process's new_group registration (the late-registration race),
    // arriving with no member list — a later member's announcement
    // carries it, and without the backfill a stalled group tensor would
    // list non-members as missing.
    if (it->second.members.empty() && members != nullptr) {
      it->second.members = *members;
    }
  }
  (void)global_size;
}

void StallInspector::RemoveUncachedTensor(const std::string& tensor_name) {
  uncached_.erase(tensor_name);
}

void StallInspector::RecordCachedTensorStart(const std::string& tensor_name) {
  if (cached_.find(tensor_name) == cached_.end()) {
    cached_[tensor_name] = Clock::now();
  }
}

void StallInspector::RemoveCachedTensor(const std::string& tensor_name) {
  cached_.erase(tensor_name);
}

bool StallInspector::CheckForStalledTensors(int global_size) {
  bool should_shut_down = false;
  auto now = Clock::now();
  // Group stalled tensors by their missing-rank set: the warning surface
  // is one line per SET per check (a 10k-tensor gradient bucket stalled
  // on one dead rank is one line, not 10k), and an unchanged set across
  // consecutive checks collapses to a short "still waiting" repeat line.
  // Every (tensor, check) stall event — printed or suppressed — counts
  // into the stall_warnings_total metric.
  struct Group {
    std::vector<std::string> names;
    long max_age = 0;
    int missing_count = 0;
  };
  std::map<std::string, Group> groups;  // key: "1, 3" missing-rank list
  for (const auto& kv : uncached_) {
    auto age = std::chrono::duration_cast<std::chrono::seconds>(
                   now - kv.second.first)
                   .count();
    if (age < warning_seconds_) continue;
    std::ostringstream missing;
    bool first = true;
    int missing_count = 0;
    // Group-scoped tensors only wait on their MEMBERS; non-members are
    // never "missing" (the tensor name itself carries the @g suffix).
    std::vector<int> expected = kv.second.members;
    if (expected.empty()) {
      expected.resize(static_cast<std::size_t>(global_size));
      for (int r = 0; r < global_size; ++r) expected[r] = r;
    }
    for (int r : expected) {
      if (kv.second.ready.count(r) == 0) {
        if (!first) missing << ", ";
        missing << r;
        first = false;
        ++missing_count;
      }
    }
    Group& g = groups[missing.str()];
    g.names.push_back(kv.first);
    g.max_age = std::max<long>(g.max_age, age);
    g.missing_count = missing_count;
    if (shutdown_seconds_ > 0 && age >= shutdown_seconds_) {
      should_shut_down = true;
    }
  }

  double since_last_check =
      std::chrono::duration<double>(now - last_check_).count();
  Metrics& metrics = GlobalMetrics();
  bool any_new = false;
  std::ostringstream warn;
  for (const auto& kv : groups) {
    const Group& g = kv.second;
    metrics.stall_warnings_total.fetch_add(g.names.size(),
                                           std::memory_order_relaxed);
    // Missing-rank seconds: each stalled tensor spent ~the check window
    // waiting on `missing_count` ranks since the last inspection.
    metrics.stall_missing_rank_micros_total.fetch_add(
        static_cast<uint64_t>(since_last_check * 1e6) * g.names.size() *
            g.missing_count,
        std::memory_order_relaxed);
    auto warned = warned_sets_.find(kv.first);
    if (warned != warned_sets_.end()) {
      // Same missing-rank set as a previous check: one compact repeat
      // line instead of re-listing every tensor.
      warned->second += 1;
      LOG(WARNING) << "Stall persists: " << g.names.size()
                   << " tensor(s) [missing ranks: " << kv.first
                   << "] still waiting after " << g.max_age
                   << "s (repeat #" << warned->second
                   << "; per-tensor details suppressed)";
      continue;
    }
    warned_sets_[kv.first] = 1;
    any_new = true;
    std::size_t shown = std::min<std::size_t>(g.names.size(), 5);
    warn << "\n" << g.names.size() << " tensor(s) [missing ranks: "
         << kv.first << "] waiting up to " << g.max_age << "s: ";
    for (std::size_t i = 0; i < shown; ++i) {
      if (i) warn << ", ";
      warn << g.names[i];
    }
    if (shown < g.names.size()) {
      warn << " (+" << g.names.size() - shown << " more)";
    }
  }
  // Sets that resolved (or changed membership) re-warn in full next time.
  for (auto it = warned_sets_.begin(); it != warned_sets_.end();) {
    if (groups.find(it->first) == groups.end()) {
      it = warned_sets_.erase(it);
    } else {
      ++it;
    }
  }

  if (any_new) {
    LOG(WARNING)
        << "One or more tensors were submitted to be reduced, gathered or "
           "broadcasted by subset of ranks and are waiting for remainder of "
           "ranks for more than " << warning_seconds_ << " seconds. This may "
           "indicate that different ranks are trying to submit different "
           "tensors or that only subset of ranks is submitting tensors, which "
           "will cause deadlock."
        << warn.str();
  }
  if (!groups.empty() && should_shut_down) {
    LOG(ERROR) << "Stall threshold exceeded; initiating coordinated "
                  "shutdown.";
  }
  return should_shut_down;
}

void StallInspector::InvalidateStalledCachedTensors(
    ResponseCache& cache, std::vector<uint32_t>& invalid_bits) {
  auto now = Clock::now();
  for (const auto& kv : cached_) {
    auto age =
        std::chrono::duration_cast<std::chrono::seconds>(now - kv.second)
            .count();
    if (age >= warning_seconds_) {
      invalid_bits.push_back(cache.peek_cache_bit(kv.first));
    }
  }
}

bool StallInspector::ShouldPerformCheck() {
  auto age = std::chrono::duration_cast<std::chrono::seconds>(Clock::now() -
                                                              last_check_)
                 .count();
  return warning_seconds_ > 0 && age >= warning_seconds_;
}

void StallInspector::UpdateCheckTime() { last_check_ = Clock::now(); }

}  // namespace hvdtpu
