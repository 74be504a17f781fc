// Process-group registry (docs/GROUPS.md): id -> ordered member ranks.
//
// Group 0 is the implicit world group and is never stored. Every other
// group is created by horovod_tpu_new_group, which EVERY rank must call
// with the identical rank list in the identical order — ids are assigned
// from a per-process counter, so the same call sequence yields the same
// ids on every rank (the same discipline the auto-name counter uses).
// Non-members register too: the response cache needs every rank to know
// every group's membership so the cache-bit protocol can treat "not my
// group" as vacuously ready (response_cache.h).
//
// The registry is immutable per entry (groups are never resized — an
// elastic membership change clears the table on re-init and Python
// re-creates the mesh groups), so readers only race the registration
// writes, which the mutex covers. Horovod's own coordinator never had
// communicator support (SURVEY §0); this table is the core of it.
#ifndef HVD_TPU_GROUP_TABLE_H
#define HVD_TPU_GROUP_TABLE_H

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace hvdtpu {

// Composite "tensor in group" key: the coordinator's pending table, the
// response cache, the stall inspector, and the call tracker all key on
// this so the SAME tensor name active in two disjoint groups at once
// (the 2-D mesh's per-column gradient reduce) never collides. The @g
// suffix is deliberately human-readable — it appears verbatim in stall
// and divergence diagnostics, which must name the group.
inline std::string GroupQualifiedName(uint32_t group,
                                      const std::string& name) {
  if (group == 0) return name;
  return name + "@g" + std::to_string(group);
}

class GroupTable {
 public:
  // Registers a group; `members` must be strictly ascending world ranks.
  // Returns the new id (>= 1), or 0 on invalid input. The caller
  // (operations.cc) validates ranks against world size.
  uint32_t Register(std::vector<int> members) {
    if (members.empty()) return 0;
    for (std::size_t i = 1; i < members.size(); ++i) {
      if (members[i] <= members[i - 1]) return 0;
    }
    uint64_t digest = 14695981039346656037ULL;  // FNV-1a offset basis
    for (int r : members) {
      for (int b = 0; b < 4; ++b) {
        digest = (digest ^ ((static_cast<uint32_t>(r) >> (8 * b)) & 0xFF)) *
                 1099511628211ULL;
      }
    }
    std::lock_guard<std::mutex> lk(mu_);
    uint32_t id = next_id_++;
    groups_.emplace(id, Entry{std::move(members), digest});
    return id;
  }

  // Member ranks (ascending); empty when the id is unknown.
  std::vector<int> Members(uint32_t id) const {
    if (id == 0) return {};
    std::lock_guard<std::mutex> lk(mu_);
    auto it = groups_.find(id);
    return it == groups_.end() ? std::vector<int>() : it->second.members;
  }

  // Group size; 0 when unknown (group 0 is the caller's world size).
  int Size(uint32_t id) const {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = groups_.find(id);
    return it == groups_.end() ? 0 : static_cast<int>(it->second.members.size());
  }

  // Rank's position in the group's ring order; -1 when not a member (or
  // the id is unknown).
  int IndexOf(uint32_t id, int rank) const {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = groups_.find(id);
    if (it == groups_.end()) return -1;
    const auto& m = it->second.members;
    auto pos = std::lower_bound(m.begin(), m.end(), rank);
    if (pos == m.end() || *pos != rank) return -1;
    return static_cast<int>(pos - m.begin());
  }

  bool Contains(uint32_t id, int rank) const { return IndexOf(id, rank) >= 0; }

  // Membership digest — rides every group Request so ranks that called
  // new_group with DIFFERENT rank lists for the same id are rejected by
  // name at negotiation (mixed membership) instead of hanging.
  uint64_t Digest(uint32_t id) const {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = groups_.find(id);
    return it == groups_.end() ? 0 : it->second.digest;
  }

  std::size_t Count() const {
    std::lock_guard<std::mutex> lk(mu_);
    return groups_.size();
  }

  std::string DescribeMembers(uint32_t id) const {
    std::ostringstream os;
    os << "[";
    bool first = true;
    for (int r : Members(id)) {
      if (!first) os << ", ";
      os << r;
      first = false;
    }
    os << "]";
    return os.str();
  }

  // Generation reset (elastic re-init): the old membership's groups
  // reference dead ranks; Python re-creates the mesh groups after init.
  void Clear() {
    std::lock_guard<std::mutex> lk(mu_);
    groups_.clear();
    next_id_ = 1;
  }

 private:
  struct Entry {
    std::vector<int> members;
    uint64_t digest;
  };

  mutable std::mutex mu_;
  std::unordered_map<uint32_t, Entry> groups_;  // guarded_by(mu_)
  uint32_t next_id_ = 1;                        // guarded_by(mu_)
};

}  // namespace hvdtpu

#endif  // HVD_TPU_GROUP_TABLE_H
