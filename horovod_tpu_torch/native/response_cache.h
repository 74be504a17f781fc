// LRU cache of negotiated Responses + cross-rank cache-bit coordinator.
//
// Why it exists: once a training loop reaches steady state, every cycle
// queues the same tensors with the same params. Caching the negotiated
// Response lets every cycle skip the coordinator round-trip entirely: ranks
// only exchange one fixed-size bit vector (bitwise AND) to agree on which
// cached entries are globally ready. This is the critical negotiation-latency
// optimization at large rank counts.
//
// Process groups (docs/GROUPS.md): entries are keyed on
// GroupQualifiedName(group, name), so the same tensor name active in two
// groups at once occupies two bits, and a tensor renegotiated under a
// DIFFERENT group id (membership change) reads as INVALID — erase and
// renegotiate, exactly like a compression-mode change. The bit protocol
// requires IDENTICAL cache contents on every rank, so ranks outside a
// response's group still mirror it as a FOREIGN entry (same bit position,
// no validation params) and treat its bit as vacuously ready each cycle
// (`NonMemberBits`) — the global AND then spans exactly the group's
// members, which is what "ready-rank bitmaps sized to the group" means
// on a bit-vector protocol.
//
// Capability parity with /root/reference horovod/common/response_cache.{h,cc}
// (ResponseCache + CacheCoordinator); fresh implementation.
#ifndef HVD_TPU_RESPONSE_CACHE_H
#define HVD_TPU_RESPONSE_CACHE_H

#include <cstdint>
#include <list>
#include <set>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "group_table.h"
#include "message.h"

namespace hvdtpu {

class TensorQueue;
class Controller;

class ResponseCache {
 public:
  enum class CacheState { MISS = 0, HIT = 1, INVALID = 2 };

  void set_capacity(uint32_t capacity);
  uint32_t capacity() const { return capacity_; }
  uint32_t num_active_bits() const;

  // Drops every cached entry and bit assignment. Called on re-init so a new
  // elastic generation (different size/topology) never executes a response
  // negotiated under the old membership.
  void clear();

  // MISS if never seen; HIT if cached with identical params; INVALID if the
  // (group, name) key is cached but shape/dtype/op params changed — or the
  // NAME is cached under a different group id (membership change). Either
  // way the stale entry must be dropped and renegotiated.
  CacheState cached(const Request& request) const;

  // Inserts (or refreshes) the response after a successful execution —
  // called with the IDENTICAL response list on every rank. Ranks outside
  // the response's group insert a foreign placeholder entry so bit
  // positions stay rank-identical; `groups`/`my_rank` decide membership.
  void put(const Response& response, TensorQueue& tensor_queue,
           const GroupTable* groups, int my_rank);

  // Bit <-> response lookups for the fast path.
  const Response& get_response(uint32_t cache_bit);
  const Response& peek_response(uint32_t cache_bit) const;
  uint32_t peek_cache_bit(const Request& request) const;
  // Lookup by composite cache key (GroupQualifiedName) — the stall
  // inspector records cached tensors under this key.
  uint32_t peek_cache_bit(const std::string& cache_key) const;

  // Bits whose entry belongs to a group THIS rank is not a member of —
  // recorded as vacuous hits every cycle so the cross-rank AND only
  // spans actual members.
  void NonMemberBits(std::vector<uint32_t>* out) const;

  void erase_response(uint32_t cache_bit);
  // Re-packs cache bits 0..N-1 in LRU order after evictions/erases so all
  // ranks agree on bit positions (called while ranks are in sync).
  void update_cache_bits();

 private:
  struct CacheEntry {
    Response response;
    std::string key;  // GroupQualifiedName(group_id, name)
    // Params captured from the Request for validity checking.
    DataType dtype;
    std::vector<int64_t> shape;
    int32_t root_rank = 0;
    double prescale_factor = 1.0;
    double postscale_factor = 1.0;
    // Wire-compression mode is part of the cache key: a hit with a
    // different mode is INVALID (renegotiate), never a silent reuse of
    // a response negotiated under another codec.
    uint8_t compression = 0;
    // The tensor's device (HOST_DEVICE_ID or a CUDA ordinal) is part of
    // the key too: a name reduced on the host and then on a GPU must
    // renegotiate, or the host op would replay on device pointers.
    int32_t device = -1;
    // Process-group scope. group_digest guards against a same-id
    // membership change; is_member gates the vacuous-hit sweep;
    // foreign entries (mirrored on non-members) carry no validation
    // params and read INVALID on any local lookup.
    uint32_t group_id = 0;
    uint64_t group_digest = 0;
    bool is_member = true;
    bool foreign = false;
  };

  void put_entry(CacheEntry entry);  // keyed by entry.key
  void DropNameRef(const std::string& name);

  uint32_t capacity_ = 1024;
  // LRU list of cache bits; most recent at front. cache_[bit] = entry.
  std::vector<CacheEntry> cache_;
  std::vector<std::list<uint32_t>::iterator> cache_iters_;
  std::list<uint32_t> lru_;
  std::unordered_map<std::string, uint32_t> key_to_bit_;
  // BARE tensor name -> number of cached entries with it (any group).
  // Gate for the membership-change INVALID scan in cached(): a plain
  // miss (e.g. every auto-named tensor, which is fresh each call) must
  // stay one hash lookup — the O(entries) scan only runs when the name
  // genuinely exists under some other group.
  std::unordered_map<std::string, uint32_t> name_refs_;
  // Entries with is_member == false — gates NonMemberBits' per-cycle
  // scan off entirely for pure data-parallel jobs.
  uint32_t non_member_entries_ = 0;
  bool bits_outdated_ = false;
};

// Packs per-cycle cache hit/invalid bit sets plus status flags and syncs them
// across ranks with one bitwise-AND allreduce (+ a second OR pass when any
// rank reports invalid entries).
class CacheCoordinator {
 public:
  explicit CacheCoordinator(std::size_t num_active_bits);

  void record_hit(uint32_t bit);
  void record_invalid_bit(uint32_t bit);
  void erase_hit(uint32_t bit);

  void set_should_shut_down(bool v) { should_shut_down_ = v; }
  void set_uncached_in_queue(bool v) { uncached_in_queue_ = v; }

  const std::set<uint32_t>& cache_hits() const { return cache_hits_; }
  const std::set<uint32_t>& invalid_bits() const { return invalid_bits_; }
  const std::set<uint32_t>& timeline_bits() const { return timeline_bits_; }
  bool should_shut_down() const { return should_shut_down_; }
  bool uncached_in_queue() const { return uncached_in_queue_; }
  bool invalid_in_queue() const { return invalid_in_queue_; }

  // Performs the cross-rank sync through the controller's bit-allreduce.
  // After this call, cache_hits() is the global intersection, and
  // invalid_bits() the global union (when any rank had invalids).
  void sync(Controller* controller, bool timeline_enabled);

 private:
  enum StatusBit {
    SHOULD_SHUT_DOWN = 0,
    UNCACHED_IN_QUEUE = 1,
    INVALID_IN_QUEUE = 2,
  };

  std::size_t num_active_bits_;
  std::set<uint32_t> cache_hits_;
  std::set<uint32_t> invalid_bits_;
  // Bits that were hits locally but lost globally — timeline shows these as
  // still negotiating.
  std::set<uint32_t> timeline_bits_;
  bool should_shut_down_ = false;
  bool uncached_in_queue_ = false;
  bool invalid_in_queue_ = false;
  bool synced_ = false;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_RESPONSE_CACHE_H
