#include "response_cache.h"

#include <cassert>

#include "controller.h"
#include "logging.h"
#include "tensor_queue.h"

namespace hvdtpu {

void ResponseCache::set_capacity(uint32_t capacity) {
  capacity_ = capacity;
  cache_.reserve(capacity);
  cache_iters_.reserve(capacity);
}

uint32_t ResponseCache::num_active_bits() const {
  return static_cast<uint32_t>(cache_.size());
}

void ResponseCache::clear() {
  cache_.clear();
  cache_iters_.clear();
  lru_.clear();
  key_to_bit_.clear();
  name_refs_.clear();
  non_member_entries_ = 0;
  bits_outdated_ = false;
}

ResponseCache::CacheState ResponseCache::cached(const Request& request) const {
  const std::string key =
      GroupQualifiedName(request.group_id(), request.tensor_name());
  auto it = key_to_bit_.find(key);
  if (it == key_to_bit_.end()) {
    // The NAME cached under a different group id is a membership change:
    // INVALID, so the stale entry is erased on every rank (via the
    // invalid-bit OR sync) and the tensor renegotiates under its new
    // group — same contract as a compression-mode change. The bare-name
    // index keeps the ordinary miss (every auto-named tensor, fresh
    // each call) a single hash lookup; the scan only runs when the name
    // genuinely lives under some other group.
    if (name_refs_.count(request.tensor_name())) {
      for (const auto& e : cache_) {
        if (e.response.tensor_names()[0] == request.tensor_name() &&
            e.group_id != request.group_id()) {
          return CacheState::INVALID;
        }
      }
    }
    return CacheState::MISS;
  }
  const CacheEntry& e = cache_[it->second];
  // Foreign entries are bit-position mirrors on non-members; they carry
  // no validation params. A local lookup on one means this rank now
  // enqueues a (group, name) it never executed — renegotiate.
  if (e.foreign) return CacheState::INVALID;
  bool same = e.dtype == request.tensor_type() &&
              e.shape == request.tensor_shape() &&
              e.root_rank == request.root_rank() &&
              e.prescale_factor == request.prescale_factor() &&
              e.postscale_factor == request.postscale_factor() &&
              e.compression == request.compression() &&
              e.device == request.device() &&
              e.group_digest == request.group_digest();
  // Response type must match the request type too. The two enums agree
  // numerically for allreduce/allgather/broadcast but diverge at
  // REDUCESCATTER (Response appends it AFTER ERROR for wire
  // compatibility, Request has no ERROR) — map before comparing, or a
  // cached reduce-scatter could never hit.
  int cached_as_request =
      e.response.response_type() == Response::REDUCESCATTER
          ? static_cast<int>(Request::REDUCESCATTER)
          : static_cast<int>(e.response.response_type());
  same = same &&
         cached_as_request == static_cast<int>(request.request_type());
  return same ? CacheState::HIT : CacheState::INVALID;
}

void ResponseCache::put_entry(CacheEntry entry) {
  // Copies, not references: `entry` is moved into the slot below, and a
  // reference into the moved-from object would index an empty key.
  const std::string key = entry.key;
  const std::string name = entry.response.tensor_names()[0];
  const bool new_non_member = !entry.is_member;
  auto it = key_to_bit_.find(key);
  if (it != key_to_bit_.end()) {
    uint32_t bit = it->second;
    if (!cache_[bit].is_member) --non_member_entries_;
    if (new_non_member) ++non_member_entries_;
    cache_[bit] = std::move(entry);
    lru_.erase(cache_iters_[bit]);
    lru_.push_front(bit);
    cache_iters_[bit] = lru_.begin();
    return;
  }
  uint32_t bit;
  if (cache_.size() < capacity_) {
    bit = static_cast<uint32_t>(cache_.size());
    cache_.push_back(std::move(entry));
    lru_.push_front(bit);
    cache_iters_.push_back(lru_.begin());
  } else {
    // Evict the LRU entry; its bit is recycled, so positions shift — all
    // ranks evict identically because they run identical put sequences.
    bit = lru_.back();
    lru_.pop_back();
    key_to_bit_.erase(cache_[bit].key);
    DropNameRef(cache_[bit].response.tensor_names()[0]);
    if (!cache_[bit].is_member) --non_member_entries_;
    cache_[bit] = std::move(entry);
    lru_.push_front(bit);
    cache_iters_[bit] = lru_.begin();
    bits_outdated_ = true;
  }
  key_to_bit_[key] = bit;
  name_refs_[name] += 1;
  if (new_non_member) ++non_member_entries_;
}

void ResponseCache::put(const Response& response, TensorQueue& tensor_queue,
                        const GroupTable* groups, int my_rank) {
  if (capacity_ == 0) return;
  if (response.response_type() == Response::ERROR) return;
  uint32_t gid = response.group_id();
  bool member = gid == 0 ||
                (groups != nullptr && groups->Contains(gid, my_rank));
  // Fused responses are cached per-tensor so each tensor can hit alone.
  for (std::size_t i = 0; i < response.tensor_names().size(); ++i) {
    const std::string& name = response.tensor_names()[i];
    Response single;
    single.set_response_type(response.response_type());
    single.set_tensor_type(response.tensor_type());
    single.set_devices(response.devices());
    single.set_compression(response.compression());
    single.set_group_id(gid);
    single.add_tensor_name(name);
    CacheEntry entry;
    entry.key = GroupQualifiedName(gid, name);
    entry.group_id = gid;
    entry.group_digest =
        gid != 0 && groups != nullptr ? groups->Digest(gid) : 0;
    entry.is_member = member;
    // Capture validation params from the table entry if it still exists;
    // member callers invoke put() before callbacks fire, so it does.
    if (member && tensor_queue.HasEntry(name) &&
        tensor_queue.GetTensorEntry(name).group_id == gid) {
      const TensorTableEntry& te = tensor_queue.GetTensorEntry(name);
      entry.dtype = te.dtype;
      entry.shape = te.shape.dims();
      entry.root_rank = te.root_rank;
      entry.prescale_factor = te.prescale_factor;
      entry.postscale_factor = te.postscale_factor;
      entry.compression = te.compression;
      entry.device = te.device;
      if (response.response_type() == Response::ALLGATHER) {
        single.set_tensor_sizes(response.tensor_sizes());
      } else {
        // Allreduce/broadcast: carry the element count so the
        // cached-path FuseResponses sees real bytes — without it a
        // cached response weighs 0 and fusion merges past the
        // threshold.
        single.add_tensor_size(te.shape.num_elements());
      }
    } else {
      // Foreign mirror: this rank never executes (group, name), but the
      // bit POSITION must exist here too or the cross-rank bit vectors
      // desync. Sizes come from the response so fusion weighing stays
      // rank-identical on the cached fast path.
      entry.dtype = response.tensor_type();
      entry.foreign = true;
      if (response.response_type() == Response::ALLGATHER) {
        single.set_tensor_sizes(response.tensor_sizes());
      } else if (i < response.tensor_sizes().size()) {
        single.add_tensor_size(response.tensor_sizes()[i]);
      }
    }
    entry.response = single;
    put_entry(std::move(entry));
  }
}

const Response& ResponseCache::get_response(uint32_t cache_bit) {
  assert(cache_bit < cache_.size());
  lru_.erase(cache_iters_[cache_bit]);
  lru_.push_front(cache_bit);
  cache_iters_[cache_bit] = lru_.begin();
  return cache_[cache_bit].response;
}

const Response& ResponseCache::peek_response(uint32_t cache_bit) const {
  assert(cache_bit < cache_.size());
  return cache_[cache_bit].response;
}

uint32_t ResponseCache::peek_cache_bit(const Request& request) const {
  auto it = key_to_bit_.find(
      GroupQualifiedName(request.group_id(), request.tensor_name()));
  if (it != key_to_bit_.end()) return it->second;
  // Membership-change INVALID path: the name lives under another group's
  // key — return that stale bit so the invalid-bit sync erases it.
  for (uint32_t bit = 0; bit < cache_.size(); ++bit) {
    if (cache_[bit].response.tensor_names()[0] == request.tensor_name()) {
      return bit;
    }
  }
  assert(false && "peek_cache_bit on an uncached request");
  return 0;
}

uint32_t ResponseCache::peek_cache_bit(const std::string& cache_key) const {
  auto it = key_to_bit_.find(cache_key);
  assert(it != key_to_bit_.end());
  return it->second;
}

void ResponseCache::NonMemberBits(std::vector<uint32_t>* out) const {
  // O(1) in the common (pure data-parallel) case: no foreign entries,
  // no scan — this runs every negotiation cycle.
  if (non_member_entries_ == 0) return;
  for (uint32_t bit = 0; bit < cache_.size(); ++bit) {
    if (!cache_[bit].is_member) out->push_back(bit);
  }
}

void ResponseCache::DropNameRef(const std::string& name) {
  auto it = name_refs_.find(name);
  if (it == name_refs_.end()) return;
  if (--it->second == 0) name_refs_.erase(it);
}

void ResponseCache::erase_response(uint32_t cache_bit) {
  if (cache_bit >= cache_.size()) return;
  key_to_bit_.erase(cache_[cache_bit].key);
  DropNameRef(cache_[cache_bit].response.tensor_names()[0]);
  if (!cache_[cache_bit].is_member) --non_member_entries_;
  lru_.erase(cache_iters_[cache_bit]);
  // Compact: move last entry into the freed slot to keep bits dense.
  uint32_t last = static_cast<uint32_t>(cache_.size()) - 1;
  if (cache_bit != last) {
    cache_[cache_bit] = std::move(cache_[last]);
    cache_iters_[cache_bit] = cache_iters_[last];
    *cache_iters_[cache_bit] = cache_bit;
    key_to_bit_[cache_[cache_bit].key] = cache_bit;
  }
  cache_.pop_back();
  cache_iters_.pop_back();
  bits_outdated_ = true;
}

void ResponseCache::update_cache_bits() {
  if (!bits_outdated_) return;
  // Reassign bits by LRU order (most recent = 0) so bit positions are a pure
  // function of the (identical) access history on every rank.
  std::vector<CacheEntry> new_cache;
  new_cache.reserve(cache_.size());
  std::list<uint32_t> new_lru;
  std::vector<std::list<uint32_t>::iterator> new_iters(cache_.size());
  uint32_t new_bit = 0;
  for (uint32_t old_bit : lru_) {
    new_cache.push_back(std::move(cache_[old_bit]));
    new_lru.push_back(new_bit);
    ++new_bit;
  }
  uint32_t i = 0;
  for (auto it = new_lru.begin(); it != new_lru.end(); ++it, ++i) {
    new_iters[i] = it;
  }
  cache_ = std::move(new_cache);
  lru_ = std::move(new_lru);
  cache_iters_ = std::move(new_iters);
  key_to_bit_.clear();
  for (uint32_t bit = 0; bit < cache_.size(); ++bit) {
    key_to_bit_[cache_[bit].key] = bit;
  }
  bits_outdated_ = false;
}

CacheCoordinator::CacheCoordinator(std::size_t num_active_bits)
    : num_active_bits_(num_active_bits) {}

void CacheCoordinator::record_hit(uint32_t bit) {
  assert(!synced_);
  cache_hits_.insert(bit);
}

void CacheCoordinator::record_invalid_bit(uint32_t bit) {
  assert(!synced_);
  invalid_bits_.insert(bit);
  invalid_in_queue_ = true;
}

void CacheCoordinator::erase_hit(uint32_t bit) { cache_hits_.erase(bit); }

void CacheCoordinator::sync(Controller* controller, bool timeline_enabled) {
  assert(!synced_);
  // Layout: word 0 = status bits (inverted semantics for AND: a bit survives
  // the AND only if *every* rank set it; for "any rank wants X" flags we set
  // the bit when X is FALSE locally and invert after, i.e. surviving bit
  // means "no rank wants X").
  std::size_t num_words = (num_active_bits_ + 63) / 64 + 1;
  std::vector<uint64_t> bits(num_words, 0);
  if (!should_shut_down_) bits[0] |= 1ull << SHOULD_SHUT_DOWN;
  if (!uncached_in_queue_) bits[0] |= 1ull << UNCACHED_IN_QUEUE;
  if (!invalid_in_queue_) bits[0] |= 1ull << INVALID_IN_QUEUE;
  for (uint32_t bit : cache_hits_) {
    bits[1 + bit / 64] |= 1ull << (bit % 64);
  }
  controller->CrossRankBitwiseAnd(bits);

  should_shut_down_ = (bits[0] & (1ull << SHOULD_SHUT_DOWN)) == 0;
  uncached_in_queue_ = (bits[0] & (1ull << UNCACHED_IN_QUEUE)) == 0;
  invalid_in_queue_ = (bits[0] & (1ull << INVALID_IN_QUEUE)) == 0;

  std::set<uint32_t> global_hits;
  for (uint32_t bit = 0; bit < num_active_bits_; ++bit) {
    bool global = (bits[1 + bit / 64] & (1ull << (bit % 64))) != 0;
    if (global) {
      global_hits.insert(bit);
    } else if (timeline_enabled && cache_hits_.count(bit)) {
      timeline_bits_.insert(bit);
    }
  }
  cache_hits_ = std::move(global_hits);

  if (invalid_in_queue_) {
    // Second pass: union of invalid bits so every rank drops the same set.
    std::vector<uint64_t> inv(num_words, 0);
    for (uint32_t bit : invalid_bits_) {
      inv[1 + bit / 64] |= 1ull << (bit % 64);
    }
    controller->CrossRankBitwiseOr(inv);
    invalid_bits_.clear();
    for (uint32_t bit = 0; bit < num_active_bits_; ++bit) {
      if (inv[1 + bit / 64] & (1ull << (bit % 64))) {
        invalid_bits_.insert(bit);
        cache_hits_.erase(bit);
      }
    }
  }
  synced_ = true;
}

}  // namespace hvdtpu
