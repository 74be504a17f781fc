#include "shm_context.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <thread>

#ifdef __linux__
#include <linux/futex.h>
#include <sys/syscall.h>
#include <sys/time.h>
#endif

#include "logging.h"
#include "metrics.h"

namespace hvdtpu {

static constexpr uint32_t kShmMagic = 0x53484d52;  // "SHMR"
static constexpr uint32_t kShmVersion = 1;

bool ShmEnabled() {
  static bool v = [] {
    const char* e = std::getenv("HVD_TPU_SHM");
    return e == nullptr || e[0] != '0';
  }();
  return v;
}

bool ShmCrcEnabled() {
  static bool v = [] {
    const char* e = std::getenv("HVD_TPU_SHM_CRC");
    if (e != nullptr) return e[0] != '0';
    return NetCrcEnabled();
  }();
  return v;
}

std::size_t ShmSegmentBytes() {
  static std::size_t v = [] {
    const char* e = std::getenv("HVD_TPU_SHM_SEGMENT_BYTES");
    // Default 4 MiB: large enough that a typical ring chunk (a 2-rank
    // hop of a 4 MB fused buffer is 2 MB) fits the ring whole, so the
    // writer publishes without ping-ponging with the reader's drain —
    // on small hosts the context-switch cadence, not the copies, is
    // what that saves.
    long long b = e ? std::strtoll(e, nullptr, 10) : (4ll << 20);
    // Floor: one frame header plus a sane payload slice must fit, and
    // the double-buffered pipelining the ring exists for needs at least
    // two slices in flight.
    if (b < 4096) b = 4096;
    return static_cast<std::size_t>(b);
  }();
  return v;
}

std::string ShmSegmentName(int my_rank, int peer_rank, int channel,
                           uint32_t generation) {
  static std::atomic<uint64_t> counter{0};
  char buf[96];
  std::snprintf(buf, sizeof(buf), "/hvdtpu-%d-%u-%d-%d-%d-%llu",
                static_cast<int>(::getpid()), generation, channel, my_rank,
                peer_rank,
                static_cast<unsigned long long>(
                    counter.fetch_add(1, std::memory_order_relaxed)));
  return buf;
}

std::string ShmHostKey(const std::string& addr_host, int cross_rank,
                       int cross_size) {
  if (cross_size > 1) {
    return addr_host + "/c" + std::to_string(cross_rank);
  }
  return addr_host;
}

// ---------------- futex ----------------

static void FutexWait(std::atomic<uint32_t>* addr, uint32_t expected,
                      int timeout_ms) {
#ifdef __linux__
  struct timespec ts;
  ts.tv_sec = timeout_ms / 1000;
  ts.tv_nsec = (timeout_ms % 1000) * 1000000l;
  ::syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT,
            expected, &ts, nullptr, 0);
#else
  (void)addr;
  (void)expected;
  std::this_thread::sleep_for(std::chrono::milliseconds(
      timeout_ms < 1 ? 1 : std::min(timeout_ms, 2)));
#endif
}

static void FutexWake(std::atomic<uint32_t>* addr) {
#ifdef __linux__
  ::syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE,
            INT32_MAX, nullptr, nullptr, 0);
#else
  (void)addr;
#endif
}

// ---------------- segment table ----------------

void ShmSegmentTable::Register(ShmRing* ring) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    rings_.push_back(ring);
    if (ring->creator()) pending_.push_back(ring->name());
  }
  GlobalMetrics().shm_segments_active.store(active(),
                                            std::memory_order_relaxed);
}

void ShmSegmentTable::Unregister(ShmRing* ring) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    rings_.erase(std::remove(rings_.begin(), rings_.end(), ring),
                 rings_.end());
    pending_.erase(
        std::remove(pending_.begin(), pending_.end(), ring->name()),
        pending_.end());
  }
  GlobalMetrics().shm_segments_active.store(active(),
                                            std::memory_order_relaxed);
}

int ShmSegmentTable::active() const {
  std::lock_guard<std::mutex> lk(mu_);
  return static_cast<int>(rings_.size());
}

void ShmSegmentTable::SweepNames() {
  std::lock_guard<std::mutex> lk(mu_);
  for (const auto& name : pending_) ::shm_unlink(name.c_str());
  pending_.clear();
}

ShmSegmentTable& GlobalShmSegments() {
  static ShmSegmentTable* table = new ShmSegmentTable();  // outlives threads
  return *table;
}

// ---------------- ShmRing ----------------

std::unique_ptr<ShmRing> ShmRing::Create(const std::string& name,
                                         std::size_t capacity) {
  int fd = ::shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    LOG(WARNING) << "shm_open(" << name << ") failed: " << strerror(errno)
                 << " — pair falls back to TCP";
    return nullptr;
  }
  std::size_t total = sizeof(ShmRingHeader) + capacity;
  if (::ftruncate(fd, static_cast<off_t>(total)) != 0) {
    ::close(fd);
    ::shm_unlink(name.c_str());
    return nullptr;
  }
  void* map = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                     fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    ::shm_unlink(name.c_str());
    return nullptr;
  }
  std::unique_ptr<ShmRing> ring(new ShmRing(name, /*creator=*/true));
  ring->fd_ = fd;
  ring->map_bytes_ = total;
  ring->hdr_ = new (map) ShmRingHeader();
  ring->hdr_->capacity = capacity;
  ring->hdr_->head.store(0, std::memory_order_relaxed);
  ring->hdr_->tail.store(0, std::memory_order_relaxed);
  ring->hdr_->data_seq.store(0, std::memory_order_relaxed);
  ring->hdr_->space_seq.store(0, std::memory_order_relaxed);
  ring->hdr_->read_waiters.store(0, std::memory_order_relaxed);
  ring->hdr_->write_waiters.store(0, std::memory_order_relaxed);
  ring->hdr_->closed.store(0, std::memory_order_relaxed);
  ring->hdr_->version = kShmVersion;
  // Magic last, release: an attacher that sees the magic sees a fully
  // initialized header.
  ring->data_ = static_cast<char*>(map) + sizeof(ShmRingHeader);
  std::atomic_thread_fence(std::memory_order_release);
  ring->hdr_->magic = kShmMagic;
  GlobalShmSegments().Register(ring.get());
  return ring;
}

std::unique_ptr<ShmRing> ShmRing::Attach(const std::string& name) {
  int fd = ::shm_open(name.c_str(), O_RDWR, 0600);
  if (fd < 0) {
    LOG(WARNING) << "shm attach(" << name << ") failed: " << strerror(errno)
                 << " — pair falls back to TCP";
    return nullptr;
  }
  struct stat st;
  if (::fstat(fd, &st) != 0 ||
      static_cast<std::size_t>(st.st_size) <= sizeof(ShmRingHeader)) {
    ::close(fd);
    return nullptr;
  }
  std::size_t total = static_cast<std::size_t>(st.st_size);
  void* map = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                     fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ShmRingHeader* hdr = static_cast<ShmRingHeader*>(map);
  if (hdr->magic != kShmMagic || hdr->version != kShmVersion ||
      sizeof(ShmRingHeader) + hdr->capacity != total) {
    LOG(WARNING) << "shm attach(" << name
                 << "): header mismatch — pair falls back to TCP";
    ::munmap(map, total);
    ::close(fd);
    return nullptr;
  }
  std::unique_ptr<ShmRing> ring(new ShmRing(name, /*creator=*/false));
  ring->fd_ = fd;
  ring->map_bytes_ = total;
  ring->hdr_ = hdr;
  ring->data_ = static_cast<char*>(map) + sizeof(ShmRingHeader);
  GlobalShmSegments().Register(ring.get());
  return ring;
}

ShmRing::~ShmRing() { Close(); }

void ShmRing::MarkExchanged() {
  if (creator_ && !unlinked_) {
    ::shm_unlink(name_.c_str());
    unlinked_ = true;
    std::lock_guard<std::mutex> lk(GlobalShmSegments().mu_);
    auto& pending = GlobalShmSegments().pending_;
    pending.erase(std::remove(pending.begin(), pending.end(), name_),
                  pending.end());
  }
}

void ShmRing::Close() {
  if (hdr_ == nullptr) return;
  hdr_->closed.store(1, std::memory_order_release);
  // Wake a peer parked on either futex so it observes the hangup now,
  // not at its wait timeout (unconditional: hangup is rare and a missed
  // wake here would cost a full wait timeout).
  hdr_->data_seq.fetch_add(1, std::memory_order_release);
  hdr_->space_seq.fetch_add(1, std::memory_order_release);
  FutexWake(&hdr_->data_seq);
  FutexWake(&hdr_->space_seq);
  GlobalShmSegments().Unregister(this);
  MarkExchanged();
  ::munmap(static_cast<void*>(hdr_), map_bytes_);
  hdr_ = nullptr;
  data_ = nullptr;
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool ShmRing::closed() const {
  return hdr_ == nullptr || hdr_->closed.load(std::memory_order_acquire) != 0;
}

// Per-call move quantum: a counter (head/tail) only advances AFTER its
// memcpy, so one giant move would serialize the producer's copy-in
// against the consumer's copy-out. Bounded moves publish progress
// incrementally and the two sides' copies overlap — the shm analogue of
// TCP's segment-sized pipelining, with zero syscalls.
static constexpr std::size_t kShmMoveQuantum = 128 << 10;

int64_t ShmRing::WriteSome(const void* buf, std::size_t len) {
  if (closed()) return -1;
  uint64_t head = hdr_->head.load(std::memory_order_relaxed);
  uint64_t tail = hdr_->tail.load(std::memory_order_acquire);
  std::size_t cap = hdr_->capacity;
  std::size_t space = cap - static_cast<std::size_t>(head - tail);
  if (space == 0) return 0;
  std::size_t n = std::min(std::min(len, space), kShmMoveQuantum);
  std::size_t pos = static_cast<std::size_t>(head % cap);
  std::size_t first = std::min(n, cap - pos);
  std::memcpy(data_ + pos, buf, first);
  if (n > first) {
    std::memcpy(data_, static_cast<const char*>(buf) + first, n - first);
  }
  hdr_->head.store(head + n, std::memory_order_release);
  // seq bump is unconditional (the kernel's FUTEX_WAIT compare makes a
  // parked peer with a stale expected value return immediately); the
  // WAKE syscall only fires when the reader announced it is parked.
  // seq_cst on the bump and the waiters load pairs with the reader's
  // seq_cst store/load (WaitReadable): in the SC order either the
  // reader sees the new seq (no sleep) or the writer sees the waiter
  // flag (wake) — a missed wake is impossible.
  hdr_->data_seq.fetch_add(1, std::memory_order_seq_cst);
  if (hdr_->read_waiters.load(std::memory_order_seq_cst) != 0) {
    FutexWake(&hdr_->data_seq);
  }
  return static_cast<int64_t>(n);
}

int64_t ShmRing::ReadSome(void* buf, std::size_t len) {
  if (hdr_ == nullptr) return -1;
  uint64_t tail = hdr_->tail.load(std::memory_order_relaxed);
  uint64_t head = hdr_->head.load(std::memory_order_acquire);
  std::size_t avail = static_cast<std::size_t>(head - tail);
  if (avail == 0) {
    // Drained AND hung up = EOF; closed with bytes still in flight
    // drains first (orderly shutdown mirrors TCP semantics).
    return closed() ? -1 : 0;
  }
  std::size_t cap = hdr_->capacity;
  std::size_t n = std::min(std::min(len, avail), kShmMoveQuantum);
  std::size_t pos = static_cast<std::size_t>(tail % cap);
  std::size_t first = std::min(n, cap - pos);
  std::memcpy(buf, data_ + pos, first);
  if (n > first) {
    std::memcpy(static_cast<char*>(buf) + first, data_, n - first);
  }
  hdr_->tail.store(tail + n, std::memory_order_release);
  hdr_->space_seq.fetch_add(1, std::memory_order_seq_cst);
  if (hdr_->write_waiters.load(std::memory_order_seq_cst) != 0) {
    FutexWake(&hdr_->space_seq);
  }
  return static_cast<int64_t>(n);
}

// Spin budget before parking: covers the common case where the peer is
// actively pumping the other end of the same exchange (it publishes
// within the spin, saving the ~10-20us park+wake round trip) without
// burning a core while it encodes a big chunk. Sized in PAUSE terms:
// a modern PAUSE is ~140 cycles, so 64 of them is a few microseconds —
// a longer spin would cost more than the futex park it avoids
// (measured on this container; bench.py --shm).
static constexpr int kSpinIters = 64;

// Polite spin: the PAUSE hint keeps a spinning hyperthread/core from
// flooding the coherence fabric with speculative loads of the line the
// peer is actively writing (its memcpy shares the same LLC here).
static inline void CpuRelax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#elif defined(__aarch64__)
  asm volatile("yield");
#endif
}

void ShmRing::WaitReadable(int timeout_ms) {
  if (hdr_ == nullptr) return;
  for (int i = 0; i < kSpinIters; ++i) {
    if (hdr_->head.load(std::memory_order_acquire) !=
            hdr_->tail.load(std::memory_order_relaxed) ||
        closed()) {
      return;
    }
    CpuRelax();
  }
  // Announce the park BEFORE loading the expected seq: paired with the
  // writer's seq_cst bump-then-load-waiters, either the writer sees the
  // flag (wake) or this load sees the bumped seq and FUTEX_WAIT's
  // compare returns immediately — a missed wake is impossible.
  hdr_->read_waiters.store(1, std::memory_order_seq_cst);
  uint32_t seq = hdr_->data_seq.load(std::memory_order_seq_cst);
  if (hdr_->head.load(std::memory_order_acquire) ==
          hdr_->tail.load(std::memory_order_relaxed) &&
      !closed()) {
    FutexWait(&hdr_->data_seq, seq, timeout_ms);
  }
  hdr_->read_waiters.store(0, std::memory_order_release);
}

void ShmRing::WaitWritable(int timeout_ms) {
  if (hdr_ == nullptr) return;
  std::size_t cap = hdr_->capacity;
  for (int i = 0; i < kSpinIters; ++i) {
    if (hdr_->head.load(std::memory_order_relaxed) -
                hdr_->tail.load(std::memory_order_acquire) <
            cap ||
        closed()) {
      return;
    }
    CpuRelax();
  }
  hdr_->write_waiters.store(1, std::memory_order_seq_cst);
  uint32_t seq = hdr_->space_seq.load(std::memory_order_seq_cst);
  if (hdr_->head.load(std::memory_order_relaxed) -
              hdr_->tail.load(std::memory_order_acquire) >=
          cap &&
      !closed()) {
    FutexWait(&hdr_->space_seq, seq, timeout_ms);
  }
  hdr_->write_waiters.store(0, std::memory_order_release);
}

bool ShmRing::WriteAll(const void* buf, std::size_t len, int deadline_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(deadline_ms);
  const char* p = static_cast<const char*>(buf);
  std::size_t done = 0;
  while (done < len) {
    int64_t n = WriteSome(p + done, len - done);
    if (n < 0) return false;
    if (n == 0) {
      if (std::chrono::steady_clock::now() >= deadline) return false;
      WaitWritable(5);
      continue;
    }
    done += static_cast<std::size_t>(n);
  }
  return true;
}

bool ShmRing::ReadAll(void* buf, std::size_t len, int deadline_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(deadline_ms);
  char* p = static_cast<char*>(buf);
  std::size_t done = 0;
  while (done < len) {
    int64_t n = ReadSome(p + done, len - done);
    if (n < 0) return false;
    if (n == 0) {
      if (std::chrono::steady_clock::now() >= deadline) return false;
      WaitReadable(5);
      continue;
    }
    done += static_cast<std::size_t>(n);
  }
  return true;
}

}  // namespace hvdtpu
