// Shared-memory intra-host data plane (docs/TRANSPORT.md).
//
// Every data-plane connection in this runtime is unidirectional (a ring
// member SENDS on its successor conn and RECEIVES on its predecessor
// conn — tcp_context.h PairExchange/PairBroadcast), so the shm
// transport is one single-producer single-consumer byte ring per
// connection: the CONNECTOR (the ring sender) creates the segment, the
// ACCEPTOR attaches read-only-in-role. A ring hop's payload then moves
// as one user-space memcpy per side instead of two kernel socket copies
// plus syscalls — the loopback-TCP overhead the original Horovod paper
// (arXiv 1802.05799) and the CUDA-aware-MPI characterization (arXiv
// 1810.11112) both identify as the dominant intra-node cost once the
// algorithm is ring-optimal.
//
// Segments are POSIX shm objects (shm_open) whose NAME is exchanged
// over the already-handshaked TCP connection (tcp_context.cc
// NegotiateShm): SCM_RIGHTS fd-passing needs a Unix-domain socket, so a
// memfd cannot cross the existing TCP rendezvous — named segments
// negotiated in-band fill that role, and the creator unlinks the name
// as soon as the peer has mapped it (the mappings keep it alive; no
// /dev/shm litter survives a crash of BOTH sides for longer than the
// next init's sweep of its own names).
//
// Signaling is spin-then-sleep: a reader/writer first spins briefly on
// the head/tail words (the common case — the peer is actively pumping),
// then parks on a futex word with a bounded timeout so a dead peer
// surfaces as a transport timeout, never a hang. The closed word makes
// an orderly hangup prompt in both directions.
//
// The frame protocol over the ring is IDENTICAL to the socket framing
// ([u32 tag][u64 len][u32 crc] + payload, net.h): CRC verification
// stays on by default (HVD_TPU_SHM_CRC=0 switches it off job-wide;
// memory is not a network, but a cheap end-to-end check catches DMA or
// logic corruption for ~free), so wire compression, pipelined
// segmenting, and the chaos invariant apply to shm legs unchanged.
#ifndef HVD_TPU_SHM_CONTEXT_H
#define HVD_TPU_SHM_CONTEXT_H

#include <atomic>
#include <cstdint>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "net.h"

namespace hvdtpu {

// Effective knob values (env, cached after first read).
bool ShmEnabled();              // HVD_TPU_SHM != 0 (default on; "0" = off)
bool ShmCrcEnabled();           // HVD_TPU_SHM_CRC (default: HVD_TPU_NET_CRC)
std::size_t ShmSegmentBytes();  // HVD_TPU_SHM_SEGMENT_BYTES, default 4 MiB

// Mapped-segment layout: one cache-line-padded header then `capacity`
// payload bytes. head/tail are free-running byte counters (head - tail
// = bytes in flight); data_seq/space_seq are the futex words the
// producer/consumer bump after publishing/consuming so the parked peer
// wakes; closed makes hangup prompt in both directions.
// Fields are grouped by WRITING side onto separate cache lines: the
// producer line (head, data_seq, write_waiters) is only ever stored by
// the writer, the consumer line only by the reader — so each side's
// hot-loop stores never invalidate a line the peer is also storing to
// (the ping-pong would tax every move on a shared-LLC host).
struct ShmRingHeader {
  uint32_t magic;
  uint32_t version;
  uint64_t capacity;
  // --- producer-written line ---
  alignas(64) std::atomic<uint64_t> head;       // bytes produced
  std::atomic<uint32_t> data_seq;               // bumped after publish
  std::atomic<uint32_t> write_waiters;          // writer announces a park
  // --- consumer-written line ---
  alignas(64) std::atomic<uint64_t> tail;       // bytes consumed
  std::atomic<uint32_t> space_seq;              // bumped after consume
  std::atomic<uint32_t> read_waiters;           // reader announces a park
  // --- rare events ---
  alignas(64) std::atomic<uint32_t> closed;     // either side hung up
};

// One direction of an intra-host pair: an SPSC byte ring in a POSIX shm
// segment. Exactly one of (writer, reader) per process per ring; all
// I/O happens on the background coordination thread (same discipline as
// the sockets it replaces).
class ShmRing {
 public:
  ~ShmRing();
  ShmRing(const ShmRing&) = delete;
  ShmRing& operator=(const ShmRing&) = delete;

  // Creator (writer) side: shm_open(O_CREAT|O_EXCL) + ftruncate + mmap.
  // Returns nullptr on failure (no /dev/shm, EEXIST, ...), which the
  // caller treats as "negotiate TCP instead".
  static std::unique_ptr<ShmRing> Create(const std::string& name,
                                         std::size_t capacity);
  // Attacher (reader) side: open + validate magic/version/capacity +
  // mmap. nullptr on any mismatch (the fallback path).
  static std::unique_ptr<ShmRing> Attach(const std::string& name);

  // Marks the ring closed, wakes any parked peer, and unmaps. Safe to
  // call twice. The creator additionally shm_unlinks (normally already
  // done at negotiation time — see MarkExchanged).
  void Close();
  bool closed() const;
  bool valid() const { return hdr_ != nullptr; }

  // Creator: the peer has mapped the segment — unlink the name now so
  // the kernel reclaims it when the last mapping drops, even on crash.
  void MarkExchanged();

  // Nonblocking progress: moves up to `len` bytes and returns how many
  // (0 = ring full/empty, would block), or -1 when the ring is closed.
  // Writer-side / reader-side respectively; never partial-syscall —
  // pure memcpy into/out of the mapped ring.
  int64_t WriteSome(const void* buf, std::size_t len);
  int64_t ReadSome(void* buf, std::size_t len);

  // Spin-then-sleep wait for readable bytes / writable space: spins a
  // short budget on the counter words, then parks on the futex word for
  // at most timeout_ms. Returns immediately when the condition already
  // holds or the ring is closed.
  void WaitReadable(int timeout_ms);
  void WaitWritable(int timeout_ms);

  // Blocking helpers for the tiny fixed-size header exchanges: false on
  // closed or when deadline_ms passes without completion.
  bool WriteAll(const void* buf, std::size_t len, int deadline_ms);
  bool ReadAll(void* buf, std::size_t len, int deadline_ms);

  std::size_t capacity() const { return hdr_ ? hdr_->capacity : 0; }
  const std::string& name() const { return name_; }
  bool creator() const { return creator_; }

 private:
  ShmRing(std::string name, bool creator) noexcept
      : name_(std::move(name)), creator_(creator) {}

  std::string name_;
  bool creator_ = false;
  bool unlinked_ = false;
  int fd_ = -1;
  ShmRingHeader* hdr_ = nullptr;
  char* data_ = nullptr;
  std::size_t map_bytes_ = 0;
};

// Process-wide registry of live segments: keeps the
// shm_segments_active gauge honest and lets Finalize/atexit sweep any
// creator-side name that never reached MarkExchanged (a peer that died
// mid-negotiation must not leave /dev/shm litter). Reached from the
// background thread (negotiation, Finalize) and the C selftest API, so
// the table is mutex-guarded.
class ShmSegmentTable {
 public:
  void Register(ShmRing* ring);
  void Unregister(ShmRing* ring);
  int active() const;
  // Unlinks every still-linked creator-side name (crash hygiene).
  void SweepNames();

 private:
  mutable std::mutex mu_;
  std::vector<ShmRing*> rings_;        // guarded_by(mu_)
  std::vector<std::string> pending_;   // guarded_by(mu_) names not yet unlinked

  friend class ShmRing;
};

ShmSegmentTable& GlobalShmSegments();

// Distinct, collision-free segment name for (rank pair, channel,
// generation): "/hvdtpu-<pid>-<gen>-<chan>-<me>-<peer>-<n>".
std::string ShmSegmentName(int my_rank, int peer_rank, int channel,
                           uint32_t generation);

// The PURE same-host key formula (one definition; TcpContext's
// DefaultHostKey/MyHostKey delegate here, the latter adding the
// per-rank HVD_TPU_HOST_KEY test override): the rank's HVD_TPU_ADDRS
// host, suffixed with its cross_rank when the topology is a forced
// multi-host grid (HVD_TPU_CROSS_SIZE > 1 on one physical box — the
// cross suffix keeps emulated "hosts" distinct; on real fleets ranks
// on one host share both the address and the cross index).
std::string ShmHostKey(const std::string& addr_host, int cross_rank,
                       int cross_size);

}  // namespace hvdtpu

#endif  // HVD_TPU_SHM_CONTEXT_H
