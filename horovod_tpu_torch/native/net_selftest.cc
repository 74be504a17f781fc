// In-process transport selftests, exposed over the C API so the Python
// suite can unit-test the frame layer's failure paths (CRC detection,
// recv deadlines, oversize rejection, handshake timeouts) without
// spawning a multi-process job. Each scenario builds its sockets from
// scratch (socketpair / loopback listener), so these run tier-1-safe on
// any CPU-only host.
#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstring>
#include <string>
#include <thread>

#include "checksum.h"
#include "fault.h"
#include "logging.h"
#include "net.h"
#include "shm_context.h"

namespace hvdtpu {
namespace {

struct ConnPair {
  Conn a;
  Conn b;
  bool ok = false;

  ConnPair() {
    int fds[2];
    if (::socketpair(AF_UNIX, SOCK_STREAM, 0, fds) != 0) return;
    a = Conn(fds[0]);
    b = Conn(fds[1]);
    ok = true;
  }
};

// A frame survives the wire and verifies, for both recv flavors.
bool CrcRoundtrip() {
  ConnPair p;
  if (!p.ok) return false;
  std::string payload = "the quick brown fox jumps over the lazy dog";
  if (!p.a.SendFrame(0x42, payload)) return false;
  uint32_t tag = 0;
  std::string got;
  if (!p.b.RecvFrame(&tag, &got)) return false;
  if (tag != 0x42 || got != payload) return false;
  if (!p.a.SendFrame(0x43, payload)) return false;
  std::string fixed(payload.size(), '\0');
  if (!p.b.RecvFrameInto(&tag, &fixed[0], fixed.size())) return false;
  return tag == 0x43 && fixed == payload;
}

// A flipped payload byte is detected as a checksum mismatch, not
// returned as data.
bool CrcCorruptDetected() {
  ConnPair p;
  if (!p.ok) return false;
  std::string payload(4096, 'G');  // a "gradient"
  uint64_t len = payload.size();
  uint32_t tag = 0x42;
  char prefix[12];
  std::memcpy(prefix, &tag, 4);
  std::memcpy(prefix + 4, &len, 8);
  uint32_t crc = Crc32c(prefix, sizeof(prefix));
  crc = Crc32c(payload.data(), payload.size(), crc);
  payload[1000] ^= 0x1;  // the wire flip
  char hdr[kFrameHeaderBytes];
  BuildFrameHeader(hdr, tag, len, crc);
  if (!p.a.SendAll(hdr, sizeof(hdr))) return false;
  if (!p.a.SendAll(payload.data(), payload.size())) return false;
  std::string got;
  uint32_t rtag;
  if (p.b.RecvFrame(&rtag, &got)) return false;  // MUST fail
  return p.b.last_error() == NetError::CRC;
}

// A peer that sends nothing trips the recv deadline promptly (bounded,
// not forever).
bool RecvDeadline() {
  ConnPair p;
  if (!p.ok) return false;
  p.b.SetTimeouts(1);
  auto t0 = std::chrono::steady_clock::now();
  uint32_t tag;
  std::string got;
  bool recv_ok = p.b.RecvFrame(&tag, &got);
  double elapsed =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  return !recv_ok && p.b.last_error() == NetError::TIMEOUT &&
         elapsed < 5.0;
}

// A corrupt length field is rejected before allocation, not OOM'd on.
bool MaxFrameRejected() {
  ConnPair p;
  if (!p.ok) return false;
  char hdr[kFrameHeaderBytes];
  BuildFrameHeader(hdr, 0x42, ~0ull >> 1, 0);  // ~9 EB "frame"
  if (!p.a.SendAll(hdr, sizeof(hdr))) return false;
  uint32_t tag;
  std::string got;
  if (p.b.RecvFrame(&tag, &got)) return false;  // MUST fail
  return p.b.last_error() == NetError::TOO_BIG;
}

// A client that connects and never handshakes (port scanner, health
// probe) cannot wedge the accept loop: AcceptPeer returns within its
// deadline, and a REAL peer arriving later still gets through.
bool HandshakeTimeout() {
  Listener l;
  if (!l.Start(0)) return false;
  int silent = ::socket(AF_INET, SOCK_STREAM, 0);
  if (silent < 0) return false;
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(0x7F000001);  // 127.0.0.1
  addr.sin_port = htons(static_cast<uint16_t>(l.port()));
  if (::connect(silent, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
      0) {
    ::close(silent);
    return false;
  }
  // ... and says nothing. Accept must give up within the deadline.
  auto t0 = std::chrono::steady_clock::now();
  PeerHandshake hs;
  int fd = l.AcceptPeer(&hs, 500, /*expected_generation=*/0);
  double elapsed =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  bool timed_out = fd < 0 && elapsed < 5.0;

  // A real peer still gets accepted while the scanner dangles.
  std::thread peer([&] {
    Conn c = ConnectPeer("127.0.0.1", l.port(), /*my_rank=*/3,
                         Channel::CONTROL, /*timeout_ms=*/3000,
                         /*generation=*/7);
    // Hold the conn open until the acceptor has read the handshake.
    std::this_thread::sleep_for(std::chrono::milliseconds(300));
  });
  int fd2 = l.AcceptPeer(&hs, 3000, /*expected_generation=*/7);
  peer.join();
  bool accepted = fd2 >= 0 && hs.rank == 3 &&
                  hs.channel == Channel::CONTROL && hs.generation == 7;
  if (fd2 >= 0) ::close(fd2);
  ::close(silent);
  return timed_out && accepted;
}

// A stale-generation peer is rejected; a current-generation peer is not.
bool StaleGenerationRejected() {
  Listener l;
  if (!l.Start(0)) return false;
  std::thread stale([&] {
    ConnectPeer("127.0.0.1", l.port(), /*my_rank=*/1, Channel::CONTROL,
                /*timeout_ms=*/2000, /*generation=*/3);
  });
  std::thread current([&] {
    // Give the stale connect a head start so rejection is exercised.
    std::this_thread::sleep_for(std::chrono::milliseconds(200));
    Conn c = ConnectPeer("127.0.0.1", l.port(), /*my_rank=*/2,
                         Channel::CONTROL, /*timeout_ms=*/3000,
                         /*generation=*/4);
    std::this_thread::sleep_for(std::chrono::milliseconds(300));
  });
  PeerHandshake hs;
  int fd = l.AcceptPeer(&hs, 4000, /*expected_generation=*/4);
  stale.join();
  current.join();
  bool ok = fd >= 0 && hs.rank == 2 && hs.generation == 4;
  if (fd >= 0) ::close(fd);
  return ok;
}

// The fault-spec parser + seeded determinism: frame= fires exactly once
// at the right index; prob= replays identically for the same seed.
bool FaultSpecDeterministic() {
  FaultInjector inj;
  inj.Configure("seed=5;rank=1,chan=control,dir=send,frame=2,action=close",
                /*rank=*/1);
  if (!inj.active()) return false;
  for (int i = 0; i < 2; ++i) {
    if (inj.OnFrame(Channel::CONTROL, true).action != FaultAction::NONE) {
      return false;
    }
  }
  if (inj.OnFrame(Channel::CONTROL, true).action != FaultAction::CLOSE) {
    return false;
  }
  // count defaults to 1 for frame rules: never fires again.
  for (int i = 0; i < 8; ++i) {
    if (inj.OnFrame(Channel::CONTROL, true).action != FaultAction::NONE) {
      return false;
    }
  }
  // Rank filter: a rule for rank 1 never fires on rank 2.
  inj.Configure("rank=1,frame=0,action=drop", /*rank=*/2);
  if (inj.OnFrame(Channel::RING, true).action != FaultAction::NONE) {
    return false;
  }
  // Seeded prob= replay: identical decision streams for identical seeds.
  auto stream = [](uint64_t seed) {
    FaultInjector x;
    std::string spec =
        "seed=" + std::to_string(seed) + ";prob=0.3,action=delay,delay_ms=1";
    x.Configure(spec.c_str(), /*rank=*/0);
    std::string bits;
    for (int i = 0; i < 64; ++i) {
      bits.push_back(
          x.OnFrame(Channel::RING, false).action == FaultAction::NONE ? '0'
                                                                      : '1');
    }
    return bits;
  };
  std::string s1 = stream(99), s2 = stream(99), s3 = stream(100);
  if (s1 != s2) return false;
  if (s1.find('1') == std::string::npos) return false;  // must fire some
  return s1 != s3;  // and differ across seeds (64 frames: ~certain)
}

// ---- shared-memory transport scenarios (shm_context.{h,cc}) ----

static std::string UniqueShmName(const char* tag) {
  return std::string("/hvdtpu-selftest-") + tag + "-" +
         std::to_string(::getpid());
}

// A frame (header + payload) round-trips the SPSC ring bitwise,
// including a wrap-around (payload larger than the remaining tail of
// the ring), and the writer/reader counters agree.
bool ShmRoundtrip() {
  std::string name = UniqueShmName("rt");
  auto w = ShmRing::Create(name, 4096);
  if (w == nullptr) return false;
  auto r = ShmRing::Attach(name);
  if (r == nullptr) return false;
  w->MarkExchanged();
  std::string payload;
  for (int i = 0; i < 6000; ++i) payload.push_back(static_cast<char>(i));
  uint32_t crc = Crc32c(payload.data(), payload.size());
  // Pump concurrently: the payload exceeds the ring capacity, so the
  // writer must block on space while the reader drains — exactly the
  // double-buffered flow of a real hop.
  std::string got(payload.size(), '\0');
  std::thread reader([&] { r->ReadAll(&got[0], got.size(), 5000); });
  bool wrote = w->WriteAll(payload.data(), payload.size(), 5000);
  reader.join();
  if (!wrote || got != payload) return false;
  if (Crc32c(got.data(), got.size()) != crc) return false;
  // Orderly hangup: the reader drains leftovers then sees EOF.
  char c = 'x';
  if (w->WriteSome(&c, 1) != 1) return false;
  w->Close();
  char back;
  if (r->ReadSome(&back, 1) != 1 || back != 'x') return false;
  return r->ReadSome(&back, 1) == -1;  // closed AND drained = EOF
}

// A byte flipped INSIDE the mapped segment after the CRC was computed is
// a detected mismatch at verification time — the shm plane keeps the
// frame-CRC discipline (corruption surfaces as an error, never data).
bool ShmCorruptDetected() {
  std::string name = UniqueShmName("crc");
  auto w = ShmRing::Create(name, 1 << 16);
  if (w == nullptr) return false;
  auto r = ShmRing::Attach(name);
  if (r == nullptr) return false;
  w->MarkExchanged();
  std::string payload(4096, 'G');
  uint64_t len = payload.size();
  uint32_t tag = 0x20;
  uint32_t crc = FrameHeaderCrc(tag, len);
  crc = Crc32c(payload.data(), payload.size(), crc);
  payload[1000] ^= 0x1;  // the "wire" flip, after the checksum
  char hdr[kFrameHeaderBytes];
  BuildFrameHeader(hdr, tag, len, crc);
  if (!w->WriteAll(hdr, sizeof(hdr), 1000)) return false;
  if (!w->WriteAll(payload.data(), payload.size(), 1000)) return false;
  char rhdr[kFrameHeaderBytes];
  if (!r->ReadAll(rhdr, sizeof(rhdr), 1000)) return false;
  uint32_t rtag, rcrc;
  uint64_t rlen;
  ParseFrameHeader(rhdr, &rtag, &rlen, &rcrc);
  std::string got(static_cast<std::size_t>(rlen), '\0');
  if (!r->ReadAll(&got[0], got.size(), 1000)) return false;
  uint32_t acc = FrameHeaderCrc(rtag, rlen);
  acc = Crc32c(got.data(), got.size(), acc);
  return acc != rcrc;  // MUST mismatch — detected, not silently wrong
}

// Attach-side fallback negotiation: a nonexistent name, and a segment
// whose header does not parse, both refuse cleanly (nullptr — the
// caller's "ride TCP instead" path), and a good segment still attaches
// afterwards.
bool ShmFallbackNegotiation() {
  if (ShmRing::Attach(UniqueShmName("nonexistent")) != nullptr) return false;
  // A raw shm object with garbage where the header should be.
  std::string bogus = UniqueShmName("bogus");
  int fd = ::shm_open(bogus.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return false;
  if (::ftruncate(fd, 8192) != 0) {
    ::close(fd);
    ::shm_unlink(bogus.c_str());
    return false;
  }
  ::close(fd);
  bool refused = ShmRing::Attach(bogus) == nullptr;
  ::shm_unlink(bogus.c_str());
  if (!refused) return false;
  // And the happy path still works after the refusals.
  std::string good = UniqueShmName("good");
  auto w = ShmRing::Create(good, 4096);
  if (w == nullptr) return false;
  auto r = ShmRing::Attach(good);
  return r != nullptr && r->capacity() == 4096;
}

// Closing the writer wakes a parked reader promptly (no deadline-long
// hang), and a reader parked on an empty ring respects its timeout.
bool ShmClosedWakesPeer() {
  std::string name = UniqueShmName("close");
  auto w = ShmRing::Create(name, 4096);
  if (w == nullptr) return false;
  auto r = ShmRing::Attach(name);
  if (r == nullptr) return false;
  w->MarkExchanged();
  auto t0 = std::chrono::steady_clock::now();
  std::thread closer([&] {
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    w->Close();
  });
  char buf;
  bool read_failed = !r->ReadAll(&buf, 1, 10000);
  closer.join();
  double elapsed =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  return read_failed && elapsed < 5.0;
}

// ---- per-hop transport microbench (bench.py --shm) ----
//
// One ring hop = a full-duplex neighbor exchange: each side sends
// `nbytes` while receiving `nbytes` (exactly PairExchange's payload
// pump), including the 16-byte frame header and the receive-side
// incremental CRC. Two threads on this host play the two ranks; each
// direction gets its own transport pair (an SPSC shm ring, or one side
// of a socketpair) — the in-process setup isolates the TRANSPORT cost
// from the negotiation/control plane that dominates end-to-end op time
// on small hosts.

struct HopEnd {
  // shm transport
  ShmRing* out_ring = nullptr;
  ShmRing* in_ring = nullptr;
  // tcp transport
  int out_fd = -1;
  int in_fd = -1;
};

static bool HopExchange(HopEnd& e, const char* sbuf, char* rbuf,
                        std::size_t nbytes) {
  char shdr[kFrameHeaderBytes];
  uint32_t scrc = FrameCrc(0x20, nbytes, sbuf, nbytes);
  BuildFrameHeader(shdr, 0x20, nbytes, scrc);
  std::size_t hsent = 0, hrecv = 0, sent = 0, received = 0;
  char rhdr[kFrameHeaderBytes];
  uint32_t crc_acc = 0;
  bool crc_seeded = false;
  while (hsent < sizeof(shdr) || hrecv < sizeof(rhdr) ||
         sent < nbytes || received < nbytes) {
    bool progress = false;
    if (e.out_ring != nullptr) {
      if (hsent < sizeof(shdr)) {
        int64_t w = e.out_ring->WriteSome(shdr + hsent,
                                          sizeof(shdr) - hsent);
        if (w < 0) return false;
        if (w > 0) { hsent += w; progress = true; }
      } else if (sent < nbytes) {
        int64_t w = e.out_ring->WriteSome(sbuf + sent, nbytes - sent);
        if (w < 0) return false;
        if (w > 0) { sent += w; progress = true; }
      }
      if (hrecv < sizeof(rhdr)) {
        int64_t r = e.in_ring->ReadSome(rhdr + hrecv,
                                        sizeof(rhdr) - hrecv);
        if (r < 0) return false;
        if (r > 0) { hrecv += r; progress = true; }
      } else if (received < nbytes) {
        if (!crc_seeded) {
          uint32_t rtag, rcrc;
          uint64_t rlen;
          ParseFrameHeader(rhdr, &rtag, &rlen, &rcrc);
          crc_acc = NetCrcEnabled() ? FrameHeaderCrc(rtag, rlen) : 0;
          crc_seeded = true;
        }
        int64_t r = e.in_ring->ReadSome(rbuf + received,
                                        nbytes - received);
        if (r < 0) return false;
        if (r > 0) {
          if (NetCrcEnabled()) {
            crc_acc = Crc32c(rbuf + received, static_cast<std::size_t>(r),
                             crc_acc);
          }
          received += r;
          progress = true;
        }
      }
      if (!progress) {
        if (received < nbytes || hrecv < sizeof(rhdr)) {
          e.in_ring->WaitReadable(2);
        } else {
          e.out_ring->WaitWritable(2);
        }
      }
      continue;
    }
    // TCP: nonblocking duplex pump with poll, the production shape.
    struct pollfd pfds[2];
    int n = 0;
    if (hsent < sizeof(shdr) || sent < nbytes) {
      pfds[n++] = {e.out_fd, POLLOUT, 0};
    }
    if (hrecv < sizeof(rhdr) || received < nbytes) {
      pfds[n++] = {e.in_fd, POLLIN, 0};
    }
    if (::poll(pfds, n, 1000) < 0) return false;
    if (hsent < sizeof(shdr)) {
      ssize_t w = ::send(e.out_fd, shdr + hsent, sizeof(shdr) - hsent,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w > 0) hsent += w;
    } else if (sent < nbytes) {
      ssize_t w = ::send(e.out_fd, sbuf + sent, nbytes - sent,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK) return false;
      if (w > 0) sent += w;
    }
    if (hrecv < sizeof(rhdr)) {
      ssize_t r = ::recv(e.in_fd, rhdr + hrecv, sizeof(rhdr) - hrecv,
                         MSG_DONTWAIT);
      if (r == 0) return false;
      if (r > 0) hrecv += r;
    } else if (received < nbytes) {
      if (!crc_seeded) {
        uint32_t rtag, rcrc;
        uint64_t rlen;
        ParseFrameHeader(rhdr, &rtag, &rlen, &rcrc);
        crc_acc = NetCrcEnabled() ? FrameHeaderCrc(rtag, rlen) : 0;
        crc_seeded = true;
      }
      ssize_t r = ::recv(e.in_fd, rbuf + received, nbytes - received,
                         MSG_DONTWAIT);
      if (r == 0) return false;
      if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK) return false;
      if (r > 0) {
        if (NetCrcEnabled()) {
          crc_acc = Crc32c(rbuf + received, static_cast<std::size_t>(r),
                           crc_acc);
        }
        received += r;
      }
    }
  }
  // Verify like the production pump (keeps the CRC pass in the timing).
  uint32_t rtag, rcrc;
  uint64_t rlen;
  ParseFrameHeader(rhdr, &rtag, &rlen, &rcrc);
  return !NetCrcEnabled() || crc_acc == rcrc;
}

static double HopBench(bool use_shm, std::size_t nbytes, int iters) {
  HopEnd a, b;
  std::unique_ptr<ShmRing> rings[4];
  int fds_ab[2] = {-1, -1}, fds_ba[2] = {-1, -1};
  if (use_shm) {
    std::string base = UniqueShmName("hop");
    rings[0] = ShmRing::Create(base + "-ab", ShmSegmentBytes());
    rings[1] = ShmRing::Attach(base + "-ab");
    rings[2] = ShmRing::Create(base + "-ba", ShmSegmentBytes());
    rings[3] = ShmRing::Attach(base + "-ba");
    for (auto& r : rings) {
      if (r == nullptr) return -1.0;
    }
    rings[0]->MarkExchanged();
    rings[2]->MarkExchanged();
    a.out_ring = rings[0].get();
    b.in_ring = rings[1].get();
    b.out_ring = rings[2].get();
    a.in_ring = rings[3].get();
  } else {
    // The baseline is genuine TCP LOOPBACK (what the production data
    // plane rides intra-host without shm), not an AF_UNIX socketpair —
    // Unix sockets skip the TCP stack and would flatter the baseline.
    auto tcp_pair = [](int out[2]) {
      Listener l;
      if (!l.Start(0)) return false;
      int cfd = ::socket(AF_INET, SOCK_STREAM, 0);
      if (cfd < 0) return false;
      sockaddr_in addr;
      std::memset(&addr, 0, sizeof(addr));
      addr.sin_family = AF_INET;
      addr.sin_addr.s_addr = htonl(0x7F000001);
      addr.sin_port = htons(static_cast<uint16_t>(l.port()));
      if (::connect(cfd, reinterpret_cast<sockaddr*>(&addr),
                    sizeof(addr)) != 0) {
        ::close(cfd);
        return false;
      }
      int sfd = ::accept(l.fd(), nullptr, nullptr);
      if (sfd < 0) {
        ::close(cfd);
        return false;
      }
      ConfigureSocket(cfd);
      ConfigureSocket(sfd);
      out[0] = cfd;
      out[1] = sfd;
      return true;
    };
    if (!tcp_pair(fds_ab) || !tcp_pair(fds_ba)) return -1.0;
    a.out_fd = fds_ab[0];
    b.in_fd = fds_ab[1];
    b.out_fd = fds_ba[0];
    a.in_fd = fds_ba[1];
  }
  std::string sa(nbytes, 'a'), sb(nbytes, 'b');
  std::string ra(nbytes, 0), rb(nbytes, 0);
  std::atomic<bool> ok{true};
  double us = -1.0;
  {
    std::thread peer([&] {
      for (int i = 0; i < iters + 1 && ok.load(); ++i) {
        if (!HopExchange(b, sb.data(), &rb[0], nbytes)) ok.store(false);
      }
    });
    // Warmup hop, then the timed run.
    if (!HopExchange(a, sa.data(), &ra[0], nbytes)) ok.store(false);
    auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < iters && ok.load(); ++i) {
      if (!HopExchange(a, sa.data(), &ra[0], nbytes)) ok.store(false);
    }
    us = std::chrono::duration<double, std::micro>(
             std::chrono::steady_clock::now() - t0)
             .count() /
         iters;
    peer.join();
  }
  if (fds_ab[0] >= 0) {
    ::close(fds_ab[0]);
    ::close(fds_ab[1]);
    ::close(fds_ba[0]);
    ::close(fds_ba[1]);
  }
  if (!ok.load() || ra != sb) return -1.0;
  return us;
}

}  // namespace
}  // namespace hvdtpu

extern "C" {

// CRC32C of a buffer (known-answer tests from Python; also handy for
// tooling that wants to pre-checksum payloads).
uint32_t horovod_tpu_crc32c(const void* data, uint64_t len) {
  return hvdtpu::Crc32c(data, static_cast<std::size_t>(len));
}

// Incremental flavor: extend `crc` over another chunk.
uint32_t horovod_tpu_crc32c_extend(uint32_t crc, const void* data,
                                   uint64_t len) {
  return hvdtpu::Crc32c(data, static_cast<std::size_t>(len), crc);
}

// Per-hop transport microbench (bench.py --shm): microseconds for one
// full-duplex `nbytes` neighbor exchange (header + incremental CRC, the
// production pump shape) between two in-process threads over shared
// memory (use_shm=1) or a socketpair (0). Returns -1.0 on failure.
double horovod_tpu_hop_bench(int use_shm, int64_t nbytes, int iters) {
  return hvdtpu::HopBench(use_shm != 0,
                          static_cast<std::size_t>(nbytes),
                          iters < 1 ? 1 : iters);
}

// Runs the named transport selftest; 1 = pass, 0 = fail, -1 = unknown
// name. Scenarios: crc_roundtrip, crc_corrupt_detected, recv_deadline,
// max_frame, handshake_timeout, stale_generation, fault_spec.
int horovod_tpu_net_selftest(const char* name) {
  using namespace hvdtpu;
  std::string n(name ? name : "");
  if (n == "crc_roundtrip") return CrcRoundtrip() ? 1 : 0;
  if (n == "crc_corrupt_detected") return CrcCorruptDetected() ? 1 : 0;
  if (n == "recv_deadline") return RecvDeadline() ? 1 : 0;
  if (n == "max_frame") return MaxFrameRejected() ? 1 : 0;
  if (n == "handshake_timeout") return HandshakeTimeout() ? 1 : 0;
  if (n == "stale_generation") return StaleGenerationRejected() ? 1 : 0;
  if (n == "fault_spec") return FaultSpecDeterministic() ? 1 : 0;
  if (n == "shm_roundtrip") return ShmRoundtrip() ? 1 : 0;
  if (n == "shm_corrupt_detected") return ShmCorruptDetected() ? 1 : 0;
  if (n == "shm_fallback") return ShmFallbackNegotiation() ? 1 : 0;
  if (n == "shm_closed_wakes_peer") return ShmClosedWakesPeer() ? 1 : 0;
  return -1;
}

}  // extern "C"
