#include "net.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <thread>

#include "checksum.h"
#include "fault.h"
#include "logging.h"
#include "metrics.h"
#include "shm_context.h"

namespace hvdtpu {

// v2 magic ("HVDU"): bumped from the pre-checksum "HVDT" so a
// mixed-version pairing fails loudly at handshake instead of as a
// baffling checksum mismatch on frame 0.
static constexpr uint32_t kHandshakeMagic = 0x48564455;

const char* NetErrorName(NetError e) {
  switch (e) {
    case NetError::NONE: return "ok";
    case NetError::CLOSED: return "connection closed by peer";
    case NetError::TIMEOUT: return "I/O deadline expired (hung peer?)";
    case NetError::CRC: return "frame checksum mismatch (corrupted frame)";
    case NetError::TOO_BIG: return "frame length exceeds HVD_TPU_MAX_FRAME_BYTES";
    case NetError::PROTOCOL: return "malformed frame";
  }
  return "?";
}

// ---------------- knobs (env, cached) ----------------

static long long EnvLL(const char* name, long long dflt) {
  const char* v = std::getenv(name);
  return v == nullptr ? dflt : std::strtoll(v, nullptr, 10);
}

std::size_t MaxFrameBytes() {
  static std::size_t v = [] {
    long long b = EnvLL("HVD_TPU_MAX_FRAME_BYTES", 1ll << 30);
    if (b < 4096) b = 4096;  // floor: control frames must still fit
    return static_cast<std::size_t>(b);
  }();
  return v;
}

int NetTimeoutSeconds() {
  static int v = [] {
    // Default rides the control poll window so the two deadline layers
    // agree (the oversubscribed 1024-rank sweep raises both via the
    // poll env; see tcp_context.cc ControlPollMs).
    long long s = EnvLL("HVD_TPU_NET_TIMEOUT_SECONDS",
                        EnvLL("HVD_TPU_CONTROL_POLL_TIMEOUT_SECONDS", 60));
    if (s <= 0) s = 60;
    if (s > 2147483) s = 2147483;
    return static_cast<int>(s);
  }();
  return v;
}

bool NetCrcEnabled() {
  static bool v = [] {
    const char* e = std::getenv("HVD_TPU_NET_CRC");
    return e == nullptr || e[0] != '0';
  }();
  return v;
}

static int KeepaliveSeconds() {
  static int v = [] {
    long long s = EnvLL("HVD_TPU_NET_KEEPALIVE_SECONDS", 10);
    if (s > 32767) s = 32767;
    return static_cast<int>(s);
  }();
  return v;
}

static void SetSocketTimeouts(int fd, int seconds) {
  struct timeval tv;
  tv.tv_sec = seconds;
  tv.tv_usec = 0;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

void ConfigureSocket(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  SetSocketTimeouts(fd, NetTimeoutSeconds());
  // Keepalive: a powered-off host sends no RST — without probes its
  // connections stay ESTABLISHED until the first write times out.
  // idle/intvl/cnt tuned so a vanished peer is detected in roughly
  // idle + 3*intvl seconds rather than the kernel's two hours.
  int idle = KeepaliveSeconds();
  if (idle > 0) {
    ::setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &one, sizeof(one));
#ifdef TCP_KEEPIDLE
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPIDLE, &idle, sizeof(idle));
    int intvl = idle / 3 > 0 ? idle / 3 : 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPINTVL, &intvl, sizeof(intvl));
    int cnt = 3;
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPCNT, &cnt, sizeof(cnt));
#endif
  }
}

// ---------------- frame header ----------------

void BuildFrameHeader(char* hdr, uint32_t tag, uint64_t len, uint32_t crc) {
  std::memcpy(hdr, &tag, 4);
  std::memcpy(hdr + 4, &len, 8);
  std::memcpy(hdr + 12, &crc, 4);
}

void ParseFrameHeader(const char* hdr, uint32_t* tag, uint64_t* len,
                      uint32_t* crc) {
  std::memcpy(tag, hdr, 4);
  std::memcpy(len, hdr + 4, 8);
  std::memcpy(crc, hdr + 12, 4);
}

uint32_t FrameHeaderCrc(uint32_t tag, uint64_t len) {
  char prefix[12];
  std::memcpy(prefix, &tag, 4);
  std::memcpy(prefix + 4, &len, 8);
  return Crc32c(prefix, sizeof(prefix));
}

uint32_t FrameCrc(uint32_t tag, uint64_t len, const void* payload,
                  std::size_t n) {
  if (!NetCrcEnabled()) return 0;
  uint32_t crc = FrameHeaderCrc(tag, len);
  if (n > 0) crc = Crc32c(payload, n, crc);
  return crc;
}

// ---------------- Conn ----------------

Conn::~Conn() { Close(); }

Conn& Conn::operator=(Conn&& o) noexcept {
  if (this != &o) {
    Close();
    fd_ = o.fd_;
    channel_ = o.channel_;
    shm_ = o.shm_;
    o.fd_ = -1;
    o.shm_ = nullptr;
  }
  return *this;
}

void Conn::AttachShm(ShmRing* ring) {
  if (shm_ != nullptr) delete shm_;
  shm_ = ring;
}

void Conn::Close() {
  if (shm_ != nullptr) {
    delete shm_;  // ShmRing::~ShmRing closes + wakes the peer
    shm_ = nullptr;
  }
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

void Conn::SetTimeouts(int seconds) {
  if (fd_ >= 0) SetSocketTimeouts(fd_, seconds);
}

void Conn::NoteIoError(ssize_t n, bool sending) {
  if (n == 0) {
    last_error_ = NetError::CLOSED;
    return;
  }
  if (errno == EAGAIN || errno == EWOULDBLOCK) {
    // Blocking socket + SO_RCVTIMEO/SO_SNDTIMEO: EAGAIN means the
    // deadline expired with the peer silent — the hung-peer signal.
    last_error_ = NetError::TIMEOUT;
    Metrics& m = GlobalMetrics();
    (sending ? m.net_send_timeouts_total : m.net_recv_timeouts_total)
        .fetch_add(1, std::memory_order_relaxed);
    return;
  }
  last_error_ = NetError::CLOSED;
}

bool Conn::SendAll(const void* buf, std::size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t n = ::send(fd_, p, len, MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      NoteIoError(n, /*sending=*/true);
      return false;
    }
    p += n;
    len -= static_cast<std::size_t>(n);
  }
  return true;
}

bool Conn::RecvAll(void* buf, std::size_t len) {
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t n = ::recv(fd_, p, len, 0);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      NoteIoError(n, /*sending=*/false);
      return false;
    }
    p += n;
    len -= static_cast<std::size_t>(n);
  }
  return true;
}

bool Conn::SendFrame(uint32_t tag, const void* payload, std::size_t len) {
  last_error_ = NetError::NONE;
  uint32_t crc = FrameCrc(tag, len, payload, len);
  FaultInjector& inj = GlobalFaultInjector();
  std::string corrupted;
  if (inj.active()) {
    FaultDecision d = inj.OnFrame(channel_, /*send=*/true);
    switch (d.action) {
      case FaultAction::DROP:
        return true;  // silently not sent: the peer's deadline must fire
      case FaultAction::DELAY:
      case FaultAction::STALL:
        std::this_thread::sleep_for(std::chrono::milliseconds(d.delay_ms));
        break;
      case FaultAction::CLOSE:
        Close();
        break;
      case FaultAction::CORRUPT:
        // Flip one payload byte AFTER the CRC was computed: the wire
        // carries corrupted data with an honest checksum, exactly what
        // a flaky NIC produces. Zero-length frames flip the crc itself.
        if (len > 0) {
          corrupted.assign(static_cast<const char*>(payload), len);
          corrupted[len / 2] ^= 0x20;
          payload = corrupted.data();
        } else {
          crc ^= 0x1;
        }
        break;
      case FaultAction::NONE:
        break;
    }
  }
  char hdr[kFrameHeaderBytes];
  BuildFrameHeader(hdr, tag, len, crc);
  if (!SendAll(hdr, sizeof(hdr))) return false;
  if (len > 0 && !SendAll(payload, len)) return false;
  return true;
}

bool Conn::RecvFrame(uint32_t* tag, std::string* payload) {
  last_error_ = NetError::NONE;
  FaultInjector& inj = GlobalFaultInjector();
  bool corrupt_in = false;
  if (inj.active()) {
    FaultDecision d = inj.OnFrame(channel_, /*send=*/false);
    switch (d.action) {
      case FaultAction::DELAY:
      case FaultAction::STALL:
        std::this_thread::sleep_for(std::chrono::milliseconds(d.delay_ms));
        break;
      case FaultAction::CLOSE:
        Close();
        break;
      case FaultAction::CORRUPT:
        corrupt_in = true;
        break;
      default:
        break;  // drop is send-side only
    }
  }
  char hdr[kFrameHeaderBytes];
  if (!RecvAll(hdr, sizeof(hdr))) return false;
  uint64_t len64;
  uint32_t crc;
  ParseFrameHeader(hdr, tag, &len64, &crc);
  if (len64 > MaxFrameBytes()) {
    // One corrupted length field must mean a detected error, not an
    // attempted multi-terabyte allocation.
    LOG(ERROR) << "frame length " << len64 << " exceeds max "
               << MaxFrameBytes() << " — rejecting (corrupt frame?)";
    last_error_ = NetError::TOO_BIG;
    GlobalMetrics().net_oversize_frames_total.fetch_add(
        1, std::memory_order_relaxed);
    return false;
  }
  payload->resize(len64);
  if (len64 > 0 && !RecvAll(&(*payload)[0], len64)) return false;
  if (corrupt_in && len64 > 0) (*payload)[len64 / 2] ^= 0x20;
  if (NetCrcEnabled() &&
      FrameCrc(*tag, len64, payload->data(), payload->size()) != crc) {
    LOG(ERROR) << "frame checksum mismatch (tag " << *tag << ", len "
               << len64 << ") — corrupted frame detected";
    last_error_ = NetError::CRC;
    GlobalMetrics().net_crc_errors_total.fetch_add(1,
                                                   std::memory_order_relaxed);
    return false;
  }
  return true;
}

bool Conn::RecvFrameInto(uint32_t* tag, void* buf, std::size_t expected_len) {
  last_error_ = NetError::NONE;
  FaultInjector& inj = GlobalFaultInjector();
  bool corrupt_in = false;
  if (inj.active()) {
    FaultDecision d = inj.OnFrame(channel_, /*send=*/false);
    switch (d.action) {
      case FaultAction::DELAY:
      case FaultAction::STALL:
        std::this_thread::sleep_for(std::chrono::milliseconds(d.delay_ms));
        break;
      case FaultAction::CLOSE:
        Close();
        break;
      case FaultAction::CORRUPT:
        corrupt_in = true;
        break;
      default:
        break;
    }
  }
  char hdr[kFrameHeaderBytes];
  if (!RecvAll(hdr, sizeof(hdr))) return false;
  uint64_t len64;
  uint32_t crc;
  ParseFrameHeader(hdr, tag, &len64, &crc);
  if (len64 != expected_len) {
    LOG(ERROR) << "frame length mismatch: got " << len64 << " expected "
               << expected_len;
    last_error_ = NetError::PROTOCOL;
    return false;
  }
  if (expected_len > 0 && !RecvAll(buf, expected_len)) return false;
  if (corrupt_in && expected_len > 0) {
    static_cast<char*>(buf)[expected_len / 2] ^= 0x20;
  }
  if (NetCrcEnabled() &&
      FrameCrc(*tag, len64, buf, expected_len) != crc) {
    LOG(ERROR) << "frame checksum mismatch (tag " << *tag << ", len "
               << len64 << ") — corrupted frame detected";
    last_error_ = NetError::CRC;
    GlobalMetrics().net_crc_errors_total.fetch_add(1,
                                                   std::memory_order_relaxed);
    return false;
  }
  return true;
}

// ---------------- Listener ----------------

Listener::~Listener() { Close(); }

void Listener::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool Listener::Start(int port) {
  fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd_ < 0) return false;
  int one = 1;
  ::setsockopt(fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  // Dynamic rendezvous holds the reserved ephemeral port open in a
  // bound (never listening) Python socket until init completes, so no
  // other process can be handed it; binding alongside that reservation
  // requires SO_REUSEPORT on both. Only set when the port is such a
  // reservation — fixed-port configs keep strict EADDRINUSE semantics.
  const char* held = std::getenv("HVD_TPU_LISTEN_REUSEPORT");
  if (held && held[0] == '1') {
    ::setsockopt(fd_, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  }
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    LOG(ERROR) << "bind failed on port " << port << ": " << strerror(errno);
    Close();
    return false;
  }
  // Backlog sized for the coordinator's connect storm: at init (and
  // after a mass control-reconnect) every worker dials rank 0's
  // listener at once, and a 128-entry queue drops SYNs past ~128 ranks
  // on a slow-to-accept (oversubscribed) host. The kernel clamps to
  // somaxconn.
  if (::listen(fd_, 1024) != 0) {
    Close();
    return false;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
  port_ = ntohs(addr.sin_port);
  return true;
}

// Reads exactly n handshake bytes from a fresh connection, bounded by
// deadline_ms from now (poll + nonblocking-style recv via MSG_DONTWAIT
// so a silent client cannot hold the accept loop hostage).
static bool RecvHandshakeBounded(int fd, void* buf, std::size_t n,
                                 int deadline_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(deadline_ms);
  char* p = static_cast<char*>(buf);
  std::size_t got = 0;
  while (got < n) {
    auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                    deadline - std::chrono::steady_clock::now())
                    .count();
    if (left <= 0) return false;
    struct pollfd pfd = {fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, static_cast<int>(left));
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return false;
    ssize_t r = ::recv(fd, p + got, n - got, MSG_DONTWAIT);
    if (r == 0) return false;
    if (r < 0) {
      if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK) continue;
      return false;
    }
    got += static_cast<std::size_t>(r);
  }
  return true;
}

static void EncodeHandshake(char* hs, int32_t rank, Channel channel,
                            uint8_t flags, uint32_t generation,
                            uint64_t opseq) {
  std::memcpy(hs, &kHandshakeMagic, 4);
  std::memcpy(hs + 4, &rank, 4);
  hs[8] = static_cast<char>(channel);
  hs[9] = static_cast<char>(flags);
  std::memcpy(hs + 10, &generation, 4);
  std::memcpy(hs + 14, &opseq, 8);
}

int Listener::AcceptPeer(PeerHandshake* hs, int timeout_ms,
                         uint32_t expected_generation) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
  while (true) {
    int wait_ms = timeout_ms;
    if (timeout_ms >= 0) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                      deadline - std::chrono::steady_clock::now())
                      .count();
      if (left < 0) return -1;
      wait_ms = static_cast<int>(left);
    }
    struct pollfd pfd = {fd_, POLLIN, 0};
    int pr = ::poll(&pfd, 1, wait_ms);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return -1;
    int cfd = ::accept(fd_, nullptr, nullptr);
    if (cfd < 0) {
      if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK ||
          errno == ECONNABORTED) {
        continue;
      }
      return -1;
    }
    ConfigureSocket(cfd);
    // Handshake read bounded independently of the overall accept
    // deadline: a silent client gets a short window, then the loop
    // returns to accepting real peers.
    int hs_ms = 5000;
    if (timeout_ms >= 0) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                      deadline - std::chrono::steady_clock::now())
                      .count();
      if (left < hs_ms) hs_ms = left > 0 ? static_cast<int>(left) : 1;
    }
    char buf[kHandshakeBytes];
    if (!RecvHandshakeBounded(cfd, buf, sizeof(buf), hs_ms)) {
      LOG(WARNING) << "dropping connection with no/short handshake "
                   << "(port scanner or stalled peer)";
      ::close(cfd);
      continue;
    }
    uint32_t magic;
    std::memcpy(&magic, buf, 4);
    if (magic != kHandshakeMagic) {
      LOG(ERROR) << "bad handshake magic — dropping connection";
      ::close(cfd);
      continue;
    }
    PeerHandshake parsed;
    std::memcpy(&parsed.rank, buf + 4, 4);
    parsed.channel = static_cast<Channel>(buf[8]);
    parsed.flags = static_cast<uint8_t>(buf[9]);
    std::memcpy(&parsed.generation, buf + 10, 4);
    std::memcpy(&parsed.opseq, buf + 14, 8);
    if (parsed.generation != expected_generation) {
      // A worker from an older elastic generation must never splice
      // into this ring; reject and keep accepting current-generation
      // peers. (A reconnect attempt gets an explicit verdict byte so
      // it fails fast instead of retrying the backoff budget out.)
      LOG(WARNING) << "rejecting rank " << parsed.rank
                   << " with stale generation " << parsed.generation
                   << " (current " << expected_generation << ")";
      if (parsed.flags & kHandshakeReconnect) {
        char verdict = 0;
        ::send(cfd, &verdict, 1, MSG_NOSIGNAL);
      }
      ::close(cfd);
      continue;
    }
    *hs = parsed;
    return cfd;
  }
}

// ---------------- ConnectPeer ----------------

// One non-blocking connect attempt bounded by attempt_ms.
static int ConnectOnce(const struct addrinfo* ai, int attempt_ms) {
  int fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
  if (fd < 0) return -1;
  int flags = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = ::connect(fd, ai->ai_addr, ai->ai_addrlen);
  if (rc != 0) {
    if (errno != EINPROGRESS) {
      ::close(fd);
      return -1;
    }
    struct pollfd pfd = {fd, POLLOUT, 0};
    int pr = ::poll(&pfd, 1, attempt_ms);
    if (pr <= 0) {
      // Blackholed host: SYN answered by nothing. Give up on THIS
      // attempt; the caller's retry loop owns the overall deadline.
      ::close(fd);
      return -1;
    }
    int err = 0;
    socklen_t elen = sizeof(err);
    if (::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) != 0 ||
        err != 0) {
      ::close(fd);
      return -1;
    }
  }
  ::fcntl(fd, F_SETFL, flags);  // back to blocking for the framed I/O
  return fd;
}

Conn ConnectPeer(const std::string& host, int port, int my_rank,
                 Channel channel, int timeout_ms, uint32_t generation,
                 uint64_t opseq, bool reconnect, bool group_ring,
                 bool shm_cap) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (true) {
    auto left_ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                       deadline - std::chrono::steady_clock::now())
                       .count();
    struct addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    std::string port_s = std::to_string(port);
    int fd = -1;
    // Per-attempt ceiling: 2 s (or what's left of the deadline), so
    // one blackholed address can't consume the whole budget.
    int attempt_ms = 2000;
    if (left_ms > 0 && left_ms < attempt_ms) {
      attempt_ms = static_cast<int>(left_ms);
    }
    if (attempt_ms < 50) attempt_ms = 50;
    if (::getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) == 0) {
      for (auto* ai = res; ai != nullptr; ai = ai->ai_next) {
        fd = ConnectOnce(ai, attempt_ms);
        if (fd >= 0) break;
      }
      ::freeaddrinfo(res);
    }
    if (fd >= 0) {
      ConfigureSocket(fd);
      Conn c(fd, channel);
      char hs[kHandshakeBytes];
      EncodeHandshake(hs, my_rank, channel,
                      static_cast<uint8_t>(
                          (reconnect ? kHandshakeReconnect : 0) |
                          (group_ring ? kHandshakeGroupRing : 0) |
                          (shm_cap ? kHandshakeShmCap : 0)),
                      generation, opseq);
      if (c.SendAll(hs, sizeof(hs))) {
        if (!reconnect) return c;
        // Reconnects wait for the acceptor's verdict so a rejected
        // resume (desynced opseq / stale generation) fails fast. The
        // verdict read is bounded by the ATTEMPT budget, not the full
        // net deadline — a coordinator that accepted the TCP connection
        // but never services it must not eat the whole reconnect window.
        c.SetTimeouts(attempt_ms / 1000 + 1);
        char verdict = 0;
        if (c.RecvAll(&verdict, 1) && verdict == 1) {
          c.SetTimeouts(NetTimeoutSeconds());
          return c;
        }
        LOG(WARNING) << "reconnect to " << host << ":" << port
                     << (verdict == 0 && c.last_error() == NetError::NONE
                             ? " rejected by coordinator"
                             : " failed awaiting verdict");
        return Conn();
      }
    }
    if (std::chrono::steady_clock::now() >= deadline) {
      LOG(ERROR) << "connect to " << host << ":" << port << " timed out";
      return Conn();
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

bool ParseHostPort(const std::string& s, std::string* host, int* port) {
  auto pos = s.rfind(':');
  if (pos == std::string::npos) return false;
  *host = s.substr(0, pos);
  *port = std::atoi(s.c_str() + pos + 1);
  return *port > 0;
}

std::vector<std::string> SplitString(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::size_t start = 0;
  while (start <= s.size()) {
    auto pos = s.find(sep, start);
    if (pos == std::string::npos) {
      out.push_back(s.substr(start));
      break;
    }
    out.push_back(s.substr(start, pos - start));
    start = pos + 1;
  }
  if (!out.empty() && out.back().empty()) out.pop_back();
  return out;
}

}  // namespace hvdtpu
