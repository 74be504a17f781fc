// Host-network transport for the TPU build: framed blocking TCP sockets.
//
// Fills the role the reference fills with MPI communicators / Gloo TCP
// contexts (/root/reference horovod/common/mpi/mpi_context.cc,
// gloo/gloo_context.cc): a control star (every worker <-> rank 0) used by the
// coordinator protocol, and a data ring (rank i <-> rank i+1 mod N) used by
// the CPU collective ops. Rendezvous is launcher-injected env:
//   HVD_TPU_ADDRS = "host:port,host:port,..."  (index == rank)
// Each rank listens on its own port; connections carry a handshake with the
// peer's rank, channel, elastic generation, and control-op sequence.
//
// Chaos-hardened (docs/CHAOS.md): every frame carries a CRC32C; all
// sockets get send/recv deadlines (HVD_TPU_NET_TIMEOUT_SECONDS) and
// keepalive probes (HVD_TPU_NET_KEEPALIVE_SECONDS); frame lengths are
// bounded (HVD_TPU_MAX_FRAME_BYTES); connects are non-blocking with
// per-attempt timeouts; the fault injector (fault.h) hooks the frame
// layer under HVD_TPU_FAULT_SPEC.
#ifndef HVD_TPU_NET_H
#define HVD_TPU_NET_H

#include <sys/types.h>

#include <cstdint>
#include <string>
#include <vector>

namespace hvdtpu {

class ShmRing;

enum class Channel : uint8_t {
  CONTROL = 0,     // worker -> coordinator star
  RING = 1,        // prev -> next data ring (global)
  LOCAL_RING = 2,  // ring within one host's local group
  CROSS_RING = 3,  // ring across hosts at one local_rank
  // Not a handshake channel: the TRANSPORT tag the fault injector and
  // error messages use for data-plane legs riding a shared-memory ring
  // (docs/TRANSPORT.md). Fault rules with chan=ring/local/cross keep
  // matching those legs by their LOGICAL channel; chan=shm additionally
  // filters to shm-transported frames only.
  SHM = 4,
};

// Why the last frame-layer call on a Conn failed — the transport error
// taxonomy the recoverable-error messages are built from.
enum class NetError : uint8_t {
  NONE = 0,
  CLOSED,    // EOF / reset / refused — the peer (or a fault) closed it
  TIMEOUT,   // SO_RCVTIMEO / SO_SNDTIMEO deadline expired (hung peer)
  CRC,       // frame checksum mismatch (corrupted frame)
  TOO_BIG,   // frame length exceeded HVD_TPU_MAX_FRAME_BYTES
  PROTOCOL,  // malformed frame (bad tag / length mismatch)
};
const char* NetErrorName(NetError e);

// Frame wire format: [u32 tag][u64 len][u32 crc] + payload, where crc =
// CRC32C over the first 12 header bytes then the payload, so a corrupted
// tag, length, or payload all surface as a checksum mismatch.
constexpr std::size_t kFrameHeaderBytes = 16;

// Effective knob values (env, cached after first read).
std::size_t MaxFrameBytes();       // HVD_TPU_MAX_FRAME_BYTES, default 1 GiB
int NetTimeoutSeconds();           // HVD_TPU_NET_TIMEOUT_SECONDS
bool NetCrcEnabled();              // HVD_TPU_NET_CRC, default on

// Applies the transport socket discipline to fd: TCP_NODELAY, send/recv
// deadlines, and keepalive probes. Called on every accepted/connected
// socket.
void ConfigureSocket(int fd);

// Builds a frame header in place (writes kFrameHeaderBytes into hdr).
void BuildFrameHeader(char* hdr, uint32_t tag, uint64_t len,
                      uint32_t crc);
// Splits a frame header into its fields; length/crc validation is the
// caller's job.
void ParseFrameHeader(const char* hdr, uint32_t* tag, uint64_t* len,
                      uint32_t* crc);
// The frame checksum: CRC32C over the 12-byte tag+len prefix, then the
// payload. 0 when checksums are disabled (HVD_TPU_NET_CRC=0 — job-wide,
// both sides must agree). FrameHeaderCrc is the prefix-only seed for
// callers that stream the payload and extend with Crc32c incrementally.
uint32_t FrameCrc(uint32_t tag, uint64_t len, const void* payload,
                  std::size_t n);
uint32_t FrameHeaderCrc(uint32_t tag, uint64_t len);

// Framed duplex connection. Frame = [u32 tag][u64 len][u32 crc][payload].
class Conn {
 public:
  Conn() = default;
  explicit Conn(int fd) : fd_(fd) {}
  Conn(int fd, Channel channel) : fd_(fd), channel_(channel) {}
  ~Conn();
  Conn(const Conn&) = delete;
  Conn& operator=(const Conn&) = delete;
  Conn(Conn&& o) noexcept : fd_(o.fd_), channel_(o.channel_), shm_(o.shm_) {
    o.fd_ = -1;
    o.shm_ = nullptr;
  }
  Conn& operator=(Conn&& o) noexcept;

  bool valid() const { return fd_ >= 0; }
  void Close();

  // Shared-memory data plane (docs/TRANSPORT.md): a successfully
  // negotiated conn carries an SPSC ring — the sender writes it, the
  // receiver drains it — and the TCP socket stays open only as the
  // liveness signal (EOF/keepalive = peer death). Ownership transfers
  // to the Conn; Close() tears both down.
  void AttachShm(ShmRing* ring);
  ShmRing* shm() const { return shm_; }

  // Raw exact-length I/O; false on error/EOF/deadline (last_error set).
  bool SendAll(const void* buf, std::size_t len);
  bool RecvAll(void* buf, std::size_t len);

  bool SendFrame(uint32_t tag, const void* payload, std::size_t len);
  bool SendFrame(uint32_t tag, const std::string& payload) {
    return SendFrame(tag, payload.data(), payload.size());
  }
  bool RecvFrame(uint32_t* tag, std::string* payload);
  // Receives a frame directly into a caller buffer; fails if length differs.
  bool RecvFrameInto(uint32_t* tag, void* buf, std::size_t expected_len);

  int fd() const { return fd_; }
  Channel channel() const { return channel_; }
  void set_channel(Channel c) { channel_ = c; }
  NetError last_error() const { return last_error_; }

  // Overrides the socket deadlines for THIS connection (seconds; used by
  // the net selftests). ConfigureSocket applies the env default.
  void SetTimeouts(int seconds);

 private:
  // Classifies a failed send/recv return into last_error_.
  void NoteIoError(ssize_t n, bool sending);

  int fd_ = -1;
  Channel channel_ = Channel::CONTROL;
  NetError last_error_ = NetError::NONE;
  ShmRing* shm_ = nullptr;  // owned; see AttachShm
};

// v2 handshake: every connection opens with
//   [u32 magic][i32 rank][u8 channel][u8 flags][u32 generation][u64 opseq]
// Generation is the elastic generation the connector believes is
// current — a stale worker (older generation) is rejected at accept so
// it can never splice into a newer ring. opseq is the connector's
// completed control-frame count, used to validate that a RECONNECT
// (flags & kHandshakeReconnect) resumes at the exact frame the
// coordinator expects (see tcp_context.cc).
constexpr uint8_t kHandshakeReconnect = 0x1;
// Group-ring connect (docs/GROUPS.md): the connection joins a process
// group's data ring; opseq carries the GROUP ID instead of a resume
// cursor. Built lazily by the background thread at a group op's first
// execution (tcp_context.cc EnsureGroupRing).
constexpr uint8_t kHandshakeGroupRing = 0x2;
// Shared-memory capability (docs/TRANSPORT.md): the connector supports
// the intra-host shm data plane (HVD_TPU_SHM enabled). An acceptor that
// sees the bit on a data-plane connection expects ONE setup frame right
// after the handshake (segment name + host key, or an empty name when
// the connector decided against shm for this pair) and answers with an
// ack frame; either side lacking support or failing the attach lands
// the pair on plain TCP — transparently, by construction.
constexpr uint8_t kHandshakeShmCap = 0x4;
constexpr std::size_t kHandshakeBytes = 22;

struct PeerHandshake {
  int32_t rank = -1;
  Channel channel = Channel::CONTROL;
  uint8_t flags = 0;
  uint32_t generation = 0;
  uint64_t opseq = 0;
};

// Listening socket bound to a port; accepts handshaked peer connections.
class Listener {
 public:
  ~Listener();
  // Binds and listens; port==0 picks an ephemeral port. Returns false on error.
  bool Start(int port);
  int port() const { return port_; }
  bool valid() const { return fd_ >= 0; }
  int fd() const { return fd_; }
  void Close();
  // Accepts one connection and reads its handshake, bounding BOTH the
  // accept and the handshake read by timeout_ms (a client that connects
  // and sends nothing — port scanner, health probe — can no longer
  // wedge the accept loop). Connections with a bad magic, a short
  // handshake, or a stale generation are closed and skipped; the wait
  // continues until a valid peer arrives or the deadline passes.
  // Returns the fd, or -1 on timeout/error. timeout_ms < 0 blocks
  // indefinitely (handshake reads still bounded per-connection).
  int AcceptPeer(PeerHandshake* hs, int timeout_ms,
                 uint32_t expected_generation);

 private:
  int fd_ = -1;
  int port_ = 0;
};

// Connects to host:port with retry until timeout_ms, then handshakes.
// Individual connect attempts are non-blocking with a bounded wait, so a
// blackholed host (SYN dropped, no RST) honors the overall deadline
// instead of hanging in connect() for the kernel default (~2 min).
// When `reconnect` is set the connection additionally waits for the
// acceptor's 1-byte verdict (1 = resume; anything else = rejected).
// `group_ring` marks a group-ring connect (kHandshakeGroupRing; opseq
// then carries the group id). Returns an invalid Conn on failure.
// `shm_cap` advertises the shared-memory capability (kHandshakeShmCap)
// on data-plane connects.
Conn ConnectPeer(const std::string& host, int port, int my_rank,
                 Channel channel, int timeout_ms, uint32_t generation = 0,
                 uint64_t opseq = 0, bool reconnect = false,
                 bool group_ring = false, bool shm_cap = false);

// Splits "host:port" / "h1:p1,h2:p2,..." forms.
bool ParseHostPort(const std::string& s, std::string* host, int* port);
std::vector<std::string> SplitString(const std::string& s, char sep);

}  // namespace hvdtpu

#endif  // HVD_TPU_NET_H
