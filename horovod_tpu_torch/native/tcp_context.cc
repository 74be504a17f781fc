#include "tcp_context.h"

#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <sstream>
#include <thread>

#include "checksum.h"
#include "fault.h"
#include "logging.h"
#include "metrics.h"
#include "trace.h"

namespace hvdtpu {

static int EnvInt(const char* name, int dflt) {
  const char* v = std::getenv(name);
  return v == nullptr ? dflt : std::atoi(v);
}

// Blocking control/ring poll window. 60 s is generous for any real
// deployment; a heavily oversubscribed localhost fleet (the 1024-rank
// protocol sweep runs 1024 processes on one core) can starve the
// coordinator past it mid-gather — raise via env there. Clamped so
// seconds*1000 cannot overflow int (poll(2) treats negative timeouts
// as INFINITE — a dead peer would hang forever, silently).
static int ControlPollMs() {
  static int ms = [] {
    long long s = EnvInt("HVD_TPU_CONTROL_POLL_TIMEOUT_SECONDS", 60);
    if (s <= 0) s = 60;
    if (s > 2147483) s = 2147483;
    return static_cast<int>(s * 1000);
  }();
  return ms;
}

// How long a broken control connection may take to come back before the
// other side declares it lost: the worker retries with capped
// exponential backoff inside this budget; the coordinator holds the
// dead peer's slot open for it. 0 disables reconnect entirely (a
// control failure then fails over immediately, the pre-chaos behavior).
// Elastic jobs default much shorter: their supervisor rebuilds
// membership on failure anyway, and a long hold only delays the
// shrink rendezvous past the driver's blacklist cooldown.
static int ReconnectWindowMs() {
  static int ms = [] {
    const char* elastic = std::getenv("HVD_TPU_ELASTIC");
    double s = (elastic != nullptr && elastic[0] == '1') ? 1.0 : 5.0;
    const char* v = std::getenv("HVD_TPU_RECONNECT_SECONDS");
    if (v != nullptr) s = std::atof(v);
    if (s < 0) s = 0;
    if (s > 2147483) s = 2147483;
    return static_cast<int>(s * 1000);
  }();
  return ms;
}

static const char* ChannelName(Channel c) {
  switch (c) {
    case Channel::CONTROL: return "control";
    case Channel::RING: return "ring";
    case Channel::LOCAL_RING: return "local-ring";
    case Channel::CROSS_RING: return "cross-ring";
    case Channel::SHM: return "shm";
  }
  return "?";
}

void TcpContext::SetLastError(Channel chan, NetError err) {
  last_error_ = std::string(NetErrorName(err)) + " on " +
                ChannelName(chan) + " channel";
}

static constexpr uint32_t kTagGather = 0x11;
static constexpr uint32_t kTagBcast = 0x12;
static constexpr uint32_t kTagBits = 0x13;
static constexpr uint32_t kTagRing = 0x20;
// One-time shm negotiation frames (docs/TRANSPORT.md), exchanged right
// after rendezvous on each data conn whose connector advertised
// kHandshakeShmCap.
static constexpr uint32_t kTagShmSetup = 0x30;
static constexpr uint32_t kTagShmAck = 0x31;

// Raw framed I/O for the negotiation frames: deliberately bypasses the
// fault injector and the wire byte counters — negotiation is init-time
// plumbing, and consulting the injector here would shift every
// deterministic chaos frame index by one per negotiated conn.
static bool SendRawFrame(Conn* c, uint32_t tag, const std::string& payload) {
  char hdr[kFrameHeaderBytes];
  BuildFrameHeader(hdr, tag, payload.size(),
                   FrameCrc(tag, payload.size(), payload.data(),
                            payload.size()));
  return c->SendAll(hdr, sizeof(hdr)) &&
         (payload.empty() || c->SendAll(payload.data(), payload.size()));
}

static bool RecvRawFrame(Conn* c, uint32_t expect_tag, std::string* payload) {
  char hdr[kFrameHeaderBytes];
  if (!c->RecvAll(hdr, sizeof(hdr))) return false;
  uint32_t tag, crc;
  uint64_t len;
  ParseFrameHeader(hdr, &tag, &len, &crc);
  if (tag != expect_tag || len > 65536) {
    LOG(ERROR) << "shm negotiation: unexpected frame (tag " << tag
               << ", len " << len << ")";
    return false;
  }
  payload->resize(static_cast<std::size_t>(len));
  if (len > 0 && !c->RecvAll(&(*payload)[0], payload->size())) return false;
  if (NetCrcEnabled() &&
      FrameCrc(tag, len, payload->data(), payload->size()) != crc) {
    LOG(ERROR) << "shm negotiation: frame checksum mismatch";
    return false;
  }
  return true;
}


bool TcpContext::Initialize() {
  rank_ = EnvInt("HVD_TPU_RANK", 0);
  size_ = EnvInt("HVD_TPU_SIZE", 1);
  local_rank_ = EnvInt("HVD_TPU_LOCAL_RANK", rank_);
  local_size_ = EnvInt("HVD_TPU_LOCAL_SIZE", size_);
  cross_rank_ = EnvInt("HVD_TPU_CROSS_RANK", 0);
  cross_size_ = EnvInt("HVD_TPU_CROSS_SIZE", 1);
  generation_ = static_cast<uint32_t>(EnvInt("HVD_TPU_GENERATION", 0));
  SetLogRank(rank_);
  last_error_.clear();

  // Chaos hooks (fault.h): parsed per init so an elastic re-init replays
  // the spec from frame 0 of the new generation.
  GlobalFaultInjector().Configure(std::getenv("HVD_TPU_FAULT_SPEC"), rank_);

  // Emulated data-ring bandwidth (docs/AUTOTUNE.md "Bench"): pace ring
  // TX to N MB/s so single-host runs reproduce a real inter-host link's
  // serialization delay. 0/unset = full loopback speed.
  {
    double mbps = 0.0;
    const char* v = std::getenv("HVD_TPU_RING_BANDWIDTH_MBPS");
    if (v != nullptr) mbps = std::atof(v);
    ring_tx_bytes_per_us_ = mbps > 0.0 ? mbps : 0.0;  // 1 MB/s == 1 B/us
    ring_tx_ready_us_ = 0.0;
  }

  my_ctrl_opseq_ = 0;
  ctrl_opseq_.assign(static_cast<std::size_t>(size_ > 0 ? size_ : 1), 0);

  if (size_ == 1) {
    is_homogeneous_ = true;
    rank_grid_.assign(1, 0);
    shm_topology_possible_ = false;
    initialized_ = true;
    return true;
  }

  const char* addrs_env = std::getenv("HVD_TPU_ADDRS");
  if (addrs_env == nullptr) {
    LOG(ERROR) << "HVD_TPU_ADDRS not set but size > 1";
    return false;
  }
  std::vector<std::string> addrs = SplitString(addrs_env, ',');
  if (static_cast<int>(addrs.size()) != size_) {
    LOG(ERROR) << "HVD_TPU_ADDRS has " << addrs.size() << " entries, expected "
               << size_;
    return false;
  }
  std::string my_host;
  int my_port = 0;
  if (!ParseHostPort(addrs[rank_], &my_host, &my_port)) {
    LOG(ERROR) << "bad address " << addrs[rank_];
    return false;
  }
  // Per-rank address hosts, kept for the shm same-host checks. The
  // topology-possible bit is computed from the FULL list (identical on
  // every rank — the autotuner's capability-profile seed must agree
  // everywhere): any address host with two or more ranks means at
  // least one pair can ride shared memory.
  addr_hosts_.assign(static_cast<std::size_t>(size_), std::string());
  shm_topology_possible_ = false;
  for (int r = 0; r < size_; ++r) {
    std::string h;
    int p = 0;
    if (ParseHostPort(addrs[r], &h, &p)) addr_hosts_[r] = h;
  }
  if (ShmEnabled()) {
    for (int r = 0; r < size_ && !shm_topology_possible_; ++r) {
      for (int q = r + 1; q < size_; ++q) {
        if (!addr_hosts_[r].empty() && addr_hosts_[r] == addr_hosts_[q]) {
          shm_topology_possible_ = true;
          break;
        }
      }
    }
  }
  shm_use_ = true;
  if (!ParseHostPort(addrs[0], &coord_host_, &coord_port_)) {
    LOG(ERROR) << "bad coordinator address " << addrs[0];
    return false;
  }
  if (!listener_.Start(my_port)) return false;

  int timeout_ms = EnvInt("HVD_TPU_START_TIMEOUT", 60) * 1000;

  // Phase 1 inbound: the global-ring predecessor, plus (rank 0 only)
  // every worker's control connection.
  int expected = 1 + (rank_ == 0 ? size_ - 1 : 0);
  control_conns_.resize(rank_ == 0 ? size_ : 1);

  std::atomic<bool> accept_ok{true};
  std::thread acceptor([&] {
    for (int i = 0; i < expected; ++i) {
      PeerHandshake hs;
      int fd = listener_.AcceptPeer(&hs, timeout_ms, generation_);
      if (fd < 0) {
        accept_ok.store(false);
        return;
      }
      if (hs.channel == Channel::RING && !(hs.flags & kHandshakeReconnect)) {
        ring_prev_ = Conn(fd, Channel::RING);
        ring_prev_flags_ = hs.flags;
      } else if (rank_ == 0 && hs.channel == Channel::CONTROL &&
                 !(hs.flags & kHandshakeReconnect) && hs.rank >= 1 &&
                 hs.rank < size_) {
        control_conns_[hs.rank] = Conn(fd, Channel::CONTROL);
      } else {
        LOG(ERROR) << "unexpected connection from rank " << hs.rank;
        ::close(fd);
        accept_ok.store(false);
        return;
      }
    }
  });

  // Outbound: global-ring successor, and (workers) control to rank 0.
  bool ok = true;
  {
    int next = (rank_ + 1) % size_;
    std::string host;
    int port;
    ParseHostPort(addrs[next], &host, &port);
    ring_next_ = ConnectPeer(host, port, rank_, Channel::RING, timeout_ms,
                             generation_, /*opseq=*/0, /*reconnect=*/false,
                             /*group_ring=*/false, /*shm_cap=*/ShmEnabled());
    ok = ok && ring_next_.valid();
  }
  if (ok && rank_ != 0) {
    control_conns_[0] = ConnectPeer(coord_host_, coord_port_, rank_,
                                    Channel::CONTROL, timeout_ms,
                                    generation_);
    ok = ok && control_conns_[0].valid();
  }
  acceptor.join();
  if (!ok || !accept_ok.load()) {
    LOG(ERROR) << "rendezvous failed (rank " << rank_ << ")";
    return false;
  }

  // Phase 2: learn every rank's (local_rank, cross_rank) over the star and
  // build the local/cross rings the two-level collectives ride (the role
  // MPI_Comm_split_type/split fill in the reference, mpi_context.cc:149-158).
  if (!ExchangeTopology()) return false;
  if (hierarchical_possible()) {
    if (!ConnectSubRings(timeout_ms)) {
      LOG(ERROR) << "sub-ring rendezvous failed (rank " << rank_ << ")";
      return false;
    }
  }

  // Shared-memory negotiation over the freshly built data conns
  // (docs/TRANSPORT.md). Runs AFTER the topology exchange so the
  // same-host keys can honor a forced (local, cross) grid; soft
  // failures transparently leave pairs on TCP.
  if (!NegotiateShmInit()) {
    LOG(ERROR) << "shm negotiation protocol failed (rank " << rank_ << ")";
    return false;
  }

  initialized_ = true;
  LOG(DEBUG) << "TcpContext initialized: rank " << rank_ << "/" << size_
             << " generation " << generation_
             << (hierarchical_possible() ? " (hierarchical)" : "");
  return true;
}

bool TcpContext::ExchangeTopology() {
  std::ostringstream mine;
  mine << local_rank_ << " " << local_size_ << " " << cross_rank_ << " "
       << cross_size_;
  std::vector<std::string> all;
  if (!GatherBlobs(mine.str(), rank_ == 0 ? &all : nullptr)) return false;

  std::string grid_blob;
  if (rank_ == 0) {
    // Validate homogeneity: every rank reports the same local/cross sizes
    // and the (local_rank, cross_rank) grid is a complete bijection.
    bool homogeneous = local_size_ * cross_size_ == size_;
    std::vector<int> grid(static_cast<std::size_t>(size_), -1);
    for (int r = 0; r < size_ && homogeneous; ++r) {
      std::istringstream in(all[r]);
      int lr, ls, cr, cs;
      if (!(in >> lr >> ls >> cr >> cs)) {
        homogeneous = false;
        break;
      }
      if (ls != local_size_ || cs != cross_size_ || lr < 0 ||
          lr >= local_size_ || cr < 0 || cr >= cross_size_) {
        homogeneous = false;
        break;
      }
      int cell = cr * local_size_ + lr;
      if (grid[cell] != -1) {
        homogeneous = false;
        break;
      }
      grid[cell] = r;
    }
    std::ostringstream out;
    out << (homogeneous ? 1 : 0);
    if (homogeneous) {
      for (int g : grid) out << " " << g;
    }
    grid_blob = out.str();
  }
  if (!BroadcastBlob(&grid_blob)) return false;

  std::istringstream in(grid_blob);
  int homogeneous = 0;
  in >> homogeneous;
  is_homogeneous_ = homogeneous != 0;
  rank_grid_.clear();
  rank_cross_.clear();
  if (is_homogeneous_) {
    rank_grid_.resize(static_cast<std::size_t>(size_));
    for (int i = 0; i < size_; ++i) in >> rank_grid_[i];
    // Reverse lookup for the shm host keys and the group grids: which
    // host (cross index) each rank lives on.
    rank_cross_.assign(static_cast<std::size_t>(size_), 0);
    for (int i = 0; i < size_; ++i) {
      int r = rank_grid_[static_cast<std::size_t>(i)];
      if (r >= 0 && r < size_) {
        rank_cross_[static_cast<std::size_t>(r)] = i / local_size_;
      }
    }
  }
  return true;
}

int TcpContext::RankAt(int local_rank, int cross_rank) const {
  if (!is_homogeneous_ || local_rank < 0 || local_rank >= local_size_ ||
      cross_rank < 0 || cross_rank >= cross_size_) {
    return -1;
  }
  return rank_grid_[static_cast<std::size_t>(cross_rank) * local_size_ +
                    local_rank];
}

bool TcpContext::ConnectSubRings(int timeout_ms) {
  const char* addrs_env = std::getenv("HVD_TPU_ADDRS");
  std::vector<std::string> addrs = SplitString(addrs_env ? addrs_env : "", ',');

  int expected = (local_size_ > 1 ? 1 : 0) + (cross_size_ > 1 ? 1 : 0);
  std::atomic<bool> accept_ok{true};
  std::thread acceptor([&] {
    for (int i = 0; i < expected; ++i) {
      PeerHandshake hs;
      int fd = listener_.AcceptPeer(&hs, timeout_ms, generation_);
      if (fd < 0) {
        accept_ok.store(false);
        return;
      }
      if (hs.channel == Channel::LOCAL_RING && !local_prev_.valid()) {
        local_prev_ = Conn(fd, Channel::LOCAL_RING);
        local_prev_flags_ = hs.flags;
      } else if (hs.channel == Channel::CROSS_RING && !cross_prev_.valid()) {
        cross_prev_ = Conn(fd, Channel::CROSS_RING);
        cross_prev_flags_ = hs.flags;
      } else {
        LOG(ERROR) << "unexpected sub-ring connection from rank " << hs.rank;
        ::close(fd);
        accept_ok.store(false);
        return;
      }
    }
  });

  bool ok = true;
  if (local_size_ > 1) {
    int next = RankAt((local_rank_ + 1) % local_size_, cross_rank_);
    std::string host;
    int port;
    ok = ok && next >= 0 && ParseHostPort(addrs[next], &host, &port);
    if (ok) {
      local_next_ = ConnectPeer(host, port, rank_, Channel::LOCAL_RING,
                                timeout_ms, generation_, /*opseq=*/0,
                                /*reconnect=*/false, /*group_ring=*/false,
                                /*shm_cap=*/ShmEnabled());
      ok = local_next_.valid();
    }
  }
  if (ok && cross_size_ > 1) {
    int next = RankAt(local_rank_, (cross_rank_ + 1) % cross_size_);
    std::string host;
    int port;
    ok = ok && next >= 0 && ParseHostPort(addrs[next], &host, &port);
    if (ok) {
      cross_next_ = ConnectPeer(host, port, rank_, Channel::CROSS_RING,
                                timeout_ms, generation_, /*opseq=*/0,
                                /*reconnect=*/false, /*group_ring=*/false,
                                /*shm_cap=*/ShmEnabled());
      ok = cross_next_.valid();
    }
  }
  acceptor.join();
  return ok && accept_ok.load();
}

void TcpContext::Finalize() {
  for (auto& c : control_conns_) c.Close();
  control_conns_.clear();
  ctrl_opseq_.clear();
  my_ctrl_opseq_ = 0;
  ring_next_.Close();
  ring_prev_.Close();
  local_next_.Close();
  local_prev_.Close();
  cross_next_.Close();
  cross_prev_.Close();
  for (auto& kv : group_rings_) {
    kv.second.next.Close();
    kv.second.prev.Close();
  }
  group_rings_.clear();
  for (auto& kv : group_subrings_) {
    kv.second.lnext.Close();
    kv.second.lprev.Close();
    kv.second.cnext.Close();
    kv.second.cprev.Close();
  }
  group_subrings_.clear();
  for (auto& kv : pending_group_fds_) ::close(kv.second.fd);
  pending_group_fds_.clear();
  listener_.Close();
  rank_grid_.clear();
  rank_cross_.clear();
  addr_hosts_.clear();
  ring_prev_flags_ = local_prev_flags_ = cross_prev_flags_ = 0;
  // Crash hygiene: any creator-side segment name that never reached
  // MarkExchanged (peer died mid-negotiation) is unlinked here.
  GlobalShmSegments().SweepNames();
  is_homogeneous_ = false;
  initialized_ = false;
}

// ---------------- shared-memory negotiation (docs/TRANSPORT.md) ------------

std::string TcpContext::DefaultHostKey(int rank) const {
  std::string host =
      rank >= 0 && rank < static_cast<int>(addr_hosts_.size())
          ? addr_hosts_[static_cast<std::size_t>(rank)]
          : std::string();
  int cr = 0, cs = 1;
  if (is_homogeneous_ && cross_size_ > 1 &&
      rank < static_cast<int>(rank_cross_.size())) {
    cr = rank_cross_[static_cast<std::size_t>(rank)];
    cs = cross_size_;
  }
  return ShmHostKey(host, cr, cs);
}

std::string TcpContext::MyHostKey() const {
  const char* e = std::getenv("HVD_TPU_HOST_KEY");
  if (e != nullptr && e[0] != '\0') return e;
  return DefaultHostKey(rank_);
}

bool TcpContext::ShmSetupSend(Conn* conn, int peer_rank, Channel chan,
                              std::vector<ShmPending>* pending) {
  if (!conn->valid()) return true;
  // Attempt only for a provably same-host peer (both keys computed the
  // symmetric, env-free way); the acceptor's comparison of the ACTUAL
  // keys in the setup frame is the authoritative check — a distinct
  // HVD_TPU_HOST_KEY on either side nacks the attach.
  std::unique_ptr<ShmRing> ring;
  std::string name;
  if (DefaultHostKey(rank_) == DefaultHostKey(peer_rank)) {
    name = ShmSegmentName(rank_, peer_rank, static_cast<int>(chan),
                          generation_);
    ring = ShmRing::Create(name, ShmSegmentBytes());
    if (ring == nullptr) name.clear();  // no /dev/shm etc. -> TCP
  }
  std::string payload = MyHostKey() + "\n" + name;
  if (!SendRawFrame(conn, kTagShmSetup, payload)) {
    SetLastError(chan, conn->last_error());
    return false;
  }
  pending->push_back(ShmPending{conn, std::move(ring)});
  return true;
}

bool TcpContext::ShmSetupRecv(Conn* conn, uint8_t peer_flags) {
  if (!conn->valid() || !(peer_flags & kHandshakeShmCap)) return true;
  std::string payload;
  if (!RecvRawFrame(conn, kTagShmSetup, &payload)) {
    SetLastError(conn->channel(), conn->last_error());
    return false;
  }
  std::string peer_key, name;
  auto nl = payload.find('\n');
  if (nl != std::string::npos) {
    peer_key = payload.substr(0, nl);
    name = payload.substr(nl + 1);
  }
  char status = 0;
  if (ShmEnabled() && !name.empty() && peer_key == MyHostKey()) {
    auto ring = ShmRing::Attach(name);
    if (ring != nullptr) {
      conn->AttachShm(ring.release());
      status = 1;
    }
  } else if (!name.empty()) {
    LOG(DEBUG) << "shm setup refused (host key / capability mismatch): "
               << "pair stays on TCP";
  }
  if (!SendRawFrame(conn, kTagShmAck, std::string(1, status))) {
    SetLastError(conn->channel(), conn->last_error());
    return false;
  }
  return true;
}

bool TcpContext::ShmAckRecv(ShmPending* p) {
  std::string payload;
  if (!RecvRawFrame(p->conn, kTagShmAck, &payload)) {
    SetLastError(p->conn->channel(), p->conn->last_error());
    return false;
  }
  bool accepted = payload.size() == 1 && payload[0] == 1;
  if (p->ring != nullptr) {
    if (accepted) {
      // Peer has mapped the segment: unlink the name now so the kernel
      // reclaims it with the last mapping even on a crash.
      p->ring->MarkExchanged();
      p->conn->AttachShm(p->ring.release());
      LOG(DEBUG) << "shm segment attached ("
                 << ChannelName(p->conn->channel()) << " sender side)";
    } else {
      p->ring.reset();  // Close + unlink: transparent TCP fallback
    }
  }
  return true;
}

bool TcpContext::NegotiateShmInit() {
  if (size_ == 1) return true;
  std::vector<ShmPending> pending;
  // Phase 1: every outbound data conn gets its setup frame (tiny; fits
  // any socket buffer, so sending all before reading anything cannot
  // deadlock).
  if (ShmEnabled()) {
    if (!ShmSetupSend(&ring_next_, (rank_ + 1) % size_, Channel::RING,
                      &pending)) {
      return false;
    }
    if (local_next_.valid() &&
        !ShmSetupSend(&local_next_,
                      RankAt((local_rank_ + 1) % local_size_, cross_rank_),
                      Channel::LOCAL_RING, &pending)) {
      return false;
    }
    if (cross_next_.valid() &&
        !ShmSetupSend(&cross_next_,
                      RankAt(local_rank_, (cross_rank_ + 1) % cross_size_),
                      Channel::CROSS_RING, &pending)) {
      return false;
    }
  }
  // Phase 2: serve the inbound side (the flagged connectors' setups are
  // already in flight).
  if (!ShmSetupRecv(&ring_prev_, ring_prev_flags_)) return false;
  if (local_prev_.valid() && !ShmSetupRecv(&local_prev_, local_prev_flags_)) {
    return false;
  }
  if (cross_prev_.valid() && !ShmSetupRecv(&cross_prev_, cross_prev_flags_)) {
    return false;
  }
  // Phase 3: collect the verdicts.
  for (auto& p : pending) {
    if (!ShmAckRecv(&p)) return false;
  }
  return true;
}

bool TcpContext::NegotiateShmPair(Conn* next, int next_rank, Conn* prev,
                                  uint8_t prev_flags, Channel chan) {
  std::vector<ShmPending> pending;
  if (ShmEnabled() && next->valid() &&
      !ShmSetupSend(next, next_rank, chan, &pending)) {
    return false;
  }
  if (prev->valid() && !ShmSetupRecv(prev, prev_flags)) return false;
  for (auto& p : pending) {
    if (!ShmAckRecv(&p)) return false;
  }
  return true;
}

// ---------------- process-group rings (docs/GROUPS.md) ----------------

// Stash key for an accepted group connect: (channel, group, peer rank).
// The channel matters since PR 15: a group's flat-ring connect and its
// local/cross sub-ring connects can come from the SAME peer.
static uint64_t GroupFdKey(uint32_t gid, Channel chan, int rank) {
  return (static_cast<uint64_t>(chan) << 60) |
         (static_cast<uint64_t>(gid) << 24) |
         static_cast<uint64_t>(rank & 0xFFFFFF);
}

int TcpContext::GroupRank(uint32_t group_id) const {
  auto it = group_rings_.find(group_id);
  return it == group_rings_.end() ? -1 : it->second.pos;
}

int TcpContext::GroupSize(uint32_t group_id) const {
  auto it = group_rings_.find(group_id);
  return it == group_rings_.end() ? 0 : it->second.size;
}

bool TcpContext::GroupPairConnect(uint32_t group_id, Channel chan,
                                  int next_rank, int prev_rank, Conn* next,
                                  Conn* prev, uint8_t* prev_flags) {
  const char* addrs_env = std::getenv("HVD_TPU_ADDRS");
  std::vector<std::string> addrs =
      SplitString(addrs_env ? addrs_env : "", ',');
  std::string host;
  int port = 0;
  if (next_rank >= static_cast<int>(addrs.size()) ||
      !ParseHostPort(addrs[next_rank], &host, &port)) {
    LOG(ERROR) << "group " << group_id << ": no address for member rank "
               << next_rank;
    return false;
  }
  int timeout_ms = EnvInt("HVD_TPU_START_TIMEOUT", 60) * 1000;
  // Connect to the ring successor FIRST: the peer's listener backlog
  // completes the TCP connect even before it accepts, so every member
  // running connect-then-accept in the same order cannot deadlock.
  // The handshake carries the group id in the opseq field; the channel
  // distinguishes the flat ring from the local/cross sub-rings.
  *next = ConnectPeer(host, port, rank_, chan, timeout_ms, generation_,
                      /*opseq=*/group_id, /*reconnect=*/false,
                      /*group_ring=*/true, /*shm_cap=*/ShmEnabled());
  if (!next->valid()) {
    LOG(ERROR) << "group " << group_id << ": connect to member rank "
               << next_rank << " on " << ChannelName(chan) << " failed";
    return false;
  }
  // Accept from the ring predecessor. Group-ring connects for OTHER
  // (group, channel) pairs may arrive first (a member of a later
  // response's group racing ahead of this op); stash them for their own
  // build instead of dropping them.
  auto stashed = pending_group_fds_.find(GroupFdKey(group_id, chan,
                                                    prev_rank));
  if (stashed != pending_group_fds_.end()) {
    *prev = Conn(stashed->second.fd, chan);
    *prev_flags = stashed->second.flags;
    pending_group_fds_.erase(stashed);
    return true;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (!prev->valid()) {
    auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                    deadline - std::chrono::steady_clock::now())
                    .count();
    if (left <= 0) {
      LOG(ERROR) << "group " << group_id
                 << ": timed out waiting for member rank " << prev_rank;
      return false;
    }
    PeerHandshake hs;
    int fd = listener_.AcceptPeer(&hs, static_cast<int>(left), generation_);
    if (fd < 0) {
      LOG(ERROR) << "group " << group_id
                 << ": accept failed waiting for member rank " << prev_rank;
      return false;
    }
    if (!(hs.flags & kHandshakeGroupRing)) {
      // Not a group-ring connect (e.g. a control reconnect racing a
      // group build). Dropping it is safe: reconnects retry with
      // backoff until their window expires.
      LOG(WARNING) << "unexpected non-group connection from rank "
                   << hs.rank << " during group ring build; dropping";
      ::close(fd);
      continue;
    }
    uint32_t peer_gid = static_cast<uint32_t>(hs.opseq);
    if (peer_gid == group_id && hs.channel == chan && hs.rank == prev_rank) {
      *prev = Conn(fd, chan);
      *prev_flags = hs.flags;
    } else {
      auto key = GroupFdKey(peer_gid, hs.channel, hs.rank);
      auto old = pending_group_fds_.find(key);
      if (old != pending_group_fds_.end()) {
        ::close(old->second.fd);
        old->second = PendingGroupFd{fd, hs.flags};
      } else {
        pending_group_fds_.emplace(key, PendingGroupFd{fd, hs.flags});
      }
    }
  }
  return true;
}

bool TcpContext::EnsureGroupRing(uint32_t group_id,
                                 const std::vector<int>& members) {
  if (group_rings_.count(group_id)) return true;
  int k = static_cast<int>(members.size());
  int pos = -1;
  for (int i = 0; i < k; ++i) {
    if (members[i] == rank_) pos = i;
  }
  if (pos < 0) {
    LOG(ERROR) << "rank " << rank_ << " is not a member of group "
               << group_id << "; refusing to build its ring";
    return false;
  }
  GroupRing gr;
  gr.pos = pos;
  gr.size = k;
  if (k > 1) {
    int next = members[(pos + 1) % k];
    int prev = members[(pos - 1 + k) % k];
    uint8_t prev_flags = 0;
    if (!GroupPairConnect(group_id, Channel::RING, next, prev, &gr.next,
                          &gr.prev, &prev_flags)) {
      return false;
    }
    // Intra-host members of the group ring ride shared memory exactly
    // like the enum rings (docs/TRANSPORT.md).
    if (!NegotiateShmPair(&gr.next, next, &gr.prev, prev_flags,
                          Channel::RING)) {
      return false;
    }
  }
  LOG(DEBUG) << "group " << group_id << " ring built: position " << pos
             << "/" << k;
  group_rings_.emplace(group_id, std::move(gr));
  return true;
}

// ---------------- group grids + sub-rings (docs/TRANSPORT.md) --------------

TcpContext::GroupGrid TcpContext::GroupGridOf(
    const std::vector<int>& members) const {
  GroupGrid g;
  if (!is_homogeneous_ || rank_cross_.empty()) return g;
  // Bucket members by host (world cross index), hosts ordered by cross
  // index, members within a host ordered by world local_rank — which
  // equals member-list order within a host only incidentally, so sort
  // explicitly by grid cell.
  std::vector<std::vector<int>> hosts(
      static_cast<std::size_t>(cross_size_));
  for (int i = 0; i < static_cast<int>(members.size()); ++i) {
    int r = members[static_cast<std::size_t>(i)];
    if (r < 0 || r >= static_cast<int>(rank_cross_.size())) return g;
    hosts[static_cast<std::size_t>(rank_cross_[r])].push_back(i);
  }
  int k = -1;
  std::vector<int> present;  // cross indices with members
  for (int c = 0; c < cross_size_; ++c) {
    if (hosts[static_cast<std::size_t>(c)].empty()) continue;
    int count = static_cast<int>(hosts[static_cast<std::size_t>(c)].size());
    if (k < 0) k = count;
    if (count != k) return g;  // ragged: not a uniform grid
    present.push_back(c);
  }
  if (k <= 0 || present.empty()) return g;
  g.uniform = true;
  g.local_size = k;
  g.cross_size = static_cast<int>(present.size());
  g.pos_grid.assign(static_cast<std::size_t>(k) * present.size(), -1);
  for (int ci = 0; ci < g.cross_size; ++ci) {
    auto& col = hosts[static_cast<std::size_t>(present[ci])];
    // Order within a host by world local_rank (grid cell order).
    std::sort(col.begin(), col.end(), [&](int a, int b) {
      return LocalRankOfWorld(members[a]) < LocalRankOfWorld(members[b]);
    });
    for (int j = 0; j < k; ++j) {
      int mpos = col[static_cast<std::size_t>(j)];
      g.pos_grid[static_cast<std::size_t>(ci) * k + j] = mpos;
      if (members[static_cast<std::size_t>(mpos)] == rank_) {
        g.local_pos = j;
        g.cross_pos = ci;
      }
    }
  }
  return g;
}

int TcpContext::LocalRankOfWorld(int rank) const {
  // Scan the grid column of the rank's host for its local index.
  if (rank < 0 || rank >= static_cast<int>(rank_cross_.size())) return -1;
  int c = rank_cross_[static_cast<std::size_t>(rank)];
  for (int j = 0; j < local_size_; ++j) {
    if (rank_grid_[static_cast<std::size_t>(c) * local_size_ + j] == rank) {
      return j;
    }
  }
  return -1;
}

bool TcpContext::GroupHierarchicalPossible(
    const std::vector<int>& members) const {
  GroupGrid g = GroupGridOf(members);
  return g.uniform && g.local_size > 1 && g.cross_size > 1;
}

bool TcpContext::EnsureGroupSubRings(uint32_t group_id,
                                     const std::vector<int>& members) {
  if (group_subrings_.count(group_id)) return true;
  GroupGrid grid = GroupGridOf(members);
  if (!grid.uniform || grid.local_pos < 0) {
    LOG(ERROR) << "group " << group_id
               << " is not a uniform (local, cross) grid containing this "
                  "rank; hierarchical sub-rings unavailable";
    return false;
  }
  GroupSubRings sr;
  sr.grid = grid;
  int k = grid.local_size, C = grid.cross_size;
  auto member_at = [&](int c, int j) {
    return members[static_cast<std::size_t>(
        grid.pos_grid[static_cast<std::size_t>(c) * k + j])];
  };
  // Intra-host ring among my host's group members, then the cross ring
  // at my local position — every member executes the two builds in the
  // same order at the same schedule point, and unrelated connects
  // arriving early are stashed by (group, channel, rank), so the
  // connect-before-accept pairing cannot deadlock.
  if (k > 1) {
    int next = member_at(grid.cross_pos, (grid.local_pos + 1) % k);
    int prev = member_at(grid.cross_pos, (grid.local_pos - 1 + k) % k);
    uint8_t prev_flags = 0;
    if (!GroupPairConnect(group_id, Channel::LOCAL_RING, next, prev,
                          &sr.lnext, &sr.lprev, &prev_flags)) {
      return false;
    }
    if (!NegotiateShmPair(&sr.lnext, next, &sr.lprev, prev_flags,
                          Channel::LOCAL_RING)) {
      return false;
    }
  }
  if (C > 1) {
    int next = member_at((grid.cross_pos + 1) % C, grid.local_pos);
    int prev = member_at((grid.cross_pos - 1 + C) % C, grid.local_pos);
    uint8_t prev_flags = 0;
    if (!GroupPairConnect(group_id, Channel::CROSS_RING, next, prev,
                          &sr.cnext, &sr.cprev, &prev_flags)) {
      return false;
    }
    if (!NegotiateShmPair(&sr.cnext, next, &sr.cprev, prev_flags,
                          Channel::CROSS_RING)) {
      return false;
    }
  }
  LOG(DEBUG) << "group " << group_id << " sub-rings built: local "
             << grid.local_pos << "/" << k << ", cross " << grid.cross_pos
             << "/" << C;
  group_subrings_.emplace(group_id, std::move(sr));
  return true;
}

int TcpContext::RingRankOn(Ring ring, uint32_t group) const {
  if (group == 0) return RingRank(ring);
  if (ring == Ring::GLOBAL) return GroupRank(group);
  auto it = group_subrings_.find(group);
  if (it == group_subrings_.end()) return -1;
  return ring == Ring::LOCAL ? it->second.grid.local_pos
                             : it->second.grid.cross_pos;
}

int TcpContext::RingSizeOn(Ring ring, uint32_t group) const {
  if (group == 0) return RingSize(ring);
  if (ring == Ring::GLOBAL) return GroupSize(group);
  auto it = group_subrings_.find(group);
  if (it == group_subrings_.end()) return 0;
  return ring == Ring::LOCAL ? it->second.grid.local_size
                             : it->second.grid.cross_size;
}

bool TcpContext::GroupSubExchange(uint32_t group_id, Ring ring,
                                  const void* send_buf, std::size_t send_len,
                                  void* recv_buf, std::size_t recv_len) {
  auto it = group_subrings_.find(group_id);
  if (it == group_subrings_.end()) {
    LOG(ERROR) << "group " << group_id
               << " sub-rings not built (EnsureGroupSubRings must run "
                  "first)";
    last_error_ = "group sub-ring missing on ring channel";
    return false;
  }
  auto& sr = it->second;
  bool local = ring == Ring::LOCAL;
  return PairExchange(local ? &sr.lnext : &sr.cnext,
                      local ? &sr.lprev : &sr.cprev,
                      local ? Channel::LOCAL_RING : Channel::CROSS_RING,
                      local ? sr.grid.local_size : sr.grid.cross_size,
                      send_buf, send_len, recv_buf, recv_len);
}

// ---------------- worker-side control star with reconnect ----------------

bool TcpContext::ReconnectControl() {
  if (ReconnectWindowMs() <= 0 || coord_port_ == 0) return false;
  Metrics& metrics = GlobalMetrics();
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(ReconnectWindowMs());
  int backoff_ms = 50;
  int attempt = 0;
  while (std::chrono::steady_clock::now() < deadline) {
    ++attempt;
    metrics.net_reconnect_attempts_total.fetch_add(1,
                                                   std::memory_order_relaxed);
    auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                    deadline - std::chrono::steady_clock::now())
                    .count();
    if (left < 1) break;
    int attempt_ms = static_cast<int>(left < 2000 ? left : 2000);
    Conn c = ConnectPeer(coord_host_, coord_port_, rank_, Channel::CONTROL,
                         attempt_ms, generation_, my_ctrl_opseq_,
                         /*reconnect=*/true);
    if (c.valid()) {
      control_conns_[0] = std::move(c);
      metrics.net_reconnects_total.fetch_add(1, std::memory_order_relaxed);
      LOG(WARNING) << "control connection re-established to coordinator "
                   << "(attempt " << attempt << ", opseq "
                   << my_ctrl_opseq_ << ", generation " << generation_
                   << ")";
      return true;
    }
    // Capped exponential backoff: fast first retries for a blip, bounded
    // pressure on a coordinator digging out from under a failure.
    std::this_thread::sleep_for(std::chrono::milliseconds(backoff_ms));
    backoff_ms = backoff_ms * 2 > 1000 ? 1000 : backoff_ms * 2;
  }
  LOG(ERROR) << "control reconnect failed after " << attempt
             << " attempt(s) — giving up (elastic recovery takes over)";
  return false;
}

bool TcpContext::ControlSendFrame(uint32_t tag, const void* payload,
                                  std::size_t len) {
  while (true) {
    if (control_conns_[0].SendFrame(tag, payload, len)) {
      ++my_ctrl_opseq_;
      GlobalTrace().NoteControlFrame(tag, /*send=*/true,
                                     len + kFrameHeaderBytes);
      return true;
    }
    NetError err = control_conns_[0].last_error();
    SetLastError(Channel::CONTROL, err);
    // Only a broken CONNECTION is worth a reconnect; a deadline or
    // checksum failure means the stream itself is unrecoverable.
    if (err != NetError::CLOSED || !ReconnectControl()) return false;
  }
}

bool TcpContext::ControlRecvFrame(uint32_t expect_tag, std::string* payload) {
  while (true) {
    uint32_t tag;
    if (control_conns_[0].RecvFrame(&tag, payload)) {
      if (tag != expect_tag) {
        LOG(ERROR) << "control frame: unexpected tag " << tag;
        SetLastError(Channel::CONTROL, NetError::PROTOCOL);
        return false;
      }
      ++my_ctrl_opseq_;
      GlobalTrace().NoteControlFrame(tag, /*send=*/false,
                                     payload->size() + kFrameHeaderBytes);
      return true;
    }
    NetError err = control_conns_[0].last_error();
    SetLastError(Channel::CONTROL, err);
    if (err != NetError::CLOSED || !ReconnectControl()) return false;
  }
}

bool TcpContext::ControlRecvFrameInto(uint32_t expect_tag, void* buf,
                                      std::size_t len) {
  while (true) {
    uint32_t tag;
    if (control_conns_[0].RecvFrameInto(&tag, buf, len)) {
      if (tag != expect_tag) {
        LOG(ERROR) << "control frame: unexpected tag " << tag;
        SetLastError(Channel::CONTROL, NetError::PROTOCOL);
        return false;
      }
      ++my_ctrl_opseq_;
      GlobalTrace().NoteControlFrame(tag, /*send=*/false,
                                     len + kFrameHeaderBytes);
      return true;
    }
    NetError err = control_conns_[0].last_error();
    SetLastError(Channel::CONTROL, err);
    if (err != NetError::CLOSED || !ReconnectControl()) return false;
  }
}

// ---------------- poll-multiplexed control star (rank 0) ----------------
//
// The reference's coordinator leans on MPI_Gatherv/MPI_Bcast, which the MPI
// library parallelizes internally; a naive per-socket loop here would
// serialize the whole negotiation through rank 0 (the SURVEY §7.3
// "negotiation latency at 256 chips" wall). These helpers service every
// worker socket concurrently with one poll loop.
//
// Peer-failure handling: a worker whose socket breaks mid-frame is NOT
// immediately fatal — its slot is held open for ReconnectWindowMs while
// the listener waits for a RECONNECT handshake carrying the matching
// (generation, opseq) cursor; the in-flight frame then restarts from
// byte 0 on both sides. A worker that never comes back (process death)
// fails the op when its window expires, which is what hands control to
// the elastic recovery path.

namespace {

struct FrameRecvState {
  char header[kFrameHeaderBytes];
  std::size_t hoff = 0;
  std::string payload;
  std::size_t poff = 0;
  uint32_t tag = 0;
  uint32_t crc = 0;
  bool have_header = false;
  bool done = false;
  // One injector consult per frame, even when the first poll wakeups
  // drain zero bytes (EAGAIN) — repeated consults would skew the
  // deterministic frame counters.
  bool fault_checked = false;
  // Injected recv-corruption: applied to the payload just before the
  // checksum verify (same semantics as Conn::RecvFrame).
  bool corrupt = false;

  void Restart() {
    hoff = 0;
    poff = 0;
    payload.clear();
    have_header = false;
    fault_checked = false;
    corrupt = false;
  }
};

struct FrameSendState {
  char header[kFrameHeaderBytes];
  std::size_t hoff = 0;
  const char* payload = nullptr;
  std::size_t len = 0;
  std::size_t poff = 0;
  bool done = false;
  bool fault_checked = false;

  void Restart() {
    hoff = 0;
    poff = 0;
    fault_checked = false;
  }
};

}  // namespace

int TcpContext::TryAcceptControlReconnect(const std::vector<bool>& dead) {
  PeerHandshake hs;
  // Short accept window: the listener was already readable, so this is
  // bounded by the handshake read (silent clients get dropped inside).
  int fd = listener_.AcceptPeer(&hs, 100, generation_);
  if (fd < 0) return 0;
  // A group member's ring connect (docs/GROUPS.md) can land while a
  // control-reconnect window has this thread polling the listener —
  // the connector is one-shot (no verdict wait), so closing it would
  // wedge that group's ring build until its timeout. Stash it for the
  // group's own EnsureGroupRing, exactly like the build-time race.
  if (hs.flags & kHandshakeGroupRing) {
    auto key = GroupFdKey(static_cast<uint32_t>(hs.opseq), hs.channel,
                          hs.rank);
    auto old = pending_group_fds_.find(key);
    if (old != pending_group_fds_.end()) {
      ::close(old->second.fd);
      old->second = PendingGroupFd{fd, hs.flags};
    } else {
      pending_group_fds_.emplace(key, PendingGroupFd{fd, hs.flags});
    }
    return 0;
  }
  char verdict = 0;
  if (hs.channel != Channel::CONTROL || !(hs.flags & kHandshakeReconnect) ||
      hs.rank < 1 || hs.rank >= size_ ||
      !dead[static_cast<std::size_t>(hs.rank)]) {
    LOG(WARNING) << "rejecting unexpected control connection from rank "
                 << hs.rank << " (not awaiting reconnect)";
    ::send(fd, &verdict, 1, MSG_NOSIGNAL);
    ::close(fd);
    return 0;
  }
  if (hs.opseq != ctrl_opseq_[static_cast<std::size_t>(hs.rank)]) {
    // The two sides disagree about which frame is in flight (e.g. a
    // response was fully sent but never received). Resuming would
    // desync the lockstep protocol — reject into elastic recovery.
    LOG(ERROR) << "control reconnect from rank " << hs.rank
               << " desynced: its opseq " << hs.opseq << " != expected "
               << ctrl_opseq_[static_cast<std::size_t>(hs.rank)]
               << " — failing over";
    ::send(fd, &verdict, 1, MSG_NOSIGNAL);
    ::close(fd);
    last_error_ = "control reconnect resume cursor mismatch (desynced "
                  "worker) on control channel";
    return -1;
  }
  verdict = 1;
  if (::send(fd, &verdict, 1, MSG_NOSIGNAL) != 1) {
    ::close(fd);
    return 0;
  }
  control_conns_[static_cast<std::size_t>(hs.rank)] =
      Conn(fd, Channel::CONTROL);
  LOG(WARNING) << "accepted control reconnect from rank " << hs.rank
               << " (opseq " << hs.opseq << ")";
  return hs.rank;
}

bool TcpContext::MultiRecvFrames(uint32_t expect_tag,
                                 std::vector<std::string>* blobs) {
  int n = size_ - 1;  // workers 1..size_-1
  std::vector<FrameRecvState> st(static_cast<std::size_t>(n));
  std::vector<bool> dead(static_cast<std::size_t>(size_), false);
  std::vector<std::chrono::steady_clock::time_point> dead_deadline(
      static_cast<std::size_t>(size_));
  int remaining = n;
  int num_dead = 0;
  FaultInjector& inj = GlobalFaultInjector();
  std::vector<struct pollfd> pfds;
  std::vector<int> idx;

  // Declares worker w's connection broken: hold its slot open for the
  // reconnect window (restarting its frame), or fail the op when
  // reconnect is disabled.
  auto peer_down = [&](int w, NetError err) -> bool {
    SetLastError(Channel::CONTROL, err);
    if (err != NetError::CLOSED || ReconnectWindowMs() <= 0) return false;
    control_conns_[w + 1].Close();
    dead[static_cast<std::size_t>(w + 1)] = true;
    dead_deadline[static_cast<std::size_t>(w + 1)] =
        std::chrono::steady_clock::now() +
        std::chrono::milliseconds(ReconnectWindowMs());
    ++num_dead;
    st[w].Restart();
    LOG(WARNING) << "control connection to rank " << w + 1
                 << " lost mid-gather; holding its slot for reconnect";
    return true;
  };

  while (remaining > 0) {
    auto now = std::chrono::steady_clock::now();
    for (int w = 1; w < size_; ++w) {
      if (dead[static_cast<std::size_t>(w)] &&
          now >= dead_deadline[static_cast<std::size_t>(w)]) {
        LOG(ERROR) << "rank " << w << " did not reconnect within "
                   << ReconnectWindowMs() << "ms — connection lost";
        last_error_ = "peer did not reconnect within the window on "
                      "control channel";
        return false;
      }
    }
    pfds.clear();
    idx.clear();
    for (int i = 0; i < n; ++i) {
      if (!st[i].done && !dead[static_cast<std::size_t>(i + 1)]) {
        pfds.push_back({control_conns_[i + 1].fd(), POLLIN, 0});
        idx.push_back(i);
      }
    }
    if (num_dead > 0) {
      pfds.push_back({listener_.fd(), POLLIN, 0});
      idx.push_back(-1);
    }
    int wait_ms = ControlPollMs();
    if (num_dead > 0 && wait_ms > 200) wait_ms = 200;  // re-check windows
    int pr = ::poll(pfds.data(), pfds.size(), wait_ms);
    if (pr < 0 && errno == EINTR) continue;
    if (pr < 0 || (pr == 0 && num_dead == 0)) {
      LOG(ERROR) << "control gather poll timeout/error";
      SetLastError(Channel::CONTROL, NetError::TIMEOUT);
      return false;
    }
    for (std::size_t k = 0; k < pfds.size(); ++k) {
      if (idx[k] < 0) {
        if (pfds[k].revents & POLLIN) {
          int back = TryAcceptControlReconnect(dead);
          if (back < 0) return false;
          if (back > 0) {
            dead[static_cast<std::size_t>(back)] = false;
            --num_dead;
            st[back - 1].Restart();
          }
        }
        continue;
      }
      if (!(pfds[k].revents & (POLLIN | POLLERR | POLLHUP))) continue;
      int i = idx[k];
      auto& s = st[i];
      int fd = control_conns_[i + 1].fd();
      if (!s.have_header) {
        if (!s.fault_checked && inj.active()) {
          // Coordinator-side chaos hook, once per frame start.
          s.fault_checked = true;
          FaultDecision d = inj.OnFrame(Channel::CONTROL, /*send=*/false);
          if (d.action == FaultAction::DELAY ||
              d.action == FaultAction::STALL) {
            std::this_thread::sleep_for(
                std::chrono::milliseconds(d.delay_ms));
          } else if (d.action == FaultAction::CLOSE) {
            if (!peer_down(i, NetError::CLOSED)) return false;
            continue;
          } else if (d.action == FaultAction::CORRUPT) {
            s.corrupt = true;
          }
        }
        ssize_t r = ::recv(fd, s.header + s.hoff, sizeof(s.header) - s.hoff,
                           MSG_DONTWAIT);
        if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                       errno != EINTR)) {
          if (!peer_down(i, NetError::CLOSED)) return false;
          continue;
        }
        if (r < 0) continue;
        s.hoff += static_cast<std::size_t>(r);
        if (s.hoff == sizeof(s.header)) {
          uint64_t len;
          ParseFrameHeader(s.header, &s.tag, &len, &s.crc);
          if (s.tag != expect_tag) {
            LOG(ERROR) << "control gather: unexpected tag " << s.tag;
            SetLastError(Channel::CONTROL, NetError::PROTOCOL);
            return false;
          }
          if (len > MaxFrameBytes()) {
            LOG(ERROR) << "control gather: frame length " << len
                       << " exceeds max " << MaxFrameBytes();
            SetLastError(Channel::CONTROL, NetError::TOO_BIG);
            GlobalMetrics().net_oversize_frames_total.fetch_add(
                1, std::memory_order_relaxed);
            return false;
          }
          s.payload.resize(static_cast<std::size_t>(len));
          s.have_header = true;
        }
      }
      if (s.have_header && !s.done && s.poff < s.payload.size()) {
        ssize_t r = ::recv(fd, &s.payload[s.poff], s.payload.size() - s.poff,
                           MSG_DONTWAIT);
        if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                       errno != EINTR)) {
          if (!peer_down(i, NetError::CLOSED)) return false;
          continue;
        }
        if (r < 0) continue;
        s.poff += static_cast<std::size_t>(r);
      }
      if (s.have_header && !s.done && s.poff == s.payload.size()) {
        uint64_t len = s.payload.size();
        if (s.corrupt) {
          if (len > 0) {
            s.payload[len / 2] ^= 0x20;
          } else {
            s.crc ^= 0x1;
          }
        }
        if (NetCrcEnabled() &&
            FrameCrc(s.tag, len, s.payload.data(), s.payload.size()) !=
                s.crc) {
          LOG(ERROR) << "control gather: checksum mismatch from rank "
                     << i + 1 << " — corrupted frame detected";
          SetLastError(Channel::CONTROL, NetError::CRC);
          GlobalMetrics().net_crc_errors_total.fetch_add(
              1, std::memory_order_relaxed);
          return false;
        }
        s.done = true;
        --remaining;
        ++ctrl_opseq_[static_cast<std::size_t>(i + 1)];
      }
    }
  }
  if (blobs != nullptr) {
    for (int i = 0; i < n; ++i) (*blobs)[i + 1] = std::move(st[i].payload);
  }
  return true;
}

bool TcpContext::MultiSendFrames(
    uint32_t tag,
    const std::vector<std::pair<const void*, std::size_t>>& payloads) {
  int n = size_ - 1;
  std::vector<FrameSendState> st(static_cast<std::size_t>(n));
  for (int i = 0; i < n; ++i) {
    auto& s = st[i];
    uint64_t len = payloads[i].second;
    BuildFrameHeader(s.header, tag, len,
                     FrameCrc(tag, len, payloads[i].first, len));
    s.payload = static_cast<const char*>(payloads[i].first);
    s.len = payloads[i].second;
  }
  std::vector<bool> dead(static_cast<std::size_t>(size_), false);
  std::vector<std::chrono::steady_clock::time_point> dead_deadline(
      static_cast<std::size_t>(size_));
  int remaining = n;
  int num_dead = 0;
  FaultInjector& inj = GlobalFaultInjector();
  std::vector<struct pollfd> pfds;
  std::vector<int> idx;

  auto peer_down = [&](int w, NetError err) -> bool {
    SetLastError(Channel::CONTROL, err);
    if (err != NetError::CLOSED || ReconnectWindowMs() <= 0) return false;
    control_conns_[w + 1].Close();
    dead[static_cast<std::size_t>(w + 1)] = true;
    dead_deadline[static_cast<std::size_t>(w + 1)] =
        std::chrono::steady_clock::now() +
        std::chrono::milliseconds(ReconnectWindowMs());
    ++num_dead;
    st[w].Restart();
    LOG(WARNING) << "control connection to rank " << w + 1
                 << " lost mid-bcast; holding its slot for reconnect";
    return true;
  };

  while (remaining > 0) {
    auto now = std::chrono::steady_clock::now();
    for (int w = 1; w < size_; ++w) {
      if (dead[static_cast<std::size_t>(w)] &&
          now >= dead_deadline[static_cast<std::size_t>(w)]) {
        LOG(ERROR) << "rank " << w << " did not reconnect within "
                   << ReconnectWindowMs() << "ms — connection lost";
        last_error_ = "peer did not reconnect within the window on "
                      "control channel";
        return false;
      }
    }
    pfds.clear();
    idx.clear();
    for (int i = 0; i < n; ++i) {
      if (!st[i].done && !dead[static_cast<std::size_t>(i + 1)]) {
        pfds.push_back({control_conns_[i + 1].fd(), POLLOUT, 0});
        idx.push_back(i);
      }
    }
    if (num_dead > 0) {
      pfds.push_back({listener_.fd(), POLLIN, 0});
      idx.push_back(-1);
    }
    int wait_ms = ControlPollMs();
    if (num_dead > 0 && wait_ms > 200) wait_ms = 200;
    int pr = ::poll(pfds.data(), pfds.size(), wait_ms);
    if (pr < 0 && errno == EINTR) continue;
    if (pr < 0 || (pr == 0 && num_dead == 0)) {
      LOG(ERROR) << "control bcast poll timeout/error";
      SetLastError(Channel::CONTROL, NetError::TIMEOUT);
      return false;
    }
    for (std::size_t k = 0; k < pfds.size(); ++k) {
      if (idx[k] < 0) {
        if (pfds[k].revents & POLLIN) {
          int back = TryAcceptControlReconnect(dead);
          if (back < 0) return false;
          if (back > 0) {
            dead[static_cast<std::size_t>(back)] = false;
            --num_dead;
            st[back - 1].Restart();
          }
        }
        continue;
      }
      if (!(pfds[k].revents & (POLLOUT | POLLERR | POLLHUP))) continue;
      int i = idx[k];
      auto& s = st[i];
      int fd = control_conns_[i + 1].fd();
      if (!s.fault_checked && inj.active()) {
        s.fault_checked = true;
        FaultDecision d = inj.OnFrame(Channel::CONTROL, /*send=*/true);
        switch (d.action) {
          case FaultAction::DROP:
            s.done = true;  // never sent: the worker's deadline fires
            --remaining;
            ++ctrl_opseq_[static_cast<std::size_t>(i + 1)];
            continue;
          case FaultAction::DELAY:
          case FaultAction::STALL:
            std::this_thread::sleep_for(
                std::chrono::milliseconds(d.delay_ms));
            break;
          case FaultAction::CLOSE:
            if (!peer_down(i, NetError::CLOSED)) return false;
            continue;
          case FaultAction::CORRUPT:
            // Flip a CRC byte in this worker's header copy: the wire
            // carries a checksum that no longer matches the payload.
            s.header[12] = static_cast<char>(s.header[12] ^ 0x1);
            break;
          case FaultAction::NONE:
            break;
        }
      }
      if (s.hoff < sizeof(s.header)) {
        ssize_t w = ::send(fd, s.header + s.hoff, sizeof(s.header) - s.hoff,
                           MSG_NOSIGNAL | MSG_DONTWAIT);
        if (w < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
            continue;
          if (!peer_down(i, NetError::CLOSED)) return false;
          continue;
        }
        s.hoff += static_cast<std::size_t>(w);
        if (s.hoff < sizeof(s.header)) continue;
      }
      if (s.poff < s.len) {
        ssize_t w = ::send(fd, s.payload + s.poff, s.len - s.poff,
                           MSG_NOSIGNAL | MSG_DONTWAIT);
        if (w < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
            continue;
          if (!peer_down(i, NetError::CLOSED)) return false;
          continue;
        }
        s.poff += static_cast<std::size_t>(w);
      }
      if (s.poff == s.len) {
        s.done = true;
        --remaining;
        ++ctrl_opseq_[static_cast<std::size_t>(i + 1)];
      }
    }
  }
  return true;
}

bool TcpContext::GatherBlobs(const std::string& mine,
                             std::vector<std::string>* all) {
  if (size_ == 1) {
    if (all != nullptr) {
      all->assign(1, mine);
    }
    return true;
  }
  if (rank_ == 0) {
    all->assign(size_, std::string());
    (*all)[0] = mine;
    if (!MultiRecvFrames(kTagGather, all)) return false;
    uint64_t recvd = 0;
    for (int r = 1; r < size_; ++r) recvd += (*all)[r].size();
    ctrl_bytes_recv_ += recvd + kFrameHeaderBytes * (size_ - 1);
    ctrl_msgs_ += size_ - 1;
    GlobalTrace().NoteControlFrame(kTagGather, /*send=*/false,
                                   recvd + kFrameHeaderBytes * (size_ - 1));
    return true;
  }
  if (!ControlSendFrame(kTagGather, mine.data(), mine.size())) return false;
  ctrl_bytes_sent_ += mine.size() + kFrameHeaderBytes;
  ctrl_msgs_ += 1;
  return true;
}

bool TcpContext::BroadcastBlob(std::string* blob) {
  if (size_ == 1) return true;
  if (rank_ == 0) {
    std::vector<std::pair<const void*, std::size_t>> payloads(
        static_cast<std::size_t>(size_ - 1),
        {blob->data(), blob->size()});
    if (!MultiSendFrames(kTagBcast, payloads)) return false;
    ctrl_bytes_sent_ +=
        (blob->size() + kFrameHeaderBytes) * uint64_t(size_ - 1);
    ctrl_msgs_ += size_ - 1;
    GlobalTrace().NoteControlFrame(
        kTagBcast, /*send=*/true,
        (blob->size() + kFrameHeaderBytes) * uint64_t(size_ - 1));
    return true;
  }
  if (!ControlRecvFrame(kTagBcast, blob)) return false;
  ctrl_bytes_recv_ += blob->size() + kFrameHeaderBytes;
  ctrl_msgs_ += 1;
  return true;
}

bool TcpContext::BitwiseSync(std::vector<uint64_t>& bits, bool is_or) {
  if (size_ == 1) return true;
  std::size_t nbytes = bits.size() * sizeof(uint64_t);
  if (rank_ == 0) {
    std::vector<std::string> blobs(static_cast<std::size_t>(size_));
    if (!MultiRecvFrames(kTagBits, &blobs)) return false;
    for (int r = 1; r < size_; ++r) {
      if (blobs[r].size() != nbytes) {
        LOG(ERROR) << "bit sync size mismatch from rank " << r;
        return false;
      }
      const uint64_t* peer =
          reinterpret_cast<const uint64_t*>(blobs[r].data());
      for (std::size_t i = 0; i < bits.size(); ++i) {
        bits[i] = is_or ? (bits[i] | peer[i]) : (bits[i] & peer[i]);
      }
    }
    std::vector<std::pair<const void*, std::size_t>> payloads(
        static_cast<std::size_t>(size_ - 1), {bits.data(), nbytes});
    if (!MultiSendFrames(kTagBits, payloads)) return false;
    ctrl_bytes_recv_ += (nbytes + kFrameHeaderBytes) * uint64_t(size_ - 1);
    ctrl_bytes_sent_ += (nbytes + kFrameHeaderBytes) * uint64_t(size_ - 1);
    ctrl_msgs_ += 2 * uint64_t(size_ - 1);
    GlobalTrace().NoteControlFrame(
        kTagBits, /*send=*/true,
        (nbytes + kFrameHeaderBytes) * uint64_t(size_ - 1));
    return true;
  }
  if (!(ControlSendFrame(kTagBits, bits.data(), nbytes) &&
        ControlRecvFrameInto(kTagBits, bits.data(), nbytes))) {
    return false;
  }
  ctrl_bytes_sent_ += nbytes + kFrameHeaderBytes;
  ctrl_bytes_recv_ += nbytes + kFrameHeaderBytes;
  ctrl_msgs_ += 2;
  return true;
}

bool TcpContext::Barrier() {
  std::vector<uint64_t> bits(1, ~0ull);
  return BitwiseSync(bits, false);
}

// ---------------- data rings ----------------

int TcpContext::RingRank(Ring ring) const {
  switch (ring) {
    case Ring::GLOBAL:
      return rank_;
    case Ring::LOCAL:
      return local_rank_;
    case Ring::CROSS:
      return cross_rank_;
  }
  return rank_;
}

int TcpContext::RingSize(Ring ring) const {
  switch (ring) {
    case Ring::GLOBAL:
      return size_;
    case Ring::LOCAL:
      return local_size_;
    case Ring::CROSS:
      return cross_size_;
  }
  return size_;
}

bool TcpContext::RingExchangeOn(Ring ring, const void* send_buf,
                                std::size_t send_len, void* recv_buf,
                                std::size_t recv_len) {
  Conn* next = &ring_next_;
  Conn* prev = &ring_prev_;
  Channel chan = Channel::RING;
  if (ring == Ring::LOCAL) {
    next = &local_next_;
    prev = &local_prev_;
    chan = Channel::LOCAL_RING;
  } else if (ring == Ring::CROSS) {
    next = &cross_next_;
    prev = &cross_prev_;
    chan = Channel::CROSS_RING;
  }
  return PairExchange(next, prev, chan, RingSize(ring), send_buf, send_len,
                      recv_buf, recv_len);
}

bool TcpContext::GroupExchange(uint32_t group_id, const void* send_buf,
                               std::size_t send_len, void* recv_buf,
                               std::size_t recv_len) {
  auto it = group_rings_.find(group_id);
  if (it == group_rings_.end()) {
    LOG(ERROR) << "group " << group_id
               << " ring not built (EnsureGroupRing must run first)";
    last_error_ = "group ring missing on ring channel";
    return false;
  }
  return PairExchange(&it->second.next, &it->second.prev, Channel::RING,
                      it->second.size, send_buf, send_len, recv_buf,
                      recv_len);
}

// Per-leg CRC switch: shm legs follow HVD_TPU_SHM_CRC (default: the
// net setting), socket legs follow HVD_TPU_NET_CRC.
static uint32_t LegFrameCrc(bool shm_leg, uint32_t tag, uint64_t len,
                            const void* payload, std::size_t n) {
  bool on = shm_leg ? ShmCrcEnabled() : NetCrcEnabled();
  if (!on) return 0;
  uint32_t crc = FrameHeaderCrc(tag, len);
  if (n > 0) crc = Crc32c(payload, n, crc);
  return crc;
}

bool TcpContext::PairExchange(Conn* next, Conn* prev, Channel chan,
                              int ring_size, const void* send_buf,
                              std::size_t send_len, void* recv_buf,
                              std::size_t recv_len) {
  if (ring_size == 1) {
    if (recv_len > 0 && recv_buf != send_buf) {
      std::memcpy(recv_buf, send_buf, std::min(send_len, recv_len));
    }
    return true;
  }
  if (!next->valid() || !prev->valid()) {
    LOG(ERROR) << "ring exchange on unconnected ring";
    return false;
  }

  // Wire-hop span (trace.h): one per exchange, both directions. Ring
  // exchanges run in lockstep, so the per-channel hop sequence pairs the
  // same logical hop across ranks; the causal check compares the
  // sender's start against its next-neighbor's end after clock
  // correction. Only the GLOBAL ring has a rank-derivable peer.
  Trace& hop_trace = GlobalTrace();
  const uint64_t hop_seq = trace_hop_seq_[static_cast<int>(chan)]++;
  const int64_t hop_start = hop_trace.NowNs();

  // Transport selection (docs/TRANSPORT.md): a leg rides its negotiated
  // shm ring only while the cycle-synchronized shm_transport knob says
  // so — both endpoints read the same knob value for any given
  // exchange, so the two sides can never disagree on the transport.
  ShmRing* sshm = shm_use_ ? next->shm() : nullptr;
  ShmRing* rshm = shm_use_ ? prev->shm() : nullptr;

  // Chaos hooks, once per exchange (send side, exactly as pre-shm so
  // logical-channel frame counters replay identically; the shm flag
  // feeds the chan=shm transport filter). corrupt flips the outgoing
  // header's CRC byte (the payload is the caller's gradient buffer —
  // never mutated); close/stall exercise the peer's deadline; close on
  // an shm leg also closes the ring, which the peer observes promptly.
  bool corrupt_out = false;
  FaultInjector& inj = GlobalFaultInjector();
  if (inj.active()) {
    FaultDecision d = inj.OnFrame(chan, /*send=*/true, sshm != nullptr);
    switch (d.action) {
      case FaultAction::DELAY:
      case FaultAction::STALL:
        std::this_thread::sleep_for(std::chrono::milliseconds(d.delay_ms));
        break;
      case FaultAction::CLOSE:
        next->Close();
        sshm = nullptr;
        break;
      case FaultAction::CORRUPT:
        corrupt_out = true;
        break;
      case FaultAction::DROP:
        // Dropping a ring frame = never sending it; the peer's recv
        // deadline fires. Model it as closing our send side silently.
        next->Close();
        sshm = nullptr;
        break;
      case FaultAction::NONE:
        break;
    }
  }
  if (!next->valid()) {
    SetLastError(chan, NetError::CLOSED);
    return false;
  }

  // Frame headers first (blocking, tiny), then pump payloads full-duplex so
  // a ring of simultaneous large sends can't deadlock on socket buffers.
  // The send CRC covers the whole payload (computed up front — one pass
  // over the buffer); the receive side accumulates incrementally as
  // chunks arrive and verifies at the end, so a corrupted frame becomes
  // a detected error, never silently wrong gradients — on shm legs
  // exactly as on sockets (memory is not a network, but the check is
  // cheap and keeps the chaos invariant uniform).
  uint64_t slen = send_len;
  uint32_t scrc = LegFrameCrc(sshm != nullptr, kTagRing, slen, send_buf,
                              send_len);
  if (corrupt_out) scrc ^= 0x1;
  char shdr[kFrameHeaderBytes];
  BuildFrameHeader(shdr, kTagRing, slen, scrc);
  int hdr_deadline_ms = NetTimeoutSeconds() * 1000;
  if (sshm != nullptr) {
    // The ring is empty between exchanges and capacity >= one header,
    // so this never blocks on a live peer.
    if (!sshm->WriteAll(shdr, sizeof(shdr), hdr_deadline_ms)) {
      SetLastError(Channel::SHM,
                   sshm->closed() ? NetError::CLOSED : NetError::TIMEOUT);
      return false;
    }
  } else if (!next->SendAll(shdr, sizeof(shdr))) {
    SetLastError(chan, next->last_error());
    return false;
  }
  char rhdr[kFrameHeaderBytes];
  if (rshm != nullptr) {
    if (!rshm->ReadAll(rhdr, sizeof(rhdr), hdr_deadline_ms)) {
      SetLastError(Channel::SHM,
                   rshm->closed() ? NetError::CLOSED : NetError::TIMEOUT);
      return false;
    }
  } else if (!prev->RecvAll(rhdr, sizeof(rhdr))) {
    SetLastError(chan, prev->last_error());
    return false;
  }
  uint32_t rtag;
  uint64_t rlen;
  uint32_t rcrc;
  ParseFrameHeader(rhdr, &rtag, &rlen, &rcrc);
  if (rtag != kTagRing || rlen != recv_len) {
    LOG(ERROR) << "ring exchange mismatch: tag " << rtag << " len " << rlen
               << " expected " << recv_len;
    SetLastError(chan, NetError::PROTOCOL);
    return false;
  }
  bool recv_crc_on = rshm != nullptr ? ShmCrcEnabled() : NetCrcEnabled();
  uint32_t crc_acc = recv_crc_on ? FrameHeaderCrc(rtag, rlen) : 0;

  const char* sp = static_cast<const char*>(send_buf);
  char* rp = static_cast<char*>(recv_buf);
  std::size_t sent = 0, received = 0;
  if (sshm != nullptr || rshm != nullptr) {
    if (!PumpShmAware(next, prev, chan, sshm, rshm, sp, send_len, rp,
                      recv_len, recv_crc_on, &crc_acc)) {
      return false;
    }
    sent = send_len;
    received = recv_len;
  } else {
  // Emulated-link TX pacing: when the token bucket is empty the send
  // side simply withholds POLLOUT until its ready time (receives keep
  // draining), then accounts the bytes it wrote. Quantized writes keep
  // the pacing granular so a receiver sees a stream, not a burst.
  const double rate = ring_tx_bytes_per_us_;
  auto now_us = [] {
    return std::chrono::duration<double, std::micro>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  while (sent < send_len || received < recv_len) {
    // (all-TCP pump; shm-touched exchanges took PumpShmAware above)
    struct pollfd pfds[2];
    int n = 0;
    int send_idx = -1, recv_idx = -1;
    int timeout_ms = ControlPollMs();
    bool throttle_wait = false;
    if (sent < send_len) {
      double wait_us =
          rate > 0.0 ? ring_tx_ready_us_ - now_us() : 0.0;
      if (wait_us > 0.0) {
        // Bucket empty: wake when it refills (or when bytes arrive).
        // poll(2) only has millisecond granularity; sub-ms refills use
        // a precise sleep below instead of a padded poll timeout —
        // padding compounds across pipeline segments.
        int wait_ms = static_cast<int>(wait_us / 1000.0);
        if (wait_ms < 1) wait_ms = 1;
        if (wait_ms < timeout_ms) timeout_ms = wait_ms;
        throttle_wait = true;
      } else {
        pfds[n] = {next->fd(), POLLOUT, 0};
        send_idx = n++;
      }
      if (throttle_wait && received >= recv_len) {
        // Only the throttled send remains: precise sleep, then retry.
        std::this_thread::sleep_for(
            std::chrono::duration<double, std::micro>(wait_us));
        continue;
      }
    }
    if (received < recv_len) {
      pfds[n] = {prev->fd(), POLLIN, 0};
      recv_idx = n++;
    }
    if (n == 0) {
      continue;  // unreachable; defensive
    }
    int rv = ::poll(pfds, n, timeout_ms);
    if (rv < 0 || (rv == 0 && !throttle_wait)) {
      LOG(ERROR) << "ring exchange poll timeout/error";
      SetLastError(chan, NetError::TIMEOUT);
      return false;
    }
    if (send_idx >= 0 && (pfds[send_idx].revents & (POLLOUT | POLLERR))) {
      std::size_t quantum = send_len - sent;
      if (rate > 0.0 && quantum > 262144) quantum = 262144;
      ssize_t w = ::send(next->fd(), sp + sent, quantum,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        SetLastError(chan, NetError::CLOSED);
        return false;
      }
      if (w > 0) {
        sent += static_cast<std::size_t>(w);
        if (rate > 0.0) {
          double now = now_us();
          ring_tx_ready_us_ = std::max(ring_tx_ready_us_, now) + w / rate;
        }
      }
    }
    if (recv_idx >= 0 && (pfds[recv_idx].revents & (POLLIN | POLLERR))) {
      ssize_t r = ::recv(prev->fd(), rp + received, recv_len - received,
                         MSG_DONTWAIT);
      if (r == 0) {
        SetLastError(chan, NetError::CLOSED);
        return false;
      }
      if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        SetLastError(chan, NetError::CLOSED);
        return false;
      }
      if (r > 0) {
        if (recv_crc_on) {
          crc_acc = Crc32c(rp + received, static_cast<std::size_t>(r),
                           crc_acc);
        }
        received += static_cast<std::size_t>(r);
      }
    }
  }
  }  // all-TCP pump
  if (recv_crc_on && crc_acc != rcrc) {
    LOG(ERROR) << "ring exchange checksum mismatch (" << recv_len
               << " bytes) — corrupted frame detected";
    SetLastError(rshm != nullptr ? Channel::SHM : chan, NetError::CRC);
    GlobalMetrics().net_crc_errors_total.fetch_add(1,
                                                   std::memory_order_relaxed);
    return false;
  }
  // Data-ring accounting (headers included): the quantity the
  // compression stage shrinks, counted at the transport layer so a
  // bench/test A/B measures actual bytes moved, not payload intent —
  // whatever the transport. The net_shm_* counters split out the
  // shared-memory share (bench.py --shm's engagement proof).
  Metrics& m = GlobalMetrics();
  m.net_ring_bytes_sent_total.fetch_add(
      static_cast<uint64_t>(send_len) + kFrameHeaderBytes,
      std::memory_order_relaxed);
  m.net_ring_bytes_recv_total.fetch_add(
      static_cast<uint64_t>(recv_len) + kFrameHeaderBytes,
      std::memory_order_relaxed);
  if (sshm != nullptr) {
    m.net_shm_bytes_sent_total.fetch_add(
        static_cast<uint64_t>(send_len) + kFrameHeaderBytes,
        std::memory_order_relaxed);
  }
  if (rshm != nullptr) {
    m.net_shm_bytes_recv_total.fetch_add(
        static_cast<uint64_t>(recv_len) + kFrameHeaderBytes,
        std::memory_order_relaxed);
  }
  if (hop_trace.enabled()) {
    static const char* kChanNames[] = {"hop.control", "hop.ring",
                                       "hop.local", "hop.cross"};
    int ci = static_cast<int>(chan);
    hop_trace.Record(ci >= 0 && ci < 4 ? kChanNames[ci] : "hop.?",
                     TRACE_WIRE_HOP, hop_start, hop_trace.NowNs(),
                     static_cast<int64_t>(send_len), /*group=*/0,
                     chan == Channel::RING ? (rank_ + 1) % size_ : -1,
                     hop_seq,
                     sshm != nullptr ? TRACE_FLAG_SHM : 0);
  }
  return true;
}

// Duplex payload pump for exchanges where at least one leg rides shared
// memory: both directions make nonblocking progress each iteration
// (socket legs via MSG_DONTWAIT, shm legs via Write/ReadSome), so a
// ring of simultaneous large sends cannot deadlock whatever the
// transport mix. TX pacing (the emulated inter-host link) applies to
// the TCP send leg only — shm is intra-host by construction. A quiet
// interval waits briefly (poll on socket legs, spin-then-futex on shm
// legs) and a no-progress stretch past the net deadline fails as a
// TIMEOUT; a peer that died without closing is additionally caught by
// an EOF probe on the shm legs' liveness sockets.
bool TcpContext::PumpShmAware(Conn* next, Conn* prev, Channel chan,
                              ShmRing* sshm, ShmRing* rshm, const char* sp,
                              std::size_t send_len, char* rp,
                              std::size_t recv_len, bool recv_crc_on,
                              uint32_t* crc_acc) {
  std::size_t sent = 0, received = 0;
  const double rate = ring_tx_bytes_per_us_;
  auto now_us = [] {
    return std::chrono::duration<double, std::micro>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  auto last_progress = std::chrono::steady_clock::now();
  const auto stall_budget =
      std::chrono::milliseconds(NetTimeoutSeconds() * 1000);
  int quiet = 0;  // consecutive no-progress waits since last progress
  while (sent < send_len || received < recv_len) {
    bool progress = false;
    double throttle_wait_us = 0.0;  // >0: TCP send leg paced (bucket empty)
    if (sent < send_len) {
      if (sshm != nullptr) {
        int64_t w = sshm->WriteSome(sp + sent, send_len - sent);
        if (w < 0) {
          SetLastError(Channel::SHM, NetError::CLOSED);
          return false;
        }
        if (w > 0) {
          sent += static_cast<std::size_t>(w);
          progress = true;
        }
      } else {
        double wait_us = rate > 0.0 ? ring_tx_ready_us_ - now_us() : 0.0;
        if (wait_us > 0.0) throttle_wait_us = wait_us;
        if (wait_us <= 0.0) {
          std::size_t quantum = send_len - sent;
          if (rate > 0.0 && quantum > 262144) quantum = 262144;
          ssize_t w = ::send(next->fd(), sp + sent, quantum,
                             MSG_NOSIGNAL | MSG_DONTWAIT);
          if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
              errno != EINTR) {
            SetLastError(chan, NetError::CLOSED);
            return false;
          }
          if (w > 0) {
            sent += static_cast<std::size_t>(w);
            progress = true;
            if (rate > 0.0) {
              double now = now_us();
              ring_tx_ready_us_ =
                  std::max(ring_tx_ready_us_, now) + w / rate;
            }
          }
        }
      }
    }
    if (received < recv_len) {
      if (rshm != nullptr) {
        int64_t r = rshm->ReadSome(rp + received, recv_len - received);
        if (r < 0) {
          SetLastError(Channel::SHM, NetError::CLOSED);
          return false;
        }
        if (r > 0) {
          if (recv_crc_on) {
            *crc_acc = Crc32c(rp + received, static_cast<std::size_t>(r),
                              *crc_acc);
          }
          received += static_cast<std::size_t>(r);
          progress = true;
        }
      } else {
        ssize_t r = ::recv(prev->fd(), rp + received, recv_len - received,
                           MSG_DONTWAIT);
        if (r == 0) {
          SetLastError(chan, NetError::CLOSED);
          return false;
        }
        if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
            errno != EINTR) {
          SetLastError(chan, NetError::CLOSED);
          return false;
        }
        if (r > 0) {
          if (recv_crc_on) {
            *crc_acc = Crc32c(rp + received, static_cast<std::size_t>(r),
                              *crc_acc);
          }
          received += static_cast<std::size_t>(r);
          progress = true;
        }
      }
    }
    if (progress) {
      last_progress = std::chrono::steady_clock::now();
      quiet = 0;
      continue;
    }
    auto now = std::chrono::steady_clock::now();
    if (now - last_progress > stall_budget) {
      SetLastError(sshm != nullptr || rshm != nullptr ? Channel::SHM : chan,
                   NetError::TIMEOUT);
      LOG(ERROR) << "ring exchange stalled past the transport deadline";
      return false;
    }
    // Peer-death probe on shm legs: an orderly Close sets the ring's
    // closed flag, but a SIGKILL'd peer cannot — its TCP liveness
    // socket delivers the EOF instead, making death prompt, not a
    // deadline expiry. Probed only on SUSTAINED quiet (each probe is a
    // syscall; the active pump's brief stalls must stay syscall-free).
    if (++quiet >= 8) {
      char probe;
      if (rshm != nullptr && received < recv_len &&
          ::recv(prev->fd(), &probe, 1, MSG_DONTWAIT | MSG_PEEK) == 0) {
        SetLastError(Channel::SHM, NetError::CLOSED);
        return false;
      }
      if (sshm != nullptr && sent < send_len &&
          ::recv(next->fd(), &probe, 1, MSG_DONTWAIT | MSG_PEEK) == 0) {
        SetLastError(Channel::SHM, NetError::CLOSED);
        return false;
      }
    }
    struct pollfd pfds[2];
    int n = 0;
    // A paced send leg with an empty token bucket must NOT poll for
    // POLLOUT — the socket is writable, so the poll would return
    // instantly and the throttle window would become a busy-loop of
    // syscalls (the all-TCP pump withholds POLLOUT the same way).
    if (sent < send_len && sshm == nullptr && throttle_wait_us <= 0.0) {
      pfds[n++] = {next->fd(), POLLOUT, 0};
    }
    if (received < recv_len && rshm == nullptr) {
      pfds[n++] = {prev->fd(), POLLIN, 0};
    }
    if (n > 0) {
      ::poll(pfds, n, 1);
    } else if (received < recv_len && rshm != nullptr) {
      rshm->WaitReadable(2);
    } else if (sshm != nullptr && sent < send_len) {
      sshm->WaitWritable(2);
    } else if (throttle_wait_us > 0.0) {
      // Only the throttled send remains: precise sleep to the bucket's
      // refill (capped so the loop re-checks deadlines regularly).
      std::this_thread::sleep_for(std::chrono::duration<double, std::micro>(
          std::min(throttle_wait_us, 1000.0)));
    }
  }
  return true;
}

bool TcpContext::RingBroadcast(void* buf, std::size_t len, int root) {
  return PairBroadcast(&ring_next_, &ring_prev_, rank_, size_, buf, len,
                       root);
}

bool TcpContext::GroupBroadcast(uint32_t group_id, void* buf,
                                std::size_t len, int root_pos) {
  auto it = group_rings_.find(group_id);
  if (it == group_rings_.end()) {
    LOG(ERROR) << "group " << group_id
               << " ring not built (EnsureGroupRing must run first)";
    last_error_ = "group ring missing on ring channel";
    return false;
  }
  return PairBroadcast(&it->second.next, &it->second.prev, it->second.pos,
                       it->second.size, buf, len, root_pos);
}

bool TcpContext::PairBroadcast(Conn* next_conn, Conn* prev_conn, int pos,
                               int n, void* buf, std::size_t len,
                               int root_pos) {
  if (n == 1 || len == 0) return true;
  int next = (pos + 1) % n;
  char* p = static_cast<char*>(buf);
  uint64_t len64 = len;
  // The broadcast CRC travels END TO END (one header, every hop
  // verifies it), so it is governed by HVD_TPU_NET_CRC uniformly — a
  // per-leg HVD_TPU_SHM_CRC opt-out cannot apply when some downstream
  // hop may ride a socket.
  if (pos == root_pos) {
    ShmRing* sshm = shm_use_ ? next_conn->shm() : nullptr;
    // Root only streams downstream (n > 1 so next != root). One
    // frame header up front carries the CRC every hop verifies.
    uint32_t crc = FrameCrc(kTagRing, len64, p, len);
    FaultInjector& inj = GlobalFaultInjector();
    if (inj.active()) {
      FaultDecision d = inj.OnFrame(Channel::RING, /*send=*/true,
                                    sshm != nullptr);
      if (d.action == FaultAction::DELAY || d.action == FaultAction::STALL) {
        std::this_thread::sleep_for(std::chrono::milliseconds(d.delay_ms));
      } else if (d.action == FaultAction::CLOSE ||
                 d.action == FaultAction::DROP) {
        next_conn->Close();
        sshm = nullptr;
      } else if (d.action == FaultAction::CORRUPT) {
        crc ^= 0x1;
      }
    }
    if (!next_conn->valid()) {
      SetLastError(Channel::RING, NetError::CLOSED);
      return false;
    }
    char hdr[kFrameHeaderBytes];
    BuildFrameHeader(hdr, kTagRing, len64, crc);
    if (sshm != nullptr) {
      int deadline_ms = NetTimeoutSeconds() * 1000;
      if (!sshm->WriteAll(hdr, sizeof(hdr), deadline_ms)) {
        SetLastError(Channel::SHM,
                     sshm->closed() ? NetError::CLOSED : NetError::TIMEOUT);
        return false;
      }
      if (!StreamIntoShm(sshm, next_conn, p, len)) {
        return false;  // StreamIntoShm set last_error
      }
    } else if (!next_conn->SendAll(hdr, sizeof(hdr)) ||
               !next_conn->SendAll(p, len)) {
      SetLastError(Channel::RING, next_conn->last_error());
      return false;
    }
    GlobalMetrics().net_ring_bytes_sent_total.fetch_add(
        static_cast<uint64_t>(len) + kFrameHeaderBytes,
        std::memory_order_relaxed);
    if (sshm != nullptr) {
      GlobalMetrics().net_shm_bytes_sent_total.fetch_add(
          static_cast<uint64_t>(len) + kFrameHeaderBytes,
          std::memory_order_relaxed);
    }
    return true;
  }
  // Non-root: read the header, forward it downstream if we forward at
  // all, then stream from the predecessor, forwarding bytes as they
  // arrive (cut-through, not store-and-forward — total time ~ len/BW +
  // hop latency). The CRC is verified at the END on every hop: bytes
  // already forwarded may be corrupt, but every downstream hop detects
  // the same mismatch, so corruption surfaces as a detected error
  // everywhere, never as silently wrong data.
  ShmRing* rshm = shm_use_ ? prev_conn->shm() : nullptr;
  char rhdr[kFrameHeaderBytes];
  if (rshm != nullptr) {
    if (!rshm->ReadAll(rhdr, sizeof(rhdr), NetTimeoutSeconds() * 1000)) {
      SetLastError(Channel::SHM,
                   rshm->closed() ? NetError::CLOSED : NetError::TIMEOUT);
      return false;
    }
  } else if (!prev_conn->RecvAll(rhdr, sizeof(rhdr))) {
    SetLastError(Channel::RING, prev_conn->last_error());
    return false;
  }
  uint32_t rtag;
  uint64_t rlen;
  uint32_t rcrc;
  ParseFrameHeader(rhdr, &rtag, &rlen, &rcrc);
  if (rtag != kTagRing || rlen != len64) {
    LOG(ERROR) << "ring broadcast mismatch: tag " << rtag << " len " << rlen
               << " expected " << len64;
    SetLastError(Channel::RING, NetError::PROTOCOL);
    return false;
  }
  bool forward = next != root_pos;
  ShmRing* fshm = forward && shm_use_ ? next_conn->shm() : nullptr;
  if (forward) {
    if (fshm != nullptr) {
      if (!fshm->WriteAll(rhdr, sizeof(rhdr), NetTimeoutSeconds() * 1000)) {
        SetLastError(Channel::SHM,
                     fshm->closed() ? NetError::CLOSED : NetError::TIMEOUT);
        return false;
      }
    } else if (!next_conn->SendAll(rhdr, sizeof(rhdr))) {
      SetLastError(Channel::RING, next_conn->last_error());
      return false;
    }
  }
  uint32_t crc_acc = NetCrcEnabled() ? FrameHeaderCrc(rtag, rlen) : 0;
  std::size_t received = 0, sent = 0;
  if (rshm != nullptr || fshm != nullptr) {
    // Mixed-transport cut-through: nonblocking progress on both legs
    // per iteration, forwarding only bytes already received, with a
    // no-progress deadline and peer-death EOF probes on shm legs.
    auto last_progress = std::chrono::steady_clock::now();
    const auto stall_budget =
        std::chrono::milliseconds(NetTimeoutSeconds() * 1000);
    while (received < len || (forward && sent < len)) {
      bool progress = false;
      if (received < len) {
        if (rshm != nullptr) {
          int64_t r = rshm->ReadSome(p + received, len - received);
          if (r < 0) {
            SetLastError(Channel::SHM, NetError::CLOSED);
            return false;
          }
          if (r > 0) {
            if (NetCrcEnabled()) {
              crc_acc = Crc32c(p + received, static_cast<std::size_t>(r),
                               crc_acc);
            }
            received += static_cast<std::size_t>(r);
            progress = true;
          }
        } else {
          ssize_t r = ::recv(prev_conn->fd(), p + received, len - received,
                             MSG_DONTWAIT);
          if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                         errno != EINTR)) {
            SetLastError(Channel::RING, NetError::CLOSED);
            return false;
          }
          if (r > 0) {
            if (NetCrcEnabled()) {
              crc_acc = Crc32c(p + received, static_cast<std::size_t>(r),
                               crc_acc);
            }
            received += static_cast<std::size_t>(r);
            progress = true;
          }
        }
      }
      if (forward && sent < received) {
        if (fshm != nullptr) {
          int64_t w = fshm->WriteSome(p + sent, received - sent);
          if (w < 0) {
            SetLastError(Channel::SHM, NetError::CLOSED);
            return false;
          }
          if (w > 0) {
            sent += static_cast<std::size_t>(w);
            progress = true;
          }
        } else {
          ssize_t w = ::send(next_conn->fd(), p + sent, received - sent,
                             MSG_NOSIGNAL | MSG_DONTWAIT);
          if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
              errno != EINTR) {
            SetLastError(Channel::RING, NetError::CLOSED);
            return false;
          }
          if (w > 0) {
            sent += static_cast<std::size_t>(w);
            progress = true;
          }
        }
      }
      if (progress) {
        last_progress = std::chrono::steady_clock::now();
        continue;
      }
      if (std::chrono::steady_clock::now() - last_progress > stall_budget) {
        LOG(ERROR) << "ring broadcast stalled past the transport deadline";
        SetLastError(Channel::SHM, NetError::TIMEOUT);
        return false;
      }
      char probe;
      if (rshm != nullptr && received < len &&
          ::recv(prev_conn->fd(), &probe, 1, MSG_DONTWAIT | MSG_PEEK) == 0) {
        SetLastError(Channel::SHM, NetError::CLOSED);
        return false;
      }
      // Forward-leg liveness: a SIGKILL'd downstream peer never sets
      // the forward ring's closed flag — its socket's EOF is what makes
      // its death prompt instead of a stall-deadline expiry.
      if (fshm != nullptr && sent < len &&
          ::recv(next_conn->fd(), &probe, 1, MSG_DONTWAIT | MSG_PEEK) == 0) {
        SetLastError(Channel::SHM, NetError::CLOSED);
        return false;
      }
      struct pollfd pfds[2];
      int nfds = 0;
      if (received < len && rshm == nullptr) {
        pfds[nfds++] = {prev_conn->fd(), POLLIN, 0};
      }
      if (forward && sent < received && fshm == nullptr) {
        pfds[nfds++] = {next_conn->fd(), POLLOUT, 0};
      }
      if (nfds > 0) {
        ::poll(pfds, nfds, 1);
      } else if (received < len && rshm != nullptr) {
        rshm->WaitReadable(2);
      } else if (fshm != nullptr) {
        fshm->WaitWritable(2);
      }
    }
  } else {
  while (received < len || (forward && sent < len)) {
    struct pollfd pfds[2];
    int nfds = 0;
    int recv_idx = -1, send_idx = -1;
    if (received < len) {
      pfds[nfds] = {prev_conn->fd(), POLLIN, 0};
      recv_idx = nfds++;
    }
    if (forward && sent < received) {
      pfds[nfds] = {next_conn->fd(), POLLOUT, 0};
      send_idx = nfds++;
    }
    if (nfds == 0) break;
    if (::poll(pfds, nfds, ControlPollMs()) <= 0) {
      LOG(ERROR) << "ring broadcast poll timeout/error";
      SetLastError(Channel::RING, NetError::TIMEOUT);
      return false;
    }
    if (recv_idx >= 0 && (pfds[recv_idx].revents & (POLLIN | POLLERR))) {
      ssize_t r = ::recv(prev_conn->fd(), p + received, len - received,
                         MSG_DONTWAIT);
      if (r == 0) {
        SetLastError(Channel::RING, NetError::CLOSED);
        return false;
      }
      if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        SetLastError(Channel::RING, NetError::CLOSED);
        return false;
      }
      if (r > 0) {
        if (NetCrcEnabled()) {
          crc_acc = Crc32c(p + received, static_cast<std::size_t>(r),
                           crc_acc);
        }
        received += static_cast<std::size_t>(r);
      }
    }
    if (send_idx >= 0 && (pfds[send_idx].revents & (POLLOUT | POLLERR))) {
      ssize_t w = ::send(next_conn->fd(), p + sent, received - sent,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        SetLastError(Channel::RING, NetError::CLOSED);
        return false;
      }
      if (w > 0) sent += static_cast<std::size_t>(w);
    }
  }
  }  // all-TCP pump
  if (NetCrcEnabled() && crc_acc != rcrc) {
    LOG(ERROR) << "ring broadcast checksum mismatch (" << len
               << " bytes) — corrupted frame detected";
    SetLastError(rshm != nullptr ? Channel::SHM : Channel::RING,
                 NetError::CRC);
    GlobalMetrics().net_crc_errors_total.fetch_add(1,
                                                   std::memory_order_relaxed);
    return false;
  }
  GlobalMetrics().net_ring_bytes_recv_total.fetch_add(
      static_cast<uint64_t>(len) + kFrameHeaderBytes,
      std::memory_order_relaxed);
  if (rshm != nullptr) {
    GlobalMetrics().net_shm_bytes_recv_total.fetch_add(
        static_cast<uint64_t>(len) + kFrameHeaderBytes,
        std::memory_order_relaxed);
  }
  if (forward) {
    GlobalMetrics().net_ring_bytes_sent_total.fetch_add(
        static_cast<uint64_t>(len) + kFrameHeaderBytes,
        std::memory_order_relaxed);
    if (fshm != nullptr) {
      GlobalMetrics().net_shm_bytes_sent_total.fetch_add(
          static_cast<uint64_t>(len) + kFrameHeaderBytes,
          std::memory_order_relaxed);
    }
  }
  return true;
}

// Root-side shm streaming body for PairBroadcast: pushes `len` bytes
// into the ring with the spin-then-sleep waits, the no-progress
// deadline, and the peer-death EOF probe.
bool TcpContext::StreamIntoShm(ShmRing* ring, Conn* conn, const char* p,
                               std::size_t len) {
  std::size_t sent = 0;
  auto last_progress = std::chrono::steady_clock::now();
  const auto stall_budget =
      std::chrono::milliseconds(NetTimeoutSeconds() * 1000);
  while (sent < len) {
    int64_t w = ring->WriteSome(p + sent, len - sent);
    if (w < 0) {
      SetLastError(Channel::SHM, NetError::CLOSED);
      return false;
    }
    if (w > 0) {
      sent += static_cast<std::size_t>(w);
      last_progress = std::chrono::steady_clock::now();
      continue;
    }
    if (std::chrono::steady_clock::now() - last_progress > stall_budget) {
      SetLastError(Channel::SHM, NetError::TIMEOUT);
      return false;
    }
    char probe;
    if (::recv(conn->fd(), &probe, 1, MSG_DONTWAIT | MSG_PEEK) == 0) {
      SetLastError(Channel::SHM, NetError::CLOSED);
      return false;
    }
    ring->WaitWritable(2);
  }
  return true;
}

}  // namespace hvdtpu
