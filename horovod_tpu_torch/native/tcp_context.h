// Owns the process's host-network communicator state: the listener, the
// control star (worker <-> rank 0), the global data ring (rank i <-> i+1
// mod N), and — when the topology is homogeneous — a local ring (within
// one host's ranks) and a cross ring (across hosts at one local_rank),
// plus rank/local/cross topology read from launcher-injected env.
//
// Role parity with /root/reference horovod/common/mpi/mpi_context.{h,cc}
// (global/local/cross communicator splits, mpi_context.cc:133-165) and
// gloo/gloo_context.{h,cc} (communicator ownership + rendezvous); transport
// here is plain TCP with launcher-assigned ports:
//   HVD_TPU_RANK / HVD_TPU_SIZE / HVD_TPU_LOCAL_RANK / HVD_TPU_LOCAL_SIZE /
//   HVD_TPU_CROSS_RANK / HVD_TPU_CROSS_SIZE
//   HVD_TPU_ADDRS = host:port per rank, comma-separated, index == rank.
//
// Failure discipline (docs/CHAOS.md): every frame is CRC32C-checked, all
// sockets carry I/O deadlines and keepalive, and the worker side of the
// control star survives a dropped connection by reconnecting to the
// coordinator with capped exponential backoff — the handshake echoes the
// elastic generation and this side's completed control-frame count, so a
// stale worker can never splice into a newer ring and a desynced resume
// is rejected into the ordinary elastic recovery path.
#ifndef HVD_TPU_TCP_CONTEXT_H
#define HVD_TPU_TCP_CONTEXT_H

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "net.h"
#include "shm_context.h"

namespace hvdtpu {

// Which ring a neighbor exchange rides.
enum class Ring { GLOBAL, LOCAL, CROSS };

class TcpContext {
 public:
  // Reads env, opens the listener, and builds the star + ring connections.
  // Blocking; returns false on rendezvous failure.
  bool Initialize();
  void Finalize();
  bool initialized() const { return initialized_; }

  int rank() const { return rank_; }
  int size() const { return size_; }
  int local_rank() const { return local_rank_; }
  int local_size() const { return local_size_; }
  int cross_rank() const { return cross_rank_; }
  int cross_size() const { return cross_size_; }
  // Elastic generation this communicator was built for (HVD_TPU_GENERATION).
  uint32_t generation() const { return generation_; }

  // Human-readable cause of the most recent transport failure on this
  // context ("frame checksum mismatch on control channel", "recv
  // deadline expired on ring channel", ...). Read by the controller to
  // build recoverable-error messages that NAME the failure; background
  // thread only.
  const std::string& last_error() const { return last_error_; }

  // True when every rank reported the same local/cross sizes and the
  // (local_rank, cross_rank) grid is complete — the precondition for the
  // two-level collectives (reference gates hierarchical ops on
  // is_homogeneous the same way, mpi_controller.cc:25-81).
  bool is_homogeneous() const { return is_homogeneous_; }
  // Local + cross rings exist and two-level ops can run.
  bool hierarchical_possible() const {
    return is_homogeneous_ && local_size_ > 1 && cross_size_ > 1;
  }
  // Global rank of the peer at (local_rank, cross_rank); -1 if unknown.
  int RankAt(int local_rank, int cross_rank) const;

  // --- control star (coordinator protocol) ---
  // Worker sends its blob to rank 0; rank 0 fills all[r] for r=1..N-1.
  // Rank 0 services every worker socket concurrently (poll-multiplexed).
  bool GatherBlobs(const std::string& mine, std::vector<std::string>* all);
  bool BroadcastBlob(std::string* blob);
  // Elementwise bitwise AND / OR across ranks (fixed-size u64 vectors).
  bool BitwiseSync(std::vector<uint64_t>& bits, bool is_or);
  bool Barrier();

  // --- data rings (collective ops) ---
  // Full-duplex neighbor exchange on the chosen ring: sends send_len bytes
  // to the ring successor while receiving recv_len bytes from the ring
  // predecessor, pumping both directions so large transfers can't deadlock
  // on full socket buffers.
  bool RingExchange(const void* send_buf, std::size_t send_len, void* recv_buf,
                    std::size_t recv_len) {
    return RingExchangeOn(Ring::GLOBAL, send_buf, send_len, recv_buf,
                          recv_len);
  }
  bool RingExchangeOn(Ring ring, const void* send_buf, std::size_t send_len,
                      void* recv_buf, std::size_t recv_len);
  // This rank's index / participant count on the given ring.
  int RingRank(Ring ring) const;
  int RingSize(Ring ring) const;

  // Chunked pipelined broadcast over the global ring: the root streams
  // `len` bytes; every other rank receives into `buf` and forwards.
  // Root passes its source in `buf` too.
  bool RingBroadcast(void* buf, std::size_t len, int root);

  // --- process-group rings (docs/GROUPS.md) ---
  // A group collective rides a dedicated ring over the GROUP's member
  // subset — hops shrink from world-1 to group-1 and disjoint groups'
  // rings run concurrently. Connections are built lazily by the
  // background thread at a group op's first execution: every member
  // connects to its ring successor (the TCP backlog completes the
  // connect even before the peer accepts), then accepts from its
  // predecessor — connect-before-accept on every member, so the pairing
  // cannot deadlock. Accepted connects for OTHER groups (a member of a
  // later response's group racing ahead) are stashed and consumed by
  // that group's own EnsureGroupRing. Background thread only.
  bool EnsureGroupRing(uint32_t group_id, const std::vector<int>& members);
  // This rank's ring position / member count for a BUILT group ring
  // (-1 / 0 when EnsureGroupRing has not run for the id).
  int GroupRank(uint32_t group_id) const;
  int GroupSize(uint32_t group_id) const;
  // Neighbor exchange / rooted broadcast on the group's ring (root_pos
  // is the GROUP-ring position, not the world rank). CRC framing, the
  // fault injector, deadlines, and the bandwidth throttle apply exactly
  // as on the global ring (Channel::RING).
  bool GroupExchange(uint32_t group_id, const void* send_buf,
                     std::size_t send_len, void* recv_buf,
                     std::size_t recv_len);
  bool GroupBroadcast(uint32_t group_id, void* buf, std::size_t len,
                      int root_pos);
  // --- group sub-rings (hierarchical composites for subgroups) ---
  // When a group's member set forms a uniform (local, cross) grid of
  // the world topology — every participating host contributes the same
  // number of members — its hierarchical composites ride dedicated
  // per-group local/cross rings (the local legs over shm when
  // negotiated) instead of the flat group ring. docs/TRANSPORT.md.
  struct GroupGrid {
    bool uniform = false;
    int local_size = 0;          // members per host
    int cross_size = 0;          // hosts the group spans
    int local_pos = -1;          // my index among my host's members
    int cross_pos = -1;          // my host's index among the group's hosts
    // pos_grid[c * local_size + j] = GROUP position (index into the
    // member list) of the j-th member (by world local_rank) on the
    // group's c-th host (hosts ordered by world cross_rank).
    std::vector<int> pos_grid;
  };
  // Pure function of (members, world grid): identical on every rank, so
  // op Enabled() decisions made from it can never diverge.
  GroupGrid GroupGridOf(const std::vector<int>& members) const;
  // Uniform grid with >1 member per host and >1 host: the precondition
  // for a subgroup's two-level composites.
  bool GroupHierarchicalPossible(const std::vector<int>& members) const;
  // Lazily builds the group's local+cross rings (background thread
  // only; connect-before-accept exactly like the flat group ring) and
  // negotiates shm on the new legs.
  bool EnsureGroupSubRings(uint32_t group_id, const std::vector<int>& members);

  // Group-aware ring coordinates: group == 0 -> the enum rings;
  // group != 0 with GLOBAL -> the group's flat ring; group != 0 with
  // LOCAL/CROSS -> the group's sub-rings (EnsureGroupSubRings first).
  int RingRankOn(Ring ring, uint32_t group) const;
  int RingSizeOn(Ring ring, uint32_t group) const;
  // Dispatch helper for the ring ops, same coordinate rule.
  bool ExchangeOn(Ring ring, uint32_t group, const void* send_buf,
                  std::size_t send_len, void* recv_buf,
                  std::size_t recv_len) {
    if (group == 0) {
      return RingExchangeOn(ring, send_buf, send_len, recv_buf, recv_len);
    }
    if (ring == Ring::GLOBAL) {
      return GroupExchange(group, send_buf, send_len, recv_buf, recv_len);
    }
    return GroupSubExchange(group, ring, send_buf, send_len, recv_buf,
                            recv_len);
  }
  bool GroupSubExchange(uint32_t group_id, Ring ring, const void* send_buf,
                        std::size_t send_len, void* recv_buf,
                        std::size_t recv_len);

  // --- shared-memory data plane (docs/TRANSPORT.md) ---
  // Whether the launcher-visible topology has at least one intra-host
  // pair AND HVD_TPU_SHM is enabled — computed from the full address
  // list, so it is identical on every rank (the autotuner's capability
  // seed). Actual per-pair use additionally requires a successfully
  // negotiated segment on both ends.
  bool shm_topology_possible() const { return shm_topology_possible_; }
  // The autotuned shm_transport knob's cycle-synchronized application
  // point (operations.cc RunLoopOnce): when off, negotiated segments
  // stay attached but every leg rides TCP. Background thread only.
  void SetShmUse(bool use) { shm_use_ = use; }
  bool shm_use() const { return shm_use_; }

  // --- control-plane protocol accounting ---
  // Bytes/messages THIS rank moved on the control star (16-byte frame
  // headers included; data-ring traffic is not counted — these isolate
  // the NEGOTIATION cost, the quantity the response-cache fast path
  // exists to shrink; reference design goal: response_cache.cc:308-409).
  // Idle heartbeat cycles also send control frames, so bytes accrue
  // with wall time when cycle pacing is zeroed.
  // Written by the background thread, read from the C API.
  uint64_t ctrl_bytes_sent() const { return ctrl_bytes_sent_.load(); }
  uint64_t ctrl_bytes_recv() const { return ctrl_bytes_recv_.load(); }
  uint64_t ctrl_msgs() const { return ctrl_msgs_.load(); }
  void ResetProtocolCounters() {
    ctrl_bytes_sent_.store(0);
    ctrl_bytes_recv_.store(0);
    ctrl_msgs_.store(0);
  }

 private:
  bool ExchangeTopology();
  bool ConnectSubRings(int timeout_ms);

  // --- shm negotiation (tcp_context.cc; docs/TRANSPORT.md) ---
  // A connector that advertised kHandshakeShmCap sends exactly ONE
  // setup frame per data conn (host key + segment name, or an empty
  // name = "TCP please"); the acceptor answers with a one-byte ack.
  // The three phases run in send-all / serve-all / collect-acks order
  // so no pair can deadlock (setup and ack frames are tiny and fit any
  // socket buffer).
  struct ShmPending {
    Conn* conn;
    std::unique_ptr<ShmRing> ring;  // null when the connector chose TCP
  };
  // Runs the full three-phase negotiation over the init-time data conns
  // (global + local + cross rings). Soft failures (attach refused, no
  // /dev/shm) land pairs on TCP; false only on a frame-protocol error.
  bool NegotiateShmInit();
  bool ShmSetupSend(Conn* conn, int peer_rank, Channel chan,
                    std::vector<ShmPending>* pending);
  bool ShmSetupRecv(Conn* conn, uint8_t peer_flags);
  bool ShmAckRecv(ShmPending* p);
  // Negotiation for one freshly built group leg pair (flat or sub).
  bool NegotiateShmPair(Conn* next, int next_rank, Conn* prev,
                        uint8_t prev_flags, Channel chan);
  // Host key WITHOUT the per-rank HVD_TPU_HOST_KEY override — the
  // connector's symmetric same-host guess for any rank (the override
  // only affects the authoritative key THIS rank puts in its setup
  // frame / compares on accept).
  std::string DefaultHostKey(int rank) const;
  std::string MyHostKey() const;

  // Shared connect-then-accept body for a group leg pair (flat ring or
  // a sub-ring): connects to next_rank on `chan`, then accepts from
  // prev_rank, stashing unrelated group connects for their own builds.
  bool GroupPairConnect(uint32_t group_id, Channel chan, int next_rank,
                        int prev_rank, Conn* next, Conn* prev,
                        uint8_t* prev_flags);
  // World local_rank of an arbitrary rank (grid scan; -1 when unknown).
  int LocalRankOfWorld(int rank) const;
  // Shared duplex-pump body for all neighbor exchanges (enum rings and
  // group rings): header swap, CRC-verified full-duplex payload pump,
  // fault hooks, TX pacing, socket-layer byte accounting.
  bool PairExchange(Conn* next, Conn* prev, Channel chan, int ring_size,
                    const void* send_buf, std::size_t send_len,
                    void* recv_buf, std::size_t recv_len);
  // Duplex payload pump for exchanges where at least one leg rides a
  // shared-memory ring (tcp_context.cc; docs/TRANSPORT.md).
  bool PumpShmAware(Conn* next, Conn* prev, Channel chan, ShmRing* sshm,
                    ShmRing* rshm, const char* sp, std::size_t send_len,
                    char* rp, std::size_t recv_len, bool recv_crc_on,
                    uint32_t* crc_acc);
  // Shared cut-through broadcast body (global ring and group rings):
  // `pos`/`n`/`root_pos` are ring positions on the given conn pair.
  bool PairBroadcast(Conn* next, Conn* prev, int pos, int n, void* buf,
                     std::size_t len, int root_pos);
  // Root-side shm streaming body for PairBroadcast.
  bool StreamIntoShm(ShmRing* ring, Conn* conn, const char* p,
                     std::size_t len);
  // Rank 0: receive one frame from every worker concurrently.
  bool MultiRecvFrames(uint32_t expect_tag, std::vector<std::string>* blobs);
  // Rank 0: send per-worker payloads concurrently (all pairs may alias).
  bool MultiSendFrames(uint32_t tag,
                       const std::vector<std::pair<const void*, std::size_t>>&
                           payloads);

  // --- worker-side control star with reconnect ---
  // Frame-granular control I/O: on a CLOSED connection these reconnect
  // to the coordinator with capped exponential backoff (up to
  // HVD_TPU_RECONNECT_SECONDS) and retry the frame; checksum/deadline/
  // oversize failures are NOT retried (the frame stream is unrecoverable
  // — that is the elastic layer's job). Each completed frame bumps
  // my_ctrl_opseq_, the resume cursor the reconnect handshake carries.
  bool ControlSendFrame(uint32_t tag, const void* payload, std::size_t len);
  bool ControlRecvFrame(uint32_t expect_tag, std::string* payload);
  bool ControlRecvFrameInto(uint32_t expect_tag, void* buf, std::size_t len);
  bool ReconnectControl();

  // --- coordinator-side reconnect acceptance ---
  // Accepts a pending control reconnect on the listener, validates its
  // (rank, generation, opseq) against `expect_opseq_for` (per-rank
  // expected resume cursor) and the dead-peer mask, sends the verdict
  // byte, and swaps the new Conn in. Returns the reconnected worker
  // index (1..size-1), 0 when nothing usable was accepted, or -1 on a
  // fatal desync (the job must fail over).
  int TryAcceptControlReconnect(const std::vector<bool>& dead);

  void SetLastError(Channel chan, NetError err);

  // --- emulated data-ring bandwidth (HVD_TPU_RING_BANDWIDTH_MBPS) ---
  // A TX token bucket paces ring-exchange sends to the configured rate
  // so a laptop/CI host can reproduce the wait states of a real
  // inter-host link (capacity planning + the pipelined-ring bench,
  // docs/AUTOTUNE.md). 0 = off. Only the send side is paced, and only
  // by withholding POLLOUT — receives keep draining, so the emulation
  // never deadlocks the duplex pump. Background thread only.
  double ring_tx_bytes_per_us_ = 0.0;
  double ring_tx_ready_us_ = 0.0;

  // Per-logical-channel wire-hop sequence for trace spans (trace.h):
  // ring exchanges run in lockstep, so hop N on the sender is hop N on
  // the receiver — the merge tool pairs spans across ranks by
  // (channel, hop). Indexed by Channel value. Background thread only.
  uint64_t trace_hop_seq_[4] = {0, 0, 0, 0};

  int rank_ = 0;
  int size_ = 1;
  int local_rank_ = 0;
  int local_size_ = 1;
  int cross_rank_ = 0;
  int cross_size_ = 1;
  bool is_homogeneous_ = false;
  bool initialized_ = false;
  uint32_t generation_ = 0;

  std::atomic<uint64_t> ctrl_bytes_sent_{0};
  std::atomic<uint64_t> ctrl_bytes_recv_{0};
  std::atomic<uint64_t> ctrl_msgs_{0};

  // rank_grid_[cross_rank * local_size + local_rank] = global rank.
  std::vector<int> rank_grid_;
  // Reverse lookup: rank_cross_[rank] = that rank's cross index (host)
  // when homogeneous; empty otherwise.
  std::vector<int> rank_cross_;
  // Host part of each rank's HVD_TPU_ADDRS entry (index == rank).
  std::vector<std::string> addr_hosts_;
  bool shm_topology_possible_ = false;
  bool shm_use_ = true;

  Listener listener_;
  // Rank 0: control_conns_[r] for r=1..N-1; workers: control_conns_[0].
  std::vector<Conn> control_conns_;
  // Completed control-frame counts: the coordinator tracks one cursor
  // per worker; a worker tracks its own in my_ctrl_opseq_. A reconnect
  // resumes only when the two cursors agree (both sides then retry the
  // same in-flight frame from its first byte).
  std::vector<uint64_t> ctrl_opseq_;
  uint64_t my_ctrl_opseq_ = 0;
  std::string coord_host_;  // rank 0's address, kept for reconnects
  int coord_port_ = 0;
  std::string last_error_;

  Conn ring_next_;        // connected to (rank+1) % size
  Conn ring_prev_;        // accepted from (rank-1+size) % size
  Conn local_next_;       // successor within my host's local ring
  Conn local_prev_;
  Conn cross_next_;       // successor within my local_rank's cross ring
  Conn cross_prev_;
  // Handshake flags of the accepted (prev) side of each init-time data
  // conn: NegotiateShmInit needs to know whether the connector
  // advertised kHandshakeShmCap (a setup frame is then in flight).
  uint8_t ring_prev_flags_ = 0;
  uint8_t local_prev_flags_ = 0;
  uint8_t cross_prev_flags_ = 0;

  // Lazily-built per-group rings (background thread only; see
  // EnsureGroupRing). pending_group_fds_ stashes accepted group-ring
  // connects that belong to a (group, channel) pair this rank has not
  // built yet, keyed (channel << 60) | (group_id << 24) | peer_rank,
  // carrying the handshake flags for the later shm negotiation.
  struct GroupRing {
    Conn next;
    Conn prev;
    int pos = 0;
    int size = 1;
  };
  // Per-group local/cross sub-rings for uniform-grid subgroups
  // (EnsureGroupSubRings).
  struct GroupSubRings {
    GroupGrid grid;
    Conn lnext, lprev;  // intra-host ring among my host's group members
    Conn cnext, cprev;  // cross-host ring at my local position
  };
  struct PendingGroupFd {
    int fd = -1;
    uint8_t flags = 0;
  };
  std::unordered_map<uint32_t, GroupRing> group_rings_;
  std::unordered_map<uint32_t, GroupSubRings> group_subrings_;
  std::unordered_map<uint64_t, PendingGroupFd> pending_group_fds_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_TCP_CONTEXT_H
