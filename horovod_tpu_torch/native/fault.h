// Deterministic fault injection for the transport (docs/CHAOS.md).
//
// The chaos harness's premise: a failure path that has never fired is
// a failure path that does not work. This injector lets a test provoke
// an exact fault at an exact point in the frame stream — and lets a
// soak run sprinkle seeded random faults — without touching production
// code paths (one relaxed atomic-bool check per frame when inactive).
//
// Configured from HVD_TPU_FAULT_SPEC, parsed once per (re)init:
//
//   spec   := clause (';' clause)*
//   clause := 'seed=N' | rule
//   rule   := field (',' field)*
//   field  := 'rank=N'          fire only on this process rank
//           | 'chan=control|ring|local|cross|shm|any'
//                               (shm filters by TRANSPORT: data-plane
//                               frames riding a shared-memory ring,
//                               whatever their logical channel; the
//                               ring/local/cross filters keep matching
//                               by logical channel regardless of the
//                               transport underneath)
//           | 'dir=send|recv|any'
//           | 'frame=N'         fire at the Nth matching frame (0-based,
//                               counted per rule over matching frames)
//           | 'prob=P'          fire with probability P per matching
//                               frame (seeded PRNG; exclusive w/ frame=)
//           | 'count=K'         max fires for this rule (default: 1 for
//                               frame=, unlimited for prob=)
//           | 'action=drop|delay|corrupt|close|stall'
//           | 'delay_ms=D'      delay duration (actions delay/stall;
//                               stall defaults to 600000 = a hang)
//
// Example — kill rank 1's control connection at its 25th control frame
// and corrupt 1% of its ring frames:
//   HVD_TPU_FAULT_SPEC='seed=7;rank=1,chan=control,frame=25,action=close;
//                       rank=1,chan=ring,prob=0.01,action=corrupt'
//
// Action semantics at the frame layer (net.cc / tcp_context.cc):
//   drop     send side: silently skip the frame (peer starves -> its
//            recv deadline fires). Ignored on recv.
//   delay    sleep delay_ms before the frame I/O, then proceed.
//   corrupt  send: flip one payload byte after the CRC is computed (the
//            receiver's checksum catches it); recv: flip one received
//            payload byte before verification. Either way the frame
//            surfaces as a detected checksum mismatch, never bad data.
//   close    close the connection's fd (peer sees EOF; local I/O fails
//            promptly) — the control-star reconnect path's trigger.
//   stall    sleep delay_ms (default 600 s) holding the frame: the
//            hung-peer scenario the I/O deadlines exist for.
//
// Determinism: a worker's frame stream is produced by the single
// background thread, so per-rule frame counters and the seeded PRNG
// replay exactly for a given (spec, rank, program). On the coordinator
// the control star is poll-multiplexed; frames count in service order,
// which can vary across runs — filter coordinator rules by frame
// ranges, not exact peers, when exactness matters.
#ifndef HVD_TPU_FAULT_H
#define HVD_TPU_FAULT_H

#include <atomic>
#include <cstdint>
#include <mutex>
#include <random>
#include <string>
#include <vector>

#include "net.h"

namespace hvdtpu {

enum class FaultAction : int {
  NONE = 0,
  DROP,
  DELAY,
  CORRUPT,
  CLOSE,
  STALL,
};

const char* FaultActionName(FaultAction a);

struct FaultDecision {
  FaultAction action = FaultAction::NONE;
  int delay_ms = 0;
};

class FaultInjector {
 public:
  // (Re)parses `spec` (nullptr/empty disables). Resets all frame
  // counters and reseeds the PRNG — an elastic re-init replays the
  // spec from frame 0 of the new generation.
  void Configure(const char* spec, int rank);

  bool active() const { return active_.load(std::memory_order_relaxed); }

  // Consulted once per frame by the transport. Returns the action to
  // apply (delay/stall sleeps are applied by the CALLER so it can pick
  // the right moment relative to its I/O). NONE when inactive or no
  // rule matches. `shm` marks a frame riding the shared-memory plane
  // (the chan=shm filter's match key; logical-channel filters ignore
  // it).
  FaultDecision OnFrame(Channel chan, bool send, bool shm = false);

  // Test hook: number of times any rule has fired since Configure.
  uint64_t fires() const { return fires_.load(std::memory_order_relaxed); }

 private:
  struct Rule {
    int rank = -1;       // -1 = any
    int chan = -1;       // -1 = any, else (int)Channel
    int dir = -1;        // -1 = any, 0 = send, 1 = recv
    int64_t frame = -1;  // fire at Nth matching frame (exclusive w/ prob)
    double prob = 0.0;
    int64_t count = -1;  // remaining fires; -1 = unlimited
    int delay_ms = 0;
    FaultAction action = FaultAction::NONE;
    int64_t seen = 0;  // matching frames observed so far
  };

  std::atomic<bool> active_{false};
  std::atomic<uint64_t> fires_{0};
  std::mutex mutex_;
  std::vector<Rule> rules_;  // guarded_by(mutex_)
  std::mt19937_64 rng_;      // guarded_by(mutex_)
  int rank_ = -1;            // guarded_by(mutex_)
};

// Process-wide injector (configured by TcpContext::Initialize; reached
// from the Conn frame layer which carries no context pointer).
FaultInjector& GlobalFaultInjector();

}  // namespace hvdtpu

#endif  // HVD_TPU_FAULT_H
