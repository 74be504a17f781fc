// Chrome-tracing (about://tracing) JSON timeline of every tensor's lifecycle
// (NEGOTIATING -> TOP_LEVEL -> per-op ACTIVITY), written by a dedicated
// writer thread fed through a bounded lock-free-ish MPSC queue so the
// coordination loop never blocks on file IO. Rank 0 only.
//
// Capability parity with /root/reference horovod/common/timeline.{h,cc}
// (which uses a boost spsc_queue + writer thread); this implementation uses a
// mutex-guarded ring buffer — contention is negligible at the event rates
// involved and it keeps the build dependency-free.
//
// Env: HVD_TPU_TIMELINE=<path>, HVD_TPU_TIMELINE_MARK_CYCLES=1.
#ifndef HVD_TPU_TIMELINE_H
#define HVD_TPU_TIMELINE_H

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "message.h"

namespace hvdtpu {

enum class TimelineRecordType : uint8_t {
  EVENT = 0,
  MARKER = 1,
};

struct TimelineRecord {
  TimelineRecordType record_type;
  std::string tensor_name;
  char phase;  // 'B' begin, 'E' end, 'X' complete, 'i' instant
  std::string op_name;
  std::string args;
  int64_t ts_us;
};

class TimelineWriter {
 public:
  void Initialize(const std::string& file_name);
  void Shutdown();
  // Fatal-signal best effort: terminate the JSON array in place, no
  // locks, no thread join — the process is about to die and an
  // unterminated file helps nobody (operations.cc FatalSignalHandler).
  void EmergencyFinalize();
  bool active() const { return active_.load(); }
  void EnqueueWriteEvent(const std::string& tensor_name, char phase,
                         const std::string& op_name, const std::string& args,
                         int64_t ts_us);
  void EnqueueWriteMarker(const std::string& name, int64_t ts_us);

 private:
  void WriterLoop();
  void BeginRecord();
  void DoWriteEvent(const TimelineRecord& r);
  void DoWriteMarker(const TimelineRecord& r);

  std::atomic<bool> active_{false};
  std::atomic<bool> shutdown_{false};
  // Comma-before-record state; writer thread only (Shutdown touches it
  // after the join).
  bool first_record_ = true;
  std::FILE* file_ = nullptr;
  std::thread writer_thread_;
  std::mutex mutex_;
  std::condition_variable cv_;
  std::deque<TimelineRecord> queue_;  // guarded_by(mutex_)
  // tensor name -> stable integer "pid" for chrome tracing rows.
  std::unordered_map<std::string, int> tensor_table_;
  int next_tensor_id_ = 0;
};

enum class TimelineState : uint8_t {
  UNKNOWN = 0,
  NEGOTIATING = 1,
  TOP_LEVEL = 2,
  ACTIVITY = 3,
};

// Records state transitions for named tensors. Thread-compatible with the
// single background coordination thread plus enqueue threads (guarded).
class Timeline {
 public:
  void Initialize(const std::string& file_name, unsigned int rank);
  void Shutdown();
  void EmergencyFinalize();
  bool Initialized() const { return initialized_.load(); }

  void NegotiateStart(const std::string& tensor_name,
                      Request::RequestType request_type);
  void NegotiateRankReady(const std::string& tensor_name, int rank);
  void NegotiateEnd(const std::string& tensor_name);

  void Start(const std::string& tensor_name,
             Response::ResponseType response_type);
  void ActivityStartAll(const std::vector<std::string>& tensor_names,
                        const std::string& activity);
  void ActivityStart(const std::string& tensor_name,
                     const std::string& activity);
  void ActivityEndAll(const std::vector<std::string>& tensor_names);
  void ActivityEnd(const std::string& tensor_name);
  void End(const std::string& tensor_name, bool ok);

  void MarkCycleStart();
  void SetMarkCycles(bool v) { mark_cycles_ = v; }

 private:
  int64_t TimeSinceStartMicros() const;
  void WriteEvent(const std::string& tensor_name, char phase,
                  const std::string& op_name = "",
                  const std::string& args = "");

  std::atomic<bool> initialized_{false};
  bool mark_cycles_ = false;
  std::chrono::steady_clock::time_point start_time_;
  TimelineWriter writer_;
  std::recursive_mutex mutex_;
  std::unordered_map<std::string, TimelineState> tensor_states_;  // guarded_by(mutex_)
};

}  // namespace hvdtpu

#endif  // HVD_TPU_TIMELINE_H
