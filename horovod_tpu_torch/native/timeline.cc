#include "timeline.h"

#include "logging.h"

namespace hvdtpu {

void TimelineWriter::Initialize(const std::string& file_name) {
  file_ = std::fopen(file_name.c_str(), "w");
  if (file_ == nullptr) {
    LOG(ERROR) << "Could not open " << file_name << " for timeline output; "
               << "timeline disabled.";
    return;
  }
  std::fputs("[", file_);
  first_record_ = true;
  active_.store(true);
  shutdown_.store(false);
  writer_thread_ = std::thread(&TimelineWriter::WriterLoop, this);
}

void TimelineWriter::Shutdown() {
  if (!active_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mutex_);
    shutdown_.store(true);
  }
  cv_.notify_all();
  if (writer_thread_.joinable()) writer_thread_.join();
  active_.store(false);
  if (file_ != nullptr) {
    // Close the array so the file is strictly valid chrome-tracing JSON
    // (the record separators are comma-BEFORE, so there is no trailing
    // comma to strip). Only a clean shutdown guarantees validity; a
    // crashed run leaves an unterminated array, same as the reference.
    std::fputs("\n]\n", file_);
    std::fclose(file_);
    file_ = nullptr;
  }
}

void TimelineWriter::EmergencyFinalize() {
  // Signal context: mark inactive so enqueues stop, then close the array
  // directly. The writer thread may be mid-record — a torn tail is what
  // `hvd-trace --repair` exists for; an unterminated array is strictly
  // worse.
  if (!active_.exchange(false)) return;
  if (file_ != nullptr) {
    std::fputs("\n]\n", file_);
    std::fflush(file_);
  }
}

// Comma-before-record separation: every record is preceded by ",\n"
// except the first. Runs on the writer thread (and Shutdown after join),
// so first_record_ needs no lock.
void TimelineWriter::BeginRecord() {
  if (first_record_) {
    std::fputs("\n", file_);
    first_record_ = false;
  } else {
    std::fputs(",\n", file_);
  }
}

void TimelineWriter::EnqueueWriteEvent(const std::string& tensor_name,
                                       char phase, const std::string& op_name,
                                       const std::string& args, int64_t ts_us) {
  if (!active_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mutex_);
    // Bound the queue so a wedged disk can't eat the heap (reference caps at
    // 1M records; we do the same and drop on overflow).
    if (queue_.size() >= 1000000) return;
    queue_.push_back(
        TimelineRecord{TimelineRecordType::EVENT, tensor_name, phase, op_name,
                       args, ts_us});
  }
  cv_.notify_one();
}

void TimelineWriter::EnqueueWriteMarker(const std::string& name,
                                        int64_t ts_us) {
  if (!active_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mutex_);
    if (queue_.size() >= 1000000) return;
    queue_.push_back(TimelineRecord{TimelineRecordType::MARKER, "", 'i', name,
                                    "", ts_us});
  }
  cv_.notify_one();
}

static std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      default: out += c;
    }
  }
  return out;
}

void TimelineWriter::DoWriteEvent(const TimelineRecord& r) {
  auto it = tensor_table_.find(r.tensor_name);
  int tid;
  if (it == tensor_table_.end()) {
    tid = next_tensor_id_++;
    tensor_table_[r.tensor_name] = tid;
    // Metadata record names the row.
    BeginRecord();
    std::fprintf(file_,
                 "{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": %d, "
                 "\"args\": {\"name\": \"%s\"}}",
                 tid, JsonEscape(r.tensor_name).c_str());
    BeginRecord();
    std::fprintf(file_,
                 "{\"name\": \"process_sort_index\", \"ph\": \"M\", \"pid\": "
                 "%d, \"args\": {\"sort_index\": %d}}",
                 tid, tid);
  } else {
    tid = it->second;
  }
  if (r.phase == 'B') {
    BeginRecord();
    std::fprintf(file_,
                 "{\"name\": \"%s\", \"ph\": \"B\", \"ts\": %lld, \"pid\": "
                 "%d%s}",
                 JsonEscape(r.op_name).c_str(),
                 static_cast<long long>(r.ts_us), tid,
                 r.args.empty()
                     ? ""
                     : (", \"args\": {" + r.args + "}").c_str());
  } else if (r.phase == 'E') {
    BeginRecord();
    std::fprintf(file_, "{\"ph\": \"E\", \"ts\": %lld, \"pid\": %d}",
                 static_cast<long long>(r.ts_us), tid);
  } else if (r.phase == 'i') {
    BeginRecord();
    std::fprintf(file_,
                 "{\"name\": \"%s\", \"ph\": \"i\", \"ts\": %lld, \"pid\": %d, "
                 "\"s\": \"p\"}",
                 JsonEscape(r.op_name).c_str(),
                 static_cast<long long>(r.ts_us), tid);
  }
}

void TimelineWriter::DoWriteMarker(const TimelineRecord& r) {
  BeginRecord();
  std::fprintf(file_,
               "{\"name\": \"%s\", \"ph\": \"i\", \"ts\": %lld, \"pid\": -1, "
               "\"s\": \"g\"}",
               JsonEscape(r.op_name).c_str(), static_cast<long long>(r.ts_us));
}

void TimelineWriter::WriterLoop() {
  while (true) {
    std::deque<TimelineRecord> batch;
    {
      std::unique_lock<std::mutex> lk(mutex_);
      cv_.wait(lk, [&] { return !queue_.empty() || shutdown_.load(); });
      batch.swap(queue_);
      if (batch.empty() && shutdown_.load()) break;
    }
    for (const auto& r : batch) {
      if (r.record_type == TimelineRecordType::EVENT) {
        DoWriteEvent(r);
      } else {
        DoWriteMarker(r);
      }
    }
    std::fflush(file_);
  }
}

void Timeline::Initialize(const std::string& file_name, unsigned int rank) {
  if (initialized_.load() || rank != 0) return;
  start_time_ = std::chrono::steady_clock::now();
  writer_.Initialize(file_name);
  if (writer_.active()) initialized_.store(true);
}

void Timeline::Shutdown() {
  if (!initialized_.load()) return;
  writer_.Shutdown();
  initialized_.store(false);
}

void Timeline::EmergencyFinalize() {
  if (!initialized_.load()) return;
  writer_.EmergencyFinalize();
}

int64_t Timeline::TimeSinceStartMicros() const {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - start_time_)
      .count();
}

void Timeline::WriteEvent(const std::string& tensor_name, char phase,
                          const std::string& op_name, const std::string& args) {
  writer_.EnqueueWriteEvent(tensor_name, phase, op_name, args,
                            TimeSinceStartMicros());
}

void Timeline::NegotiateStart(const std::string& tensor_name,
                              Request::RequestType request_type) {
  if (!initialized_.load()) return;
  std::lock_guard<std::recursive_mutex> lk(mutex_);
  std::string event =
      std::string("NEGOTIATE_") + Request::RequestTypeName(request_type);
  WriteEvent(tensor_name, 'B', event);
  tensor_states_[tensor_name] = TimelineState::NEGOTIATING;
}

void Timeline::NegotiateRankReady(const std::string& tensor_name, int rank) {
  if (!initialized_.load()) return;
  std::lock_guard<std::recursive_mutex> lk(mutex_);
  WriteEvent(tensor_name, 'i', std::to_string(rank));
}

void Timeline::NegotiateEnd(const std::string& tensor_name) {
  if (!initialized_.load()) return;
  std::lock_guard<std::recursive_mutex> lk(mutex_);
  WriteEvent(tensor_name, 'E');
  tensor_states_.erase(tensor_name);
}

void Timeline::Start(const std::string& tensor_name,
                     Response::ResponseType response_type) {
  if (!initialized_.load()) return;
  std::lock_guard<std::recursive_mutex> lk(mutex_);
  WriteEvent(tensor_name, 'B', Response::ResponseTypeName(response_type));
  tensor_states_[tensor_name] = TimelineState::TOP_LEVEL;
}

void Timeline::ActivityStartAll(const std::vector<std::string>& tensor_names,
                                const std::string& activity) {
  for (const auto& n : tensor_names) ActivityStart(n, activity);
}

void Timeline::ActivityStart(const std::string& tensor_name,
                             const std::string& activity) {
  if (!initialized_.load()) return;
  std::lock_guard<std::recursive_mutex> lk(mutex_);
  WriteEvent(tensor_name, 'B', activity);
  tensor_states_[tensor_name] = TimelineState::ACTIVITY;
}

void Timeline::ActivityEndAll(const std::vector<std::string>& tensor_names) {
  for (const auto& n : tensor_names) ActivityEnd(n);
}

void Timeline::ActivityEnd(const std::string& tensor_name) {
  if (!initialized_.load()) return;
  std::lock_guard<std::recursive_mutex> lk(mutex_);
  WriteEvent(tensor_name, 'E');
  tensor_states_[tensor_name] = TimelineState::TOP_LEVEL;
}

void Timeline::End(const std::string& tensor_name, bool ok) {
  if (!initialized_.load()) return;
  std::lock_guard<std::recursive_mutex> lk(mutex_);
  // Close any open activity then the top-level span.
  auto it = tensor_states_.find(tensor_name);
  if (it != tensor_states_.end() && it->second == TimelineState::ACTIVITY) {
    WriteEvent(tensor_name, 'E');
  }
  WriteEvent(tensor_name, 'E', "",
             ok ? "" : "\"error\": true");
  tensor_states_.erase(tensor_name);
}

void Timeline::MarkCycleStart() {
  if (!initialized_.load() || !mark_cycles_) return;
  writer_.EnqueueWriteMarker("CYCLE_START", TimeSinceStartMicros());
}

}  // namespace hvdtpu
