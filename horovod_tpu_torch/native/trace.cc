#include "trace.h"

#include <unistd.h>

#include <cctype>
#include <cinttypes>
#include <cstdlib>
#include <cstring>
#include <sys/stat.h>
#include <sys/types.h>

#include "metrics.h"

namespace hvdtpu {

namespace {

// JSON string escape (names come from user tensor names).
void AppendEscaped(std::string* out, const char* s) {
  for (const char* p = s; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          *out += buf;
        } else {
          out->push_back(static_cast<char>(c));
        }
    }
  }
}

void AppendSpanJson(std::string* out, const TraceSpan& s) {
  char buf[160];
  *out += "{\"n\":\"";
  AppendEscaped(out, s.name);
  std::snprintf(buf, sizeof(buf),
                "\",\"p\":%d,\"g\":%u,\"c\":%" PRIu64
                ",\"pe\":%d,\"b\":%" PRId64 ",\"s\":%" PRId64
                ",\"e\":%" PRId64 ",\"f\":%u}",
                s.phase, s.group, s.cycle, s.peer, s.bytes, s.t_start,
                s.t_end, static_cast<unsigned>(s.flags));
  *out += buf;
}

uint64_t RoundUpPow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

const char* TracePhaseName(int p) {
  switch (p) {
    case TRACE_ENQUEUE: return "enqueue";
    case TRACE_NEGOTIATE: return "negotiate";
    case TRACE_FUSE: return "fuse";
    case TRACE_EXEC: return "exec";
    case TRACE_WIRE_HOP: return "wire_hop";
    case TRACE_ENCODE: return "encode";
    case TRACE_DECODE: return "decode";
    case TRACE_CALLBACK: return "callback";
    case TRACE_REQUEST: return "request";
  }
  return "unknown";
}

Trace::Trace() : epoch_(std::chrono::steady_clock::now()) {}

int64_t Trace::NowNs() const {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now() - epoch_)
      .count();
}

void Trace::Configure(int rank, int world_size, int64_t generation) {
  rank_.store(rank, std::memory_order_relaxed);
  world_size_.store(world_size, std::memory_order_relaxed);
  generation_.store(generation, std::memory_order_relaxed);

  const char* trace_env = std::getenv("HVD_TPU_TRACE");
  bool on = !(trace_env && std::strcmp(trace_env, "0") == 0);

  if (!ring_) {
    uint64_t cap = 32768;
    const char* ring_env = std::getenv("HVD_TPU_TRACE_RING");
    if (ring_env && *ring_env) {
      long long v = std::atoll(ring_env);
      if (v >= 64 && v <= (1ll << 22)) cap = static_cast<uint64_t>(v);
    }
    cap = RoundUpPow2(cap);
    ring_.reset(new TraceSlot[cap]);
    ring_mask_ = cap - 1;
  }

  {
    std::lock_guard<std::mutex> lock(bundle_mutex_);
    const char* bdir = std::getenv("HVD_TPU_BUNDLE_DIR");
    bundle_dir_ = bdir ? bdir : "";
  }

  {
    std::lock_guard<std::mutex> lock(shard_mutex_);
    const char* tdir = std::getenv("HVD_TPU_TRACE_DIR");
    trace_dir_ = (on && tdir) ? tdir : "";
    if (!trace_dir_.empty() && shard_file_ == nullptr) {
      ::mkdir(trace_dir_.c_str(), 0777);  // best-effort; may pre-exist
      std::string path =
          trace_dir_ + "/trace_rank" + std::to_string(rank) + ".jsonl";
      shard_file_ = std::fopen(path.c_str(), "w");
    }
    if (shard_file_ != nullptr) {
      WriteShardHeaderLocked();
      if (!drainer_running_) {
        drainer_stop_.store(false, std::memory_order_relaxed);
        drainer_thread_ = std::thread(&Trace::DrainerLoop, this);
        drainer_running_ = true;
      }
    }
  }

  enabled_.store(on, std::memory_order_relaxed);
}

// lockorder: requires(shard_mutex_)
void Trace::WriteShardHeaderLocked() {
  char buf[256];
  std::snprintf(buf, sizeof(buf),
                "{\"hvd_trace_shard\":1,\"rank\":%d,\"size\":%d,"
                "\"generation\":%" PRId64 ",\"pid\":%d,\"ring\":%" PRIu64
                "}\n",
                rank_.load(std::memory_order_relaxed),
                world_size_.load(std::memory_order_relaxed),
                generation_.load(std::memory_order_relaxed),
                static_cast<int>(::getpid()), ring_mask_ + 1);
  std::fputs(buf, shard_file_);
  std::fflush(shard_file_);
}

void Trace::Record(const char* name, int phase, int64_t start_ns,
                   int64_t end_ns, int64_t bytes, uint32_t group, int peer,
                   uint64_t cycle, uint8_t flags) {
  if (!enabled_.load(std::memory_order_relaxed) || !ring_) return;
  uint64_t idx = head_.fetch_add(1, std::memory_order_relaxed);
  TraceSlot& slot = ring_[idx & ring_mask_];
  slot.seq.store(TraceSlot::kBusy, std::memory_order_relaxed);
  // Order the busy marker before the payload stores: a reader that
  // observes any payload word then re-checks seq (acquire fence) must
  // see at least the busy marker and reject the torn slot.
  std::atomic_thread_fence(std::memory_order_release);
  slot.t_start.store(start_ns, std::memory_order_relaxed);
  slot.t_end.store(end_ns, std::memory_order_relaxed);
  slot.cycle.store(cycle, std::memory_order_relaxed);
  slot.bytes.store(bytes, std::memory_order_relaxed);
  uint64_t meta = static_cast<uint64_t>(static_cast<uint8_t>(phase)) |
                  (static_cast<uint64_t>(flags) << 8) |
                  (static_cast<uint64_t>(group & 0xffff) << 16) |
                  (static_cast<uint64_t>(static_cast<uint32_t>(peer)) << 32);
  slot.meta.store(meta, std::memory_order_relaxed);
  char padded[TraceSlot::kNameWords * 8];
  std::memset(padded, 0, sizeof(padded));
  if (name) {
    size_t n = std::strlen(name);
    if (n > sizeof(padded) - 1) n = sizeof(padded) - 1;
    std::memcpy(padded, name, n);
  }
  for (int w = 0; w < TraceSlot::kNameWords; ++w) {
    uint64_t word;
    std::memcpy(&word, padded + w * 8, 8);
    slot.name[w].store(word, std::memory_order_relaxed);
  }
  slot.seq.store(idx + 1, std::memory_order_release);
  spans_total.fetch_add(1, std::memory_order_relaxed);
}

bool Trace::ReadSlot(uint64_t idx, TraceSpan* out) const {
  const TraceSlot& slot = ring_[idx & ring_mask_];
  uint64_t s1 = slot.seq.load(std::memory_order_acquire);
  if (s1 != idx + 1) return false;
  out->t_start = slot.t_start.load(std::memory_order_relaxed);
  out->t_end = slot.t_end.load(std::memory_order_relaxed);
  out->cycle = slot.cycle.load(std::memory_order_relaxed);
  out->bytes = slot.bytes.load(std::memory_order_relaxed);
  uint64_t meta = slot.meta.load(std::memory_order_relaxed);
  out->phase = static_cast<int>(meta & 0xff);
  out->flags = static_cast<uint8_t>((meta >> 8) & 0xff);
  out->group = static_cast<uint32_t>((meta >> 16) & 0xffff);
  out->peer = static_cast<int>(static_cast<int32_t>(meta >> 32));
  for (int w = 0; w < TraceSlot::kNameWords; ++w) {
    uint64_t word = slot.name[w].load(std::memory_order_relaxed);
    std::memcpy(out->name + w * 8, &word, 8);
  }
  out->name[sizeof(out->name) - 1] = '\0';
  std::atomic_thread_fence(std::memory_order_acquire);
  return slot.seq.load(std::memory_order_relaxed) == idx + 1;
}

void Trace::OpenSpan(const std::string& key, int64_t start_ns) {
  if (!enabled_.load(std::memory_order_relaxed)) return;
  std::lock_guard<std::mutex> lock(open_mutex_);
  open_spans_[key] = start_ns;
}

int64_t Trace::CloseSpan(const std::string& key) {
  std::lock_guard<std::mutex> lock(open_mutex_);
  auto it = open_spans_.find(key);
  if (it == open_spans_.end()) return -1;
  int64_t start = it->second;
  open_spans_.erase(it);
  return start;
}

void Trace::NoteControlFrame(uint32_t tag, bool send, uint64_t bytes) {
  if (!enabled_.load(std::memory_order_relaxed)) return;
  std::lock_guard<std::mutex> lock(frame_mutex_);
  control_frames_.push_back(FrameNote{NowNs(), tag, send, bytes});
  while (control_frames_.size() > kControlFrameLog) {
    control_frames_.pop_front();
  }
}

void Trace::UpdateClockSample(int64_t t1, int64_t t2, int64_t t3,
                              int64_t t4) {
  // offset maps local time onto the reference: t_ref = t_local + offset.
  int64_t offset = ((t2 - t1) + (t3 - t4)) / 2;
  int64_t uncertainty = ((t4 - t1) - (t3 - t2)) / 2;
  if (uncertainty < 0) return;  // asymmetric nonsense (clock slew mid-sample)
  int64_t now = NowNs();
  int64_t cur_unc = clock_uncertainty_ns_.load(std::memory_order_relaxed);
  int64_t cur_at = clock_sampled_at_ns_.load(std::memory_order_relaxed);
  bool stale = (now - cur_at) > kClockStaleNs;
  if (cur_unc >= 0 && !stale && uncertainty >= cur_unc) return;
  clock_offset_ns_.store(offset, std::memory_order_relaxed);
  clock_uncertainty_ns_.store(uncertainty, std::memory_order_relaxed);
  clock_sampled_at_ns_.store(now, std::memory_order_relaxed);
}

// lockorder: requires(shard_mutex_)
void Trace::DrainLocked() {
  if (shard_file_ == nullptr || !ring_) return;
  uint64_t cap = ring_mask_ + 1;
  uint64_t head = head_.load(std::memory_order_acquire);
  if (head - drain_cursor_ > cap) {
    uint64_t lost = head - drain_cursor_ - cap;
    spans_dropped.fetch_add(lost, std::memory_order_relaxed);
    drain_cursor_ = head - cap;
  }
  // Emit a clock record when the estimate moved since the last emit.
  int64_t unc = clock_uncertainty_ns_.load(std::memory_order_relaxed);
  if (unc >= 0) {
    int64_t off = clock_offset_ns_.load(std::memory_order_relaxed);
    if (off != last_clock_emitted_) {
      char buf[160];
      std::snprintf(buf, sizeof(buf),
                    "{\"clock\":{\"offset_ns\":%" PRId64
                    ",\"uncertainty_ns\":%" PRId64 ",\"at_ns\":%" PRId64
                    "}}\n",
                    off, unc, NowNs());
      std::fputs(buf, shard_file_);
      last_clock_emitted_ = off;
    }
  }
  std::string line;
  while (drain_cursor_ < head) {
    TraceSpan span;
    if (!ReadSlot(drain_cursor_, &span)) {
      // Unpublished (writer mid-flight) or overwritten by a racing
      // wrap. A racing wrap means the head moved past cursor + cap —
      // the next drain's overrun accounting picks the loss up; a
      // mid-flight writer means everything after it is younger, so
      // stop either way and retry next wake.
      break;
    }
    line.clear();
    AppendSpanJson(&line, span);
    line += '\n';
    std::fputs(line.c_str(), shard_file_);
    ++drain_cursor_;
  }
  std::fflush(shard_file_);
}

void Trace::DrainerLoop() {
  while (!drainer_stop_.load(std::memory_order_relaxed)) {
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    std::lock_guard<std::mutex> lock(shard_mutex_);
    DrainLocked();
  }
}

void Trace::FlushShard() {
  std::lock_guard<std::mutex> lock(shard_mutex_);
  DrainLocked();
}

void Trace::Shutdown() {
  std::thread t;
  {
    std::lock_guard<std::mutex> lock(shard_mutex_);
    if (drainer_running_) {
      drainer_stop_.store(true, std::memory_order_relaxed);
      t = std::move(drainer_thread_);
      drainer_running_ = false;
    }
  }
  if (t.joinable()) t.join();
  std::lock_guard<std::mutex> lock(shard_mutex_);
  DrainLocked();
  if (shard_file_ != nullptr) {
    std::fclose(shard_file_);
    shard_file_ = nullptr;
  }
}

std::vector<TraceSpan> Trace::SnapshotSpans() const {
  std::vector<TraceSpan> out;
  if (!ring_) return out;
  uint64_t cap = ring_mask_ + 1;
  uint64_t head = head_.load(std::memory_order_acquire);
  uint64_t start = head > cap ? head - cap : 0;
  out.reserve(static_cast<size_t>(head - start));
  for (uint64_t i = start; i < head; ++i) {
    TraceSpan span;
    if (ReadSlot(i, &span)) out.push_back(span);
  }
  return out;
}

std::string Trace::DumpBundle(const char* reason,
                              const std::string& pending_json) {
  if (bundles_written.load(std::memory_order_relaxed) >=
      static_cast<uint64_t>(kMaxBundles)) {
    return "";
  }
  std::lock_guard<std::mutex> lock(bundle_mutex_);
  if (bundle_dir_.empty()) return "";
  ::mkdir(bundle_dir_.c_str(), 0777);  // best-effort; may pre-exist

  std::string safe_reason;
  for (const char* p = reason ? reason : "unknown"; *p; ++p) {
    char c = *p;
    safe_reason += (std::isalnum(static_cast<unsigned char>(c)) || c == '_' ||
                    c == '-')
                       ? c
                       : '_';
  }
  uint64_t n = bundles_written.fetch_add(1, std::memory_order_relaxed);
  std::string path = bundle_dir_ + "/hvd_bundle_rank" +
                     std::to_string(rank_.load(std::memory_order_relaxed)) +
                     "_" + safe_reason + "_" + std::to_string(n) + "_" +
                     std::to_string(static_cast<int>(::getpid())) + ".json";

  std::string out;
  out.reserve(1 << 16);
  char buf[256];
  std::snprintf(buf, sizeof(buf),
                "{\"hvd_bundle\":1,\"reason\":\"%s\",\"rank\":%d,"
                "\"world_size\":%d,\"generation\":%" PRId64
                ",\"pid\":%d,\"now_ns\":%" PRId64 ",",
                safe_reason.c_str(), rank_.load(std::memory_order_relaxed),
                world_size_.load(std::memory_order_relaxed),
                generation_.load(std::memory_order_relaxed),
                static_cast<int>(::getpid()), NowNs());
  out += buf;
  std::snprintf(buf, sizeof(buf),
                "\"clock\":{\"offset_ns\":%" PRId64
                ",\"uncertainty_ns\":%" PRId64 "},",
                clock_offset_ns_.load(std::memory_order_relaxed),
                clock_uncertainty_ns_.load(std::memory_order_relaxed));
  out += buf;
  std::snprintf(buf, sizeof(buf),
                "\"counters\":{\"trace_spans_total\":%" PRIu64
                ",\"trace_spans_dropped_total\":%" PRIu64
                ",\"bundles_written_total\":%" PRIu64 "},",
                spans_total.load(std::memory_order_relaxed),
                spans_dropped.load(std::memory_order_relaxed),
                bundles_written.load(std::memory_order_relaxed));
  out += buf;

  out += "\"pending\":";
  out += pending_json.empty() ? "null" : pending_json;
  out += ',';

  out += "\"control_frames\":[";
  {
    std::lock_guard<std::mutex> flock(frame_mutex_);
    bool first = true;
    for (const FrameNote& f : control_frames_) {
      if (!first) out += ',';
      first = false;
      char tag[5];
      for (int i = 0; i < 4; ++i) {
        char c = static_cast<char>((f.tag >> (8 * i)) & 0xff);
        tag[i] = (c >= 0x20 && c < 0x7f) ? c : '.';
      }
      tag[4] = '\0';
      std::snprintf(buf, sizeof(buf),
                    "{\"t\":%" PRId64
                    ",\"tag\":\"%s\",\"dir\":\"%s\",\"bytes\":%" PRIu64 "}",
                    f.t_ns, tag, f.send ? "send" : "recv", f.bytes);
      out += buf;
    }
  }
  out += "],";

  out += "\"open_spans\":[";
  {
    std::lock_guard<std::mutex> olock(open_mutex_);
    bool first = true;
    for (const auto& kv : open_spans_) {
      if (!first) out += ',';
      first = false;
      out += "{\"key\":\"";
      AppendEscaped(&out, kv.first.c_str());
      std::snprintf(buf, sizeof(buf), "\",\"since_ns\":%" PRId64 "}",
                    kv.second);
      out += buf;
    }
  }
  out += "],";

  out += "\"metrics\":";
  out += GlobalMetrics().SnapshotJson();
  out += ',';

  out += "\"spans\":[";
  {
    std::vector<TraceSpan> spans = SnapshotSpans();
    bool first = true;
    for (const TraceSpan& s : spans) {
      if (!first) out += ',';
      first = false;
      AppendSpanJson(&out, s);
    }
  }
  out += "]}\n";

  std::FILE* f = std::fopen(path.c_str(), "w");
  if (f == nullptr) return "";
  std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  FlushShard();
  return path;
}

Trace& GlobalTrace() {
  static Trace* trace = new Trace();
  return *trace;
}

}  // namespace hvdtpu
