#include "fault.h"

#include <cstdlib>
#include <cstring>

#include "logging.h"
#include "metrics.h"

namespace hvdtpu {

const char* FaultActionName(FaultAction a) {
  switch (a) {
    case FaultAction::NONE: return "none";
    case FaultAction::DROP: return "drop";
    case FaultAction::DELAY: return "delay";
    case FaultAction::CORRUPT: return "corrupt";
    case FaultAction::CLOSE: return "close";
    case FaultAction::STALL: return "stall";
  }
  return "?";
}

namespace {

bool ParseChan(const std::string& v, int* out) {
  if (v == "any") { *out = -1; return true; }
  if (v == "control") { *out = static_cast<int>(Channel::CONTROL); return true; }
  if (v == "ring") { *out = static_cast<int>(Channel::RING); return true; }
  if (v == "local") { *out = static_cast<int>(Channel::LOCAL_RING); return true; }
  if (v == "cross") { *out = static_cast<int>(Channel::CROSS_RING); return true; }
  if (v == "shm") { *out = static_cast<int>(Channel::SHM); return true; }
  return false;
}

bool ParseAction(const std::string& v, FaultAction* out) {
  if (v == "drop") { *out = FaultAction::DROP; return true; }
  if (v == "delay") { *out = FaultAction::DELAY; return true; }
  if (v == "corrupt") { *out = FaultAction::CORRUPT; return true; }
  if (v == "close") { *out = FaultAction::CLOSE; return true; }
  if (v == "stall") { *out = FaultAction::STALL; return true; }
  return false;
}

}  // namespace

void FaultInjector::Configure(const char* spec, int rank) {
  std::lock_guard<std::mutex> lk(mutex_);
  rules_.clear();
  rank_ = rank;
  uint64_t seed = 0;
  bool ok = true;
  if (spec != nullptr && spec[0] != '\0') {
    for (const std::string& clause : SplitString(spec, ';')) {
      if (clause.empty()) continue;
      if (clause.compare(0, 5, "seed=") == 0) {
        seed = std::strtoull(clause.c_str() + 5, nullptr, 10);
        continue;
      }
      Rule rule;
      for (const std::string& field : SplitString(clause, ',')) {
        auto eq = field.find('=');
        if (eq == std::string::npos) { ok = false; break; }
        std::string key = field.substr(0, eq);
        std::string val = field.substr(eq + 1);
        if (key == "rank") {
          rule.rank = std::atoi(val.c_str());
        } else if (key == "chan") {
          ok = ParseChan(val, &rule.chan) && ok;
        } else if (key == "dir") {
          if (val == "any") rule.dir = -1;
          else if (val == "send") rule.dir = 0;
          else if (val == "recv") rule.dir = 1;
          else ok = false;
        } else if (key == "frame") {
          rule.frame = std::strtoll(val.c_str(), nullptr, 10);
        } else if (key == "prob") {
          rule.prob = std::strtod(val.c_str(), nullptr);
        } else if (key == "count") {
          rule.count = std::strtoll(val.c_str(), nullptr, 10);
        } else if (key == "delay_ms") {
          rule.delay_ms = std::atoi(val.c_str());
        } else if (key == "action") {
          ok = ParseAction(val, &rule.action) && ok;
        } else {
          ok = false;
        }
      }
      if (rule.action == FaultAction::NONE) ok = false;
      if (rule.count < 0 && rule.frame >= 0) rule.count = 1;
      if (rule.delay_ms == 0 && rule.action == FaultAction::STALL) {
        rule.delay_ms = 600000;  // effectively a hang; deadlines must fire
      }
      if (rule.delay_ms == 0 && rule.action == FaultAction::DELAY) {
        rule.delay_ms = 100;
      }
      if (ok) rules_.push_back(rule);
    }
    if (!ok) {
      LOG(ERROR) << "HVD_TPU_FAULT_SPEC parse error in \"" << spec
                 << "\" — fault injection disabled (see docs/CHAOS.md "
                 << "for the grammar)";
      rules_.clear();
    } else if (!rules_.empty()) {
      LOG(WARNING) << "fault injection ACTIVE (rank " << rank << ", seed "
                   << seed << ", " << rules_.size() << " rule(s)): \""
                   << spec << "\"";
    }
  }
  rng_.seed(seed ^ (0x9E3779B97F4A7C15ull * static_cast<uint64_t>(rank + 1)));
  fires_.store(0, std::memory_order_relaxed);
  active_.store(!rules_.empty(), std::memory_order_relaxed);
}

FaultDecision FaultInjector::OnFrame(Channel chan, bool send, bool shm) {
  FaultDecision d;
  if (!active()) return d;
  std::lock_guard<std::mutex> lk(mutex_);
  for (auto& rule : rules_) {
    if (rule.rank >= 0 && rule.rank != rank_) continue;
    // chan=shm filters by TRANSPORT (a data-plane leg riding a shared-
    // memory ring, whatever its logical channel); chan=ring/local/cross
    // keep matching by LOGICAL channel regardless of transport, so
    // pre-shm specs and their frame counters are unchanged when the
    // shm plane engages (docs/CHAOS.md).
    if (rule.chan == static_cast<int>(Channel::SHM)) {
      if (!shm) continue;
    } else if (rule.chan >= 0 && rule.chan != static_cast<int>(chan)) {
      continue;
    }
    if (rule.dir >= 0 && rule.dir != (send ? 0 : 1)) continue;
    int64_t idx = rule.seen++;
    if (rule.count == 0) continue;  // exhausted
    bool fire = false;
    if (rule.frame >= 0) {
      fire = idx == rule.frame;
    } else if (rule.prob > 0.0) {
      fire = std::uniform_real_distribution<double>(0.0, 1.0)(rng_) <
             rule.prob;
    }
    if (!fire) continue;
    if (rule.count > 0) --rule.count;
    d.action = rule.action;
    d.delay_ms = rule.delay_ms;
    fires_.fetch_add(1, std::memory_order_relaxed);
    Metrics& m = GlobalMetrics();
    m.faults_injected_total.fetch_add(1, std::memory_order_relaxed);
    switch (rule.action) {
      case FaultAction::DROP:
        m.fault_drop_total.fetch_add(1, std::memory_order_relaxed); break;
      case FaultAction::DELAY:
        m.fault_delay_total.fetch_add(1, std::memory_order_relaxed); break;
      case FaultAction::CORRUPT:
        m.fault_corrupt_total.fetch_add(1, std::memory_order_relaxed); break;
      case FaultAction::CLOSE:
        m.fault_close_total.fetch_add(1, std::memory_order_relaxed); break;
      case FaultAction::STALL:
        m.fault_stall_total.fetch_add(1, std::memory_order_relaxed); break;
      case FaultAction::NONE: break;
    }
    LOG(WARNING) << "fault injected: " << FaultActionName(rule.action)
                 << " on " << (send ? "send" : "recv") << " frame " << idx
                 << " chan " << static_cast<int>(chan) << " (rank " << rank_
                 << ")";
    return d;  // first matching rule that fires wins
  }
  return d;
}

FaultInjector& GlobalFaultInjector() {
  static FaultInjector* injector = new FaultInjector();  // leaked: outlives threads
  return *injector;
}

}  // namespace hvdtpu
