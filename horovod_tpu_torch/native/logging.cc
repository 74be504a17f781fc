#include "logging.h"

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>

namespace hvdtpu {

static std::atomic<int> g_log_rank{-1};

void SetLogRank(int rank) { g_log_rank.store(rank); }

static LogLevel ParseLevel(const char* s) {
  if (s == nullptr) return LogLevel::WARNING;
  std::string v(s);
  for (auto& c : v) c = static_cast<char>(tolower(c));
  if (v == "trace" || v == "0") return LogLevel::TRACE;
  if (v == "debug" || v == "1") return LogLevel::DEBUG;
  if (v == "info" || v == "2") return LogLevel::INFO;
  if (v == "warning" || v == "warn" || v == "3") return LogLevel::WARNING;
  if (v == "error" || v == "4") return LogLevel::ERROR;
  if (v == "fatal" || v == "5") return LogLevel::FATAL;
  return LogLevel::WARNING;
}

LogLevel MinLogLevelFromEnv() {
  static LogLevel cached = ParseLevel(std::getenv("HVD_TPU_LOG_LEVEL"));
  return cached;
}

static bool HideTime() {
  static bool cached = [] {
    const char* v = std::getenv("HVD_TPU_LOG_HIDE_TIME");
    return v != nullptr && std::strtol(v, nullptr, 10) != 0;
  }();
  return cached;
}

static const char* LevelName(LogLevel level) {
  switch (level) {
    case LogLevel::TRACE: return "TRACE";
    case LogLevel::DEBUG: return "DEBUG";
    case LogLevel::INFO: return "INFO";
    case LogLevel::WARNING: return "WARNING";
    case LogLevel::ERROR: return "ERROR";
    case LogLevel::FATAL: return "FATAL";
  }
  return "?";
}

LogMessage::LogMessage(const char* file, int line, LogLevel level)
    : file_(file), line_(line), level_(level) {}

LogMessage::~LogMessage() {
  if (level_ < MinLogLevelFromEnv()) return;
  std::ostringstream prefix;
  if (!HideTime()) {
    auto now = std::chrono::system_clock::now();
    auto us = std::chrono::duration_cast<std::chrono::microseconds>(
                  now.time_since_epoch())
                  .count();
    std::time_t secs = static_cast<std::time_t>(us / 1000000);
    struct tm tmv;
    localtime_r(&secs, &tmv);
    char buf[32];
    std::strftime(buf, sizeof(buf), "%H:%M:%S", &tmv);
    prefix << "[" << buf << "." << (us % 1000000) / 1000 << "]";
  }
  int rank = g_log_rank.load();
  if (rank >= 0) prefix << "[" << rank << "]";
  std::fprintf(stderr, "%s[%s] %s:%d: %s\n", prefix.str().c_str(),
               LevelName(level_), file_, line_, str().c_str());
}

LogMessageFatal::LogMessageFatal(const char* file, int line)
    : LogMessage(file, line, LogLevel::FATAL) {}

LogMessageFatal::~LogMessageFatal() {
  std::fprintf(stderr, "[FATAL] %s\n", str().c_str());
  std::abort();
}

}  // namespace hvdtpu
