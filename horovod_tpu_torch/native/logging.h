// Leveled logging with optional rank prefix, configured from env.
// TPU-native equivalent of the reference logger (see /root/reference
// horovod/common/logging.{h,cc}) — same capability, fresh implementation.
//
// Env: HVD_TPU_LOG_LEVEL = trace|debug|info|warning|error|fatal (default warning)
//      HVD_TPU_LOG_HIDE_TIME = 1 to suppress timestamps.
#ifndef HVD_TPU_LOGGING_H
#define HVD_TPU_LOGGING_H

#include <sstream>
#include <string>

namespace hvdtpu {

enum class LogLevel : int {
  TRACE = 0,
  DEBUG = 1,
  INFO = 2,
  WARNING = 3,
  ERROR = 4,
  FATAL = 5,
};

LogLevel MinLogLevelFromEnv();
void SetLogRank(int rank);

class LogMessage : public std::basic_ostringstream<char> {
 public:
  LogMessage(const char* file, int line, LogLevel level);
  ~LogMessage();

 private:
  const char* file_;
  int line_;
  LogLevel level_;
};

class LogMessageFatal : public LogMessage {
 public:
  LogMessageFatal(const char* file, int line);
  ~LogMessageFatal();
};

#define HVD_LOG_TRACE \
  ::hvdtpu::LogMessage(__FILE__, __LINE__, ::hvdtpu::LogLevel::TRACE)
#define HVD_LOG_DEBUG \
  ::hvdtpu::LogMessage(__FILE__, __LINE__, ::hvdtpu::LogLevel::DEBUG)
#define HVD_LOG_INFO \
  ::hvdtpu::LogMessage(__FILE__, __LINE__, ::hvdtpu::LogLevel::INFO)
#define HVD_LOG_WARNING \
  ::hvdtpu::LogMessage(__FILE__, __LINE__, ::hvdtpu::LogLevel::WARNING)
#define HVD_LOG_ERROR \
  ::hvdtpu::LogMessage(__FILE__, __LINE__, ::hvdtpu::LogLevel::ERROR)
#define HVD_LOG_FATAL ::hvdtpu::LogMessageFatal(__FILE__, __LINE__)

#define LOG(level) HVD_LOG_##level

#define SHOULD_LOG(level) \
  (::hvdtpu::LogLevel::level >= ::hvdtpu::MinLogLevelFromEnv())

}  // namespace hvdtpu

#endif  // HVD_TPU_LOGGING_H
