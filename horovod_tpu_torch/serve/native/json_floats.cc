// The serve plane's float arrays in JSON, in C so that a replica's HTTP
// threads format and parse them outside the interpreter's lock (ctypes
// releases it): about 70 % of a replica's CPU a request went to
// json.dumps and json.loads of the 2048-float rows, all of it under the
// lock its batch loop needs too.
//
// hvd_serve_format_floats writes a JSON array of doubles the way Python's
// json.dumps separates one ("[a, b, c]"), each number in 17 significant
// digits (it parses back to the same double) with ".0" added where the
// digits alone would read as an integer, and NaN, Infinity and -Infinity
// as json.dumps writes them. hvd_serve_parse_floats reads the inside of a
// JSON array of numbers, strictly by JSON's number grammar, with strtod
// (correctly rounded, as Python's float()); it refuses what Python's json
// would read differently or not at all (NaN and Infinity, integers of more
// than 15 digits, anything else), and the caller then parses with
// json.loads.

#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

bool IsDigit(char c) { return c >= '0' && c <= '9'; }

// Length of the JSON number at p (at most end), 0 when there is none;
// *integral is set when it has neither a fraction nor an exponent.
std::size_t NumberLength(const char* p, const char* end, bool* integral) {
  const char* q = p;
  if (q < end && *q == '-') ++q;
  if (q >= end || !IsDigit(*q)) return 0;
  if (*q == '0') {
    ++q;
  } else {
    while (q < end && IsDigit(*q)) ++q;
  }
  *integral = true;
  if (q < end && *q == '.') {
    ++q;
    if (q >= end || !IsDigit(*q)) return 0;
    while (q < end && IsDigit(*q)) ++q;
    *integral = false;
  }
  if (q < end && (*q == 'e' || *q == 'E')) {
    ++q;
    if (q < end && (*q == '+' || *q == '-')) ++q;
    if (q >= end || !IsDigit(*q)) return 0;
    while (q < end && IsDigit(*q)) ++q;
    *integral = false;
  }
  return static_cast<std::size_t>(q - p);
}

bool IsSpace(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

}  // namespace

extern "C" {

// Writes "[v0, v1, ...]" into out (cap bytes); returns the bytes written,
// or 0 when cap is too small (26 bytes a number always suffice).
std::size_t hvd_serve_format_floats(const double* v, std::size_t n, char* out,
                                    std::size_t cap) {
  std::size_t pos = 0;
  if (cap < 2) return 0;
  out[pos++] = '[';
  for (std::size_t i = 0; i < n; ++i) {
    if (cap - pos < 32) return 0;
    if (i > 0) {
      out[pos++] = ',';
      out[pos++] = ' ';
    }
    double x = v[i];
    if (std::isnan(x)) {
      std::memcpy(out + pos, "NaN", 3);
      pos += 3;
      continue;
    }
    if (std::isinf(x)) {
      const char* s = x > 0 ? "Infinity" : "-Infinity";
      std::size_t len = std::strlen(s);
      std::memcpy(out + pos, s, len);
      pos += len;
      continue;
    }
    int len = std::snprintf(out + pos, cap - pos, "%.17g", x);
    if (len <= 0 || static_cast<std::size_t>(len) >= cap - pos) return 0;
    bool integral = true;
    for (int k = 0; k < len; ++k) {
      char c = out[pos + k];
      if (c == '.' || c == 'e') integral = false;
    }
    pos += static_cast<std::size_t>(len);
    if (integral) {
      out[pos++] = '.';
      out[pos++] = '0';
    }
  }
  if (cap - pos < 1) return 0;
  out[pos++] = ']';
  return pos;
}

// Parses the numbers of s[0, len) (the inside of a JSON array: numbers
// separated by commas, whitespace around them) into out (cap doubles).
// Returns how many, or -1 when s is not such a list or holds more than
// cap numbers.
long hvd_serve_parse_floats(const char* s, std::size_t len, double* out,
                            std::size_t cap) {
  const char* p = s;
  const char* end = s + len;
  char buf[64];
  std::size_t n = 0;
  while (p < end && IsSpace(*p)) ++p;
  if (p == end) return 0;
  while (true) {
    bool integral = false;
    std::size_t m = NumberLength(p, end, &integral);
    if (m == 0 || m >= sizeof(buf) || n >= cap) return -1;
    std::size_t digits = m - (*p == '-' ? 1 : 0);
    if (integral && digits > 15) return -1;
    std::memcpy(buf, p, m);
    buf[m] = '\0';
    double value = std::strtod(buf, nullptr);
    // an integer is Python's int, whose zero has no sign ("-0" is 0)
    out[n++] = integral && value == 0.0 ? 0.0 : value;
    p += m;
    while (p < end && IsSpace(*p)) ++p;
    if (p == end) return static_cast<long>(n);
    if (*p != ',') return -1;
    ++p;
    while (p < end && IsSpace(*p)) ++p;
  }
}

}  // extern "C"
