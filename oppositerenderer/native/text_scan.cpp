// Fast whitespace-separated numeric token scanner for scene file payloads.
//
// The reference imports flagship scenes through Assimp's native parser
// (RenderEngine/scene/Scene.cpp:73-175) in seconds; our dependency-free
// Python Collada loader spends most of a flagship load in str.split +
// float() over <float_array>/<p> payloads. This scanner parses the same
// payloads at memory speed.
//
// Grammar per token: [+-]?digits[.digits][(e|E)[+-]digits] — the Collada
// <float_array>/<p> number format. Tokens are separated by any run of
// bytes that cannot start a number; a malformed token aborts the scan by
// returning -(byte offset)-1 so the caller can fall back to the exact
// Python parser instead of silently mis-reading.
#include <cstdint>
#include <cmath>

namespace {
inline bool is_sep(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\f' ||
         c == '\v' || c == ',';
}
}  // namespace

extern "C" {

// Parses up to `cap` floats from text[0..n) into out. Returns the number
// of floats written, or -(offset)-1 on a malformed token at `offset`.
int64_t scan_floats(const char* text, int64_t n, float* out, int64_t cap) {
  int64_t i = 0, k = 0;
  while (i < n) {
    while (i < n && is_sep(text[i])) ++i;
    if (i >= n) break;
    if (k >= cap) return -i - 1;  // caller under-allocated; fall back
    const int64_t tok = i;
    bool neg = false;
    if (text[i] == '+' || text[i] == '-') { neg = (text[i] == '-'); ++i; }
    double mant = 0.0;
    int digits = 0;
    while (i < n && text[i] >= '0' && text[i] <= '9') {
      mant = mant * 10.0 + (text[i] - '0');
      ++digits; ++i;
    }
    int frac = 0;
    if (i < n && text[i] == '.') {
      ++i;
      while (i < n && text[i] >= '0' && text[i] <= '9') {
        mant = mant * 10.0 + (text[i] - '0');
        ++frac; ++digits; ++i;
      }
    }
    if (digits == 0) {
      // Accept Collada's occasional NaN/INF spellings.
      auto match = [&](const char* w, int len) {
        if (i + len > n) return false;
        for (int j = 0; j < len; ++j) {
          char c = text[i + j], u = w[j];
          if (c != u && c != (u - 'A' + 'a')) return false;
        }
        i += len;
        return true;
      };
      if (match("NAN", 3)) { out[k++] = NAN; goto endtok; }
      if (match("INF", 3)) {
        out[k++] = neg ? -INFINITY : INFINITY;
        goto endtok;
      }
      return -tok - 1;
    }
    {
      int e = 0;
      if (i < n && (text[i] == 'e' || text[i] == 'E')) {
        ++i;
        bool eneg = false;
        if (i < n && (text[i] == '+' || text[i] == '-')) {
          eneg = (text[i] == '-'); ++i;
        }
        int edig = 0;
        while (i < n && text[i] >= '0' && text[i] <= '9') {
          e = e * 10 + (text[i] - '0');
          ++edig; ++i;
        }
        if (edig == 0) return -tok - 1;
        if (eneg) e = -e;
      }
      double v = mant * std::pow(10.0, e - frac);
      out[k++] = static_cast<float>(neg ? -v : v);
    }
  endtok:
    if (i < n && !is_sep(text[i])) return -tok - 1;
  }
  return k;
}

// Same contract for whitespace-separated integers (Collada <p>/<vcount>).
int64_t scan_ints(const char* text, int64_t n, int64_t* out, int64_t cap) {
  int64_t i = 0, k = 0;
  while (i < n) {
    while (i < n && is_sep(text[i])) ++i;
    if (i >= n) break;
    if (k >= cap) return -i - 1;
    const int64_t tok = i;
    bool neg = false;
    if (text[i] == '+' || text[i] == '-') { neg = (text[i] == '-'); ++i; }
    int64_t v = 0;
    int digits = 0;
    while (i < n && text[i] >= '0' && text[i] <= '9') {
      v = v * 10 + (text[i] - '0');
      ++digits; ++i;
    }
    if (digits == 0) return -tok - 1;
    if (i < n && !is_sep(text[i])) return -tok - 1;
    out[k++] = neg ? -v : v;
  }
  return k;
}

}  // extern "C"
