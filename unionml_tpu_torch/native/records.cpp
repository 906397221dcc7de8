// Native feature-record parser: the serving path's host-side hot loop.
//
// A copy of unionml_tpu/native/records.cpp. Record assembly (json -> list-of-dicts
// -> pandas DataFrame per request) dominates a sub-millisecond predictor path. This
// shim parses a
// strict subset of JSON — an array of flat records whose values are numbers /
// true/false/null — straight into one contiguous float64 row-major matrix (float64 keeps the values
// bit-identical to what json.loads would produce, so predictions cannot differ
// between native-enabled and fallback deployments), skipping
// the dict-of-PyObjects intermediate entirely. Anything outside the subset returns
// an error and the caller falls back to the Python path, so semantics never change.
//
// C ABI (ctypes-friendly; no pybind11 in this image):
//   urt_parse_records(buf, len, &rows, &cols, &data, &names) -> 0 on success
//     data:  malloc'd float64[rows*cols], row-major, caller frees via urt_free
//     names: malloc'd '\n'-joined column names, caller frees via urt_free
//   urt_version() -> ABI version int
//
// Build: g++ -O3 -shared -fPIC (driven by unionml_tpu_torch/native/__init__.py).

#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  bool eat(char c) {
    skip_ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    return false;
  }
  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }
};

// Parse a JSON string (no unicode escapes — fallback on those: they never appear in
// numeric-feature column names produced by dataframes).
bool parse_key(Cursor& cur, std::string* out) {
  if (!cur.eat('"')) return false;
  out->clear();
  while (cur.p < cur.end) {
    char c = *cur.p++;
    if (c == '"') return true;
    if (c == '\\') return false;  // escaped keys -> fallback
    out->push_back(c);
  }
  return false;
}

// Scan exactly the JSON number grammar: -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?
// strtod alone is too permissive (hex floats, "Infinity", leading '+') and would
// accept payloads the Python json path rejects with 400.
const char* scan_json_number(const char* p, const char* end) {
  if (p < end && *p == '-') ++p;
  if (p >= end || *p < '0' || *p > '9') return nullptr;
  if (*p == '0') {
    ++p;
  } else {
    while (p < end && *p >= '0' && *p <= '9') ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    while (p < end && *p >= '0' && *p <= '9') ++p;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    if (p < end && (*p == '+' || *p == '-')) ++p;
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    while (p < end && *p >= '0' && *p <= '9') ++p;
  }
  return p;
}

bool parse_value(Cursor& cur, double* out) {
  cur.skip_ws();
  if (cur.p >= cur.end) return false;
  if (*cur.p == 't') {  // true
    if (cur.end - cur.p >= 4 && std::memcmp(cur.p, "true", 4) == 0) {
      cur.p += 4;
      *out = 1.0;
      return true;
    }
    return false;
  }
  if (*cur.p == 'f') {  // false
    if (cur.end - cur.p >= 5 && std::memcmp(cur.p, "false", 5) == 0) {
      cur.p += 5;
      *out = 0.0;
      return true;
    }
    return false;
  }
  if (*cur.p == 'n') {  // null -> NaN
    if (cur.end - cur.p >= 4 && std::memcmp(cur.p, "null", 4) == 0) {
      cur.p += 4;
      *out = std::nan("");
      return true;
    }
    return false;
  }
  const char* tok_end = scan_json_number(cur.p, cur.end);
  if (tok_end == nullptr) return false;
  std::string tok(cur.p, tok_end);  // NUL-terminated copy for strtod
  char* next = nullptr;
  double val = std::strtod(tok.c_str(), &next);
  if (next != tok.c_str() + tok.size()) return false;
  cur.p = tok_end;
  *out = val;
  return true;
}

}  // namespace

extern "C" {

int urt_version() { return 1; }

void urt_free(void* ptr) { std::free(ptr); }

// Returns 0 on success; any nonzero = unsupported input, use the Python fallback.
// out_consumed reports how many bytes of buf the array occupied (trailing
// whitespace included), letting callers parse a record array embedded at the head
// of a larger buffer (e.g. the serving envelope's "features" value).
int urt_parse_records(const char* buf, long len, long* out_rows, long* out_cols,
                      double** out_data, char** out_names, long* out_consumed) {
  Cursor cur{buf, buf + len};
  if (!cur.eat('[')) return 1;

  std::vector<std::string> columns;
  std::vector<double> data;
  long rows = 0;
  std::string key;

  if (cur.eat(']')) {  // empty record list
    cur.skip_ws();
    *out_rows = 0;
    *out_cols = 0;
    *out_data = nullptr;
    *out_names = static_cast<char*>(std::calloc(1, 1));
    *out_consumed = static_cast<long>(cur.p - buf);
    return *out_names ? 0 : 7;
  }

  do {
    if (!cur.eat('{')) return 2;
    size_t col = 0;
    if (!cur.peek('}')) {
      do {
        if (!parse_key(cur, &key)) return 3;
        if (!cur.eat(':')) return 3;
        double value;
        if (!parse_value(cur, &value)) return 4;
        if (rows == 0) {
          // duplicate keys within a record: json.loads does last-wins (one
          // column); decline rather than silently produce two columns
          for (const std::string& existing : columns) {
            if (existing == key) return 8;
          }
          columns.push_back(key);
        } else {
          // every record must repeat the first record's key order (the layout
          // DataFrame.to_dict("records") and well-formed clients produce)
          if (col >= columns.size() || columns[col] != key) return 5;
        }
        data.push_back(value);
        ++col;
      } while (cur.eat(','));
    }
    if (!cur.eat('}')) return 2;
    if (rows > 0 && col != columns.size()) return 5;
    ++rows;
  } while (cur.eat(','));
  if (!cur.eat(']')) return 6;
  cur.skip_ws();

  const long cols = static_cast<long>(columns.size());
  double* out = static_cast<double*>(std::malloc(sizeof(double) * data.size()));
  if (!out) return 7;
  std::memcpy(out, data.data(), sizeof(double) * data.size());

  std::string joined;
  for (size_t i = 0; i < columns.size(); ++i) {
    if (i) joined.push_back('\n');
    joined += columns[i];
  }
  char* names = static_cast<char*>(std::malloc(joined.size() + 1));
  if (!names) {
    std::free(out);
    return 7;
  }
  std::memcpy(names, joined.c_str(), joined.size() + 1);

  *out_rows = rows;
  *out_cols = cols;
  *out_data = out;
  *out_names = names;
  *out_consumed = static_cast<long>(cur.p - buf);
  return 0;
}

}  // extern "C"
