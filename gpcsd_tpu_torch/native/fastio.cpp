// Fast LFP data loading: parallel whitespace-delimited text parsing.
//
// The PyTorch port's own copy of the JAX package's native parser (same C
// ABI, same parser).  The auditory workload loads 48 electrode files of
// ~600x400 doubles each (reference ``auditory_lfp/fit_gpcsd_baseline.py:59-62``
// via np.loadtxt, which is ~20x slower than a tight strtod loop): mmap +
// manual parsing, one thread per file.  Host code; it runs on no device.
//
// C ABI (ctypes-friendly):
//   fastio_count(path, *rows, *cols) -> 0 on success
//   fastio_load(path, out, rows, cols) -> number of values parsed
//   fastio_load_many(paths, n_files, out, rows, cols, n_threads)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
}

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Exact powers of ten representable as doubles (for correctly-rounded
// integer fast-path conversion).
const double kPow10[23] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                           1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                           1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Fast decimal parser: handles the overwhelmingly common case — up to 15
// significant digits, |decimal exponent| <= 22 — with one uint64 multiply
// and one exact double multiply/divide (both correctly rounded, so the
// result is bit-identical to strtod).  Everything else (long mantissas,
// inf/nan, hex) falls back to strtod.  Returns the advanced pointer, or
// nullptr if no number was consumed.
inline const char* parse_double_fast(const char* p, const char* end,
                                     double* out) {
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    ++p;
  }
  uint64_t mant = 0;
  int digits = 0;     // significant digits accumulated
  int int_extra = 0;  // integer digits dropped past the accumulator
  int frac = 0;       // fraction digits accumulated
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    any = true;
    if (digits < 19) {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      ++digits;
    } else {
      ++int_extra;
    }
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      any = true;
      if (digits < 19) {
        mant = mant * 10 + static_cast<uint64_t>(*p - '0');
        ++digits;
        ++frac;
      }
      // dropped fraction digits are below the 19-digit accumulator: they
      // only matter in the >15-digit case, which falls back anyway
      ++p;
    }
  }
  if (!any) return nullptr;  // inf/nan/garbage -> strtod
  long ex = 0;
  bool ex_neg = false;
  if (p < end && (*p == 'e' || *p == 'E')) {
    const char* ep = p + 1;
    if (ep < end && (*ep == '+' || *ep == '-')) {
      ex_neg = (*ep == '-');
      ++ep;
    }
    if (ep < end && *ep >= '0' && *ep <= '9') {
      while (ep < end && *ep >= '0' && *ep <= '9') {
        if (ex < 10000) ex = ex * 10 + (*ep - '0');
        ++ep;
      }
      p = ep;
    }
  }
  long total_exp = (ex_neg ? -ex : ex) + int_extra - frac;
  if (digits <= 15 && total_exp >= -22 && total_exp <= 22) {
    double v = static_cast<double>(mant);  // exact: mant < 10^16 < 2^53
    v = total_exp >= 0 ? v * kPow10[total_exp] : v / kPow10[-total_exp];
    *out = neg ? -v : v;
    return p;
  }
  // hard case: defer to strtod for guaranteed correct rounding
  char* next = nullptr;
  double v = strtod(start, &next);
  if (next == start) return nullptr;
  *out = v;
  return next;
}

}  // namespace

extern "C" {

// Count rows (newline-terminated non-empty lines) and columns (fields in
// the first non-empty line).  Returns 0 on success.
int fastio_count(const char* path, int64_t* rows, int64_t* cols) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t r = 0, c = 0;
  bool counted_cols = false;
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    if (p < end && *p == '\n') {
      ++p;
      continue;
    }
    if (p >= end) break;
    // non-empty line
    ++r;
    int64_t fields = 0;
    while (p < end && *p != '\n') {
      while (p < end && is_space(*p)) ++p;
      if (p >= end || *p == '\n') break;
      ++fields;
      while (p < end && !is_space(*p) && *p != '\n') ++p;
    }
    if (!counted_cols) {
      c = fields;
      counted_cols = true;
    }
    if (p < end) ++p;  // skip newline
  }
  unmap(m);
  *rows = r;
  *cols = c;
  return 0;
}

// Parse up to rows*cols doubles (row-major) into out.  Returns the number
// of values parsed, or -1 on IO error.
int64_t fastio_load(const char* path, double* out, int64_t rows, int64_t cols) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  const int64_t want = rows * cols;
  int64_t got = 0;
  while (p < end && got < want) {
    while (p < end && (is_space(*p) || *p == '\n')) ++p;
    if (p >= end) break;
    double v;
    const char* next = parse_double_fast(p, end, &v);
    if (next == nullptr) {
      // token strtod couldn't start on either (e.g. stray text): try strtod
      // once (handles inf/nan), else skip the byte
      char* snext = nullptr;
      v = strtod(p, &snext);
      if (snext == p) {
        ++p;
        continue;
      }
      next = snext;
    }
    out[got++] = v;
    p = next;
  }
  unmap(m);
  return got;
}

// Load n_files files of identical (rows, cols) shape into a contiguous
// (n_files, rows, cols) buffer, one thread per file (capped).  Returns the
// number of files fully parsed.
int64_t fastio_load_many(const char** paths, int64_t n_files, double* out,
                         int64_t rows, int64_t cols, int64_t n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  std::vector<int64_t> results(n_files, 0);
  std::vector<std::thread> workers;
  std::int64_t stride = rows * cols;
  int64_t per = (n_files + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min(n_files, lo + per);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi]() {
      for (int64_t i = lo; i < hi; ++i) {
        results[i] = fastio_load(paths[i], out + i * stride, rows, cols);
      }
    });
  }
  for (auto& w : workers) w.join();
  int64_t ok = 0;
  for (int64_t i = 0; i < n_files; ++i) {
    if (results[i] == stride) ++ok;
  }
  return ok;
}

}  // extern "C"
