// ekio: the native I/O fast paths of the port (a copy of native/ekio.cpp,
// the JAX package's, with two changes: the formatting threads leave one
// core to the caller's process, and a row may be as long as its values
// make it).
//
// The reference solver's I/O layer is C stdio in CUDA host code
// (save_data_tecplot LBM.cu:2492-2565, save_data_end/read_data
// LBM.cu:2567-2671).  ASCII formatting and parsing of multi-million-row
// field tables is the only I/O hot path.  std::to_chars (locale-free,
// printf-compatible with explicit precision) is ~5-10x faster than glibc
// snprintf; rows are formatted thread-parallel.  Built by g++ at first use
// and loaded through ctypes by ekpnp_torch/io/native.py, which releases the
// interpreter lock for the call, so the run loop's launching thread keeps
// going while its writer thread formats a dump.

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

// one core stays with the process that called: its main thread launches
// the next chunk on the card while a writer thread formats through here
int n_workers(int64_t work, int64_t work_per_worker) {
  int hw = (int)std::thread::hardware_concurrency() - 1;
  if (hw < 1) hw = 1;
  int64_t want = (work + work_per_worker - 1) / work_per_worker;
  if (want < 1) want = 1;
  return (int)(want < hw ? want : hw);
}

// printf "%g": general format, 6 significant digits.
inline char* put_g(char* p, double v) {
  auto r = std::to_chars(p, p + 32, v, std::chars_format::general, 6);
  return r.ptr;
}

// The longest "%10.6f" of a double: sign, 309 digits, point, 6 decimals.
constexpr int kMaxF = 320;

// printf "%10.6f": fixed 6 decimals, right-aligned to width 10.
inline char* put_f10(char* p, double v) {
  char tmp[kMaxF];
  auto r = std::to_chars(tmp, tmp + kMaxF, v, std::chars_format::fixed, 6);
  int len = (int)(r.ptr - tmp);
  for (int k = len; k < 10; ++k) *p++ = ' ';
  memcpy(p, tmp, (size_t)len);
  return p + len;
}

// Parallel scatter-format rows [0,n) with `row_fn(cols, i, p) -> p'`,
// then gather into one malloc'd buffer returned to the caller.  Each row
// is formatted into a scratch line of `max_row` bytes (the longest row the
// formats can give) and appended to its thread's chunk, which grows past
// the `bytes_per_row` estimate where it must (the JAX package's copy
// writes into the estimate and overruns it on wide "%10.6f" values).
template <typename RowFn>
char* parallel_format(const double* const* cols, int64_t n,
                      int64_t bytes_per_row, int64_t max_row, RowFn row_fn,
                      int64_t* out_len) {
  int nw = n_workers(n, 1 << 15);
  std::vector<std::vector<char>> chunks((size_t)nw);
  std::vector<std::thread> threads;
  int64_t per = (n + nw - 1) / nw;
  for (int t = 0; t < nw; ++t) {
    threads.emplace_back([&, t]() {
      int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
      if (lo >= hi) return;
      auto& c = chunks[(size_t)t];
      c.reserve((size_t)((hi - lo) * bytes_per_row));
      std::unique_ptr<char[]> line(new char[(size_t)max_row + 1]);
      for (int64_t i = lo; i < hi; ++i) {
        char* p = row_fn(cols, i, line.get());
        *p++ = '\n';
        c.insert(c.end(), line.get(), p);
      }
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (auto& c : chunks) total += (int64_t)c.size();
  char* out = (char*)malloc((size_t)total + 1);
  if (!out) return nullptr;
  int64_t off = 0;
  for (auto& c : chunks) {
    if (!c.empty()) memcpy(out + off, c.data(), c.size());
    off += (int64_t)c.size();
  }
  out[off] = '\0';
  *out_len = off;
  return out;
}

}  // namespace

extern "C" {

void ekio_free(char* p) { free(p); }

// cols: 14 column pointers, each (n,) float64.  Reference tecplot row
// format: 8 "%g" columns then 6 "%10.6f" columns (LBM.cu:2555-2562).
// Returns a malloc'd buffer (caller frees via ekio_free), length in
// *out_len; nullptr on allocation failure.
char* ekio_format_tecplot(const double* const* cols, int64_t n,
                          int64_t* out_len) {
  return parallel_format(
      cols, n, /*bytes_per_row=*/8 * 26 + 6 * 32 + 16,
      /*max_row=*/8 * 33 + 6 * (kMaxF + 1),
      [](const double* const* c, int64_t i, char* p) {
        for (int k = 0; k < 8; ++k) {
          p = put_g(p, c[k][i]);
          *p++ = ' ';
        }
        for (int k = 8; k < 14; ++k) {
          p = put_f10(p, c[k][i]);
          if (k < 13) *p++ = ' ';
        }
        return p;
      },
      out_len);
}

// cols: ncols column pointers.  All-"%10.6f" rows, space-separated — the
// reference data_end.dat layout (LBM.cu:2613-2624).
char* ekio_format_table(const double* const* cols, int64_t n, int64_t ncols,
                        int64_t* out_len) {
  return parallel_format(
      cols, n, /*bytes_per_row=*/32 * ncols + 8,
      /*max_row=*/(kMaxF + 1) * ncols,
      [ncols](const double* const* c, int64_t i, char* p) {
        for (int64_t k = 0; k < ncols; ++k) {
          if (k) *p++ = ' ';
          p = put_f10(p, c[k][i]);
        }
        return p;
      },
      out_len);
}

// Parse whitespace-separated floats from NUL-terminated text[0:len) into
// out[0:max_vals).  Returns the number of values parsed.  Parallel: the
// text is split at line boundaries, so each chunk parses whole lines.
int64_t ekio_parse_floats(const char* text, int64_t len, double* out,
                          int64_t max_vals) {
  int nw = n_workers(len, 1 << 20);
  std::vector<int64_t> starts((size_t)nw + 1, len);
  starts[0] = 0;
  for (int t = 1; t < nw; ++t) {
    int64_t p = len * t / nw;
    while (p < len && text[p] != '\n') ++p;
    starts[(size_t)t] = p < len ? p + 1 : len;
  }
  std::vector<std::vector<double>> vals((size_t)nw);
  std::vector<std::thread> threads;
  for (int t = 0; t < nw; ++t) {
    threads.emplace_back([&, t]() {
      const char* p = text + starts[(size_t)t];
      const char* end = text + starts[(size_t)t + 1];
      auto& v = vals[(size_t)t];
      v.reserve((size_t)((starts[(size_t)t + 1] - starts[(size_t)t]) / 8));
      while (p < end) {
        if (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r') {
          ++p;
          continue;
        }
        double x;
        auto r = std::from_chars(p, end, x);
        if (r.ec != std::errc()) {
          ++p;
          continue;
        }
        v.push_back(x);
        p = r.ptr;
      }
    });
  }
  for (auto& th : threads) th.join();
  int64_t k = 0;
  for (auto& v : vals) {
    int64_t take = std::min<int64_t>((int64_t)v.size(), max_vals - k);
    if (take > 0) {
      memcpy(out + k, v.data(), (size_t)take * sizeof(double));
      k += take;
    }
  }
  return k;
}

}  // extern "C"
