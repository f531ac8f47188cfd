// Native data-plane CSV loader.
//
// The reference's data plane is pandas re-reading CSVs from a shared volume
// for every subtask (reference worker.py:424-425, dataset_util.py:119-136).
// This framework parses once into a columnar cache; this library makes that
// one parse native: mmap the file, scan dimensions, then parse all numeric
// cells to float32 with a thread pool over row chunks. Non-numeric columns
// are detected and reported so the Python side can fall back to pandas
// label-encoding for those tables (small demo datasets); large benchmark
// tables (covertype, MNIST, synthetics) are fully numeric and take the
// native path end-to-end.
//
// C API (ctypes, see native/__init__.py):
//   csv_dims(path, *n_rows, *n_cols) -> 0 ok / <0 errno-style
//   csv_parse_f32(path, out, n_rows, n_cols, col_numeric_ok) -> rows parsed
//
// Contract: header row required (skipped); delimiter ','; rows beyond
// n_rows or cells beyond n_cols are ignored; empty trailing lines skipped;
// a cell that fails float parse writes NaN and clears its column's
// numeric_ok flag.

#include <cerrno>
#include <cmath>
#include <cstdint>
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
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (::fstat(m.fd, &st) != 0 || st.st_size == 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap(Mapped& m) {
  if (m.data) ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

// End of the header line (first '\n'), or size if single-line file.
size_t header_end(const Mapped& m) {
  const char* nl = static_cast<const char*>(memchr(m.data, '\n', m.size));
  return nl ? static_cast<size_t>(nl - m.data) + 1 : m.size;
}

size_t count_cols(const Mapped& m) {
  size_t end = header_end(m);
  size_t cols = 1;
  for (size_t i = 0; i < end; i++) {
    if (m.data[i] == ',') cols++;
  }
  return cols;
}

// Parse one data line into row-major out[row * n_cols .. ]. Flags columns
// whose cells fail float parse. file_end bounds the mapping: the very last
// cell of the file may end flush against it with no delimiter, and strtof
// on the raw pointer would read past the mapping (SIGSEGV when the file
// size is an exact page multiple) — that one case is parsed from a bounded
// local copy instead.
void parse_line(const char* p, const char* line_end, const char* file_end,
                float* out_row, int64_t n_cols, uint8_t* col_numeric_ok) {
  int64_t col = 0;
  while (col < n_cols && p <= line_end) {
    const char* cell_end =
        static_cast<const char*>(memchr(p, ',', line_end - p));
    if (!cell_end) cell_end = line_end;
    // strtof stops at the first invalid char, so parsing in place against
    // the ','/'\n' boundary is safe everywhere except flush at file_end.
    const char* s = p;
    while (s < cell_end && (*s == ' ' || *s == '\t')) s++;
    const char* e = cell_end;
    while (e > s && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) e--;
    if (s == e) {
      out_row[col] = NAN;  // empty cell: missing value, still "numeric"
    } else {
      char* parse_end = nullptr;
      float v;
      if (e == file_end) {
        char buf[64];
        size_t len = static_cast<size_t>(e - s);
        if (len >= sizeof(buf)) len = sizeof(buf) - 1;
        memcpy(buf, s, len);
        buf[len] = '\0';
        v = strtof(buf, &parse_end);
        parse_end = const_cast<char*>(s) + (parse_end - buf);
      } else {
        v = strtof(s, &parse_end);
      }
      if (parse_end == e) {
        out_row[col] = v;
      } else {
        out_row[col] = NAN;
        col_numeric_ok[col] = 0;
      }
    }
    col++;
    p = cell_end + 1;
  }
  // Ragged short row: fewer cells than the header promises. This is not a
  // missing value — it signals a header the naive comma count mis-parsed
  // (e.g. quoted names containing commas), so poison the phantom columns
  // to force the caller's pandas fallback.
  while (col < n_cols) {
    out_row[col] = NAN;
    col_numeric_ok[col] = 0;
    col++;
  }
}

}  // namespace

extern "C" {

// Fast dimension scan: n_rows = data lines (header excluded, blank lines
// ignored), n_cols from the header. Replaces the Python
// sum(1 for _ in open(path)) in collect_csv_metadata.
int csv_dims(const char* path, int64_t* n_rows, int64_t* n_cols) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  *n_cols = static_cast<int64_t>(count_cols(m));
  size_t start = header_end(m);
  // Parallel newline count over chunks.
  size_t body = m.size - start;
  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 1;
  if (body < (1u << 20)) n_threads = 1;
  std::vector<int64_t> counts(n_threads, 0);
  std::vector<std::thread> workers;
  size_t chunk = body / n_threads + 1;
  for (unsigned t = 0; t < n_threads; t++) {
    size_t lo = start + t * chunk;
    size_t hi = lo + chunk < m.size ? lo + chunk : m.size;
    if (lo >= hi) break;
    workers.emplace_back([&, t, lo, hi]() {
      const char* p = m.data + lo;
      const char* end = m.data + hi;
      int64_t c = 0;
      while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!nl) break;
        c++;
        p = nl + 1;
      }
      counts[t] = c;
    });
  }
  for (auto& w : workers) w.join();
  int64_t rows = 0;
  for (int64_t c : counts) rows += c;
  // A final line without trailing newline is still a row.
  if (m.size > start && m.data[m.size - 1] != '\n') rows++;
  *n_rows = rows;
  unmap(m);
  return 0;
}

// Parse the file body into out (row-major float32, n_rows x n_cols).
// col_numeric_ok must be n_cols bytes, preset to 1 by the caller; cleared
// for any column containing a non-float cell. Returns rows parsed (>=0) or
// <0 on IO error.
int64_t csv_parse_f32(const char* path, float* out, int64_t n_rows,
                      int64_t n_cols, uint8_t* col_numeric_ok) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  size_t start = header_end(m);

  // Index line starts first (cheap scan) so parsing can be parallel with
  // exact row -> output-slot mapping.
  std::vector<const char*> line_starts;
  line_starts.reserve(static_cast<size_t>(n_rows));
  {
    const char* p = m.data + start;
    const char* end = m.data + m.size;
    while (p < end && static_cast<int64_t>(line_starts.size()) < n_rows) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      const char* line_end = nl ? nl : end;
      if (line_end > p && !(line_end == p + 1 && *p == '\r')) {
        line_starts.push_back(p);
      }
      if (!nl) break;
      p = nl + 1;
    }
  }
  int64_t rows = static_cast<int64_t>(line_starts.size());

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 1;
  if (rows < 4096) n_threads = 1;
  // Per-thread column flags merged at the end (avoids false sharing/races).
  std::vector<std::vector<uint8_t>> flags(
      n_threads, std::vector<uint8_t>(static_cast<size_t>(n_cols), 1));
  std::vector<std::thread> workers;
  int64_t chunk = rows / n_threads + 1;
  const char* file_end = m.data + m.size;
  for (unsigned t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < rows ? lo + chunk : rows;
    if (lo >= hi) break;
    workers.emplace_back([&, t, lo, hi]() {
      for (int64_t r = lo; r < hi; r++) {
        const char* p = line_starts[static_cast<size_t>(r)];
        const char* scan_end =
            (r + 1 < rows) ? line_starts[static_cast<size_t>(r + 1)] : file_end;
        const char* nl =
            static_cast<const char*>(memchr(p, '\n', scan_end - p));
        const char* line_end = nl ? nl : scan_end;
        parse_line(p, line_end, file_end, out + r * n_cols, n_cols,
                   flags[t].data());
      }
    });
  }
  for (auto& w : workers) w.join();
  for (unsigned t = 0; t < n_threads; t++) {
    for (int64_t c = 0; c < n_cols; c++) {
      if (!flags[t][static_cast<size_t>(c)]) col_numeric_ok[c] = 0;
    }
  }
  unmap(m);
  return rows;
}

}  // extern "C"
