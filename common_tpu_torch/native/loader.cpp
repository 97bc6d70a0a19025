// Parallel text-to-float32 parser behind `common_tpu_torch.io.load_csv_f32`.
//
// The counterpart of `common_tpu/native/loader.cpp`, with the same two C
// functions and error codes:
//
//   long ct_csv_shape(path, long* cols)                     -> data rows, or < 0
//   long ct_csv_load_f32(path, float* out, max_rows, cols, n_threads)
//                                                           -> rows written, or < 0
//
//   -1  the file cannot be opened or read
//   -2  the file holds no data line
//   -3  a line has another number of fields than the first, or a field is
//       not a number
//
// A data line is any line that is neither blank nor starts (after blanks)
// with '#'. Fields are separated by runs of commas, semicolons, tabs and
// spaces; '\r' ends a line as '\n' does, so CRLF files read as LF ones.
//
// Each field is parsed to the correctly rounded double and then rounded to
// float, which is what numpy's loadtxt does for a float32 array, so the two
// routes give the same bits. The file is read once; the data lines are
// indexed in one pass (memchr from line to line) and then cut into one
// contiguous range per thread.
#include <algorithm>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct Text {
  std::string bytes;
  std::vector<long> starts;  // byte offset of each data line
};

bool slurp(const char* path, std::string& out) {
  std::FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(f) : -1;
  ok = ok && size >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out.assign(static_cast<size_t>(size), '\0');
    ok = size == 0 || std::fread(&out[0], 1, static_cast<size_t>(size), f) == static_cast<size_t>(size);
  }
  std::fclose(f);
  return ok;
}

inline bool separator(char c) { return c == ',' || c == ';' || c == '\t' || c == ' '; }
inline bool line_end(char c) { return c == '\n' || c == '\r'; }
inline bool blank(char c) { return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f'; }

// -1 or 0: read the file and index its data lines.
int index_lines(const char* path, Text& text) {
  if (!slurp(path, text.bytes)) return -1;
  const char* p = text.bytes.data();
  const long n = static_cast<long>(text.bytes.size());
  long i = 0;
  while (i < n) {
    long first = i;
    while (first < n && blank(p[first])) ++first;
    const void* nl = first < n ? std::memchr(p + first, '\n', static_cast<size_t>(n - first)) : nullptr;
    const long end = nl != nullptr ? static_cast<const char*>(nl) - p : n;
    if (first < end && p[first] != '#') text.starts.push_back(i);
    i = end + 1;
  }
  return 0;
}

// One field at p: the float it reads as, and where it ends; false if it
// is not a number.
inline bool parse_field(const char* p, const char* end, float& value, const char*& next) {
  const char* q = (p < end && *p == '+') ? p + 1 : p;  // from_chars takes no '+'
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  double v = 0.0;
  const std::from_chars_result r = std::from_chars(q, end, v);
  if (r.ec == std::errc::result_out_of_range) {
    v = std::strtod(q, nullptr);  // over- or underflow: strtod's inf or 0
  } else if (r.ec != std::errc()) {
    return false;
  }
  next = r.ptr;
#else
  char* stop = nullptr;
  const double v = std::strtod(q, &stop);
  if (stop == q) return false;
  next = stop;
#endif
  if (next == q) return false;
  value = static_cast<float>(v);
  return true;
}

// Parse one data line into row[0 .. cols); false if it is ragged or holds
// something that is not a number.
bool parse_line(const char* p, const char* end, float* row, long cols) {
  long c = 0;
  for (;;) {
    while (p < end && separator(*p)) ++p;
    if (p == end || line_end(*p)) break;
    if (c == cols) return false;  // a field past the first line's count
    const char* next = nullptr;
    if (!parse_field(p, end, row[c], next)) return false;
    if (next < end && !separator(*next) && !line_end(*next)) return false;  // "1.5x"
    p = next;
    ++c;
  }
  return c == cols;
}

long count_fields(const char* p, const char* end) {
  long cols = 0;
  for (;;) {
    while (p < end && separator(*p)) ++p;
    if (p == end || line_end(*p)) return cols;
    ++cols;
    while (p < end && !separator(*p) && !line_end(*p)) ++p;
  }
}

}  // namespace

extern "C" {

long ct_csv_shape(const char* path, long* cols) {
  Text text;
  if (index_lines(path, text) != 0) return -1;
  if (text.starts.empty()) return -2;
  const char* base = text.bytes.data();
  *cols = count_fields(base + text.starts[0], base + text.bytes.size());
  return static_cast<long>(text.starts.size());
}

long ct_csv_load_f32(const char* path, float* out, long max_rows, long cols, int n_threads) {
  Text text;
  if (index_lines(path, text) != 0) return -1;
  if (text.starts.empty()) return -2;
  const long rows = std::min<long>(static_cast<long>(text.starts.size()), max_rows);
  if (n_threads <= 0) {
    const unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw > 0 ? static_cast<int>(hw) : 4;
  }
  const long workers = std::max<long>(1, std::min<long>(n_threads, rows));
  const char* base = text.bytes.data();
  const char* end = base + text.bytes.size();
  std::vector<char> bad(static_cast<size_t>(workers), 0);
  auto work = [&](long w) {
    const long r0 = rows * w / workers, r1 = rows * (w + 1) / workers;
    bool ok = true;  // kept local: workers writing neighbouring flags a row would share a cache line
    for (long r = r0; r < r1 && ok; ++r) ok = parse_line(base + text.starts[r], end, out + r * cols, cols);
    bad[w] = !ok;
  };
  std::vector<std::thread> pool;
  for (long w = 1; w < workers; ++w) pool.emplace_back(work, w);
  work(0);
  for (auto& t : pool) t.join();
  for (char b : bad)
    if (b) return -3;
  return rows;
}

}  // extern "C"
