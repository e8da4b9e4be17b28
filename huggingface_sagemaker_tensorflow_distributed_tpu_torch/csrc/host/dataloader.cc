// Data-loader core, C++ host library of the PyTorch port.
//
// The port's own copy of the JAX package's native/dataloader.cc (same code,
// same C interface). Primitives on host int32 column arrays and files:
//
//  - dl_permutation: deterministic keyed-hash shuffle (splitmix64 keys,
//    stable sort): the epoch order every rank computes identically.
//    Key-sorted rather than Fisher-Yates so the Python twin is a
//    vectorized numpy argsort giving bit-identical orders
//    (data/pipeline.py::epoch_permutation).
//  - dl_gather: parallel row gather of a batch's indices into a contiguous
//    caller-owned buffer.
//  - dl_row_lengths: token count per row (length-bucketed batching).
//  - dl_line_index: line-start offsets of a text file (the streaming
//    tier's index), by a parallel pread + memchr scan.
//
// Python binding: data/native.py (ctypes); built by ops/_build.py
// (build_host) with g++ into build/host/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline uint64_t mix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// out[0..n) = seeded permutation of [0, n): indices stably sorted by a
// per-index splitmix64 key. Same (n, seed) -> same result on every host
// and platform; mirrored exactly (vectorized) in data/native.py.
void dl_permutation(int64_t n, uint64_t seed, int64_t* out) {
  uint64_t seedmix = seed * 0xD1342543DE82EF95ull + 0x2545F4914F6CDD1Dull;
  std::vector<uint64_t> keys((size_t)n);
  for (int64_t i = 0; i < n; i++)
    keys[i] = mix64(seedmix ^ ((uint64_t)i * 0x9E3779B97F4A7C15ull));
  for (int64_t i = 0; i < n; i++) out[i] = i;
  std::stable_sort(out, out + n, [&](int64_t a, int64_t b) {
    return keys[a] < keys[b];
  });
}

// Gather rows: out[b, :] = src[idx[b], :], row_elems int32 elements per row.
// Parallel memcpy over batch rows.
void dl_gather(const int32_t* src, int64_t row_elems, const int64_t* idx,
               int64_t n_idx, int32_t* out, int32_t n_threads) {
  const size_t row_bytes = (size_t)row_elems * sizeof(int32_t);
  auto copy_range = [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; b++)
      memcpy(out + b * row_elems, src + idx[b] * row_elems, row_bytes);
  };
  if (n_threads <= 1 || n_idx < 256) { copy_range(0, n_idx); return; }
  n_threads = std::min<int64_t>(n_threads, n_idx);
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n_idx);
    if (lo >= hi) break;
    threads.emplace_back(copy_range, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// lengths[r] = number of nonzero entries in mask row r (token count);
// used for length-bucketed batching.
void dl_row_lengths(const int32_t* mask, int64_t n_rows, int64_t row_elems,
                    int32_t* lengths, int32_t n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; r++) {
      const int32_t* row = mask + r * row_elems;
      int32_t c = 0;
      for (int64_t j = 0; j < row_elems; j++) c += (row[j] != 0);
      lengths[r] = c;
    }
  };
  if (n_threads <= 1 || n_rows < 1024) { work(0, n_rows); return; }
  n_threads = std::min<int64_t>(n_threads, n_rows);
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n_rows);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Newline index of a text/jsonl corpus: parallel memchr scan with pread
// (no shared file position), used by the streaming tier's LineCorpus to
// build its line-offset index at disk bandwidth instead of a Python
// line loop. Returns the newline count; when out != null, fills up to
// cap sorted byte positions (a caller seeing count > cap re-calls with
// an exact buffer — one scan in the common generous-guess case).
// Returns -1 when the file cannot be opened/stat'd.
int64_t dl_line_index(const char* path, int64_t* out, int64_t cap,
                      int32_t n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  const int64_t size = (int64_t)st.st_size;
  if (size == 0) { close(fd); return 0; }
  if (n_threads < 1) n_threads = 1;
  n_threads = (int32_t)std::min<int64_t>(n_threads, (size + (1 << 20) - 1) >> 20);
  if (n_threads < 1) n_threads = 1;
  std::vector<std::vector<int64_t>> found((size_t)n_threads);
  std::atomic<bool> io_error{false};
  int64_t chunk = (size + n_threads - 1) / n_threads;
  auto scan = [&](int32_t t) {
    int64_t lo = (int64_t)t * chunk, hi = std::min<int64_t>(lo + chunk, size);
    std::vector<char> buf((size_t)std::min<int64_t>(hi - lo, 4 << 20));
    int64_t pos = lo;
    while (pos < hi) {
      int64_t want = std::min<int64_t>((int64_t)buf.size(), hi - pos);
      int64_t got = pread(fd, buf.data(), (size_t)want, (off_t)pos);
      if (got <= 0) { io_error.store(true); return; }
      const char* p = buf.data();
      const char* end = p + got;
      while ((p = (const char*)memchr(p, '\n', (size_t)(end - p)))) {
        found[(size_t)t].push_back(pos + (p - buf.data()));
        p++;
      }
      pos += got;
    }
  };
  if (n_threads == 1) {
    scan(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; t++) threads.emplace_back(scan, t);
    for (auto& th : threads) th.join();
  }
  close(fd);
  if (io_error.load()) return -1;
  int64_t total = 0;
  for (auto& v : found) total += (int64_t)v.size();
  if (out) {
    int64_t k = 0;
    for (auto& v : found) {             // threads cover ascending ranges
      for (int64_t p : v) {
        if (k >= cap) break;
        out[k++] = p;
      }
      if (k >= cap) break;
    }
  }
  return total;
}

}  // extern "C"
