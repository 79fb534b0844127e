// Native snapshot runtime: multithreaded compression + field diff norms.
//
// Counterpart of the reference's C/C++ I/O stack (reference:
// source/dataIO/dataio_silo_MPI.cpp PMPIO grouped parallel writes and
// analysis/silocompare/silocompare.cpp cell-by-cell norms).  The hot paths
// of checkpointing large device arrays — compressing gigabyte snapshots and
// computing regression norms — run here in C++ with a thread pool, off the
// Python interpreter, exposed through a plain C ABI consumed via ctypes.
//
// Build: make -C pion_tpu/native   (g++ + zlib, both baked into the image)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Chunked, multithreaded deflate.  Layout of the output buffer:
//   [int64 n_chunks][int64 raw_chunk_bytes]
//   [int64 comp_size x n_chunks][chunk data ...]
// Returns total bytes written, or -1 on failure (buffer too small).
// ---------------------------------------------------------------------------

int64_t snap_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t dst_cap, int32_t level, int32_t n_threads) {
  const int64_t chunk = 4 << 20;  // 4 MiB per task
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  if (n_threads < 1) n_threads = 1;

  std::vector<std::vector<uint8_t>> out(n_chunks);
  std::atomic<int64_t> next(0);
  std::atomic<bool> ok(true);

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_chunks || !ok.load()) return;
      int64_t off = i * chunk;
      int64_t len = std::min(chunk, n - off);
      uLongf cap = compressBound((uLong)len);
      out[i].resize(cap);
      if (compress2(out[i].data(), &cap, src + off, (uLong)len, level) !=
          Z_OK) {
        ok.store(false);
        return;
      }
      out[i].resize(cap);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (!ok.load()) return -1;

  int64_t header = 16 + 8 * n_chunks;
  int64_t total = header;
  for (auto& c : out) total += (int64_t)c.size();
  if (total > dst_cap) return -1;

  std::memcpy(dst, &n_chunks, 8);
  std::memcpy(dst + 8, &chunk, 8);
  int64_t pos = header;
  for (int64_t i = 0; i < n_chunks; i++) {
    int64_t sz = (int64_t)out[i].size();
    std::memcpy(dst + 16 + 8 * i, &sz, 8);
    std::memcpy(dst + pos, out[i].data(), sz);
    pos += sz;
  }
  return total;
}

// Decompress a snap_compress buffer into dst (must hold raw_n bytes).
// Returns raw bytes written, or -1 on failure.
int64_t snap_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t raw_n, int32_t n_threads) {
  if (n < 16) return -1;
  int64_t n_chunks, chunk;
  std::memcpy(&n_chunks, src, 8);
  std::memcpy(&chunk, src + 8, 8);
  if (n_chunks <= 0 || chunk <= 0) return -1;
  int64_t header = 16 + 8 * n_chunks;
  std::vector<int64_t> sizes(n_chunks), offs(n_chunks);
  int64_t pos = header;
  for (int64_t i = 0; i < n_chunks; i++) {
    std::memcpy(&sizes[i], src + 16 + 8 * i, 8);
    offs[i] = pos;
    pos += sizes[i];
  }
  if (pos > n) return -1;
  if (n_threads < 1) n_threads = 1;

  std::atomic<int64_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_chunks || !ok.load()) return;
      int64_t roff = i * chunk;
      uLongf rlen = (uLongf)std::min(chunk, raw_n - roff);
      if (uncompress(dst + roff, &rlen, src + offs[i], (uLong)sizes[i]) !=
          Z_OK) {
        ok.store(false);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load() ? raw_n : -1;
}

// ---------------------------------------------------------------------------
// Field diff norms: per-variable L1/L2/max of (a-b), threaded over variables
// (the silocompare inner loop, reference: silocompare.cpp:259-282).
// a,b: (nvar, ncell) float64 row-major; out: (nvar, 3) [L1, L2, max].
// ---------------------------------------------------------------------------

void snap_diff_norms(const double* a, const double* b, int64_t nvar,
                     int64_t ncell, double* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t v = next.fetch_add(1);
      if (v >= nvar) return;
      const double* pa = a + v * ncell;
      const double* pb = b + v * ncell;
      double l1 = 0.0, l2 = 0.0, mx = 0.0;
      for (int64_t i = 0; i < ncell; i++) {
        double d = pa[i] - pb[i];
        double ad = std::fabs(d);
        l1 += ad;
        l2 += d * d;
        if (ad > mx) mx = ad;
      }
      out[3 * v + 0] = l1 / (double)ncell;
      out[3 * v + 1] = std::sqrt(l2 / (double)ncell);
      out[3 * v + 2] = mx;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

int32_t snap_version() { return 1; }

}  // extern "C"
