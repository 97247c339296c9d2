// velocycle_tpu_torch native ingest library: the port's own copy of
// velocycle_tpu/native/ingest.cpp (same C interface, same results).
//
// The reference framework is pure Python and pays its host-side
// preprocessing costs through scipy/numpy (sparse densification in the
// reference's `velocycle/preprocessing.py:124-147`, notebook-level
// .mtx/.h5ad loading).  At Stereo-seq scale (1e6+ cells) that path is the
// wall-clock bottleneck before the device ever sees a batch, so this
// library provides multi-threaded C++ kernels for the ingest pipeline:
//
//   * CSR -> dense float32 densification (row-parallel)
//   * MatrixMarket (.mtx) sparse-triplet parsing (chunk-parallel)
//   * per-cell size factors  log(UMI_c / mean UMI)
//   * one-hot design-matrix construction from integer category codes
//
// Exposed as a plain C ABI consumed via ctypes.  All outputs are
// caller-allocated; all functions return 0 on success.
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(first, last) over [0, n) split across nthreads.
template <typename F>
void parallel_for(int64_t n, int nthreads, F fn) {
  if (n <= 0) return;
  nthreads = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(nthreads, n)));
  if (nthreads == 1) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// CSR (cells x genes) -> dense row-major float32, row-parallel.
// indptr: n_rows+1, indices: nnz, data: nnz.
int vct_csr_to_dense(const int64_t* indptr, const int32_t* indices,
                     const float* data, int64_t n_rows, int64_t n_cols,
                     float* out, int nthreads) {
  if (!indptr || !indices || !data || !out) return 1;
  if (nthreads <= 0) nthreads = hardware_threads();
  parallel_for(n_rows, nthreads, [&](int64_t lo, int64_t hi) {
    std::memset(out + lo * n_cols, 0,
                sizeof(float) * static_cast<size_t>((hi - lo) * n_cols));
    for (int64_t r = lo; r < hi; ++r) {
      float* row = out + r * n_cols;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
        row[indices[k]] = data[k];
      }
    }
  });
  return 0;
}

// Same, but writes the transpose (genes x cells) — the model layout
// (S, U: (Ng, Nc)), saving a separate host-side transpose pass.
int vct_csr_to_dense_t(const int64_t* indptr, const int32_t* indices,
                       const float* data, int64_t n_rows, int64_t n_cols,
                       float* out, int nthreads) {
  if (!indptr || !indices || !data || !out) return 1;
  if (nthreads <= 0) nthreads = hardware_threads();
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(n_rows * n_cols));
  // column-of-output == row-of-input: each thread owns a row range, writes
  // disjoint output columns -> no races.
  parallel_for(n_rows, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
        out[static_cast<int64_t>(indices[k]) * n_rows + r] = data[k];
      }
    }
  });
  return 0;
}

// Per-cell totals and log size factors from a dense (n_cells x n_genes)
// row-major matrix: count_factor_c = log(sum_g X_cg / mean_c sum_g X_cg).
int vct_size_factors(const float* dense, int64_t n_cells, int64_t n_genes,
                     float* totals, float* count_factor, int nthreads) {
  if (!dense || !totals || !count_factor) return 1;
  if (nthreads <= 0) nthreads = hardware_threads();
  parallel_for(n_cells, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      const float* row = dense + c * n_genes;
      double s = 0.0;
      for (int64_t g = 0; g < n_genes; ++g) s += row[g];
      totals[c] = static_cast<float>(s);
    }
  });
  double mean = 0.0;
  for (int64_t c = 0; c < n_cells; ++c) mean += totals[c];
  mean /= std::max<int64_t>(n_cells, 1);
  if (mean <= 0.0) return 2;
  for (int64_t c = 0; c < n_cells; ++c) {
    count_factor[c] = static_cast<float>(std::log(totals[c] / mean));
  }
  return 0;
}

// One-hot (n x k) int8 design from integer category codes in [0, k).
int vct_one_hot(const int32_t* codes, int64_t n, int64_t k, int8_t* out,
                int nthreads) {
  if (!codes || !out) return 1;
  if (nthreads <= 0) nthreads = hardware_threads();
  std::atomic<int> bad{0};
  parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
    std::memset(out + lo * k, 0,
                static_cast<size_t>((hi - lo) * k));
    for (int64_t i = lo; i < hi; ++i) {
      int32_t c = codes[i];
      if (c < 0 || c >= k) {
        bad.store(1, std::memory_order_relaxed);
        continue;
      }
      out[i * k + c] = 1;
    }
  });
  return bad.load() ? 2 : 0;
}

// ---------------------------------------------------------------------------
// MatrixMarket parsing.
// ---------------------------------------------------------------------------

// Pass 1 (header): rows/cols/nnz of a "coordinate" .mtx file.
int vct_mtx_header(const char* path, int64_t* n_rows, int64_t* n_cols,
                   int64_t* nnz) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  char line[4096];
  int rc = 3;
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == '%' || line[0] == '\n' || line[0] == '\r') continue;
    if (std::sscanf(line, "%lld %lld %lld",
                    reinterpret_cast<long long*>(n_rows),
                    reinterpret_cast<long long*>(n_cols),
                    reinterpret_cast<long long*>(nnz)) == 3) {
      rc = 0;
    }
    break;
  }
  std::fclose(f);
  return rc;
}

namespace {

// Parse triplets from a buffer range [lo, hi) where lo/hi sit on line
// boundaries.  Returns the number parsed.
int64_t parse_triplets(const char* buf, int64_t lo, int64_t hi,
                       int32_t* rows, int32_t* cols, float* vals,
                       int64_t max_out) {
  int64_t n = 0;
  const char* p = buf + lo;
  const char* end = buf + hi;
  while (p < end && n < max_out) {
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ')) ++p;
    if (p >= end) break;
    char* q;
    long r = std::strtol(p, &q, 10);
    if (q == p) {  // malformed line: skip it
      while (p < end && *p != '\n') ++p;
      continue;
    }
    long c = std::strtol(q, &q, 10);
    float v = std::strtof(q, &q);
    if (v == 0.0f && q == p) v = 1.0f;  // pattern matrices carry no value
    rows[n] = static_cast<int32_t>(r - 1);  // 1-based -> 0-based
    cols[n] = static_cast<int32_t>(c - 1);
    vals[n] = v;
    ++n;
    p = q;
    while (p < end && *p != '\n') ++p;
  }
  return n;
}

}  // namespace

// Pass 2 (body): fill caller-allocated triplet arrays (length >= nnz).
// Chunk-parallel: the file is read once, then split on line boundaries.
int vct_mtx_read(const char* path, int32_t* rows, int32_t* cols, float* vals,
                 int64_t nnz, int nthreads) {
  if (!rows || !cols || !vals) return 1;
  if (nthreads <= 0) nthreads = hardware_threads();
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  int64_t size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  int64_t got = static_cast<int64_t>(
      std::fread(buf.data(), 1, static_cast<size_t>(size), f));
  std::fclose(f);
  if (got != size) return 2;
  buf[size] = '\0';

  // skip comments + the size line
  int64_t pos = 0;
  bool size_line_done = false;
  while (pos < size && !size_line_done) {
    int64_t eol = pos;
    while (eol < size && buf[eol] != '\n') ++eol;
    if (buf[pos] != '%' && buf[pos] != '\n' && buf[pos] != '\r') {
      size_line_done = true;  // this was the "rows cols nnz" line
    }
    pos = eol + 1;
  }

  // split [pos, size) into nthreads chunks on line boundaries
  int nt = std::max(1, nthreads);
  std::vector<int64_t> bounds(nt + 1);
  bounds[0] = pos;
  bounds[nt] = size;
  for (int t = 1; t < nt; ++t) {
    int64_t b = pos + (size - pos) * t / nt;
    while (b < size && buf[b] != '\n') ++b;
    bounds[t] = std::min(size, b + 1);
  }
  for (int t = 1; t < nt; ++t) bounds[t] = std::max(bounds[t], bounds[t - 1]);

  // count lines per chunk to compute output offsets
  std::vector<int64_t> counts(nt, 0);
  parallel_for(nt, nt, [&](int64_t lo, int64_t hi) {
    for (int64_t t = lo; t < hi; ++t) {
      int64_t cnt = 0;
      for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i) {
        if (buf[i] == '\n') ++cnt;
      }
      // a last line without trailing newline
      if (t == nt - 1 && bounds[t + 1] > bounds[t] &&
          buf[bounds[t + 1] - 1] != '\n') {
        ++cnt;
      }
      counts[t] = cnt;
    }
  });
  std::vector<int64_t> offsets(nt + 1, 0);
  for (int t = 0; t < nt; ++t) offsets[t + 1] = offsets[t] + counts[t];

  std::atomic<int> err{0};
  parallel_for(nt, nt, [&](int64_t lo, int64_t hi) {
    for (int64_t t = lo; t < hi; ++t) {
      int64_t budget = std::min(counts[t], nnz - offsets[t]);
      if (budget < 0) budget = 0;
      int64_t n = parse_triplets(buf.data(), bounds[t], bounds[t + 1],
                                 rows + offsets[t], cols + offsets[t],
                                 vals + offsets[t], budget);
      if (n != counts[t] && offsets[t] + counts[t] <= nnz) {
        // blank/comment lines inside the body: compact is still correct
        // as long as total parsed <= nnz; signal only hard failure
        if (n == 0 && counts[t] > 0) err.store(3);
      }
    }
  });
  return err.load();
}

int vct_version() { return 1; }

}  // extern "C"
