// Native host runtime for the OMR client-side decoder.
//
// Counterpart of the reference's compiled hot loops on the retriever path:
// Gaussian elimination + back substitution over Z_p with payload-vector
// right-hand sides (reference omr_core/src/matrix.rs:78-336, including the
// unchecked-indexing fast paths at matrix.rs:43-75 and the inverse-table
// specializations solve_matrix_mod_256 / solve_matrix_mod_257 at
// matrix.rs:13-41,78-247) and the bucket scan / digit recomposition of
// decode_pertinent_indices (omr_core/src/retriever.rs:93-123).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

int64_t inv_mod(int64_t a, int64_t p) {
  // extended Euclid; returns -1 if not invertible
  int64_t g = a % p, b = p, x0 = 1, x1 = 0;
  while (b != 0) {
    int64_t q = g / b;
    int64_t t = g - q * b;
    g = b;
    b = t;
    t = x0 - q * x1;
    x0 = x1;
    x1 = t;
  }
  if (g != 1 && g != -1) return -1;
  x0 %= p;
  if (x0 < 0) x0 += p;
  return x0;
}

// Run fn(lo, hi) over [0, n) split across up to max_threads workers
// (counterpart of the reference client's rayon parallelism). Threads only
// pay off when the TOTAL work per call (``work`` ~ touched elements, not
// just the split axis n — the production RHS pass is rows x plen) clears
// the spawn cost; small problems run inline.
void parallel_for(int64_t n, int max_threads, int64_t work,
                  const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = static_cast<int>(hw == 0 ? 1 : hw);
  if (nt > max_threads) nt = max_threads;
  if (nt <= 1 || work < 4096) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    workers.emplace_back(fn, lo, hi);
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Solve matrix (rows x cols, row-major) * x = rhs (rows x plen) mod p.
// Writes x (cols x plen) into out. Returns 0 on success, -1 if singular.
//
// For small p (p <= 65536 — covering the reference's specialized mod-256 /
// mod-257 paths, matrix.rs:164-247) a full inverse table is built once so
// the per-pivot extended-Euclid disappears from the elimination loop, and
// the RHS row updates (the only payload-proportional work) are threaded
// across the payload axis.
int omr_solve_matrix(int64_t* m, int64_t* r, int64_t rows, int64_t cols,
                     int64_t plen, int64_t p, int64_t* out) {
  if (rows < cols) return -1;
  std::vector<int64_t> table;  // table[v] = v^-1 mod p, 0 if not invertible
  const int64_t* tab = nullptr;
  if (p > 1 && p <= 65536) {
    table.assign(p, 0);
    for (int64_t v = 1; v < p; ++v) {
      int64_t iv = inv_mod(v, p);
      table[v] = iv < 0 ? 0 : iv;
    }
    tab = table.data();
  }
  // Per-column elimination factors, stashed so the threaded RHS pass can
  // re-read them without re-deriving from the (already-updated) matrix.
  std::vector<int64_t> factors(rows, 0);
  for (int64_t c = 0; c < cols; ++c) {
    // pivot: first row >= c with invertible entry (mirrors the pivot scan
    // of solve_matrix_mod_256, matrix.rs:86-97)
    int64_t piv = -1, inv = -1;
    for (int64_t rr = c; rr < rows; ++rr) {
      int64_t v = m[rr * cols + c] % p;
      if (v < 0) v += p;  // entries need not be pre-reduced to [0, p)
      inv = tab ? (tab[v] != 0 ? tab[v] : -1) : inv_mod(v, p);
      if (inv >= 1) {  // an inverse is always >= 1 when it exists
        piv = rr;
        break;
      }
    }
    if (piv < 0) return -1;
    if (piv != c) {
      for (int64_t k = 0; k < cols; ++k)
        std::swap(m[c * cols + k], m[piv * cols + k]);
      for (int64_t k = 0; k < plen; ++k)
        std::swap(r[c * plen + k], r[piv * plen + k]);
    }
    for (int64_t k = 0; k < cols; ++k)
      m[c * cols + k] = m[c * cols + k] * inv % p;
    for (int64_t k = 0; k < plen; ++k)
      r[c * plen + k] = r[c * plen + k] * inv % p;
    for (int64_t rr = c + 1; rr < rows; ++rr) {
      int64_t f = m[rr * cols + c] % p;
      factors[rr] = f;
      if (f == 0) continue;
      for (int64_t k = c; k < cols; ++k) {
        int64_t v = (m[rr * cols + k] - f * m[c * cols + k]) % p;
        m[rr * cols + k] = v < 0 ? v + p : v;
      }
    }
    parallel_for(plen, 8, (rows - c - 1) * plen, [&](int64_t lo, int64_t hi) {
      for (int64_t rr = c + 1; rr < rows; ++rr) {
        int64_t f = factors[rr];
        if (f == 0) continue;
        for (int64_t k = lo; k < hi; ++k) {
          int64_t v = (r[rr * plen + k] - f * r[c * plen + k]) % p;
          r[rr * plen + k] = v < 0 ? v + p : v;
        }
      }
    });
  }
  // back substitution (matrix.rs:134-158 shape)
  for (int64_t c = cols - 1; c >= 0; --c) {
    for (int64_t rr = 0; rr < c; ++rr) {
      factors[rr] = m[rr * cols + c] % p;
      m[rr * cols + c] = 0;
    }
    parallel_for(plen, 8, c * plen, [&](int64_t lo, int64_t hi) {
      for (int64_t rr = 0; rr < c; ++rr) {
        int64_t f = factors[rr];
        if (f == 0) continue;
        for (int64_t k = lo; k < hi; ++k) {
          int64_t v = (r[rr * plen + k] - f * r[c * plen + k]) % p;
          r[rr * plen + k] = v < 0 ? v + p : v;
        }
      }
    });
  }
  std::memcpy(out, r, sizeof(int64_t) * cols * plen);
  return 0;
}

// Scan decoded digest coefficients for flag==1 buckets and recompose indices.
// decoded: n_seg * sps values; layout [segment][bucket][slot], spb slots per
// bucket of which the last is the flag. Appends found indices (< max_index)
// to out (capacity cap); returns the count found.
int omr_scan_buckets(const int64_t* decoded, int64_t n_seg, int64_t sps,
                     int64_t spb, int64_t n_buckets, int64_t p,
                     int64_t max_index, int64_t* out, int64_t cap) {
  int64_t found = 0;
  for (int64_t s = 0; s < n_seg; ++s) {
    const int64_t* seg = decoded + s * sps;
    for (int64_t b = 0; b < n_buckets; ++b) {
      const int64_t* bucket = seg + b * spb;
      if (bucket[spb - 1] != 1) continue;
      int64_t idx = 0;
      for (int64_t k = spb - 2; k >= 0; --k) idx = idx * p + bucket[k];
      if (idx < max_index && found < cap) out[found++] = idx;
    }
  }
  return static_cast<int>(found);
}

}  // extern "C"
