// Copied verbatim from chamjax/native/src/ivfpq.cpp (the port keeps its own copy).
// Native host IVF-PQ query engine: the CPU serving tier.
//
// The reference serves its CPU baseline through Faiss' C++ engine
// (`FaissServer` cpu mode, `Faiss_experiments` CPU benchmarks); chamjax's
// CPU tier otherwise runs the JAX kernels in interpret mode, which is
// test-grade, not serving-grade.  This is an original scalar engine over
// the SAME packed CSR index layout the TPU path uses (PackedIVF:
// row-major (n_pad, m) uint8 codes + int32 ids/list tables), implementing
// the same math as chamjax/searcher.py: exact coarse top-nprobe, residual
// ADC LUTs, LUT-sum scan, exact top-k.  Distances are squared L2, float32
// accumulation — matching the device kernels to float tolerance.
//
// The engine BORROWS all array memory (zero-copy for multi-GB code
// arrays); the Python wrapper keeps the backing numpy arrays alive for
// the handle's lifetime.  Queries within one search call fan out over a
// thread pool (per-thread scratch — the index arrays are read-only), so
// a handle is safe to drive from one caller thread; concurrent calls on
// ONE handle are not supported (distinct handles are independent).
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct IvfPq {
  int d = 0, m = 0, ksub = 0, dsub = 0;
  long long nlist = 0, n_pad = 0;
  bool by_residual = true;
  const float* centroids = nullptr;   // (nlist, d)
  const float* codebooks = nullptr;   // (m, ksub, dsub)
  const uint8_t* codes = nullptr;     // (n_pad, m) row-major
  const int32_t* ids = nullptr;       // (n_pad,)
  const int32_t* list_start = nullptr;
  const int32_t* list_len = nullptr;
  std::vector<float> cent_norms;      // (nlist,) ||c||^2
};

// Per-thread query scratch — everything mutable during a search.
struct Scratch {
  std::vector<float> lut;             // (m, ksub)
  std::vector<float> resid;           // (d,)
  std::vector<std::pair<float, int32_t>> probes;
  std::vector<std::pair<float, int64_t>> heap;  // max-heap of k best

  explicit Scratch(const IvfPq& ix)
      : lut(static_cast<size_t>(ix.m) * ix.ksub), resid(ix.d) {}
};

// create/free/lookup guard: ctypes releases the GIL, so one thread may be
// mid-search while another creates a handle (vector reallocation would
// invalidate the reader); searches hold only the brief lookup lock.
std::mutex g_handles_mu;
std::vector<IvfPq*> g_handles;

IvfPq* lookup_handle(long long h) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  if (h < 0 || h >= static_cast<long long>(g_handles.size())) return nullptr;
  return g_handles[h];
}

inline void heap_push(std::vector<std::pair<float, int64_t>>& h, size_t k,
                      float dist, int64_t id) {
  if (h.size() < k) {
    h.emplace_back(dist, id);
    std::push_heap(h.begin(), h.end());
  } else if (dist < h.front().first) {
    std::pop_heap(h.begin(), h.end());
    h.back() = {dist, id};
    std::push_heap(h.begin(), h.end());
  }
}

void scan_one_list(const IvfPq& ix, Scratch& sc, size_t k, int32_t list_id) {
  const long long s = ix.list_start[list_id];
  const long long ln = ix.list_len[list_id];
  const int m = ix.m;
  const float* lut = sc.lut.data();
  const uint8_t* row = ix.codes + s * m;
  auto& h = sc.heap;
  for (long long r = 0; r < ln; ++r, row += m) {
    float dist = 0.f;
    int j = 0;
    for (; j + 4 <= m; j += 4) {  // unrolled LUT-sum (adc_bench best)
      dist += lut[(j + 0) * ix.ksub + row[j + 0]]
            + lut[(j + 1) * ix.ksub + row[j + 1]]
            + lut[(j + 2) * ix.ksub + row[j + 2]]
            + lut[(j + 3) * ix.ksub + row[j + 3]];
    }
    for (; j < m; ++j) dist += lut[j * ix.ksub + row[j]];
    const int32_t id = ix.ids[s + r];
    if (id >= 0) heap_push(h, k, dist, id);
  }
}

void build_lut(const IvfPq& ix, Scratch& sc, const float* q,
               int32_t list_id) {
  const int dsub = ix.dsub;
  const float* cent = ix.centroids + static_cast<long long>(list_id) * ix.d;
  if (ix.by_residual) {
    for (int t = 0; t < ix.d; ++t) sc.resid[t] = q[t] - cent[t];
  } else {
    std::memcpy(sc.resid.data(), q, sizeof(float) * ix.d);
  }
  for (int j = 0; j < ix.m; ++j) {
    const float* rj = sc.resid.data() + j * dsub;
    const float* cb = ix.codebooks
        + (static_cast<long long>(j) * ix.ksub) * dsub;
    float* out = sc.lut.data() + static_cast<long long>(j) * ix.ksub;
    for (int c = 0; c < ix.ksub; ++c, cb += dsub) {
      float a0 = 0.f, a1 = 0.f;
      int t = 0;
      for (; t + 2 <= dsub; t += 2) {
        const float d0 = rj[t] - cb[t];
        const float d1 = rj[t + 1] - cb[t + 1];
        a0 += d0 * d0;
        a1 += d1 * d1;
      }
      float acc = a0 + a1;
      for (; t < dsub; ++t) {
        const float diff = rj[t] - cb[t];
        acc += diff * diff;
      }
      out[c] = acc;
    }
  }
}

void coarse_topn(const IvfPq& ix, Scratch& sc, const float* q, int nprobe) {
  // exact ||q - c||^2 ranking via ||c||^2 - 2 q.c (the ||q||^2 term is
  // rank-invariant), bounded max-heap of nprobe
  auto& pr = sc.probes;
  pr.clear();
  for (long long l = 0; l < ix.nlist; ++l) {
    const float* c = ix.centroids + l * ix.d;
    // 4 independent accumulators: breaks the FP add dependency chain so
    // -O3 can vectorize (reassociation is bit-stable per build, and the
    // comparison tests carry 1e-4 tolerances)
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int t = 0;
    for (; t + 4 <= ix.d; t += 4) {
      a0 += q[t + 0] * c[t + 0];
      a1 += q[t + 1] * c[t + 1];
      a2 += q[t + 2] * c[t + 2];
      a3 += q[t + 3] * c[t + 3];
    }
    float dot = (a0 + a1) + (a2 + a3);
    for (; t < ix.d; ++t) dot += q[t] * c[t];
    const float dist = ix.cent_norms[l] - 2.f * dot;
    if (static_cast<int>(pr.size()) < nprobe) {
      pr.emplace_back(dist, static_cast<int32_t>(l));
      std::push_heap(pr.begin(), pr.end());
    } else if (dist < pr.front().first) {
      std::pop_heap(pr.begin(), pr.end());
      pr.back() = {dist, static_cast<int32_t>(l)};
      std::push_heap(pr.begin(), pr.end());
    }
  }
}

void finish_query(Scratch& sc, size_t k, int64_t* out_ids,
                  float* out_dists) {
  auto& h = sc.heap;
  std::sort_heap(h.begin(), h.end());  // ascending distance
  size_t i = 0;
  for (; i < h.size() && i < k; ++i) {
    out_dists[i] = h[i].first;
    out_ids[i] = h[i].second;
  }
  for (; i < k; ++i) {  // under-filled: pad like the device path
    out_dists[i] = std::numeric_limits<float>::infinity();
    out_ids[i] = -1;
  }
}

// Fan a [0, nq) query range over a thread pool; fn(qi, scratch) runs the
// whole per-query pipeline.  n_threads<=0 → hardware concurrency.
template <typename Fn>
void parallel_queries(const IvfPq& ix, long long nq, int n_threads, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 1);
  if (nt > nq) nt = static_cast<int>(nq > 0 ? nq : 1);
  if (nt <= 1) {
    Scratch sc(ix);
    for (long long qi = 0; qi < nq; ++qi) fn(qi, sc);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int w = 0; w < nt; ++w) {
    pool.emplace_back([&, w]() {
      Scratch sc(ix);
      for (long long qi = w; qi < nq; qi += nt) fn(qi, sc);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Create an engine over BORROWED arrays (caller keeps them alive and
// unchanged until cham_ivfpq_free).  Returns handle >= 0, or -1 on bad
// arguments.
long long cham_ivfpq_create(int d, int m, int ksub, long long nlist,
                            const float* centroids, const float* codebooks,
                            const uint8_t* codes, const int32_t* ids,
                            const int32_t* list_start,
                            const int32_t* list_len, long long n_pad,
                            int by_residual) {
  if (d <= 0 || m <= 0 || ksub <= 0 || d % m != 0 || nlist <= 0 ||
      !centroids || !codebooks || !codes || !ids || !list_start ||
      !list_len || n_pad < 0) {
    return -1;
  }
  // Validate the CSR tables against n_pad before trusting them: a corrupt
  // artifact must fail here with -1, not OOB-read inside a search (the
  // same discipline as cham_hnsw_load's header validation).
  for (long long l = 0; l < nlist; ++l) {
    const long long s = list_start[l], ln = list_len[l];
    if (s < 0 || ln < 0 || s + ln > n_pad) return -1;
  }
  try {
    IvfPq* ix = new IvfPq();
    ix->d = d; ix->m = m; ix->ksub = ksub; ix->dsub = d / m;
    ix->nlist = nlist; ix->n_pad = n_pad;
    ix->by_residual = by_residual != 0;
    ix->centroids = centroids; ix->codebooks = codebooks;
    ix->codes = codes; ix->ids = ids;
    ix->list_start = list_start; ix->list_len = list_len;
    ix->cent_norms.resize(nlist);
    for (long long l = 0; l < nlist; ++l) {
      const float* c = centroids + l * d;
      float n2 = 0.f;
      for (int t = 0; t < d; ++t) n2 += c[t] * c[t];
      ix->cent_norms[l] = n2;
    }
    std::lock_guard<std::mutex> lk(g_handles_mu);
    g_handles.push_back(ix);
    return static_cast<long long>(g_handles.size()) - 1;
  } catch (const std::exception&) {
    return -1;   // bad_alloc must not cross the ctypes boundary
  }
}

// Full search: exact coarse top-nprobe + residual-ADC scan + exact top-k.
// queries (nq, d) f32 -> out_ids (nq, k) i64, out_dists (nq, k) f32.
// Reported ADC distances are complete squared L2; the coarse ranking
// drops the rank-invariant ||q||^2 term.  n_threads<=0 = all cores.
// Returns 0, or -1 on bad arguments.
long long cham_ivfpq_search(long long h, long long nq, const float* queries,
                            int nprobe, int k, int64_t* out_ids,
                            float* out_dists, int n_threads) {
  const IvfPq* ixp = lookup_handle(h);
  if (!ixp || nq < 0 || nprobe <= 0 || k <= 0 || !queries || !out_ids ||
      !out_dists) {
    return -1;
  }
  const IvfPq& ix = *ixp;
  const int np = nprobe > ix.nlist ? static_cast<int>(ix.nlist) : nprobe;
  parallel_queries(ix, nq, n_threads, [&](long long qi, Scratch& sc) {
    const float* q = queries + qi * ix.d;
    coarse_topn(ix, sc, q, np);
    sc.heap.clear();
    for (const auto& pr : sc.probes) {
      build_lut(ix, sc, q, pr.second);
      scan_one_list(ix, sc, static_cast<size_t>(k), pr.second);
    }
    finish_query(sc, static_cast<size_t>(k), out_ids + qi * k,
                 out_dists + qi * k);
  });
  return 0;
}

// Preassigned search (the disaggregated contract): caller supplies the
// probed list ids (nq, nprobe) int32; entries < 0 are skipped.
long long cham_ivfpq_search_preassigned(long long h, long long nq,
                                        const float* queries,
                                        const int32_t* lists, int nprobe,
                                        int k, int64_t* out_ids,
                                        float* out_dists, int n_threads) {
  const IvfPq* ixp = lookup_handle(h);
  if (!ixp || nq < 0 || nprobe <= 0 || k <= 0 || !lists || !queries ||
      !out_ids || !out_dists) {
    return -1;
  }
  const IvfPq& ix = *ixp;
  parallel_queries(ix, nq, n_threads, [&](long long qi, Scratch& sc) {
    const float* q = queries + qi * ix.d;
    sc.heap.clear();
    for (int p = 0; p < nprobe; ++p) {
      const int32_t lid = lists[qi * nprobe + p];
      if (lid < 0 || lid >= ix.nlist) continue;
      build_lut(ix, sc, q, lid);
      scan_one_list(ix, sc, static_cast<size_t>(k), lid);
    }
    finish_query(sc, static_cast<size_t>(k), out_ids + qi * k,
                 out_dists + qi * k);
  });
  return 0;
}

void cham_ivfpq_free(long long h) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  if (h >= 0 && h < static_cast<long long>(g_handles.size()) &&
      g_handles[h]) {
    delete g_handles[h];
    g_handles[h] = nullptr;
  }
}

}  // extern "C"
