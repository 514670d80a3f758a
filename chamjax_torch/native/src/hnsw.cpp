// Copied verbatim from chamjax/native/src/hnsw.cpp (the port keeps its own copy).
// Native HNSW graph index (C API, ctypes-bound).
//
// The reference vendors hnswlib for its host-side ANN needs: the FPGA host
// program's coarse centroid search (reference SRC/host.cpp:516-556,
// SRC/hnswlib/*.h) and BEIR's HNSWFaissSearch variant
// (beir/beir/retrieval/search/dense/faiss_search.py). chamjax's coarse scan
// runs on-TPU as a matmul; this file provides the host-side graph-ANN
// capability for the IR harness and for CPU-only deployments.
//
// Original implementation of the HNSW algorithm (Malkov & Yashunin 2016):
// geometric level sampling, greedy descent through upper layers, beam
// (ef) search with a visited-stamp array at the target layer, and the
// distance-domination neighbor-selection heuristic.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct Pair {
    float dist;
    int id;
};
struct Closer {                       // min-heap on dist
    bool operator()(const Pair &a, const Pair &b) const {
        return a.dist > b.dist;
    }
};
struct Farther {                      // max-heap on dist
    bool operator()(const Pair &a, const Pair &b) const {
        return a.dist < b.dist;
    }
};

struct HNSW {
    int dim = 0;
    int M = 16;            // max links per node, layers > 0
    int Mmax0 = 32;        // max links at layer 0
    int efc = 200;         // construction beam width
    double mult = 0.0;     // level sampling: 1 / ln(M)
    int entry = -1;
    int max_level = -1;
    std::vector<float> data;                         // n * dim
    std::vector<int64_t> labels;                     // n
    std::vector<int> levels;                         // n
    std::vector<std::vector<std::vector<int>>> links;  // node→layer→nbrs
    std::mt19937_64 rng{42};
    // visited stamps (search scratch).  Per-index, NOT per-call: a handle
    // is single-threaded — concurrent searches on one handle race on this
    // array (ctypes releases the GIL).  Use one handle per thread.
    std::vector<uint32_t> stamp;
    uint32_t stamp_cur = 0;

    size_t size() const { return labels.size(); }

    float dist(const float *a, const float *b) const {
        float s = 0.f;
        for (int i = 0; i < dim; ++i) {
            float d = a[i] - b[i];
            s += d * d;
        }
        return s;
    }
    const float *vec(int id) const { return data.data() + (size_t)id * dim; }

    uint32_t fresh_stamp() {
        if (stamp.size() < size()) stamp.resize(size() * 2 + 64, 0);
        if (++stamp_cur == 0) {                  // wrapped: clear
            std::fill(stamp.begin(), stamp.end(), 0);
            stamp_cur = 1;
        }
        return stamp_cur;
    }

    // Beam search at one layer. Returns up to `ef` closest as a max-heap
    // drained into a dist-ascending vector.
    std::vector<Pair> search_layer(const float *q, int ep, int ef,
                                   int layer) {
        uint32_t st = fresh_stamp();
        std::priority_queue<Pair, std::vector<Pair>, Closer> cand;
        std::priority_queue<Pair, std::vector<Pair>, Farther> res;
        float d0 = dist(q, vec(ep));
        cand.push({d0, ep});
        res.push({d0, ep});
        stamp[ep] = st;
        while (!cand.empty()) {
            Pair c = cand.top();
            if (c.dist > res.top().dist && (int)res.size() >= ef) break;
            cand.pop();
            const auto &nbrs = links[c.id][layer];
            for (int nb : nbrs) {
                if (stamp[nb] == st) continue;
                stamp[nb] = st;
                float d = dist(q, vec(nb));
                if ((int)res.size() < ef || d < res.top().dist) {
                    cand.push({d, nb});
                    res.push({d, nb});
                    if ((int)res.size() > ef) res.pop();
                }
            }
        }
        std::vector<Pair> out(res.size());
        for (size_t i = res.size(); i-- > 0;) {
            out[i] = res.top();
            res.pop();
        }
        return out;
    }

    // hnswlib-style domination heuristic: keep a candidate only if it is
    // closer to the query than to every already-kept neighbor.
    void select_neighbors(std::vector<Pair> &cand, int m) {
        if ((int)cand.size() <= m) return;
        // cand is dist-ascending
        std::vector<Pair> kept;
        kept.reserve(m);
        for (const Pair &c : cand) {
            if ((int)kept.size() >= m) break;
            bool ok = true;
            for (const Pair &k : kept) {
                if (dist(vec(c.id), vec(k.id)) < c.dist) {
                    ok = false;
                    break;
                }
            }
            if (ok) kept.push_back(c);
        }
        // backfill with nearest skipped if the heuristic was too strict
        for (const Pair &c : cand) {
            if ((int)kept.size() >= m) break;
            bool have = false;
            for (const Pair &k : kept)
                if (k.id == c.id) { have = true; break; }
            if (!have) kept.push_back(c);
        }
        cand.swap(kept);
    }

    void shrink(int node, int layer) {
        auto &nbrs = links[node][layer];
        int cap = layer == 0 ? Mmax0 : M;
        if ((int)nbrs.size() <= cap) return;
        std::vector<Pair> cand;
        cand.reserve(nbrs.size());
        for (int nb : nbrs) cand.push_back({dist(vec(node), vec(nb)), nb});
        std::sort(cand.begin(), cand.end(),
                  [](const Pair &a, const Pair &b) { return a.dist < b.dist; });
        select_neighbors(cand, cap);
        nbrs.clear();
        for (const Pair &c : cand) nbrs.push_back(c.id);
    }

    void add_one(const float *v, int64_t label) {
        int id = (int)size();
        labels.push_back(label);
        data.insert(data.end(), v, v + dim);
        std::uniform_real_distribution<double> u(0.0, 1.0);
        int lvl = (int)(-std::log(std::max(u(rng), 1e-12)) * mult);
        levels.push_back(lvl);
        links.emplace_back(lvl + 1);
        if (entry < 0) {
            entry = id;
            max_level = lvl;
            return;
        }
        int ep = entry;
        // greedy descent through layers above lvl
        for (int l = max_level; l > lvl; --l) {
            bool moved = true;
            float best = dist(v, vec(ep));
            while (moved) {
                moved = false;
                for (int nb : links[ep][l]) {
                    float d = dist(v, vec(nb));
                    if (d < best) {
                        best = d;
                        ep = nb;
                        moved = true;
                    }
                }
            }
        }
        // connect at layers min(lvl, max_level)..0
        for (int l = std::min(lvl, max_level); l >= 0; --l) {
            auto cand = search_layer(v, ep, efc, l);
            ep = cand.front().id;                 // closest for next layer
            std::vector<Pair> sel = cand;
            select_neighbors(sel, M);
            auto &my = links[id][l];
            for (const Pair &s : sel) {
                my.push_back(s.id);
                links[s.id][l].push_back(id);
                shrink(s.id, l);
            }
        }
        if (lvl > max_level) {
            max_level = lvl;
            entry = id;
        }
    }

    void search(const float *q, int k, int ef, int64_t *out_labels,
                float *out_dists) {
        if (entry < 0) {
            for (int i = 0; i < k; ++i) {
                out_labels[i] = -1;
                out_dists[i] = INFINITY;
            }
            return;
        }
        int ep = entry;
        for (int l = max_level; l > 0; --l) {
            bool moved = true;
            float best = dist(q, vec(ep));
            while (moved) {
                moved = false;
                for (int nb : links[ep][l]) {
                    float d = dist(q, vec(nb));
                    if (d < best) {
                        best = d;
                        ep = nb;
                        moved = true;
                    }
                }
            }
        }
        auto res = search_layer(q, ep, std::max(ef, k), 0);
        for (int i = 0; i < k; ++i) {
            if (i < (int)res.size()) {
                out_labels[i] = labels[res[i].id];
                out_dists[i] = res[i].dist;
            } else {
                out_labels[i] = -1;
                out_dists[i] = INFINITY;
            }
        }
    }
};

std::mutex g_mu;
std::unordered_map<int64_t, HNSW *> g_handles;
int64_t g_next = 1;

int64_t register_index(HNSW *h) {
    std::lock_guard<std::mutex> lk(g_mu);
    int64_t id = g_next++;
    g_handles[id] = h;
    return id;
}

HNSW *get(int64_t h) {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_handles.find(h);
    return it == g_handles.end() ? nullptr : it->second;
}

constexpr uint64_t kMagic = 0x43484e535748ull;  // "CHNSWH"

}  // namespace

extern "C" {

int64_t cham_hnsw_create(int dim, int M, int ef_construction,
                         uint64_t seed) {
    if (dim <= 0 || M < 2) return -1;
    try {
        auto *h = new HNSW();
        h->dim = dim;
        h->M = M;
        h->Mmax0 = 2 * M;
        h->efc = ef_construction;
        h->mult = 1.0 / std::log((double)M);
        h->rng.seed(seed);
        return register_index(h);
    } catch (const std::bad_alloc &) {
        return -5;       // bad_alloc must not cross the ctypes boundary
    }
}

int64_t cham_hnsw_add(int64_t handle, int64_t n, const float *vecs,
                      const int64_t *labels) {
    HNSW *h = get(handle);
    if (!h) return -1;
    try {
        for (int64_t i = 0; i < n; ++i)
            h->add_one(vecs + i * h->dim,
                       labels ? labels[i] : (int64_t)h->size());
    } catch (const std::bad_alloc &) {
        // growth vectors can throw mid-corpus; already-added rows remain
        // valid — report the failure instead of aborting the interpreter
        return -5;
    }
    return (int64_t)h->size();
}

int64_t cham_hnsw_search(int64_t handle, int64_t n, const float *queries,
                         int k, int ef, int64_t *out_labels,
                         float *out_dists) {
    HNSW *h = get(handle);
    if (!h) return -1;
    for (int64_t i = 0; i < n; ++i)
        h->search(queries + i * h->dim, k, ef, out_labels + i * k,
                  out_dists + i * k);
    return n;
}

int64_t cham_hnsw_size(int64_t handle) {
    HNSW *h = get(handle);
    return h ? (int64_t)h->size() : -1;
}

int64_t cham_hnsw_save(int64_t handle, const char *path) {
    HNSW *h = get(handle);
    if (!h) return -1;
    FILE *f = fopen(path, "wb");
    if (!f) return -2;
    uint64_t n = h->size();
    uint64_t hdr[8] = {kMagic, (uint64_t)h->dim, (uint64_t)h->M,
                       (uint64_t)h->Mmax0, (uint64_t)h->efc, n,
                       (uint64_t)(h->entry + 1),
                       (uint64_t)(h->max_level + 1)};
    fwrite(hdr, sizeof hdr, 1, f);
    fwrite(h->data.data(), sizeof(float), n * h->dim, f);
    fwrite(h->labels.data(), sizeof(int64_t), n, f);
    fwrite(h->levels.data(), sizeof(int), n, f);
    for (uint64_t i = 0; i < n; ++i) {
        uint32_t nl = h->links[i].size();
        fwrite(&nl, sizeof nl, 1, f);
        for (const auto &layer : h->links[i]) {
            uint32_t m = layer.size();
            fwrite(&m, sizeof m, 1, f);
            fwrite(layer.data(), sizeof(int), m, f);
        }
    }
    fclose(f);
    return (int64_t)n;
}

int64_t cham_hnsw_load(const char *path) try {
    FILE *f = fopen(path, "rb");
    if (!f) return -2;
    // header fields are untrusted: bound every count against sane limits
    // and against the actual remaining file size BEFORE any resize, so a
    // corrupt/truncated file returns an error code instead of triggering a
    // huge allocation (std::bad_alloc aborts across the ctypes boundary)
    // or out-of-bounds graph walks on the first search.
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -3; }
    const int64_t fsize = ftell(f);
    if (fsize < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return -3; }
    uint64_t hdr[8];
    if (fread(hdr, sizeof hdr, 1, f) != 1 || hdr[0] != kMagic) {
        fclose(f);
        return -3;
    }
    const uint64_t dim = hdr[1], M = hdr[2], Mmax0 = hdr[3], efc = hdr[4];
    const uint64_t n = hdr[5];
    const int64_t entry = (int64_t)hdr[6] - 1;
    const int64_t max_level = (int64_t)hdr[7] - 1;
    const uint64_t remain = (uint64_t)fsize - sizeof hdr;
    const bool hdr_ok =
        dim >= 1 && dim <= (1u << 16) &&
        M >= 2 && M <= 4096 && Mmax0 >= M && Mmax0 <= 8192 &&
        efc >= 1 && efc <= (1u << 20) &&
        // fixed-size payload (vectors + labels + levels) must fit the file
        n <= remain / (dim * sizeof(float) + sizeof(int64_t) + sizeof(int)) &&
        max_level >= -1 && max_level <= 64 &&
        ((n == 0 && entry == -1) || (entry >= 0 && (uint64_t)entry < n));
    if (!hdr_ok) {
        fclose(f);
        return -3;
    }
    auto *h = new HNSW();
    h->dim = (int)dim;
    h->M = (int)M;
    h->Mmax0 = (int)Mmax0;
    h->efc = (int)efc;
    h->entry = (int)entry;
    h->max_level = (int)max_level;
    h->mult = 1.0 / std::log((double)h->M);
    h->data.resize(n * h->dim);
    h->labels.resize(n);
    h->levels.resize(n);
    bool ok = fread(h->data.data(), sizeof(float), n * h->dim, f)
                  == n * (uint64_t)h->dim
              && fread(h->labels.data(), sizeof(int64_t), n, f) == n
              && fread(h->levels.data(), sizeof(int), n, f) == n;
    h->links.resize(n);
    for (uint64_t i = 0; ok && i < n; ++i) {
        uint32_t nl = 0;
        ok = fread(&nl, sizeof nl, 1, f) == 1 && nl <= 65u;
        for (uint32_t l = 0; ok && l < nl; ++l) {
            uint32_t m = 0;
            ok = fread(&m, sizeof m, 1, f) == 1 && m <= Mmax0;
            if (!ok) break;
            if (l >= h->links[i].size()) h->links[i].resize(nl);
            h->links[i][l].resize(m);
            if (m)
                ok = fread(h->links[i][l].data(), sizeof(int), m, f) == m;
            for (uint32_t t = 0; ok && t < m; ++t)
                ok = h->links[i][l][t] >= 0 && (uint64_t)h->links[i][l][t] < n;
        }
    }
    fclose(f);
    // graph-consistency post-pass: search() walks links[node][l] for every
    // node it reaches at layer l, so (a) the entry point must carry
    // max_level+1 layers, (b) per-node layer counts must match the levels
    // array (links.size() == levels+1 >= 1 by construction in add_one),
    // and (c) any neighbor referenced at layer l must itself have a
    // layer-l list — otherwise a corrupt file that passes the id bounds
    // check still drives an out-of-bounds vector access on first search.
    if (ok && n > 0)
        ok = h->links[(size_t)entry].size() == (size_t)max_level + 1;
    for (uint64_t i = 0; ok && i < n; ++i) {
        const auto &ls = h->links[i];
        ok = !ls.empty() && h->levels[i] >= 0 &&
             ls.size() == (size_t)h->levels[i] + 1;
        for (size_t l = 0; ok && l < ls.size(); ++l)
            for (int nb : ls[l])
                if (h->links[(size_t)nb].size() <= l) { ok = false; break; }
    }
    if (!ok) {
        delete h;
        return -4;
    }
    return register_index(h);
} catch (const std::bad_alloc &) {
    return -5;
}

void cham_hnsw_free(int64_t handle) {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_handles.find(handle);
    if (it != g_handles.end()) {
        delete it->second;
        g_handles.erase(it);
    }
}

}  // extern "C"
