// Native combinatorial kernels for the TPU framework.
//
// The reference delegates these to external pybind11 wheels (nifty's
// Kernighan-Lin / greedy-additive multicut, boost union-find, affogato's
// mutex watershed -- SURVEY.md section 2.3).  Combinatorial, data-dependent
// algorithms do not map onto the MXU, so they live here as first-party C++
// with a flat extern "C" array API loaded via ctypes (no pybind11 in the
// image).  The device side produces the edge lists; these kernels consume
// them on the host CPU.
//
// Build: g++ -O3 -march=native -shared -fPIC solvers.cpp -o libctt_native.so

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <tuple>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// union-find with path halving + union by size
// ---------------------------------------------------------------------------
struct Ufd {
    std::vector<int64_t> parent;
    std::vector<int64_t> size;
    explicit Ufd(int64_t n) : parent(n), size(n, 1) {
        std::iota(parent.begin(), parent.end(), 0);
    }
    int64_t find(int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }
    // returns the surviving root, or -1 if already joined
    int64_t merge(int64_t a, int64_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return -1;
        if (size[a] < size[b]) std::swap(a, b);
        parent[b] = a;
        size[a] += size[b];
        return a;
    }
};

// multicut objective: sum of costs over cut edges (minimized)
double objective(int64_t n_edges, const int64_t* uv, const double* costs,
                 const uint64_t* labels) {
    double e = 0.0;
    for (int64_t i = 0; i < n_edges; ++i) {
        if (labels[uv[2 * i]] != labels[uv[2 * i + 1]]) e += costs[i];
    }
    return e;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// union-find over pair lists (boost_ufd replacement,
// reference: multicut/reduce_problem.py:161, thresholded_components)
// ---------------------------------------------------------------------------
// labels_out[i] = root of node i after merging all pairs.
void ufd_merge_pairs(int64_t n_nodes, int64_t n_pairs, const int64_t* pairs,
                     uint64_t* labels_out) {
    Ufd ufd(n_nodes);
    for (int64_t i = 0; i < n_pairs; ++i) {
        ufd.merge(pairs[2 * i], pairs[2 * i + 1]);
    }
    for (int64_t i = 0; i < n_nodes; ++i) {
        labels_out[i] = static_cast<uint64_t>(ufd.find(i));
    }
}

// ---------------------------------------------------------------------------
// greedy additive edge contraction (GAEC)
// (nifty.graph.opt.multicut greedyAdditive replacement)
// ---------------------------------------------------------------------------
// Contract the most attractive (largest positive accumulated cost) edge until
// none remains.  Dynamic graph as per-node hash maps, lazy priority queue.
// labels_out: dense component labels in [0, n_components).
int64_t mc_gaec(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                const double* costs, uint64_t* labels_out) {
    std::vector<std::unordered_map<int64_t, double>> adj(n_nodes);
    for (int64_t i = 0; i < n_edges; ++i) {
        int64_t u = uv[2 * i], v = uv[2 * i + 1];
        if (u == v) continue;
        adj[u][v] += costs[i];
        adj[v][u] += costs[i];
    }
    using Entry = std::tuple<double, int64_t, int64_t>;  // (w, u, v)
    std::priority_queue<Entry> pq;
    for (int64_t u = 0; u < n_nodes; ++u) {
        for (const auto& kv : adj[u]) {
            if (kv.first > u && kv.second > 0) pq.emplace(kv.second, u, kv.first);
        }
    }
    Ufd ufd(n_nodes);
    while (!pq.empty()) {
        auto [w, u, v] = pq.top();
        pq.pop();
        if (w <= 0) break;
        int64_t ru = ufd.find(u), rv = ufd.find(v);
        // stale entry: nodes already merged or weight changed
        if (ru == rv) continue;
        auto it = adj[ru].find(rv);
        if (it == adj[ru].end() || it->second != w || u != std::min(ru, rv) ||
            v != std::max(ru, rv)) {
            // re-push the current live pair if still attractive
            if (it != adj[ru].end() && it->second > 0) {
                pq.emplace(it->second, std::min(ru, rv), std::max(ru, rv));
            }
            continue;
        }
        // contract rv into ru (keep the larger adjacency)
        if (adj[ru].size() < adj[rv].size()) std::swap(ru, rv);
        int64_t rw = ufd.merge(ru, rv);
        if (rw != ru) std::swap(ru, rv);  // ufd chose the other root
        adj[ru].erase(rv);
        adj[rv].erase(ru);
        for (const auto& kv : adj[rv]) {
            int64_t n = kv.first;
            double nw = kv.second;
            adj[n].erase(rv);
            double& acc = adj[ru][n];
            acc += nw;
            adj[n][ru] = acc;
            if (acc > 0) pq.emplace(acc, std::min(ru, n), std::max(ru, n));
        }
        adj[rv].clear();
    }
    // dense component labels
    std::unordered_map<int64_t, uint64_t> remap;
    uint64_t next = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t r = ufd.find(i);
        auto it = remap.find(r);
        if (it == remap.end()) it = remap.emplace(r, next++).first;
        labels_out[i] = it->second;
    }
    return static_cast<int64_t>(next);
}

// ---------------------------------------------------------------------------
// Kernighan-Lin-style greedy node moves
// (nifty multicutKernighanLin replacement: local search with joins)
// ---------------------------------------------------------------------------
// Improve labels_inout by repeatedly moving single nodes to the neighboring
// component (or a fresh singleton) with the best objective gain, until a full
// pass yields no improvement or max_passes is hit.  Returns passes used.
int64_t mc_kl_refine(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                     const double* costs, uint64_t* labels, int64_t max_passes,
                     double time_limit) {
    const auto deadline = std::chrono::steady_clock::now() +
        std::chrono::duration<double>(time_limit > 0 ? time_limit : 1e18);
    // CSR adjacency
    std::vector<int64_t> deg(n_nodes, 0);
    for (int64_t i = 0; i < n_edges; ++i) {
        ++deg[uv[2 * i]];
        ++deg[uv[2 * i + 1]];
    }
    std::vector<int64_t> off(n_nodes + 1, 0);
    for (int64_t i = 0; i < n_nodes; ++i) off[i + 1] = off[i] + deg[i];
    std::vector<int64_t> nbr(off[n_nodes]);
    std::vector<double> nw(off[n_nodes]);
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (int64_t i = 0; i < n_edges; ++i) {
        int64_t u = uv[2 * i], v = uv[2 * i + 1];
        nbr[cur[u]] = v;
        nw[cur[u]++] = costs[i];
        nbr[cur[v]] = u;
        nw[cur[v]++] = costs[i];
    }
    uint64_t next_label = 0;
    for (int64_t i = 0; i < n_nodes; ++i) next_label = std::max(next_label, labels[i] + 1);

    std::unordered_map<uint64_t, double> comp_w;
    int64_t pass = 0;
    for (; pass < max_passes; ++pass) {
        if (std::chrono::steady_clock::now() > deadline) break;
        bool improved = false;
        for (int64_t x = 0; x < n_nodes; ++x) {
            if (off[x + 1] == off[x]) continue;
            comp_w.clear();
            for (int64_t j = off[x]; j < off[x + 1]; ++j) {
                comp_w[labels[nbr[j]]] += nw[j];
            }
            uint64_t own = labels[x];
            double w_own = 0.0;
            auto it_own = comp_w.find(own);
            if (it_own != comp_w.end()) w_own = it_own->second;
            // candidate: fresh singleton (gain = w_own if w_own < 0)
            double best_gain = -w_own;  // delta objective of leaving to empty
            uint64_t best_label = next_label;
            for (const auto& kv : comp_w) {
                if (kv.first == own) continue;
                double gain = kv.second - w_own;  // uncut B, cut own
                if (gain > best_gain + 1e-12) {
                    best_gain = gain;
                    best_label = kv.first;
                }
            }
            if (best_gain > 1e-12) {
                labels[x] = best_label;
                if (best_label == next_label) ++next_label;
                improved = true;
            }
        }
        if (!improved) break;
    }
    return pass;
}

double mc_objective(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                    const double* costs, const uint64_t* labels) {
    (void)n_nodes;
    return objective(n_edges, uv, costs, labels);
}

// ---------------------------------------------------------------------------
// mutex watershed (affogato compute_mws_clustering replacement)
// ---------------------------------------------------------------------------
// Kruskal-style: process attractive and mutex (repulsive) edges jointly in
// descending weight order; attractive edges union unless a mutex constraint
// exists between the roots; mutex edges install constraints.
int64_t mws_clustering(int64_t n_nodes, int64_t n_attr, const int64_t* uv_attr,
                       const double* w_attr, int64_t n_mutex,
                       const int64_t* uv_mutex, const double* w_mutex,
                       uint64_t* labels_out) {
    struct E {
        double w;
        int64_t u, v;
        bool mutex;
    };
    std::vector<E> edges;
    edges.reserve(n_attr + n_mutex);
    for (int64_t i = 0; i < n_attr; ++i) {
        edges.push_back({w_attr[i], uv_attr[2 * i], uv_attr[2 * i + 1], false});
    }
    for (int64_t i = 0; i < n_mutex; ++i) {
        edges.push_back({w_mutex[i], uv_mutex[2 * i], uv_mutex[2 * i + 1], true});
    }
    std::stable_sort(edges.begin(), edges.end(),
                     [](const E& a, const E& b) { return a.w > b.w; });

    Ufd ufd(n_nodes);
    // mutex constraints per root (merged small-into-large on union)
    std::vector<std::unordered_set<int64_t>> mtx(n_nodes);
    auto have_mutex = [&](int64_t ra, int64_t rb) {
        const auto& small = mtx[ra].size() < mtx[rb].size() ? mtx[ra] : mtx[rb];
        int64_t other = (&small == &mtx[ra]) ? rb : ra;
        return small.count(other) > 0;
    };
    for (const auto& e : edges) {
        int64_t ru = ufd.find(e.u), rv = ufd.find(e.v);
        if (ru == rv) continue;
        if (e.mutex) {
            mtx[ru].insert(rv);
            mtx[rv].insert(ru);
        } else {
            if (have_mutex(ru, rv)) continue;
            int64_t keep = ufd.merge(ru, rv);
            int64_t gone = keep == ru ? rv : ru;
            // rewire the vanished root's constraints onto the survivor.
            // NO small-into-large swap here: swapping the two sets breaks
            // the back-pointer symmetry (partners of the survivor would be
            // "rewired" as if they pointed at the vanished root), leaving
            // stale entries that eventually put a root inside its own set
            // — and erasing an element of the set being iterated is UB
            // (observed as a segfault on near-uniform affinity fields)
            for (int64_t c : mtx[gone]) {
                mtx[c].erase(gone);
                if (c != keep) {
                    mtx[c].insert(keep);
                    mtx[keep].insert(c);
                }
            }
            mtx[gone].clear();
        }
    }
    std::unordered_map<int64_t, uint64_t> remap;
    uint64_t next = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t r = ufd.find(i);
        auto it = remap.find(r);
        if (it == remap.end()) it = remap.emplace(r, next++).first;
        labels_out[i] = it->second;
    }
    return static_cast<int64_t>(next);
}

// Mutex-watershed scan over a PRE-SORTED edge stream: the caller (the
// device path) already extracted the edges and sorted them by descending
// priority on the accelerator, so this is only the inherently sequential
// constrained union-find — no 24-byte edge structs, no host sort (the
// std::stable_sort above is the dominant cost of mws_clustering at
// tens of millions of edges).  u[i] < 0 marks a dropped edge (the
// zero-affinity filter applied on device).  mutex_flag[i] != 0 marks a
// mutex (repulsive) edge.
int64_t mws_clustering_sorted(int64_t n_nodes, int64_t n_edges,
                              const int32_t* u, const int32_t* v,
                              const uint8_t* mutex_flag,
                              uint64_t* labels_out) {
    Ufd ufd(n_nodes);
    std::vector<std::unordered_set<int64_t>> mtx(n_nodes);
    auto have_mutex = [&](int64_t ra, int64_t rb) {
        const auto& small = mtx[ra].size() < mtx[rb].size() ? mtx[ra] : mtx[rb];
        int64_t other = (&small == &mtx[ra]) ? rb : ra;
        return small.count(other) > 0;
    };
    for (int64_t i = 0; i < n_edges; ++i) {
        if (u[i] < 0) continue;
        int64_t ru = ufd.find(u[i]), rv = ufd.find(v[i]);
        if (ru == rv) continue;
        if (mutex_flag[i]) {
            mtx[ru].insert(rv);
            mtx[rv].insert(ru);
        } else {
            if (have_mutex(ru, rv)) continue;
            int64_t keep = ufd.merge(ru, rv);
            int64_t gone = keep == ru ? rv : ru;
            // same rewiring discipline as mws_clustering above (no
            // small-into-large swap: it breaks back-pointer symmetry)
            for (int64_t c : mtx[gone]) {
                mtx[c].erase(gone);
                if (c != keep) {
                    mtx[c].insert(keep);
                    mtx[keep].insert(c);
                }
            }
            mtx[gone].clear();
        }
    }
    std::unordered_map<int64_t, uint64_t> remap;
    uint64_t next = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t r = ufd.find(i);
        auto it = remap.find(r);
        if (it == remap.end()) it = remap.emplace(r, next++).first;
        labels_out[i] = it->second;
    }
    return static_cast<int64_t>(next);
}

// ---------------------------------------------------------------------------
// lifted multicut (nifty.graph.opt.lifted_multicut replacement,
// reference: utils/segmentation_utils.py:153-223)
// ---------------------------------------------------------------------------
// Greedy additive contraction for the lifted objective: only LOCAL edges are
// contractible (components must stay connected in the local graph), but the
// contraction priority of a local pair includes the accumulated LIFTED cost
// between the two components.
int64_t lmc_gaec(int64_t n_nodes, int64_t n_local, const int64_t* uv_local,
                 const double* costs_local, int64_t n_lifted,
                 const int64_t* uv_lifted, const double* costs_lifted,
                 uint64_t* labels_out) {
    std::vector<std::unordered_map<int64_t, double>> adj(n_nodes);   // local
    std::vector<std::unordered_map<int64_t, double>> lift(n_nodes);  // lifted
    for (int64_t i = 0; i < n_local; ++i) {
        int64_t u = uv_local[2 * i], v = uv_local[2 * i + 1];
        if (u == v) continue;
        adj[u][v] += costs_local[i];
        adj[v][u] += costs_local[i];
    }
    for (int64_t i = 0; i < n_lifted; ++i) {
        int64_t u = uv_lifted[2 * i], v = uv_lifted[2 * i + 1];
        if (u == v) continue;
        lift[u][v] += costs_lifted[i];
        lift[v][u] += costs_lifted[i];
    }
    auto pair_w = [&](int64_t ru, int64_t rv) {
        double w = 0.0;
        auto it = adj[ru].find(rv);
        if (it != adj[ru].end()) w += it->second;
        auto jt = lift[ru].find(rv);
        if (jt != lift[ru].end()) w += jt->second;
        return w;
    };
    using Entry = std::tuple<double, int64_t, int64_t>;
    std::priority_queue<Entry> pq;
    for (int64_t u = 0; u < n_nodes; ++u) {
        for (const auto& kv : adj[u]) {
            if (kv.first > u) {
                double w = pair_w(u, kv.first);
                if (w > 0) pq.emplace(w, u, kv.first);
            }
        }
    }
    Ufd ufd(n_nodes);
    while (!pq.empty()) {
        auto [w, u, v] = pq.top();
        pq.pop();
        if (w <= 0) break;
        int64_t ru = ufd.find(u), rv = ufd.find(v);
        if (ru == rv) continue;
        if (adj[ru].find(rv) == adj[ru].end()) continue;  // no local edge
        double live = pair_w(ru, rv);
        if (live != w || u != std::min(ru, rv) || v != std::max(ru, rv)) {
            if (live > 0) pq.emplace(live, std::min(ru, rv), std::max(ru, rv));
            continue;
        }
        if (adj[ru].size() + lift[ru].size() <
            adj[rv].size() + lift[rv].size()) {
            std::swap(ru, rv);
        }
        int64_t rw = ufd.merge(ru, rv);
        if (rw != ru) std::swap(ru, rv);
        adj[ru].erase(rv);
        adj[rv].erase(ru);
        lift[ru].erase(rv);
        lift[rv].erase(ru);
        for (const auto& kv : adj[rv]) {
            int64_t n = kv.first;
            adj[n].erase(rv);
            double& acc = adj[ru][n];
            acc += kv.second;
            adj[n][ru] = acc;
        }
        for (const auto& kv : lift[rv]) {
            int64_t n = kv.first;
            lift[n].erase(rv);
            double& acc = lift[ru][n];
            acc += kv.second;
            lift[n][ru] = acc;
        }
        adj[rv].clear();
        lift[rv].clear();
        for (const auto& kv : adj[ru]) {  // refresh priorities of live pairs
            double nw = pair_w(ru, kv.first);
            if (nw > 0) {
                pq.emplace(nw, std::min(ru, kv.first), std::max(ru, kv.first));
            }
        }
    }
    std::unordered_map<int64_t, uint64_t> remap;
    uint64_t next = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t r = ufd.find(i);
        auto it = remap.find(r);
        if (it == remap.end()) it = remap.emplace(r, next++).first;
        labels_out[i] = it->second;
    }
    return static_cast<int64_t>(next);
}

// Kernighan-Lin-style refinement for the lifted objective: node moves among
// LOCAL-neighbor components (or a fresh singleton), gains include lifted
// contributions.
int64_t lmc_kl_refine(int64_t n_nodes, int64_t n_local, const int64_t* uv_local,
                      const double* costs_local, int64_t n_lifted,
                      const int64_t* uv_lifted, const double* costs_lifted,
                      uint64_t* labels, int64_t max_passes,
                      double time_limit) {
    const auto deadline = std::chrono::steady_clock::now() +
        std::chrono::duration<double>(time_limit > 0 ? time_limit : 1e18);
    auto build_csr = [n_nodes](int64_t n_e, const int64_t* uv, const double* c,
                               std::vector<int64_t>& off,
                               std::vector<int64_t>& nbr,
                               std::vector<double>& nw) {
        std::vector<int64_t> deg(n_nodes, 0);
        for (int64_t i = 0; i < n_e; ++i) {
            ++deg[uv[2 * i]];
            ++deg[uv[2 * i + 1]];
        }
        off.assign(n_nodes + 1, 0);
        for (int64_t i = 0; i < n_nodes; ++i) off[i + 1] = off[i] + deg[i];
        nbr.resize(off[n_nodes]);
        nw.resize(off[n_nodes]);
        std::vector<int64_t> cur(off.begin(), off.end() - 1);
        for (int64_t i = 0; i < n_e; ++i) {
            int64_t u = uv[2 * i], v = uv[2 * i + 1];
            nbr[cur[u]] = v;
            nw[cur[u]++] = c[i];
            nbr[cur[v]] = u;
            nw[cur[v]++] = c[i];
        }
    };
    std::vector<int64_t> loff, lnbr, toff, tnbr;
    std::vector<double> lw, tw;
    build_csr(n_local, uv_local, costs_local, loff, lnbr, lw);
    build_csr(n_lifted, uv_lifted, costs_lifted, toff, tnbr, tw);

    uint64_t next_label = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        next_label = std::max(next_label, labels[i] + 1);
    }
    std::unordered_map<uint64_t, double> comp_w;
    std::unordered_set<uint64_t> local_comps;
    int64_t pass = 0;
    for (; pass < max_passes; ++pass) {
        if (std::chrono::steady_clock::now() > deadline) break;
        bool improved = false;
        for (int64_t x = 0; x < n_nodes; ++x) {
            if (loff[x + 1] == loff[x]) continue;
            comp_w.clear();
            local_comps.clear();
            for (int64_t j = loff[x]; j < loff[x + 1]; ++j) {
                comp_w[labels[lnbr[j]]] += lw[j];
                local_comps.insert(labels[lnbr[j]]);
            }
            for (int64_t j = toff[x]; j < toff[x + 1]; ++j) {
                comp_w[labels[tnbr[j]]] += tw[j];
            }
            uint64_t own = labels[x];
            double w_own = 0.0;
            auto it_own = comp_w.find(own);
            if (it_own != comp_w.end()) w_own = it_own->second;
            double best_gain = -w_own;  // leave to a fresh singleton
            uint64_t best_label = next_label;
            for (uint64_t cand : local_comps) {
                if (cand == own) continue;
                double gain = comp_w[cand] - w_own;
                if (gain > best_gain + 1e-12) {
                    best_gain = gain;
                    best_label = cand;
                }
            }
            if (best_gain > 1e-12) {
                labels[x] = best_label;
                if (best_label == next_label) ++next_label;
                improved = true;
            }
        }
        if (!improved) break;
    }
    return pass;
}

// ---------------------------------------------------------------------------
// edge-weighted agglomerative clustering
// (nifty.graph.agglo edgeWeighted/mala cluster-policy replacement,
// reference: utils/segmentation_utils.py:298-321, watershed/agglomerate.py)
// ---------------------------------------------------------------------------
// Merge the lowest-weight edge (weight = size-weighted mean boundary
// probability, maintained under contraction) while it stays below
// `threshold`.  `size_regularizer` > 0 biases against growing large nodes:
// priority = w * (harmonic-mean of node sizes / 2)^size_regularizer —
// the mala-style size regularization.
int64_t agglomerate_edge_weighted(int64_t n_nodes, int64_t n_edges,
                                  const int64_t* uv, const double* weights,
                                  const double* edge_sizes,
                                  const double* node_sizes, double threshold,
                                  double size_regularizer,
                                  uint64_t* labels_out) {
    // adjacency with accumulated (weight*size, size) per live pair
    struct Acc {
        double ws, s;
    };
    std::vector<std::unordered_map<int64_t, Acc>> adj(n_nodes);
    for (int64_t i = 0; i < n_edges; ++i) {
        int64_t u = uv[2 * i], v = uv[2 * i + 1];
        if (u == v) continue;
        double s = edge_sizes ? edge_sizes[i] : 1.0;
        Acc& a = adj[u][v];
        a.ws += weights[i] * s;
        a.s += s;
        adj[v][u] = a;
    }
    std::vector<double> nsize(n_nodes, 1.0);
    if (node_sizes) nsize.assign(node_sizes, node_sizes + n_nodes);

    Ufd ufd(n_nodes);
    auto priority = [&](int64_t ru, int64_t rv, const Acc& a) {
        double p = a.ws / a.s;
        if (size_regularizer > 0.0) {
            double hm = 2.0 / (1.0 / nsize[ru] + 1.0 / nsize[rv]);
            p *= std::pow(hm / 2.0, size_regularizer);
        }
        return p;
    };
    using Entry = std::tuple<double, int64_t, int64_t>;  // (-p, u, v): min-heap
    std::priority_queue<Entry> pq;
    for (int64_t u = 0; u < n_nodes; ++u) {
        for (const auto& kv : adj[u]) {
            if (kv.first > u) pq.emplace(-priority(u, kv.first, kv.second), u, kv.first);
        }
    }
    while (!pq.empty()) {
        auto [np_, u, v] = pq.top();
        pq.pop();
        double p = -np_;
        if (p >= threshold) break;
        int64_t ru = ufd.find(u), rv = ufd.find(v);
        if (ru == rv) continue;
        auto it = adj[ru].find(rv);
        if (it == adj[ru].end()) continue;
        double live_p = priority(ru, rv, it->second);
        if (live_p != p || u != std::min(ru, rv) || v != std::max(ru, rv)) {
            // stale: re-push the live pair (it may still be below threshold)
            pq.emplace(-live_p, std::min(ru, rv), std::max(ru, rv));
            continue;
        }
        if (adj[ru].size() < adj[rv].size()) std::swap(ru, rv);
        int64_t rw = ufd.merge(ru, rv);
        if (rw != ru) std::swap(ru, rv);
        nsize[ru] += nsize[rv];
        adj[ru].erase(rv);
        adj[rv].erase(ru);
        for (const auto& kv : adj[rv]) {
            int64_t n = kv.first;
            adj[n].erase(rv);
            Acc& acc = adj[ru][n];
            acc.ws += kv.second.ws;
            acc.s += kv.second.s;
            adj[n][ru] = acc;
            int64_t rn = ufd.find(n);
            pq.emplace(-priority(ru, rn, acc), std::min(ru, n), std::max(ru, n));
        }
        adj[rv].clear();
    }
    std::unordered_map<int64_t, uint64_t> remap;
    uint64_t next = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t r = ufd.find(i);
        auto it = remap.find(r);
        if (it == remap.end()) it = remap.emplace(r, next++).first;
        labels_out[i] = it->second;
    }
    return static_cast<int64_t>(next);
}

// edge-weighted seeded watershed on a graph
// (nifty.graph.edgeWeightedWatershedsSegmentation replacement,
// reference: postprocess/graph_watershed_assignments.py:172)
// Grows seed labels along maximum-weight edges (Prim-style).
void graph_watershed(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                     const double* weights, uint64_t* seeds_inout) {
    std::vector<int64_t> deg(n_nodes, 0);
    for (int64_t i = 0; i < n_edges; ++i) {
        ++deg[uv[2 * i]];
        ++deg[uv[2 * i + 1]];
    }
    std::vector<int64_t> off(n_nodes + 1, 0);
    for (int64_t i = 0; i < n_nodes; ++i) off[i + 1] = off[i] + deg[i];
    std::vector<int64_t> nbr(off[n_nodes]);
    std::vector<double> nw(off[n_nodes]);
    {
        std::vector<int64_t> cur(off.begin(), off.end() - 1);
        for (int64_t i = 0; i < n_edges; ++i) {
            int64_t u = uv[2 * i], v = uv[2 * i + 1];
            nbr[cur[u]] = v;
            nw[cur[u]++] = weights[i];
            nbr[cur[v]] = u;
            nw[cur[v]++] = weights[i];
        }
    }
    using Entry = std::tuple<double, int64_t, int64_t>;  // (w, from, to)
    std::priority_queue<Entry> pq;
    for (int64_t i = 0; i < n_nodes; ++i) {
        if (seeds_inout[i] == 0) continue;
        for (int64_t j = off[i]; j < off[i + 1]; ++j) {
            if (seeds_inout[nbr[j]] == 0) pq.emplace(nw[j], i, nbr[j]);
        }
    }
    while (!pq.empty()) {
        auto [w, from, to] = pq.top();
        pq.pop();
        if (seeds_inout[to] != 0) continue;
        seeds_inout[to] = seeds_inout[from];
        for (int64_t j = off[to]; j < off[to + 1]; ++j) {
            if (seeds_inout[nbr[j]] == 0) pq.emplace(nw[j], to, nbr[j]);
        }
    }
}

// ---------------------------------------------------------------------------
// 3d skeletonization by topological thinning
// (skimage.morphology.skeletonize_3d replacement for the skeletons
// component, reference: skeletons/skeletonize.py:129-157; skimage is not in
// the image, so the thinning is first-party)
// ---------------------------------------------------------------------------
namespace {

inline int manhattan(int i) {  // local 3x3x3 index -> |dz|+|dy|+|dx|
    int z = i / 9 - 1, y = (i / 3) % 3 - 1, x = i % 3 - 1;
    return std::abs(z) + std::abs(y) + std::abs(x);
}

// number of 26-connected components of OBJECT voxels in the 26-neighborhood
// (center excluded)
int cc_object_26(const bool* m) {
    int comp[27];
    for (int i = 0; i < 27; ++i) comp[i] = -1;
    int n_comp = 0;
    for (int seed = 0; seed < 27; ++seed) {
        if (seed == 13 || !m[seed] || comp[seed] != -1) continue;
        int stack[27], sp = 0;
        stack[sp++] = seed;
        comp[seed] = n_comp;
        while (sp) {
            int cur = stack[--sp];
            int cz = cur / 9, cy = (cur / 3) % 3, cx = cur % 3;
            for (int oz = -1; oz <= 1; ++oz)
                for (int oy = -1; oy <= 1; ++oy)
                    for (int ox = -1; ox <= 1; ++ox) {
                        if (!(oz | oy | ox)) continue;
                        int nz = cz + oz, ny = cy + oy, nx = cx + ox;
                        if (nz < 0 || nz > 2 || ny < 0 || ny > 2 ||
                            nx < 0 || nx > 2) continue;
                        int nidx = nz * 9 + ny * 3 + nx;
                        if (nidx == 13 || !m[nidx] || comp[nidx] != -1)
                            continue;
                        comp[nidx] = n_comp;
                        stack[sp++] = nidx;
                    }
        }
        ++n_comp;
    }
    return n_comp;
}

// number of 6-connected components of BACKGROUND voxels in the
// 18-neighborhood that contain a face-neighbor of the center
int cc_background_6(const bool* m) {
    int comp[27];
    for (int i = 0; i < 27; ++i) comp[i] = -1;
    int n_comp = 0;
    for (int seed = 0; seed < 27; ++seed) {
        if (seed == 13 || m[seed] || comp[seed] != -1) continue;
        if (manhattan(seed) > 2) continue;  // corners not in N18
        int stack[27], sp = 0;
        stack[sp++] = seed;
        comp[seed] = 0;
        bool touches = manhattan(seed) == 1;
        while (sp) {
            int cur = stack[--sp];
            int cz = cur / 9, cy = (cur / 3) % 3, cx = cur % 3;
            const int d6[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                  {0, 1, 0},  {0, 0, -1}, {0, 0, 1}};
            for (const auto& d : d6) {
                int nz = cz + d[0], ny = cy + d[1], nx = cx + d[2];
                if (nz < 0 || nz > 2 || ny < 0 || ny > 2 ||
                    nx < 0 || nx > 2) continue;
                int nidx = nz * 9 + ny * 3 + nx;
                if (nidx == 13 || m[nidx] || comp[nidx] != -1) continue;
                if (manhattan(nidx) > 2) continue;
                comp[nidx] = 0;
                stack[sp++] = nidx;
                if (manhattan(nidx) == 1) touches = true;
            }
        }
        if (touches) ++n_comp;
    }
    return n_comp;
}

}  // namespace

// Thin a binary volume to a 1-voxel-wide skeleton.  `vol` is 0/1 uint8 of
// shape (sz, sy, sx), modified in place.  Border-peeling with the standard
// simple-point test (object stays 26-connected, background stays
// 6-connected across the deletion) and curve-endpoint preservation.
void skeletonize_3d(uint8_t* vol, int64_t sz, int64_t sy, int64_t sx) {
    auto at = [&](int64_t z, int64_t y, int64_t x) -> uint8_t {
        if (z < 0 || z >= sz || y < 0 || y >= sy || x < 0 || x >= sx)
            return 0;
        return vol[z * sy * sx + y * sx + x];
    };
    std::vector<int64_t> candidates;
    bool changed = true;
    while (changed) {
        changed = false;
        // six directional sub-iterations keep the skeleton centered
        const int dirs[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                {0, 1, 0},  {0, 0, -1}, {0, 0, 1}};
        for (const auto& d : dirs) {
            candidates.clear();
            for (int64_t z = 0; z < sz; ++z)
                for (int64_t y = 0; y < sy; ++y)
                    for (int64_t x = 0; x < sx; ++x) {
                        int64_t idx = z * sy * sx + y * sx + x;
                        if (!vol[idx]) continue;
                        // border in direction d
                        if (at(z + d[0], y + d[1], x + d[2])) continue;
                        // endpoint: exactly one object neighbor -> keep
                        int n_obj = 0;
                        for (int oz = -1; oz <= 1; ++oz)
                            for (int oy = -1; oy <= 1; ++oy)
                                for (int ox = -1; ox <= 1; ++ox)
                                    if ((oz | oy | ox) &&
                                        at(z + oz, y + oy, x + ox))
                                        ++n_obj;
                        if (n_obj <= 1) continue;
                        // simple point test on the 3x3x3 neighborhood
                        bool m[27];
                        for (int oz = -1; oz <= 1; ++oz)
                            for (int oy = -1; oy <= 1; ++oy)
                                for (int ox = -1; ox <= 1; ++ox)
                                    m[(oz + 1) * 9 + (oy + 1) * 3 + ox + 1] =
                                        at(z + oz, y + oy, x + ox) != 0;
                        if (cc_object_26(m) != 1) continue;
                        if (cc_background_6(m) != 1) continue;
                        candidates.push_back(idx);
                    }
            // delete sequentially, re-checking the simple-point condition
            // (a neighbor deleted earlier in this pass can change it)
            for (int64_t idx : candidates) {
                int64_t z = idx / (sy * sx), y = (idx / sx) % sy, x = idx % sx;
                int n_obj = 0;
                for (int oz = -1; oz <= 1; ++oz)
                    for (int oy = -1; oy <= 1; ++oy)
                        for (int ox = -1; ox <= 1; ++ox)
                            if ((oz | oy | ox) && at(z + oz, y + oy, x + ox))
                                ++n_obj;
                if (n_obj <= 1) continue;
                bool m[27];
                for (int oz = -1; oz <= 1; ++oz)
                    for (int oy = -1; oy <= 1; ++oy)
                        for (int ox = -1; ox <= 1; ++ox)
                            m[(oz + 1) * 9 + (oy + 1) * 3 + ox + 1] =
                                at(z + oz, y + oy, x + ox) != 0;
                if (cc_object_26(m) != 1) continue;
                if (cc_background_6(m) != 1) continue;
                vol[idx] = 0;
                changed = true;
            }
        }
    }
}

// Seeded 3D watershed by priority flood over a uint8 height map — the
// vigra watershedsNew algorithm (reference: utils/volume_utils.py:124
// `vigra.analysis.watershedsNew`): seeds grow in increasing height order,
// FIFO within a level, 6-connectivity.  A monotone 256-bucket queue makes
// it exact O(n) without a heap.  `labels` carries the seeds in (0 = free)
// and the full labeling out; every voxel connected to a seed gets labeled.
void seeded_watershed_u8(const uint8_t* height, int64_t sz, int64_t sy,
                         int64_t sx, int64_t* labels) {
    const int64_t n = sz * sy * sx;
    std::vector<std::vector<int64_t>> buckets(256);
    for (int64_t i = 0; i < n; ++i)
        if (labels[i] > 0) buckets[height[i]].push_back(i);
    const int64_t strides[3] = {sy * sx, sx, 1};
    const int64_t dims[3] = {sz, sy, sx};
    for (int level = 0; level < 256; ++level) {
        auto& q = buckets[level];
        // q grows while we scan it (same-level FIFO flood): index loop
        for (size_t h = 0; h < q.size(); ++h) {
            const int64_t v = q[h];
            int64_t coord[3];
            coord[0] = v / strides[0];
            coord[1] = (v / sx) % sy;
            coord[2] = v % sx;
            for (int d = 0; d < 3; ++d)
                for (int s = -1; s <= 1; s += 2) {
                    const int64_t c = coord[d] + s;
                    if (c < 0 || c >= dims[d]) continue;
                    const int64_t u = v + s * strides[d];
                    if (labels[u] != 0) continue;
                    labels[u] = labels[v];
                    const int lu = height[u] < level ? level : height[u];
                    buckets[lu].push_back(u);
                }
        }
        q.clear();
        q.shrink_to_fit();
    }
}

// Size filter with LOCAL regrow: fragments below min_size are cleared and
// their voxels re-flooded from the surviving neighborhood — touches only
// the small fragments' voxels instead of re-running the full watershed
// (reference semantics: utils/volume_utils.py:123-139 watershed-and-
// size-filter, which regrows via a second full pass).
void size_filter_u8(const uint8_t* height, int64_t sz, int64_t sy,
                    int64_t sx, int64_t* labels, int64_t min_size) {
    const int64_t n = sz * sy * sx;
    int64_t max_label = 0;
    for (int64_t i = 0; i < n; ++i)
        if (labels[i] > max_label) max_label = labels[i];
    std::vector<int64_t> counts(max_label + 1, 0);
    for (int64_t i = 0; i < n; ++i)
        if (labels[i] > 0) ++counts[labels[i]];
    std::vector<uint8_t> small(max_label + 1, 0);
    bool any = false;
    for (int64_t l = 1; l <= max_label; ++l)
        if (counts[l] > 0 && counts[l] < min_size) {
            small[l] = 1;
            any = true;
        }
    if (!any) return;
    const int64_t strides[3] = {sy * sx, sx, 1};
    const int64_t dims[3] = {sz, sy, sx};
    std::vector<std::vector<int64_t>> buckets(256);
    // clear small fragments to the -2 sentinel; seed the refill queues
    // with their surviving neighbors.  The flood expands ONLY into -2
    // voxels, so pre-existing background (label 0, e.g. masked regions)
    // is never claimed — the regrow touches exactly the removed voxels.
    for (int64_t i = 0; i < n; ++i)
        if (labels[i] > 0 && small[labels[i]]) labels[i] = -2;
    for (int64_t i = 0; i < n; ++i) {
        if (labels[i] <= 0) continue;
        const int64_t cz = i / strides[0], cy = (i / sx) % sy, cx = i % sx;
        const int64_t coord[3] = {cz, cy, cx};
        bool frontier = false;
        for (int d = 0; d < 3 && !frontier; ++d)
            for (int s = -1; s <= 1 && !frontier; s += 2) {
                const int64_t c = coord[d] + s;
                if (c < 0 || c >= dims[d]) continue;
                if (labels[i + s * strides[d]] == -2) frontier = true;
            }
        if (frontier) buckets[height[i]].push_back(i);
    }
    for (int level = 0; level < 256; ++level) {
        auto& q = buckets[level];
        for (size_t h = 0; h < q.size(); ++h) {
            const int64_t v = q[h];
            const int64_t coord[3] = {v / strides[0], (v / sx) % sy,
                                      v % sx};
            for (int d = 0; d < 3; ++d)
                for (int s = -1; s <= 1; s += 2) {
                    const int64_t c = coord[d] + s;
                    if (c < 0 || c >= dims[d]) continue;
                    const int64_t u = v + s * strides[d];
                    if (labels[u] != -2) continue;
                    labels[u] = labels[v];
                    const int lu = height[u] < level ? level : height[u];
                    buckets[lu].push_back(u);
                }
        }
        q.clear();
    }
    // unreachable removed voxels (no surviving neighbor path) become 0
    for (int64_t i = 0; i < n; ++i)
        if (labels[i] == -2) labels[i] = 0;
}

}  // extern "C"
