// Host-side graph partition passes of relgat_projector_tpu_torch.
//
// The port's copy of the JAX package's label-propagation and BFS-growing
// passes (its native/graphbuild.cpp: build_undirected_csr, lpa_refine,
// bfs_grow), kept line for line so that both packages relabel a graph the
// same way. Host C++, integer-only, exposed through a C ABI for ctypes and
// built at first use by data/native.py. The block-padded layout passes of
// that file have no counterpart here: the port reads CSR (data/csr.py).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

// Undirected CSR over the edge list with self-loops dropped.
struct Csr {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
};

Csr build_undirected_csr(const int64_t* src, const int64_t* dst, int64_t e,
                         int64_t n) {
  Csr csr;
  csr.indptr.assign(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] == dst[i]) continue;
    csr.indptr[src[i] + 1]++;
    csr.indptr[dst[i] + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) csr.indptr[v + 1] += csr.indptr[v];
  csr.indices.resize(csr.indptr[n]);
  std::vector<int64_t> cursor(csr.indptr.begin(), csr.indptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] == dst[i]) continue;
    csr.indices[cursor[src[i]]++] = static_cast<int32_t>(dst[i]);
    csr.indices[cursor[dst[i]]++] = static_cast<int32_t>(src[i]);
  }
  return csr;
}

}  // namespace

extern "C" {

// Async size-constrained label propagation + exact-caps repair.
//   labels_io [n] in: initial labels (0..g-1); out: refined labels with
//   bincount(labels) == caps EXACTLY.  caps/soft_caps [g], sum(caps) == n.
// Returns the number of passes run (negative on bad input).
int64_t lpa_refine(const int64_t* src, const int64_t* dst, int64_t e,
                   int64_t n, int64_t g, const int64_t* caps,
                   const int64_t* soft_caps, int64_t max_passes,
                   int64_t* labels_io) {
  int64_t cap_sum = 0;
  for (int64_t k = 0; k < g; ++k) cap_sum += caps[k];
  if (cap_sum != n || g < 1) return -1;
  if (g == 1) {
    std::fill(labels_io, labels_io + n, int64_t{0});
    return 0;
  }
  const Csr csr = build_undirected_csr(src, dst, e, n);

  std::vector<int64_t> sizes(g, 0);
  for (int64_t v = 0; v < n; ++v) sizes[labels_io[v]]++;

  std::vector<int64_t> cnt(g, 0);
  std::vector<int64_t> touched;
  touched.reserve(64);

  auto count_neighbors = [&](int64_t v) {
    touched.clear();
    for (int64_t j = csr.indptr[v]; j < csr.indptr[v + 1]; ++j) {
      const int64_t l = labels_io[csr.indices[j]];
      if (cnt[l]++ == 0) touched.push_back(l);
    }
  };
  auto reset_counts = [&]() {
    for (int64_t l : touched) cnt[l] = 0;
  };

  int64_t pass = 0;
  for (; pass < max_passes; ++pass) {
    int64_t moves = 0;
    for (int64_t v = 0; v < n; ++v) {
      count_neighbors(v);
      const int64_t cur = labels_io[v];
      // Best admissible label: strictly more neighbor votes than the
      // current attachment (zero-gain moves could cycle) and soft-cap
      // room; equal-vote ties between CANDIDATES break toward the smaller
      // label (touched order varies run to run otherwise).
      int64_t best = -1, best_cnt = cnt[cur];
      for (int64_t l : touched) {
        if (l == cur || sizes[l] >= soft_caps[l]) continue;
        if (cnt[l] > best_cnt ||
            (cnt[l] == best_cnt && best >= 0 && l < best)) {
          best = l;
          best_cnt = cnt[l];
        }
      }
      reset_counts();
      if (best >= 0) {
        sizes[cur]--;
        sizes[best]++;
        labels_io[v] = best;
        ++moves;
      }
    }
    if (moves == 0) break;
  }

  // ---- repair to exact caps -------------------------------------------
  // Evict the weakest-attached members of overfull parts; each evictee goes
  // to its best-connected part that still has deficit room, leftovers fill
  // remaining deficits in part order. Deterministic throughout.
  std::vector<int64_t> attach(n, 0);
  for (int64_t v = 0; v < n; ++v) {
    int64_t a = 0;
    const int64_t lv = labels_io[v];
    for (int64_t j = csr.indptr[v]; j < csr.indptr[v + 1]; ++j) {
      if (labels_io[csr.indices[j]] == lv) ++a;
    }
    attach[v] = a;
  }
  for (int64_t k = 0; k < g; ++k) sizes[k] = 0;
  for (int64_t v = 0; v < n; ++v) sizes[labels_io[v]]++;

  std::vector<int64_t> evictees;
  for (int64_t k = 0; k < g; ++k) {
    const int64_t surplus = sizes[k] - caps[k];
    if (surplus <= 0) continue;
    std::vector<int64_t> members;
    for (int64_t v = 0; v < n; ++v) {
      if (labels_io[v] == k) members.push_back(v);
    }
    std::stable_sort(members.begin(), members.end(),
                     [&](int64_t a, int64_t b) { return attach[a] < attach[b]; });
    evictees.insert(evictees.end(), members.begin(), members.begin() + surplus);
  }
  // Strongest-connected evictees place first so they get their best target
  // while room lasts.
  std::stable_sort(evictees.begin(), evictees.end(),
                   [&](int64_t a, int64_t b) { return attach[a] > attach[b]; });
  std::vector<int64_t> deficit(g, 0);
  for (int64_t k = 0; k < g; ++k) {
    deficit[k] = caps[k] > sizes[k] ? caps[k] - sizes[k] : 0;
  }
  std::vector<int64_t> leftover;
  for (int64_t v : evictees) {
    count_neighbors(v);
    int64_t best = -1, best_cnt = -1;
    for (int64_t l : touched) {
      if (deficit[l] <= 0) continue;
      if (cnt[l] > best_cnt || (cnt[l] == best_cnt && l < best)) {
        best = l;
        best_cnt = cnt[l];
      }
    }
    reset_counts();
    if (best >= 0) {
      labels_io[v] = best;
      deficit[best]--;
    } else {
      leftover.push_back(v);
    }
  }
  int64_t fill_part = 0;
  for (int64_t v : leftover) {
    while (fill_part < g && deficit[fill_part] == 0) ++fill_part;
    labels_io[v] = fill_part < g ? fill_part : g - 1;
    if (fill_part < g) deficit[fill_part]--;
  }
  return pass;
}

// Greedy graph-growing seeding (BFS waves from max-degree seeds), the
// native twin of data/partition.py bfs_grow_partition. labels_out [n].
void bfs_grow(const int64_t* src, const int64_t* dst, int64_t e, int64_t n,
              int64_t g, const int64_t* caps, int64_t* labels_out) {
  const Csr csr = build_undirected_csr(src, dst, e, n);
  std::fill(labels_out, labels_out + n, int64_t{-1});

  std::vector<int64_t> seed_order(n);
  std::iota(seed_order.begin(), seed_order.end(), int64_t{0});
  std::stable_sort(seed_order.begin(), seed_order.end(),
                   [&](int64_t a, int64_t b) {
                     return (csr.indptr[a + 1] - csr.indptr[a]) >
                            (csr.indptr[b + 1] - csr.indptr[b]);
                   });
  int64_t seed_ptr = 0;

  std::vector<int64_t> frontier, next;
  for (int64_t k = 0; k < g; ++k) {
    int64_t room = caps[k];
    frontier.clear();
    while (room > 0) {
      if (frontier.empty()) {
        while (seed_ptr < n && labels_out[seed_order[seed_ptr]] != -1) {
          ++seed_ptr;
        }
        if (seed_ptr >= n) break;
        frontier.push_back(seed_order[seed_ptr]);
      }
      // Take one whole wave (capacity permitting), then expand it —
      // mirrors the numpy wave semantics (sorted-unique next frontier).
      const int64_t take = std::min<int64_t>(room, frontier.size());
      next.clear();
      for (int64_t i = 0; i < take; ++i) {
        labels_out[frontier[i]] = k;
      }
      room -= take;
      if (room == 0) break;
      for (int64_t i = 0; i < take; ++i) {
        const int64_t v = frontier[i];
        for (int64_t j = csr.indptr[v]; j < csr.indptr[v + 1]; ++j) {
          const int64_t u = csr.indices[j];
          if (labels_out[u] == -1) next.push_back(u);
        }
      }
      std::sort(next.begin(), next.end());
      next.erase(std::unique(next.begin(), next.end()), next.end());
      // Drop anything labeled meanwhile (same-wave duplicates handled by
      // unique; labels_out check keeps it safe).
      frontier.clear();
      for (int64_t u : next) {
        if (labels_out[u] == -1) frontier.push_back(u);
      }
    }
  }
  // Unassigned stragglers (caps filled by waves that skipped them): fill
  // remaining deficit in part order.
  std::vector<int64_t> sizes(g, 0);
  for (int64_t v = 0; v < n; ++v) {
    if (labels_out[v] >= 0) sizes[labels_out[v]]++;
  }
  int64_t fill_part = 0;
  for (int64_t v = 0; v < n; ++v) {
    if (labels_out[v] != -1) continue;
    while (fill_part < g && sizes[fill_part] >= caps[fill_part]) ++fill_part;
    labels_out[v] = fill_part < g ? fill_part : g - 1;
    if (fill_part < g) sizes[fill_part]++;
  }
}

}  // extern "C"
