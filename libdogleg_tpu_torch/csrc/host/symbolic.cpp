// Native symbolic-analysis routines for libdogleg_tpu_torch (host code,
// built with g++ by native/loader.py; the JAX package's csrc/symbolic.cpp,
// with the same outputs and C ABI).
//
// The structure-only (symbolic) phase of the block-sparse pipeline — block
// pattern derivation from scalar CSR, and the sorted JtJ pair schedule — is
// pointer-chasing graph work executed once per problem structure on the
// host. It is the counterpart of the reference's one-time
// cholmod_analyze (reference dogleg.c:649-654), and like CHOLMOD's, it
// belongs in native code: for large patterns (1e5+ block rows) the
// pure-numpy fallback in sparsity.py is orders of magnitude slower.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this toolchain).
// All index arrays are int32 (matching BCSRStructure) with int64 counts.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <set>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Minimum-degree fill-reducing ordering on a symmetric (block) pattern.
//
// The reference gets its fill-reducing ordering from cholmod_analyze
// (AMD/COLAMD inside CHOLMOD, reference dogleg.c:649-654); without one, a
// sparse Cholesky can fill catastrophically (an arrow matrix pointing the
// wrong way fills completely). This is the classic exact-minimum-degree
// elimination-graph algorithm with lazy heap updates: eliminate the
// minimum-degree vertex, form a clique among its neighbors, repeat.
// perm_out[k] = original index of the block eliminated k-th.

void mindeg_order(const int32_t* rows, const int32_t* cols, int64_t nnz,
                  int32_t n, int32_t* perm_out) {
  std::vector<std::set<int32_t>> adj(static_cast<size_t>(n));
  for (int64_t e = 0; e < nnz; ++e) {
    const int32_t i = rows[e], j = cols[e];
    if (i != j) {
      adj[i].insert(j);
      adj[j].insert(i);
    }
  }
  // lazy min-heap of (degree, vertex); stale entries skipped on pop
  using Ent = std::pair<int32_t, int32_t>;
  std::priority_queue<Ent, std::vector<Ent>, std::greater<Ent>> heap;
  std::vector<char> eliminated(static_cast<size_t>(n), 0);
  for (int32_t v = 0; v < n; ++v) {
    heap.push({static_cast<int32_t>(adj[v].size()), v});
  }
  for (int32_t k = 0; k < n; ++k) {
    int32_t v = -1;
    while (!heap.empty()) {
      const Ent top = heap.top();
      heap.pop();
      if (!eliminated[top.second] &&
          static_cast<int32_t>(adj[top.second].size()) == top.first) {
        v = top.second;
        break;
      }
    }
    // exhausted heap (all stale): pick any remaining vertex
    if (v < 0) {
      for (int32_t u = 0; u < n; ++u) {
        if (!eliminated[u]) { v = u; break; }
      }
    }
    perm_out[k] = v;
    eliminated[v] = 1;
    const std::vector<int32_t> nbrs(adj[v].begin(), adj[v].end());
    for (const int32_t u : nbrs) adj[u].erase(v);
    for (size_t a = 0; a < nbrs.size(); ++a) {
      for (size_t c = a + 1; c < nbrs.size(); ++c) {
        adj[nbrs[a]].insert(nbrs[c]);
        adj[nbrs[c]].insert(nbrs[a]);
      }
    }
    for (const int32_t u : nbrs) {
      heap.push({static_cast<int32_t>(adj[u].size()), u});
    }
    adj[v].clear();
  }
}

// ---------------------------------------------------------------------
// JtJ pair schedule: for every ordered pair (a, b) of stored blocks that
// share a block row, one output contribution at block (indices[a],
// indices[b]). Returns pairs sorted by output block (so each output tile is
// a contiguous accumulation run) with a dense rank per distinct output
// block. Two-phase: call jtj_pair_count first to size the buffers.

int64_t jtj_pair_count(const int32_t* indptr, int32_t nbrow) {
  int64_t total = 0;
  for (int32_t r = 0; r < nbrow; ++r) {
    const int64_t k = indptr[r + 1] - indptr[r];
    total += k * k;
  }
  return total;
}

struct PairRec {
  int32_t ci, cj, pi, pj;
};

int64_t jtj_schedule(const int32_t* indptr, const int32_t* indices,
                     int32_t nbrow, int32_t nbcol,
                     // outputs, sized by jtj_pair_count():
                     int32_t* pair_i, int32_t* pair_j, int32_t* out_idx,
                     // outputs, sized by jtj_pair_count() (upper bound on
                     // distinct blocks); returns the actual count:
                     int32_t* out_ci, int32_t* out_cj) {
  const int64_t npairs = jtj_pair_count(indptr, nbrow);
  std::vector<PairRec> recs;
  recs.reserve(static_cast<size_t>(npairs));
  for (int32_t r = 0; r < nbrow; ++r) {
    for (int32_t a = indptr[r]; a < indptr[r + 1]; ++a) {
      for (int32_t b = indptr[r]; b < indptr[r + 1]; ++b) {
        recs.push_back(PairRec{indices[a], indices[b], a, b});
      }
    }
  }
  std::sort(recs.begin(), recs.end(),
            [](const PairRec& x, const PairRec& y) {
              if (x.ci != y.ci) return x.ci < y.ci;
              if (x.cj != y.cj) return x.cj < y.cj;
              if (x.pi != y.pi) return x.pi < y.pi;
              return x.pj < y.pj;
            });
  int64_t nblocks = 0;
  for (int64_t p = 0; p < npairs; ++p) {
    const PairRec& rec = recs[static_cast<size_t>(p)];
    if (p == 0 || rec.ci != recs[static_cast<size_t>(p - 1)].ci ||
        rec.cj != recs[static_cast<size_t>(p - 1)].cj) {
      out_ci[nblocks] = rec.ci;
      out_cj[nblocks] = rec.cj;
      ++nblocks;
    }
    pair_i[p] = rec.pi;
    pair_j[p] = rec.pj;
    out_idx[p] = static_cast<int32_t>(nblocks - 1);
  }
  (void)nbcol;
  return nblocks;
}

// ---------------------------------------------------------------------
// Block pattern from a scalar CSR pattern (the reference's Jt layout,
// dogleg.h:11-20): block (br, bc) is stored iff any scalar nnz falls in it.
// Two-phase: first call fills indptr and returns nnzb; second fills indices.

int64_t bcsr_block_pattern(const int64_t* rowptr, const int32_t* colidx,
                           int32_t nmeas, int32_t nstate,
                           int32_t block_rows, int32_t block_cols,
                           // outputs:
                           int32_t* indptr,        // (nbrow + 1)
                           int32_t* indices_or_null) {
  const int32_t nbrow = nmeas / block_rows;
  std::vector<int32_t> cols;
  int64_t nnzb = 0;
  indptr[0] = 0;
  for (int32_t br = 0; br < nbrow; ++br) {
    cols.clear();
    const int64_t lo = rowptr[static_cast<int64_t>(br) * block_rows];
    const int64_t hi = rowptr[static_cast<int64_t>(br + 1) * block_rows];
    for (int64_t k = lo; k < hi; ++k) {
      cols.push_back(colidx[k] / block_cols);
    }
    std::sort(cols.begin(), cols.end());
    cols.erase(std::unique(cols.begin(), cols.end()), cols.end());
    if (indices_or_null != nullptr) {
      std::memcpy(indices_or_null + nnzb, cols.data(),
                  cols.size() * sizeof(int32_t));
    }
    nnzb += static_cast<int64_t>(cols.size());
    indptr[br + 1] = static_cast<int32_t>(nnzb);
  }
  (void)nstate;
  return nnzb;
}

}  // extern "C"
