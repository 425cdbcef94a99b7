// Native symbolic factorization for the block-sparse Cholesky of
// libdogleg_tpu_torch (host code, built with g++ by native/loader.py; the JAX
// package's csrc/chol_symbolic.cpp, with the same outputs and C ABI).
//
// The host-side one-time analysis (fill pattern, operation DAG scheduled
// into ASAP dependency levels, forward/backward solve levels) is
// pointer-chasing graph work — the counterpart of CHOLMOD's cholmod_analyze
// (reference dogleg.c:649-654), and like it, it belongs in native code: the
// pure-Python builder in sparse_cholesky.py takes seconds at 5e3+ block
// rows where this takes milliseconds.
//
// Contract: identical outputs to the Python builder (same slot layout, same
// ASAP level assignment, same op order within a level). Exposed as a C ABI
// consumed via ctypes: build once into an opaque handle, copy the flat
// arrays out, free.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <set>
#include <vector>

namespace {

struct Symbolic {
  int32_t nb = 0;
  // filled pattern: diagonal slots [0, nb), then column-major off-diagonals
  std::vector<int32_t> rows, cols;
  // operation DAG, flattened with per-level offsets
  std::vector<int32_t> upd_tgt, upd_i, upd_j, upd_off;
  std::vector<int32_t> fac, fac_off;
  std::vector<int32_t> sol_tgt, sol_diag, sol_off;
  // forward/backward substitution levels
  std::vector<int32_t> fwd_pj, fwd_pk, fwd_ps, fwd_poff;
  std::vector<int32_t> fwd_dr, fwd_ds, fwd_doff;
  std::vector<int32_t> bwd_pj, bwd_pk, bwd_ps, bwd_poff;
  std::vector<int32_t> bwd_dr, bwd_ds, bwd_doff;
  // scatter map for input blocks
  std::vector<int32_t> a_slot_of_input;
};

// Bucket per-op level assignments into flat arrays + offsets, preserving
// the order ops were emitted within each level.
template <typename Emit>
void bucket_by_level(int32_t nlevels, const std::vector<int32_t>& levels,
                     std::vector<int32_t>& off, Emit emit) {
  std::vector<int32_t> count(static_cast<size_t>(nlevels) + 1, 0);
  for (const int32_t lv : levels) ++count[static_cast<size_t>(lv) + 1];
  off.assign(count.begin(), count.end());
  for (int32_t l = 0; l < nlevels; ++l) off[l + 1] += off[l];
  std::vector<int32_t> cursor(off.begin(), off.end() - 1);
  for (size_t k = 0; k < levels.size(); ++k) {
    emit(static_cast<int64_t>(cursor[levels[k]]++), static_cast<int64_t>(k));
  }
}

}  // namespace

extern "C" {

void* chol_symbolic_build(const int32_t* in_rows, const int32_t* in_cols,
                          int64_t nnz, int32_t nb) {
  auto* s = new Symbolic();
  s->nb = nb;

  // --- symbolic fill: column j's below-diagonal structure propagates to
  // its elimination parent (same recurrence as the Python builder).
  std::vector<std::set<int32_t>> colsets(static_cast<size_t>(nb));
  for (int64_t e = 0; e < nnz; ++e) {
    if (in_rows[e] != in_cols[e]) colsets[in_cols[e]].insert(in_rows[e]);
  }
  for (int32_t j = 0; j < nb; ++j) {
    if (colsets[j].empty()) continue;
    const int32_t parent = *colsets[j].begin();
    for (const int32_t i : colsets[j]) {
      if (i != parent) colsets[parent].insert(i);
    }
  }

  // --- slot layout: all diagonals first, then column-major off-diagonals
  // in sorted row order (std::set iterates sorted). struct_of[j] gives the
  // sorted below-diagonal rows; col_start[j] their first slot.
  std::vector<std::vector<int32_t>> struct_of(static_cast<size_t>(nb));
  std::vector<int64_t> col_start(static_cast<size_t>(nb) + 1, 0);
  int64_t nslots = nb;
  for (int32_t j = 0; j < nb; ++j) {
    struct_of[j].assign(colsets[j].begin(), colsets[j].end());
    colsets[j].clear();
    col_start[j] = nslots;
    nslots += static_cast<int64_t>(struct_of[j].size());
  }
  col_start[nb] = nslots;
  s->rows.resize(static_cast<size_t>(nslots));
  s->cols.resize(static_cast<size_t>(nslots));
  for (int32_t j = 0; j < nb; ++j) {
    s->rows[j] = j;
    s->cols[j] = j;
    for (size_t r = 0; r < struct_of[j].size(); ++r) {
      s->rows[static_cast<size_t>(col_start[j]) + r] = struct_of[j][r];
      s->cols[static_cast<size_t>(col_start[j]) + r] = j;
    }
  }
  auto slot_of = [&](int32_t i, int32_t j) -> int32_t {
    if (i == j) return j;
    const auto& st = struct_of[j];
    const auto it = std::lower_bound(st.begin(), st.end(), i);
    return static_cast<int32_t>(col_start[j] + (it - st.begin()));
  };
  s->a_slot_of_input.resize(static_cast<size_t>(nnz));
  for (int64_t e = 0; e < nnz; ++e) {
    s->a_slot_of_input[e] = slot_of(in_rows[e], in_cols[e]);
  }

  // --- operation DAG with ASAP levels (identical recurrence to Python:
  // FACTOR(j) after all updates into (j,j); SOLVE(i,j) after FACTOR(j) and
  // updates into (i,j); UPDATE from the (a,c) pairs of column j's
  // structure after both solves).
  std::vector<int32_t> upd_ready(static_cast<size_t>(nslots), 0);
  std::vector<int32_t> sol_level_of(static_cast<size_t>(nslots), 0);
  std::vector<int32_t> fac_lv, sol_lv, upd_lv;
  fac_lv.reserve(static_cast<size_t>(nb));
  int32_t nlevels = 0;
  for (int32_t j = 0; j < nb; ++j) {
    const int32_t fl = upd_ready[j];  // diag slot of j is j
    fac_lv.push_back(fl);
    s->fac.push_back(j);
    nlevels = std::max(nlevels, fl + 1);
    const auto& st = struct_of[j];
    for (size_t r = 0; r < st.size(); ++r) {
      const int32_t tgt = static_cast<int32_t>(col_start[j] + r);
      const int32_t sl = std::max(fl, upd_ready[tgt]) + 1;
      sol_level_of[tgt] = sl;
      sol_lv.push_back(sl);
      s->sol_tgt.push_back(tgt);
      s->sol_diag.push_back(j);
      nlevels = std::max(nlevels, sl + 1);
    }
    for (size_t a = 0; a < st.size(); ++a) {
      const int32_t slot_a = static_cast<int32_t>(col_start[j] + a);
      for (size_t c = a; c < st.size(); ++c) {
        const int32_t slot_c = static_cast<int32_t>(col_start[j] + c);
        const int32_t ul =
            std::max(sol_level_of[slot_a], sol_level_of[slot_c]) + 1;
        const int32_t tgt = slot_of(st[c], st[a]);
        upd_lv.push_back(ul);
        s->upd_tgt.push_back(tgt);
        s->upd_i.push_back(slot_c);
        s->upd_j.push_back(slot_a);
        upd_ready[tgt] = std::max(upd_ready[tgt], ul);
        nlevels = std::max(nlevels, ul + 1);
      }
    }
  }
  {
    std::vector<int32_t> t1, t2, t3;
    t1 = s->upd_tgt; t2 = s->upd_i; t3 = s->upd_j;
    bucket_by_level(nlevels, upd_lv, s->upd_off, [&](int64_t d, int64_t k) {
      s->upd_tgt[d] = t1[k]; s->upd_i[d] = t2[k]; s->upd_j[d] = t3[k];
    });
    t1 = s->fac;
    bucket_by_level(nlevels, fac_lv, s->fac_off, [&](int64_t d, int64_t k) {
      s->fac[d] = t1[k];
    });
    t1 = s->sol_tgt; t2 = s->sol_diag;
    bucket_by_level(nlevels, sol_lv, s->sol_off, [&](int64_t d, int64_t k) {
      s->sol_tgt[d] = t1[k]; s->sol_diag[d] = t2[k];
    });
  }

  // --- forward-substitution levels: y_j final after every y_k it reads
  // (k < j with (j,k) stored). row_struct from the filled pattern.
  std::vector<std::vector<int32_t>> row_struct(static_cast<size_t>(nb));
  for (int32_t j = 0; j < nb; ++j) {
    for (const int32_t i : struct_of[j]) row_struct[i].push_back(j);
  }
  for (auto& rs : row_struct) std::sort(rs.begin(), rs.end());
  {
    std::vector<int32_t> f_level(static_cast<size_t>(nb), 0);
    int32_t nfl = nb ? 1 : 0;
    for (int32_t j = 0; j < nb; ++j) {
      int32_t lv = -1;
      for (const int32_t k : row_struct[j]) lv = std::max(lv, f_level[k]);
      f_level[j] = lv + 1;
      nfl = std::max(nfl, lv + 2);
    }
    // emit in j order; stable level bucketing reproduces the
    // level-then-ascending-j order without an O(nlevels * nb) scan
    std::vector<int32_t> p_lv, d_lv;
    for (int32_t j = 0; j < nb; ++j) {
      d_lv.push_back(f_level[j]);
      s->fwd_dr.push_back(j);
      s->fwd_ds.push_back(j);
      for (const int32_t k : row_struct[j]) {
        p_lv.push_back(f_level[j]);
        s->fwd_pj.push_back(j);
        s->fwd_pk.push_back(k);
        s->fwd_ps.push_back(slot_of(j, k));
      }
    }
    std::vector<int32_t> t1 = s->fwd_pj, t2 = s->fwd_pk, t3 = s->fwd_ps;
    bucket_by_level(nfl, p_lv, s->fwd_poff, [&](int64_t d, int64_t k) {
      s->fwd_pj[d] = t1[k]; s->fwd_pk[d] = t2[k]; s->fwd_ps[d] = t3[k];
    });
    t1 = s->fwd_dr; t2 = s->fwd_ds;
    bucket_by_level(nfl, d_lv, s->fwd_doff, [&](int64_t d, int64_t k) {
      s->fwd_dr[d] = t1[k]; s->fwd_ds[d] = t2[k];
    });
  }

  // --- backward-substitution levels: x_j after every x_i, i in column j.
  {
    std::vector<int32_t> b_level(static_cast<size_t>(nb), 0);
    int32_t nbl = nb ? 1 : 0;
    for (int32_t j = nb - 1; j >= 0; --j) {
      int32_t lv = -1;
      for (const int32_t i : struct_of[j]) lv = std::max(lv, b_level[i]);
      b_level[j] = lv + 1;
      nbl = std::max(nbl, lv + 2);
    }
    std::vector<int32_t> p_lv, d_lv;
    for (int32_t j = 0; j < nb; ++j) {
      d_lv.push_back(b_level[j]);
      s->bwd_dr.push_back(j);
      s->bwd_ds.push_back(j);
      const auto& st = struct_of[j];
      for (size_t r = 0; r < st.size(); ++r) {
        p_lv.push_back(b_level[j]);
        s->bwd_pj.push_back(j);
        s->bwd_pk.push_back(st[r]);
        s->bwd_ps.push_back(static_cast<int32_t>(col_start[j] + r));
      }
    }
    std::vector<int32_t> t1 = s->bwd_pj, t2 = s->bwd_pk, t3 = s->bwd_ps;
    bucket_by_level(nbl, p_lv, s->bwd_poff, [&](int64_t d, int64_t k) {
      s->bwd_pj[d] = t1[k]; s->bwd_pk[d] = t2[k]; s->bwd_ps[d] = t3[k];
    });
    t1 = s->bwd_dr; t2 = s->bwd_ds;
    bucket_by_level(nbl, d_lv, s->bwd_doff, [&](int64_t d, int64_t k) {
      s->bwd_dr[d] = t1[k]; s->bwd_ds[d] = t2[k];
    });
  }
  return s;
}

void chol_symbolic_free(void* h) { delete static_cast<Symbolic*>(h); }

// counts[0..11]: nslots, nlevels, n_upd, n_fac, n_sol,
//                n_fwd_levels, n_fwd_pairs, n_fwd_diag,
//                n_bwd_levels, n_bwd_pairs, n_bwd_diag, n_input
void chol_symbolic_counts(void* h, int64_t* counts) {
  auto* s = static_cast<Symbolic*>(h);
  counts[0] = static_cast<int64_t>(s->rows.size());
  counts[1] = static_cast<int64_t>(s->upd_off.size()) - 1;
  counts[2] = static_cast<int64_t>(s->upd_tgt.size());
  counts[3] = static_cast<int64_t>(s->fac.size());
  counts[4] = static_cast<int64_t>(s->sol_tgt.size());
  counts[5] = static_cast<int64_t>(s->fwd_poff.size()) - 1;
  counts[6] = static_cast<int64_t>(s->fwd_pj.size());
  counts[7] = static_cast<int64_t>(s->fwd_dr.size());
  counts[8] = static_cast<int64_t>(s->bwd_poff.size()) - 1;
  counts[9] = static_cast<int64_t>(s->bwd_pj.size());
  counts[10] = static_cast<int64_t>(s->bwd_dr.size());
  counts[11] = static_cast<int64_t>(s->a_slot_of_input.size());
}

void chol_symbolic_export(
    void* h, int32_t* rows, int32_t* cols, int32_t* a_slot,
    int32_t* upd_tgt, int32_t* upd_i, int32_t* upd_j, int32_t* upd_off,
    int32_t* fac, int32_t* fac_off, int32_t* sol_tgt, int32_t* sol_diag,
    int32_t* sol_off, int32_t* fwd_pj, int32_t* fwd_pk, int32_t* fwd_ps,
    int32_t* fwd_poff, int32_t* fwd_dr, int32_t* fwd_ds, int32_t* fwd_doff,
    int32_t* bwd_pj, int32_t* bwd_pk, int32_t* bwd_ps, int32_t* bwd_poff,
    int32_t* bwd_dr, int32_t* bwd_ds, int32_t* bwd_doff) {
  auto* s = static_cast<Symbolic*>(h);
  auto cp = [](const std::vector<int32_t>& v, int32_t* dst) {
    if (!v.empty()) std::memcpy(dst, v.data(), v.size() * sizeof(int32_t));
  };
  cp(s->rows, rows); cp(s->cols, cols); cp(s->a_slot_of_input, a_slot);
  cp(s->upd_tgt, upd_tgt); cp(s->upd_i, upd_i); cp(s->upd_j, upd_j);
  cp(s->upd_off, upd_off);
  cp(s->fac, fac); cp(s->fac_off, fac_off);
  cp(s->sol_tgt, sol_tgt); cp(s->sol_diag, sol_diag); cp(s->sol_off, sol_off);
  cp(s->fwd_pj, fwd_pj); cp(s->fwd_pk, fwd_pk); cp(s->fwd_ps, fwd_ps);
  cp(s->fwd_poff, fwd_poff);
  cp(s->fwd_dr, fwd_dr); cp(s->fwd_ds, fwd_ds); cp(s->fwd_doff, fwd_doff);
  cp(s->bwd_pj, bwd_pj); cp(s->bwd_pk, bwd_pk); cp(s->bwd_ps, bwd_ps);
  cp(s->bwd_poff, bwd_poff);
  cp(s->bwd_dr, bwd_dr); cp(s->bwd_ds, bwd_ds); cp(s->bwd_doff, bwd_doff);
}

}  // extern "C"
