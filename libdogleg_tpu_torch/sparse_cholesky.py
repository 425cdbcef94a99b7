"""Block-sparse Cholesky, the replacement for CHOLMOD (counterpart of
libdogleg_tpu/sparse_cholesky.py).

The reference factors a sparse JtJ with CHOLMOD's simplicial Cholesky after
a one-time symbolic analysis (reference dogleg.c:649-654, 1595-1599). Here
the factorization is built from batched dense block ops on a static
schedule:

  symbolic (host, once per pattern; output-identical to the JAX package's
  analysis; the host library's csrc/host/chol_symbolic.cpp where it is
  available, its Python form `_symbolic_python` otherwise):
    * a fill-reducing ordering (ordering.py, the AMD step inside
      cholmod_analyze);
    * symbolic fill on the block pattern;
    * the operation DAG, UPDATE(i,j,k): C_ij -= L_ik L_jk^T,
      FACTOR(j): L_jj = chol(C_jj), SOLVE(i,j): L_ij = C_ij L_jj^-T,
      scheduled into ASAP dependency levels;
    * level schedules of the forward and backward block substitutions.

  numeric (per factorization):
    * a Python loop over the levels, each level one batch of independent
      ops: UPDATE as one batched product whose negation is added in a
      fixed order (ops/segsum.py: each target's terms in index order),
      FACTOR through kernel K6 (ops/tilechol.tile_cholesky, the JAX
      package's _chol_blocks), SOLVE through kernel K7
      (ops/tilechol.tri_solve_right, its _tri_solve_right).

A batch of problems that share the pattern (the JAX package's vmap of
factorize and solve, the batched-SLAM regime) takes a leading batch axis:
input blocks (B, n_input, b, b), lam (B,), right-hand sides (B, nb*b), and
ok (B,). The level loop is the same, each level's ops over the whole batch:
one batched product for its UPDATE, one K6 launch over the B*k tiles of its
FACTOR and one K7 launch over those of its SOLVE. Each element's pivots
decide its own ok only.

The JAX package pads the levels into rectangles for a `lax.scan`, with a
trash slot for the padding (`_pad`, `_chunk_boundaries`, `_slice_*`,
`_sched_chunks`, `_solve_chunks`, `_pad_levels`). None of that is ported:
the loop here walks the levels with the schedule's own offsets, and a level
whose count of an op kind is zero launches nothing for it. The offsets live
on the host, so choosing what to launch never waits for the device. The
index arrays are copied to the device once per device and kept on the
analysis (`device_array`); each level indexes with slices of those copies.

A non-SPD pivot is caught per FACTOR op and and-reduced on the device into
`ok`, which drives the same permanent escalating lambda as the dense path
(reference dogleg.c:670-676), per element of a batch. Where several terms
of a level land on one block (UPDATE, the substitutions' pair steps) they
are added in the order index_add_ adds them on the CPU, fixed per level
when the analysis is first used (`_level_plans`): the CPU's bits are
index_add_'s, and a factorization on the card gives the same bits on
every run (index_add_'s atomics would not).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from libdogleg_tpu_torch.ops import segsum, tilechol
from libdogleg_tpu_torch.ops.traced import real_constant


# --------------------------------------------------------------------------
# Symbolic phase (host; once per pattern)
# --------------------------------------------------------------------------

class OpSchedule(NamedTuple):
    """Factorization ops flattened with per-level offsets: level k's ops are
    slice(off[k], off[k+1]) of each flat array. The three op kinds share one
    level axis."""
    upd_tgt: np.ndarray   # (n_upd,) L-slot receiving C_ij -= L_ik L_jk^T
    upd_i: np.ndarray     # (n_upd,) L-slot of L_ik
    upd_j: np.ndarray     # (n_upd,) L-slot of L_jk
    upd_off: np.ndarray   # (nlevels + 1,)
    fac: np.ndarray       # (n_fac,) L-slots of diagonal blocks to factor
    fac_off: np.ndarray   # (nlevels + 1,)
    sol_tgt: np.ndarray   # (n_sol,) L-slots of off-diagonal blocks to solve
    sol_diag: np.ndarray  # (n_sol,) L-slots of the corresponding L_jj
    sol_off: np.ndarray   # (nlevels + 1,)

    @property
    def nlevels(self) -> int:
        return int(self.upd_off.shape[0]) - 1


class SolveSchedule(NamedTuple):
    """One triangular-substitution direction, flattened with offsets."""
    pair_j: np.ndarray    # (n_pairs,) destination block-row
    pair_k: np.ndarray    # (n_pairs,) source block-row (already final)
    pair_slot: np.ndarray  # (n_pairs,) L-slot of the coupling block
    pair_off: np.ndarray  # (nlevels + 1,)
    diag_rows: np.ndarray  # (n_diag,) block-rows finalized per level
    diag_slot: np.ndarray  # (n_diag,) L-slots of their diagonal blocks
    diag_off: np.ndarray  # (nlevels + 1,)


@dataclasses.dataclass(frozen=True)
class SparseCholeskySymbolic:
    """The one-time analysis (the cholmod_analyze equivalent).

    Structural fields live in the permuted (elimination-order) space; perm
    maps back: permuted block row j is original block perm[j]. factorize and
    solve apply the permutation themselves, so callers pass data in the
    original order, as with CHOLMOD."""
    nb: int                       # number of block rows/cols
    b: int                        # block size
    # filled lower pattern, diagonal included: slot k holds block
    # (rows[k], cols[k])
    rows: np.ndarray
    cols: np.ndarray
    diag_slot_of: np.ndarray      # (nb,) slot of each diagonal block
    sched: OpSchedule
    fwd: SolveSchedule
    bwd: SolveSchedule
    a_slot_of_input: np.ndarray   # (n_input_blocks,) slot per input block
    # whether each input block lands transposed (its (i, j) pair flipped
    # triangles under the permutation)
    a_transpose: np.ndarray       # (n_input_blocks,) bool
    perm: np.ndarray              # (nb,) perm[k] = original block k-th
    # the input (unfilled) pattern in original coordinates
    in_rows: np.ndarray
    in_cols: np.ndarray
    # device copies of the index arrays, filled by device_array
    _device: Dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def nslots(self) -> int:
        return int(self.rows.shape[0])


def device_array(sym, device: torch.device, name: str,
                 make: Optional[Callable[[], np.ndarray]] = None
                 ) -> torch.Tensor:
    """A host array of an analysis (SparseCholeskySymbolic or
    supernodal.AmalgamatedSymbolic) as a tensor on `device`: int64 for
    indices, bool kept bool. Copied once per device and cached on the
    analysis. `name` is a field path such as "sched.upd_tgt"; `make`, when
    given, builds the host array instead."""
    key = (device, name)
    t = sym._device.get(key)
    if t is None:
        if make is not None:
            a = np.asarray(make())
        else:
            a = sym
            for part in name.split("."):
                a = getattr(a, part)
            a = np.asarray(a)
        if a.dtype != np.bool_:
            a = a.astype(np.int64)
        # a real tensor even while torch.export traces (a fake one kept here
        # would break the next eager solve)
        t = real_constant(lambda: torch.as_tensor(a, device=device))
        sym._device[key] = t
    return t


def _plan(sym, name: str) -> segsum.AddPlan:
    """The fixed-order plan of adding into the targets sym.<name>, cached
    on the analysis."""
    key = ("plan", name)
    plan = sym._device.get(key)
    if plan is None:
        plan = sym._device[key] = segsum.AddPlan(getattr(sym, name))
    return plan


def _level_plans(sym, schedule: str, target: str,
                 offsets: str) -> List[segsum.AddPlan]:
    """One fixed-order plan a level for the targets `<schedule>.<target>`
    leveled by `<schedule>.<offsets>`: built on the host in one pass at
    first use and cached on the analysis."""
    key = ("plans", schedule, target)
    plans = sym._device.get(key)
    if plans is None:
        ss = getattr(sym, schedule)
        plans = sym._device[key] = segsum.level_plans(
            getattr(ss, target), getattr(ss, offsets))
    return plans


def _flatten_level_lists(per_level: List[Dict[str, list]],
                         keys: Tuple[str, ...]) -> Tuple[np.ndarray, ...]:
    """Concatenate per-level Python lists into (flat, offsets) per key."""
    out = []
    for key in keys:
        flat = np.asarray(
            [v for d in per_level for v in d[key]], np.int32)
        off = np.zeros(len(per_level) + 1, np.int32)
        for k, d in enumerate(per_level):
            off[k + 1] = off[k] + len(d[key])
        out.append((flat, off))
    return tuple(out)


def _bucket_solve_schedule(nb, level_of, slot, pairs_of) -> SolveSchedule:
    """A SolveSchedule built by emitting rows in ascending-j order and
    stably bucketing them by level."""
    nl = int(level_of.max()) + 1 if nb else 0
    pj, pk, ps, p_lv = [], [], [], []
    dr, ds, d_lv = [], [], []
    for j in range(nb):
        lv = int(level_of[j])
        dr.append(j)
        ds.append(slot[(j, j)])
        d_lv.append(lv)
        for k, sl in pairs_of(j):
            pj.append(j)
            pk.append(k)
            ps.append(sl)
            p_lv.append(lv)

    def bucket(arrs, lv_list):
        lv = np.asarray(lv_list, np.int64)
        order = np.argsort(lv, kind="stable")
        off = np.zeros(nl + 1, np.int32)
        np.add.at(off, lv + 1, 1)
        off = np.cumsum(off).astype(np.int32)
        return [np.asarray(a, np.int32)[order] for a in arrs] + [off]

    pj, pk, ps, poff = bucket((pj, pk, ps), p_lv)
    dr, ds, doff = bucket((dr, ds), d_lv)
    return SolveSchedule(pair_j=pj, pair_k=pk, pair_slot=ps, pair_off=poff,
                         diag_rows=dr, diag_slot=ds, diag_off=doff)


def _symbolic_python(rows: np.ndarray, cols: np.ndarray, nb: int):
    """The symbolic analysis: fill, slot layout, op DAG and its levels, and
    the substitution levels."""
    # symbolic fill: column j's below-diagonal structure propagates to its
    # elimination parent (classic simplicial fill)
    colsets: List[set] = [set() for _ in range(nb)]   # i > j entries
    for i, j in zip(rows, cols):
        if i != j:
            colsets[j].add(int(i))
    for j in range(nb):
        s = colsets[j]
        if s:
            parent = min(s)
            colsets[parent] |= {i for i in s if i != parent}

    # slot layout: all diagonal blocks, then column-major off-diagonals
    out_rows, out_cols = [], []
    slot = {}
    for j in range(nb):
        slot[(j, j)] = len(out_rows)
        out_rows.append(j)
        out_cols.append(j)
    for j in range(nb):
        for i in sorted(colsets[j]):
            slot[(i, j)] = len(out_rows)
            out_rows.append(i)
            out_cols.append(j)

    a_slot_of_input = np.array([slot[(int(i), int(j))]
                                for i, j in zip(rows, cols)], np.int32)

    # operation DAG with ASAP levels
    sol_level = {}
    per_level_ops: List[dict] = []

    def level_dict(lv):
        while len(per_level_ops) <= lv:
            per_level_ops.append({"ut": [], "ui": [], "uj": [],
                                  "f": [], "st": [], "sd": []})
        return per_level_ops[lv]

    # upd_ready[slot] = level after which the block at `slot` has received
    # all its updates from columns k < its column
    upd_ready = np.zeros(len(out_rows), np.int64)

    for j in range(nb):
        # FACTOR(j): after every update targeting (j, j)
        fl = int(upd_ready[slot[(j, j)]])
        level_dict(fl)["f"].append(slot[(j, j)])

        struct_j = sorted(colsets[j])
        # SOLVE(i, j) for each i in column j's structure
        for i in struct_j:
            sl = max(fl, int(upd_ready[slot[(i, j)]])) + 1
            sol_level[(i, j)] = sl
            d = level_dict(sl)
            d["st"].append(slot[(i, j)])
            d["sd"].append(slot[(j, j)])
        # UPDATE ops from column j: for every pair (a <= c) in struct_j,
        # C_{c,a} -= L_{c,j} L_{a,j}^T (targets exist by the fill property)
        for ai, a in enumerate(struct_j):
            for c in struct_j[ai:]:
                ul = max(sol_level[(a, j)], sol_level[(c, j)]) + 1
                tgt = slot[(c, a)]
                d = level_dict(ul)
                d["ut"].append(tgt)
                d["ui"].append(slot[(c, j)])
                d["uj"].append(slot[(a, j)])
                upd_ready[tgt] = max(upd_ready[tgt], ul)

    ((ut, uoff), (ui, _), (uj, _), (f, foff),
     (st, soff), (sd, _)) = _flatten_level_lists(
        per_level_ops, ("ut", "ui", "uj", "f", "st", "sd"))
    sched = OpSchedule(upd_tgt=ut, upd_i=ui, upd_j=uj, upd_off=uoff,
                       fac=f, fac_off=foff,
                       sol_tgt=st, sol_diag=sd, sol_off=soff)

    # forward-substitution levels: y_j is final after every y_k it reads
    row_struct: List[List[int]] = [[] for _ in range(nb)]  # (j, k) k < j
    for j in range(nb):
        for i in colsets[j]:
            row_struct[i].append(j)
    f_level = np.zeros(nb, np.int64)
    for j in range(nb):
        f_level[j] = (max((f_level[k] for k in row_struct[j]), default=-1)
                      + 1)
    fwd = _bucket_solve_schedule(
        nb, f_level, slot,
        pairs_of=lambda j: [(k, slot[(j, k)]) for k in row_struct[j]])

    # backward-substitution levels: x_j after every x_i with i in column j
    b_level = np.zeros(nb, np.int64)
    for j in range(nb - 1, -1, -1):
        b_level[j] = (max((b_level[i] for i in colsets[j]), default=-1) + 1)
    bwd = _bucket_solve_schedule(
        nb, b_level, slot,
        pairs_of=lambda j: [(i, slot[(i, j)]) for i in sorted(colsets[j])])

    return (np.asarray(out_rows, np.int32), np.asarray(out_cols, np.int32),
            a_slot_of_input, sched, fwd, bwd)


def analyze(rows: np.ndarray, cols: np.ndarray, nb: int,
            b: int = 1, ordering="mindeg") -> SparseCholeskySymbolic:
    """Symbolic analysis of a symmetric block pattern.

    Args:
      rows, cols: block coordinates of the stored lower triangle of JtJ
        (i >= j), diagonal blocks required present.
      nb: number of block rows/cols; b: block size.
      ordering: "mindeg"/"amd" (default), "rcm", "nd", "natural", or an
        explicit permutation perm[k] = original block k-th in elimination
        order (ordering.resolve_ordering).
    """
    from libdogleg_tpu_torch.ordering import resolve_ordering
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    assert np.all(rows >= cols), "pass the lower triangle (i >= j)"
    in_rows, in_cols = rows, cols

    # fill-reducing permutation, then the pattern in elimination order; an
    # input block whose (i, j) pair flips triangles lands transposed
    perm = resolve_ordering(ordering, rows, cols, nb)
    iperm = np.empty(nb, np.int64)
    iperm[perm] = np.arange(nb)
    pi, pj = iperm[rows], iperm[cols]
    a_transpose = pi < pj
    rows = np.where(a_transpose, pj, pi)
    cols = np.where(a_transpose, pi, pj)

    from libdogleg_tpu_torch.native.symbolic import chol_symbolic_native
    built = chol_symbolic_native(rows, cols, nb)
    if built is None:
        built = _symbolic_python(rows, cols, nb)
    out_rows, out_cols, a_slot_of_input, sched, fwd, bwd = built
    return SparseCholeskySymbolic(
        nb=nb, b=b, rows=out_rows, cols=out_cols,
        diag_slot_of=np.arange(nb, dtype=np.int64),
        sched=sched, fwd=fwd, bwd=bwd,
        a_slot_of_input=a_slot_of_input, a_transpose=a_transpose,
        perm=perm.astype(np.int64), in_rows=in_rows, in_cols=in_cols)


# --------------------------------------------------------------------------
# Numeric phase
# --------------------------------------------------------------------------

def _batch_lam(lam, blocks: torch.Tensor) -> torch.Tensor:
    """lam as a (B,) tensor for (B, n, b, b) blocks: one lambda an
    element, or one for all."""
    lam = torch.as_tensor(lam, dtype=blocks.dtype, device=blocks.device)
    return lam.expand(blocks.shape[:1]) if lam.dim() == 0 else lam


def factorize(sym: SparseCholeskySymbolic, input_blocks: torch.Tensor,
              lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """Numeric factorization of the block matrix whose stored lower-triangle
    blocks, in the order passed to analyze, are input_blocks (n_input, b,
    b), damped by lam on the diagonal. Returns (L_blocks (nslots, b, b),
    ok), ok a 0-d bool tensor on the blocks' device. A batch, input_blocks
    (B, n_input, b, b) and lam (B,) (or one lam for all), gives L_blocks
    (B, nslots, b, b) and ok (B,)."""
    if input_blocks.dim() == 3:
        L, ok = factorize(sym, input_blocks[None],
                          torch.as_tensor(lam, dtype=input_blocks.dtype,
                                          device=input_blocks.device)[None])
        return L[0], ok[0]
    b, dev, dtype = sym.b, input_blocks.device, input_blocks.dtype
    B = input_blocks.shape[0]

    def idx(name):
        return device_array(sym, dev, name)

    # blocks whose (i, j) pair flipped triangles under the permutation
    # enter transposed
    if b > 1 and bool(np.any(sym.a_transpose)):
        input_blocks = torch.where(idx("a_transpose")[:, None, None],
                                   input_blocks.mT, input_blocks)
    vals = torch.zeros((B, sym.nslots, b, b), dtype=dtype, device=dev)
    vals = segsum.add_(vals, 1, _plan(sym, "a_slot_of_input"), input_blocks)
    eye = torch.eye(b, dtype=dtype, device=dev)
    lam = _batch_lam(lam, input_blocks)
    vals = segsum.add_(vals, 1, _plan(sym, "diag_slot_of"),
                       (lam[:, None, None, None] * eye).expand(B, sym.nb, b,
                                                               b))

    s = sym.sched
    plans = _level_plans(sym, "sched", "upd_tgt", "upd_off")
    ui, uj = idx("sched.upd_i"), idx("sched.upd_j")
    fac = idx("sched.fac")
    st, sd = idx("sched.sol_tgt"), idx("sched.sol_diag")
    uoff, foff, soff = (o.tolist() for o in (s.upd_off, s.fac_off,
                                             s.sol_off))
    ok = torch.ones(B, dtype=torch.bool, device=dev)

    def tiles(slots):      # (B, k, b, b) -> the B*k tiles of one launch
        return vals.index_select(1, slots).reshape(-1, b, b)

    for k in range(s.nlevels):
        lo, hi = uoff[k], uoff[k + 1]
        if hi > lo:
            contrib = (vals.index_select(1, ui[lo:hi])
                       @ vals.index_select(1, uj[lo:hi]).mT)
            vals = segsum.add_(vals, 1, plans[k], contrib, alpha=-1)
        lo, hi = foff[k], foff[k + 1]
        if hi > lo:
            fc = fac[lo:hi]
            L, blk_ok = tilechol.tile_cholesky(tiles(fc))
            vals.index_copy_(1, fc, L.reshape(B, -1, b, b))
            ok = ok & blk_ok.reshape(B, -1).all(-1)
        lo, hi = soff[k], soff[k + 1]
        if hi > lo:
            tgt = st[lo:hi]
            X = tilechol.tri_solve_right(tiles(sd[lo:hi]), tiles(tgt))
            vals.index_copy_(1, tgt, X.reshape(B, -1, b, b))
    return vals, ok


def _substitute(sym: SparseCholeskySymbolic, L_blocks: torch.Tensor,
                y: torch.Tensor, phase: str) -> torch.Tensor:
    """One block-triangular substitution over its levels, in place on y
    (B, nb, b, k) with L_blocks (B, nslots, b, b): "fwd" solves L y = r,
    "bwd" solves L^T x = y."""
    ss = getattr(sym, phase)
    back = phase == "bwd"

    def idx(name):
        return device_array(sym, y.device, f"{phase}.{name}")

    plans = _level_plans(sym, phase, "pair_j", "pair_off")
    pk, ps = idx("pair_k"), idx("pair_slot")
    dr, ds = idx("diag_rows"), idx("diag_slot")
    poff, doff = ss.pair_off.tolist(), ss.diag_off.tolist()
    for lev in range(len(poff) - 1):
        lo, hi = poff[lev], poff[lev + 1]
        if hi > lo:
            blk = L_blocks.index_select(1, ps[lo:hi])
            if back:
                # subtract L_ij^T x_i from row j
                blk = blk.mT
            y = segsum.add_(y, 1, plans[lev],
                            blk @ y.index_select(1, pk[lo:hi]), alpha=-1)
        lo, hi = doff[lev], doff[lev + 1]
        if hi > lo:
            rows = dr[lo:hi]
            Ld = L_blocks.index_select(1, ds[lo:hi])
            y.index_copy_(1, rows, torch.linalg.solve_triangular(
                Ld.mT if back else Ld, y.index_select(1, rows), upper=back))
    return y


def solve(sym: SparseCholeskySymbolic, L_blocks: torch.Tensor,
          rhs: torch.Tensor) -> torch.Tensor:
    """Solve (P^T L L^T P) x = rhs with the block-sparse factor, P the
    fill-reducing permutation of the analysis. rhs is in the caller's
    original order: (nb*b,), or (nb*b, k) for k right-hand sides at once
    (the reference pushes chunks of 4 through cholmod_solve,
    dogleg.c:2427). A batch's factor, L_blocks (B, nslots, b, b), takes rhs
    (B, nb*b) or (B, nb*b, k)."""
    if L_blocks.dim() == 3:
        return solve(sym, L_blocks[None], rhs[None])[0]
    b, B = sym.b, L_blocks.shape[0]
    squeeze = rhs.dim() == 2
    if squeeze:
        rhs = rhs[..., None]
    k = rhs.shape[-1]
    perm = device_array(sym, rhs.device, "perm")
    y = rhs.reshape(B, sym.nb, b, k).index_select(1, perm)
    y = _substitute(sym, L_blocks, y, "fwd")
    y = _substitute(sym, L_blocks, y, "bwd")
    # un-permute: original block perm[j] holds permuted solution block j
    out = torch.empty_like(y).index_copy_(1, perm, y).reshape(
        B, sym.nb * b, k)
    return out[..., 0] if squeeze else out


def factorize_with_lambda(sym: SparseCholeskySymbolic,
                          input_blocks: torch.Tensor,
                          lam,
                          *,
                          lambda_initial: float = 1e-10,
                          lambda_max_tries: int = 60,
                          active: Optional[torch.Tensor] = None):
    """The permanent escalating-lambda loop around factorize (reference
    dogleg.c:656-677). Returns (L_blocks, lam, ok). On a batch, lam and ok
    are (B,) and each element escalates on its own, only where `active`
    (B,) allows (ops/cholesky.escalating_lambda)."""
    from libdogleg_tpu_torch.ops.cholesky import escalating_lambda
    lam = torch.as_tensor(lam, dtype=input_blocks.dtype,
                          device=input_blocks.device)
    if input_blocks.dim() == 4:
        lam = _batch_lam(lam, input_blocks)
    return escalating_lambda(
        lambda lm: factorize(sym, input_blocks, lm), lam,
        lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries,
        active=active)
