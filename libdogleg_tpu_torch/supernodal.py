"""Supernodal amalgamation for the block-sparse Cholesky (counterpart of
libdogleg_tpu/supernodal.py).

CHOLMOD's supernodal mode, which the reference disables at a measured 25%
cost (reference dogleg.c:1595-1599), merges columns of similar structure
into dense panels. Here amalgamation is a pattern coarsening: after the
fill-reducing ordering, S consecutive elimination-order block columns merge
into one super column of size S*b, and any super block holding a stored
sub-block is stored whole (explicit zeros included). The result is the same
matrix factored by sparse_cholesky at block size S*b: about S times fewer
levels, each tile op S^2 times larger, so kernels K6 and K7 run on S*b-wide
tiles. It is exact: the diagonal supers are principal submatrices of the
permuted JtJ, padded with decoupled identity states when nb % S != 0.

The analysis is host numpy, identical in output to the JAX package's. A
batch that shares the pattern takes a leading batch axis through every
numeric function, as sparse_cholesky's do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from libdogleg_tpu_torch import sparse_cholesky as sc


@dataclasses.dataclass(frozen=True)
class AmalgamatedSymbolic:
    """Analysis artifact of the amalgamated factorization."""
    inner: sc.SparseCholeskySymbolic   # super-block symbolic (size S*b)
    S: int                             # columns merged per super column
    nb: int                            # original block count
    b: int                             # original block size
    nb_pad: int                        # nb rounded up to a multiple of S
    perm: np.ndarray                   # (nb,) fill-reducing order (b-level)
    # elementwise scatter of the input (n_input, b, b) values into the
    # (n_super_input, Sb, Sb) super-block tensor (flattened)
    scatter_idx: np.ndarray            # (n_input * b * b,) int64
    # mirror copies for off-diagonal sub-blocks inside diagonal supers
    mirror_src: np.ndarray             # (n_mirror * b * b,) into flat input
    mirror_idx: np.ndarray             # (n_mirror * b * b,) into flat supers
    ones_idx: np.ndarray               # virtual-padding unit diagonal
    n_super_input: int
    # original input pattern
    in_rows: np.ndarray
    in_cols: np.ndarray
    # device copies of the index arrays, filled by sc.device_array
    _device: Dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def sb(self) -> int:
        return self.S * self.b


def analyze(rows: np.ndarray, cols: np.ndarray, nb: int, b: int = 1,
            ordering="rcm", amalgamate: int = 4,
            inner_ordering="auto") -> AmalgamatedSymbolic:
    """Symbolic analysis with supernodal amalgamation.

    Args: as sparse_cholesky.analyze, plus amalgamate = S, the number of
    consecutive (post-ordering) block columns merged per supernode. The
    default ordering is "rcm": amalgamation needs consecutive elimination
    columns to be adjacent in the graph, which minimum degree does not give.

    inner_ordering orders the super pattern's elimination: "natural", "nd"
    (nested dissection, a shallow elimination tree at modest extra fill),
    or "auto" (default), which analyzes both and keeps the one with fewer
    sequential levels in all (ties to "natural").
    """
    from libdogleg_tpu_torch.ordering import resolve_ordering
    S = int(amalgamate)
    assert S >= 1
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    assert np.all(rows >= cols), "pass the lower triangle (i >= j)"
    in_rows, in_cols = rows, cols

    perm = resolve_ordering(ordering, rows, cols, nb).astype(np.int64)
    iperm = np.empty(nb, np.int64)
    iperm[perm] = np.arange(nb)

    nb_pad = ((nb + S - 1) // S) * S
    nb_s = nb_pad // S
    sb = S * b

    # input blocks in permuted coordinates, lower triangle at b-level
    pi, pj = iperm[rows], iperm[cols]
    flip = pi < pj
    pi2 = np.where(flip, pj, pi)
    pj2 = np.where(flip, pi, pj)
    si, sj = pi2 // S, pj2 // S
    oi, oj = pi2 % S, pj2 % S

    # super pattern: stored pairs and every diagonal super
    keys = si * nb_s + sj
    uniq_keys = np.unique(np.concatenate(
        [keys, np.arange(nb_s) * nb_s + np.arange(nb_s)]))
    sup_rows = (uniq_keys // nb_s).astype(np.int64)
    sup_cols = (uniq_keys % nb_s).astype(np.int64)
    pair_index = {int(k): idx for idx, k in enumerate(uniq_keys)}
    input_super = np.fromiter((pair_index[int(k)] for k in keys),
                              np.int64, count=keys.shape[0])
    n_super_input = uniq_keys.shape[0]

    # inner symbolic on the super pattern (the b-level ordering is already
    # applied; inner_ordering only re-orders supers)
    def total_levels(s):
        return (s.sched.nlevels + len(s.fwd.pair_off) - 1
                + len(s.bwd.pair_off) - 1)

    candidates = (("natural", "nd") if inner_ordering == "auto"
                  else (inner_ordering,))
    inner = None
    for o in candidates:
        cand = sc.analyze(sup_rows, sup_cols, nb_s, sb, ordering=o)
        if inner is None or total_levels(cand) < total_levels(inner):
            inner = cand

    # elementwise scatter: source element (r, c) of input block e lands at
    # super element (oi*b + (c if flip else r), oj*b + (r if flip else c)),
    # flipping transposes the block for pairs that swapped triangles
    rr = np.arange(b)
    e_r = np.broadcast_to(rr[None, :, None], (keys.shape[0], b, b))
    e_c = np.broadcast_to(rr[None, None, :], (keys.shape[0], b, b))
    land_r = oi[:, None, None] * b + np.where(flip[:, None, None], e_c, e_r)
    land_c = oj[:, None, None] * b + np.where(flip[:, None, None], e_r, e_c)
    scatter_idx = (input_super[:, None, None] * (sb * sb)
                   + land_r * sb + land_c).reshape(-1)

    # mirror: off-diagonal sub-blocks inside a diagonal super also need
    # their transpose in that super's upper half (diagonal tiles are
    # factored as full symmetric matrices)
    need_mirror = (si == sj) & (pi2 != pj2)
    me = np.nonzero(need_mirror)[0]
    if me.size:
        m_land_r = oj[me][:, None, None] * b + np.where(
            flip[me][:, None, None], e_r[me], e_c[me])
        m_land_c = oi[me][:, None, None] * b + np.where(
            flip[me][:, None, None], e_c[me], e_r[me])
        mirror_idx = (input_super[me][:, None, None] * (sb * sb)
                      + m_land_r * sb + m_land_c).reshape(-1)
        mirror_src = ((me[:, None, None] * (b * b)
                       + e_r[me] * b + e_c[me]).reshape(-1))
    else:
        mirror_idx = np.zeros(0, np.int64)
        mirror_src = np.zeros(0, np.int64)

    # virtual padding states (permuted b-rows nb..nb_pad-1) get a unit
    # diagonal so the factor stays SPD and they decouple exactly
    virt = np.arange(nb, nb_pad)
    if virt.size:
        vsup = virt // S
        vo = (virt % S) * b
        vslot = np.asarray([pair_index[int(s * nb_s + s)] for s in vsup],
                           np.int64)
        ones_idx = (vslot[:, None] * (sb * sb)
                    + (vo[:, None] + rr[None, :]) * sb
                    + (vo[:, None] + rr[None, :])).reshape(-1)
    else:
        ones_idx = np.zeros(0, np.int64)

    return AmalgamatedSymbolic(
        inner=inner, S=S, nb=nb, b=b, nb_pad=nb_pad, perm=perm,
        scatter_idx=scatter_idx, mirror_src=mirror_src,
        mirror_idx=mirror_idx, ones_idx=ones_idx,
        n_super_input=n_super_input, in_rows=in_rows, in_cols=in_cols)


def _super_blocks(sym: AmalgamatedSymbolic,
                  input_blocks: torch.Tensor) -> torch.Tensor:
    """The (..., n_super_input, Sb, Sb) super blocks of the input blocks
    (..., n_input, b, b), the mirrored sub-blocks and the unit diagonal of
    the padding states."""
    sb, dev = sym.sb, input_blocks.device
    lead = tuple(input_blocks.shape[:-3])
    flat_in = input_blocks.reshape(lead + (-1,))
    flat = flat_in.new_zeros(lead + (sym.n_super_input * sb * sb,))
    flat.index_add_(-1, sc.device_array(sym, dev, "scatter_idx"), flat_in)
    if sym.mirror_idx.size:
        flat.index_add_(-1, sc.device_array(sym, dev, "mirror_idx"),
                        flat_in.index_select(
                            -1, sc.device_array(sym, dev, "mirror_src")))
    if sym.ones_idx.size:
        ones = sc.device_array(sym, dev, "ones_idx")
        flat.index_add_(-1, ones, flat.new_ones(lead + ones.shape))
    return flat.reshape(lead + (sym.n_super_input, sb, sb))


def factorize(sym: AmalgamatedSymbolic, input_blocks: torch.Tensor,
              lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """Numeric factorization; input_blocks are the original (n_input, b, b)
    lower-triangle blocks, or a batch (B, n_input, b, b) with lam (B,), as
    for sparse_cholesky.factorize."""
    return sc.factorize(sym.inner, _super_blocks(sym, input_blocks), lam)


def solve(sym: AmalgamatedSymbolic, L_blocks: torch.Tensor,
          rhs: torch.Tensor) -> torch.Tensor:
    """rhs: (n,) or (n, k) for k right-hand sides at once; with a batch's
    factor (B, nslots, Sb, Sb), (B, n) or (B, n, k)."""
    if L_blocks.dim() == 3:
        return solve(sym, L_blocks[None], rhs[None])[0]
    b, B = sym.b, L_blocks.shape[0]
    squeeze = rhs.dim() == 2
    if squeeze:
        rhs = rhs[..., None]
    k = rhs.shape[-1]
    perm = sc.device_array(sym, rhs.device, "perm")
    yb = rhs.reshape(B, sym.nb, b, k).index_select(1, perm)
    yb = torch.cat([yb, yb.new_zeros((B, sym.nb_pad - sym.nb, b, k))], 1)
    x = sc.solve(sym.inner, L_blocks, yb.reshape(B, sym.nb_pad * b, k))
    xb = x.reshape(B, sym.nb_pad, b, k)[:, :sym.nb]
    out = torch.empty_like(xb).index_copy_(1, perm, xb)
    out = out.reshape(B, sym.nb * b, k)
    return out[..., 0] if squeeze else out


def factorize_with_lambda(sym: AmalgamatedSymbolic,
                          input_blocks: torch.Tensor, lam, *,
                          lambda_initial: float = 1e-10,
                          lambda_max_tries: int = 60,
                          active=None):
    """Escalating-lambda wrapper (reference dogleg.c:656-677 semantics).
    The super blocks are built once; retries only refactor. lam lands on
    the full super diagonal, the virtual padding states included, which
    stay decoupled. On a batch each element escalates on its own, only
    where `active` allows."""
    blocks = _super_blocks(sym, input_blocks)
    return sc.factorize_with_lambda(
        sym.inner, blocks, lam, lambda_initial=lambda_initial,
        lambda_max_tries=lambda_max_tries, active=active)
