#!/usr/bin/env python3
"""The plain version of the sparse path's fixed-order segment add on the
CPU (ops/segsum.py), against the other torch form it could take and
against index_add_, at the CPU tests' sizes and at config 6's.

Forms, each in the same order of adds (index_add_'s own on the CPU):
  rounds   the shipped plain version, segsum.reference: one index_select
           and one index_add_ a round, as many rounds as the most terms on
           one target;
  segment  each target's value and then its terms gathered into one run
           and summed by torch.segment_reduce, the sums copied back
           (about six ops whatever the multiplicity; written here);
  index_add_  one index_add_ on the plan's targets, the form before the
           fixed order (on the CPU it too adds in index order).

Cases: grid MRFs in float64 (8x8x4, the size of tests/test_torch_segsum.py,
and 32x32x8, config 6's), simplicial and amalgamated: one factorization
and one solve; and J^T x under torch.func.vmap over 8 residuals (the
batched products' form; segment_reduce has no batching rule, so vmap runs
it once an element). Best of 5 after a warm call, in ms; every form's
results are checked to be index_add_'s bits.

    python3 artifacts/exp_torch_segsum_cpu.py [--threads N]

Prints one line a case and one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import platform
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libdogleg_tpu_torch import SparseNewtonSolver  # noqa: E402
from libdogleg_tpu_torch.models import grid_mrf  # noqa: E402
from libdogleg_tpu_torch.ops import bcsr, segsum  # noqa: E402

FORMS = ("rounds", "segment", "index_add_")
_HOST: dict = {}


def _segment_arrays(plan):
    """The segment form's gather and run lengths for a plan, over
    cat([base[uniq], terms]): each run its target's value, then its
    terms in index order."""
    key = id(plan)
    if key not in _HOST:
        nu, n = plan.uniq.size, plan.n
        ptr = plan.run_ptr - plan.run_ptr[0]
        counts = np.diff(ptr)
        seg = np.empty(n + nu, np.int64)
        seg[ptr[:-1] + np.arange(nu)] = np.arange(nu)
        run = np.repeat(np.arange(nu), counts)
        seg[np.arange(n) + run + 1] = nu + plan.term_pos[
            plan.run_ptr[0]:plan.run_ptr[-1]]
        _HOST[key] = (plan, torch.as_tensor(plan.uniq),
                      torch.as_tensor(seg), torch.as_tensor(counts + 1),
                      torch.as_tensor(plan.targets))
    return _HOST[key][1:]


def _segment(base, dim, plan, terms, alpha=1, in_place=False):
    uniq, seg, lens, _ = _segment_arrays(plan)
    if alpha != 1:
        terms = terms * alpha
    src = torch.cat([base.index_select(dim, uniq), terms], dim)
    src = src.index_select(dim, seg).movedim(dim, 0)
    sums = torch.segment_reduce(src, "sum", lengths=lens).movedim(0, dim)
    if in_place:
        return base.index_copy_(dim, uniq, sums)
    return base.index_copy(dim, uniq, sums)


@contextlib.contextmanager
def form(name):
    shipped = segsum.add_, segsum.add
    if name == "segment":
        segsum.add_ = lambda base, dim, plan, terms, alpha=1: _segment(
            base, dim, plan, terms, alpha, in_place=True)
        segsum.add = lambda base, dim, plan, terms: _segment(
            base, dim, plan, terms)
    elif name == "index_add_":
        segsum.add_ = lambda base, dim, plan, terms, alpha=1: \
            base.index_add_(dim, _segment_arrays(plan)[3], terms,
                            alpha=alpha)
        segsum.add = lambda base, dim, plan, terms: base.index_add(
            dim, _segment_arrays(plan)[3], terms)
    try:
        yield
    finally:
        segsum.add_, segsum.add = shipped


def best_ms(fn, reps=5):
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    warnings.simplefilter("ignore")
    rows = []
    for dims, amalgamate in (((8, 8, 4), 1), ((8, 8, 4), 4),
                             ((32, 32, 8), 1), ((32, 32, 8), 16)):
        g = grid_mrf.make_grid_mrf(*dims, dtype=torch.float64, device="cpu")
        sched = bcsr.jtj_lower_schedule(g.structure)
        x, J = g.problem().jacobian(torch.linspace(-1, 1, g.nstate,
                                                   dtype=torch.float64))
        ns = SparseNewtonSolver.analyze(sched.rows, sched.cols,
                                        g.structure.nbcol, dims[2],
                                        amalgamate=amalgamate)
        blocks = bcsr.bcsr_jtj_lower_blocks(J, sched)
        rhs = bcsr.bcsr_jt_x(J, x)
        be = ns._backend()
        lam = torch.tensor(1e-3, dtype=torch.float64)
        xs = torch.stack([x * (1 + k) for k in range(8)])

        def solve():
            L, ok = be.factorize(ns.symbolic, blocks, lam)
            return L, be.solve(ns.symbolic, L, rhs)

        def jt_x():
            return torch.func.vmap(lambda v: bcsr.bcsr_jt_x(J, v))(xs)
        want = {}
        with form("index_add_"):
            want["solve"], want["jt_x"] = solve(), jt_x()
        row = {"grid": "x".join(map(str, dims)), "amalgamate": amalgamate,
               "ms": {}}
        for name in FORMS:
            with form(name):
                got = (solve(), jt_x())
                same = all(torch.equal(a, b) for a, b in zip(
                    got[0] + (got[1],), want["solve"] + (want["jt_x"],)))
                row["ms"][name] = {"solve": best_ms(solve),
                                   "vmap8_jt_x": best_ms(jt_x),
                                   "index_add_bits": same}
        rows.append(row)
        print(f"{row['grid']} amalgamate {amalgamate}: " + "; ".join(
            f"{n} solve {v['solve']:.2f} ms, vmap8 J^T x "
            f"{v['vmap8_jt_x']:.2f} ms, index_add_'s bits "
            f"{v['index_add_bits']}" for n, v in row["ms"].items()),
            flush=True)
    print(json.dumps({"cpu": platform.processor() or platform.machine(),
                      "threads": torch.get_num_threads(),
                      "torch": torch.__version__, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
