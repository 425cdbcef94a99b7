"""Demo and self-checking CLI: the reference's sample.c (counterpart of
libdogleg_tpu/sample.py).

Usage:
    python -m libdogleg_tpu_torch.sample [--check] [--diag vnlog|human]
        [--test-gradients] [--f32] [--device cuda|cpu]
        sparse|dense|dense-products-packed-upper|
        dense-products-unpacked|residual|factored

Solves the 6-parameter quadratic-surface fit in the chosen mode; --check
asserts convergence within 8 accepted steps and per-parameter recovery
within 5e-2 (reference sample.c:364-365, 424-457). --diag vnlog prints the
per-attempt vnlog table to stdout; --diag human prints one line an attempt
(the solve's debug=True) and a summary on stderr. --test-gradients prints
the gradient-check table of every variable and solves nothing (reference
sample.c:392-405; the dense-products modes check Jt_x against norm2x); it
excludes --check. `sparse` goes through
the block-CSR SparseProblem with every block stored. The two dense-products
spellings exercise the packed-upper and unpacked JtJ layouts. `residual` is
the autodiff mode. `factored` is the sufficient-statistics form
(FactoredBasisProblem): the same optimum at a cost per evaluation
independent of the measurement count. The measurements and the start
point come from torch.Generators seeded 0 and 1 on the CPU, so every device
solves the same instance. The solve runs on the CUDA device unless --device cpu is given;
with no CUDA device and no --device cpu it prints a message and returns 1.
"""

from __future__ import annotations

import argparse
import sys

GREEN = "\x1b[32m"
RED = "\x1b[31m"
RESET = "\x1b[0m"

MODES = ("sparse", "dense", "dense-products-packed-upper",
         "dense-products-unpacked", "residual", "factored")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="libdogleg_tpu_torch.sample",
        description="libdogleg_tpu_torch demo (the reference sample.c "
                    "problem)")
    ap.add_argument("--check", action="store_true",
                    help="self-check mode: assert convergence + recovery")
    ap.add_argument("--diag", choices=("vnlog", "human"),
                    help="diagnostic stream")
    ap.add_argument("--test-gradients", action="store_true",
                    help="print gradient-check tables and exit")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 instead of float64")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where to solve (default: the CUDA device)")
    ap.add_argument("mode", choices=MODES)
    args = ap.parse_args(argv)

    if args.check and args.test_gradients:
        print("--check and --test-gradients are exclusive", file=sys.stderr)
        return 1

    import torch

    import libdogleg_tpu_torch.sample_problem as sp
    from libdogleg_tpu_torch import DoglegParameters, ProductsProblem, optimize
    from libdogleg_tpu_torch.analysis import (check_gradients,
                                              check_gradients_products,
                                              format_gradient_table)
    from libdogleg_tpu_torch.diagnostics import explain_result, print_vnlog
    from libdogleg_tpu_torch.utils.packed import full_to_packed, packed_to_full

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device (pass --device cpu to solve "
              "on the CPU)", file=sys.stderr)
        return 1
    dtype = torch.float32 if args.f32 else torch.float64
    device = torch.device(args.device)
    meas = sp.simulate(torch.Generator().manual_seed(0), dtype=dtype,
                       device=device)
    p0 = sp.initial_state(torch.Generator().manual_seed(1), dtype=dtype,
                          device=device)

    if args.mode == "sparse":
        problem = sp.make_sparse_problem(meas)
    elif args.mode == "dense":
        problem = sp.make_dense_problem(meas)
    elif args.mode == "residual":
        problem = sp.make_residual_problem(meas)
    elif args.mode == "factored":
        problem = sp.make_factored_problem(meas)
    elif args.mode.endswith("packed-upper"):
        # the user callback produces packed-upper JtJ; the adapter expands
        # it (sample.c:165-237)
        base = sp.make_products_problem(meas)

        def f(p):
            n2, jtx, jtj = base.f(p)
            packed = full_to_packed(jtj, upper=True)
            return n2, jtx, packed_to_full(packed, sp.NSTATE, upper=True)
        problem = ProductsProblem(f=f)
    else:
        problem = sp.make_products_problem(meas)

    if not args.check:
        print(f"Using {args.mode} math", file=sys.stderr)
        print("starting state:", file=sys.stderr)
        for i, v in enumerate(p0.tolist()):
            print(f"  p[{i}] = {v:f}", file=sys.stderr)

    if args.test_gradients:
        if args.mode.startswith("dense-products"):
            print("# ivar gradient_reported gradient_observed error "
                  "error_relative")
            for ivar in range(sp.NSTATE):
                rep, obs, err, rel = check_gradients_products(
                    problem, p0, ivar)
                print(f"{ivar} {float(rep):.6g} {float(obs):.6g} "
                      f"{float(err):.6g} {float(rel):.6g}")
        else:
            for ivar in range(sp.NSTATE):
                print(f"checking gradients for variable {ivar}",
                      file=sys.stderr)
                print(format_gradient_table(
                    check_gradients(problem, p0, ivar)), end="")
        return 0

    # An easy problem, solvable in this many iterations (sample.c:364-365).
    prm = DoglegParameters(max_iterations=8)
    record = args.diag == "vnlog"
    result = optimize(problem, p0, prm, record_history=record,
                      debug=args.diag == "human")
    if record:
        print_vnlog(result)
    if args.diag == "human":
        print(explain_result(result), file=sys.stderr)
    optimum = float(result.norm2_x)

    if args.check:
        if int(result.step_count) > prm.max_iterations:
            print(RED + "ERROR: the optimization did not converge" + RESET)
            return 1
        print(GREEN + "OK: the optimization converged to an optimum  "
              f"of norm2(x)={optimum:.1f}" + RESET)
        anyfailed = False
        for i, (pi, pref) in enumerate(zip(result.p.tolist(), sp.P_TRUE)):
            err = pi - pref
            ok = abs(err) < 5e-2
            print((GREEN + "OK: parameter {i} recovered" if ok else
                   RED + "ERROR: parameter {i} was NOT recovered").format(i=i)
                  + f": psolved={pi:.3f} pref={pref:.3f} perr={err:.3f}"
                  + RESET)
            anyfailed |= not ok
        return 1 if anyfailed else 0

    print(f"Done. Optimum = {optimum:f}", file=sys.stderr)
    print("optimal state:", file=sys.stderr)
    for i, v in enumerate(result.p.tolist()):
        print(f"  p[{i}] = {v:f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
