"""Powell's dog-leg trust-region solver (counterpart of libdogleg_tpu/solver.py).

Two solve loops carry the same decision rules (reference dogleg.c:1172-1476):

* `run_solver` / `solve_products` solve ONE problem as a plain Python loop
  whose branches read host values. The Cauchy step is computed once per
  operating point and the Gauss-Newton step (with the factorization behind
  it) only when the Cauchy step does not fill the trust region and the
  cached GN step is stale, so a rejected step re-runs no factorization
  (reference dogleg.h:86-100). It can record the per-attempt History, and
  `run_solver` can stop after a given number of attempts (segments, which
  checkpoint.py saves and resumes).
* `solve_products_batched` solves a batch of independent problems as a
  masked tensor program over a leading batch axis: every attempt runs for
  the whole batch, each element's update is selected by its own masks, and
  an element freezes once it is done. A data-dependent loop cannot be
  batched with torch.func.vmap, hence the masks. It is the composition of
  `init_batched_state`, `run_batched_solver` (which can stop after a given
  number of attempts, for straggler compaction) and
  `result_from_batched_state`. `run_batched_solver_traced` runs the same
  attempt to the end with no host read (a while_loop, export.py's form). Its states are (B, n) tensors or trees of
  (B, ...) leaves, its JtJ whatever the products return (a SchurJtJ of
  (B, ...) fields for bundle adjustment), and it can record the History,
  one (B, cap) buffer a field.

Termination criteria and their placement match the reference:
  1. inf-norm(Jt_x) <= Jt_x_threshold on the initial point and on accepted
     trial points (dogleg.c:1071-1082, 1364-1371, 1446-1451);
  2. inf-norm(step) <= update_threshold before evaluating the trial
     (dogleg.c:1287-1296);
  3. trustregion < trustregion_threshold after a rejected step
     (dogleg.c:1460-1466);
  4. max_iterations accepted steps (dogleg.c:1376);
plus the attempt cap (STALLED) and FACTORIZATION_FAILED. "Exceeds" means
|v| > threshold, so a NaN element never exceeds a threshold, as in the
reference's C loop.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.ops import dense as dops
from libdogleg_tpu_torch.ops import treevec as tv
from libdogleg_tpu_torch.ops.newton import DenseNewtonSolver
from libdogleg_tpu_torch.params import DoglegParameters


class Products(NamedTuple):
    """An operating point reduced over the measurement axis."""
    norm2_x: torch.Tensor  # (...) norm2(f(p))
    Jt_x: torch.Tensor     # (..., Nstate) J^T x, half the cost gradient
    JtJ: Any               # (..., Nstate, Nstate) Gauss-Newton Hessian


ProductsFn = Callable[[torch.Tensor], Products]


class StopReason(enum.IntEnum):
    """Why the solve stopped (same codes as libdogleg_tpu.StopReason)."""
    RUNNING = 0
    GRADIENT_CONVERGED = 1    # criterion 1
    SMALL_STEP = 2            # criterion 2
    SMALL_TRUSTREGION = 3     # criterion 3
    MAX_ITERATIONS = 4        # criterion 4
    STALLED = 5               # attempt cap
    FACTORIZATION_FAILED = 6  # lambda escalated past lambda_max_tries


class StepType(enum.IntEnum):
    """The reference vnlog step-type taxonomy (dogleg.c:42-46)."""
    CAUCHY = 0
    GAUSSNEWTON = 1
    INTERPOLATED = 2
    FAILED = 3
    UNINITIALIZED = 4


class History(NamedTuple):
    """Per-attempt record, one row per step attempt: the reference vnlog
    schema (dogleg.c:50-64, 104-113). Unset fields hold +inf."""
    iteration: torch.Tensor                  # (cap,) int32
    step_accepted: torch.Tensor              # (cap,) int32
    norm2x_before: torch.Tensor              # (cap,)
    norm2x_after: torch.Tensor               # (cap,)
    step_len_cauchy: torch.Tensor            # (cap,)
    step_len_gauss_newton: torch.Tensor      # (cap,)
    step_len_interpolated: torch.Tensor      # (cap,)
    k_cauchy_to_gn: torch.Tensor             # (cap,)
    step_len: torch.Tensor                   # (cap,)
    step_type: torch.Tensor                  # (cap,) int32 (StepType)
    step_direction_change_deg: torch.Tensor  # (cap,)
    expected_improvement: torch.Tensor       # (cap,)
    observed_improvement: torch.Tensor       # (cap,)
    rho: torch.Tensor                        # (cap,)
    trustregion_before: torch.Tensor         # (cap,)
    trustregion_after: torch.Tensor          # (cap,)


class SolveResult(NamedTuple):
    p: Any                     # (..., Nstate) final state, or a tree
    norm2_x: torch.Tensor      # (...) cost at the final state
    Jt_x: Any                  # (..., Nstate) gradient at the final state
    JtJ: Any                   # (..., Nstate, Nstate), or the strategy's form
    step_count: torch.Tensor   # (...) int32: accepted steps
    n_attempts: torch.Tensor   # (...) int32: attempts incl. rejects
    reason: torch.Tensor       # (...) int32 StopReason
    trustregion: torch.Tensor  # (...) final trust-region radius
    lam: torch.Tensor          # (...) permanent Tikhonov lambda
    history: Optional[History] = None


class SolverState(NamedTuple):
    """The single-problem solve state between attempts (the JAX package's
    _Carry). Flags and counters are Python values. The state vectors (p,
    Jt_x, the cached steps) are (Nstate,) tensors or trees of tensors
    (ops/treevec.py), such as {"c": cameras, "q": points}."""
    p: torch.Tensor
    norm2_x: torch.Tensor
    Jt_x: torch.Tensor
    JtJ: torch.Tensor
    # cached update vectors (reference dogleg.h:72-80)
    cauchy: torch.Tensor
    norm2_cauchy: torch.Tensor
    have_cauchy: bool
    gn: torch.Tensor
    norm2_gn: torch.Tensor
    have_gn: bool
    # the accepted step into the current point (diagnostics only)
    prev_step: torch.Tensor
    norm2_prev_step: torch.Tensor
    have_prev_step: bool
    lam: torch.Tensor
    trustregion: torch.Tensor
    step_count: int
    n_attempts: int
    done: bool
    reason: int
    history: Optional[History]


def _empty_history(cap: int, dtype, device) -> History:
    def full(v, dt):
        return torch.full((cap,), v, dtype=dt, device=device)
    return History(
        iteration=full(-1, torch.int32), step_accepted=full(-1, torch.int32),
        norm2x_before=full(math.inf, dtype), norm2x_after=full(math.inf, dtype),
        step_len_cauchy=full(math.inf, dtype),
        step_len_gauss_newton=full(math.inf, dtype),
        step_len_interpolated=full(math.inf, dtype),
        k_cauchy_to_gn=full(math.inf, dtype), step_len=full(math.inf, dtype),
        step_type=full(int(StepType.UNINITIALIZED), torch.int32),
        step_direction_change_deg=full(math.inf, dtype),
        expected_improvement=full(math.inf, dtype),
        observed_improvement=full(math.inf, dtype), rho=full(math.inf, dtype),
        trustregion_before=full(math.inf, dtype),
        trustregion_after=full(math.inf, dtype))


def init_solver_state(products_fn: ProductsFn,
                      p0: torch.Tensor,
                      parameters: Optional[DoglegParameters] = None,
                      *,
                      record_history: bool = False,
                      history_capacity: Optional[int] = None,
                      shards=None) -> SolverState:
    """Evaluate the initial operating point and build the solve state,
    including the initial convergence test (reference dogleg.c:1364-1371).

    A point-sharded start (as solve_products takes it) gives a
    point-sharded state: evaluated on the rank's local leaves, its leaves
    DTensors placed as parallel/points.PointShards.wrap says, which
    run_solver continues and checkpoint.save_state_orbax saves. shards: the PointShards of a
    point-sharded start given as its local leaves (the state's leaves are
    then local too), or None."""
    wrap = shards is None and tv.is_sharded(p0)
    if wrap:
        from libdogleg_tpu_torch.parallel.points import point_shards
        shards, p0 = point_shards(p0)
    prm = parameters if parameters is not None else DoglegParameters()
    init = products_fn(p0)
    first = tv.tree_leaves(p0)[0]
    zero = torch.zeros((), dtype=first.dtype, device=first.device)
    zvec = tv.tree_zeros_like(p0)
    converged0 = not bool(tv.tree_any_exceeds(init.Jt_x, prm.Jt_x_threshold,
                                              shards))
    history = None
    if record_history:
        history = _empty_history(
            history_capacity or prm.resolved_max_attempts(), first.dtype,
            first.device)
    state = SolverState(
        p=p0, norm2_x=init.norm2_x, Jt_x=init.Jt_x, JtJ=init.JtJ,
        cauchy=zvec, norm2_cauchy=zero, have_cauchy=False,
        gn=zvec, norm2_gn=zero, have_gn=False,
        prev_step=zvec, norm2_prev_step=zero, have_prev_step=False,
        lam=zero, trustregion=torch.full_like(zero, prm.trustregion0),
        step_count=0, n_attempts=0, done=converged0,
        reason=int(StopReason.GRADIENT_CONVERGED if converged0
                   else StopReason.RUNNING),
        history=history)
    return shards.wrap(state) if wrap else state


def _record(c: SolverState, step, norm2_step, step_type, norm2_cauchy,
            norm2_gn, use_cauchy, interp, expected, small_step, accept,
            trial_norm2, observed, rho, tr_new, shards) -> None:
    """Write this attempt's History row in place (JAX solver.py:478-536)."""
    h = c.history
    idx = min(c.n_attempts, h.iteration.shape[0] - 1)
    inf = math.inf
    if c.have_prev_step:
        cos_dc = float(tv.tree_dot(step, c.prev_step, shards)
                       / torch.sqrt(norm2_step * c.norm2_prev_step))
        dc_deg = (0.0 if cos_dc >= 1.0 else 180.0 if cos_dc <= -1.0
                  else math.degrees(math.acos(cos_dc)))
    else:
        dc_deg = inf
    row = {
        "iteration": c.step_count,
        # the small-step termination row is recorded as accepted, matching
        # the reference's emit at dogleg.c:1404-1406
        "step_accepted": int(accept or small_step),
        "norm2x_before": c.norm2_x,
        "norm2x_after": inf if small_step else trial_norm2,
        "step_len_cauchy": torch.sqrt(norm2_cauchy),
        "step_len_gauss_newton": inf if use_cauchy else torch.sqrt(norm2_gn),
        "step_len_interpolated": (inf if interp is None
                                  else torch.sqrt(interp.norm2_step)),
        "k_cauchy_to_gn": inf if interp is None else interp.k,
        "step_len": torch.sqrt(norm2_step),
        "step_type": int(step_type),
        "step_direction_change_deg": dc_deg,
        "expected_improvement": expected,
        "observed_improvement": inf if small_step else observed,
        "rho": inf if small_step else rho,
        "trustregion_before": c.trustregion,
        "trustregion_after": inf if small_step else tr_new,
    }
    for name, value in row.items():
        getattr(h, name)[idx] = value


# The human diagnostic stream of debug=True, one line an attempt, in the
# JAX package's text (its jax.debug.print, solver.py:463-476): the
# reference's SAY_IF_VERBOSE narration at each solver decision (reference
# dogleg.c:1182, 611, 900, 1314, 1432, 1456).
_DEBUG_LINE = ("libdogleg-tpu: attempt {a}: trustregion {tr:.6} | "
               "cauchy {lc:.6} gn {lg} | step type {st} len {ls:.6} | "
               "expected/observed {e:.6}/{o:.6} rho {r:.6} | "
               "accept {acc} -> trustregion {tr2:.6}")


def _debug_print(c: SolverState, tr, norm2_cauchy, norm2_gn, have_gn,
                 step_type, norm2_step, expected, observed, rho, accept,
                 tr_new) -> None:
    """Print this attempt's debug line to stdout. Each value is a numpy
    scalar of the solve's dtype, so it formats as jax.debug.print's do."""
    def host(v):
        return np.asarray(torch.as_tensor(v).detach().cpu())[()]
    lg = torch.sqrt(norm2_gn) if have_gn else torch.full_like(norm2_gn,
                                                              math.nan)
    print(_DEBUG_LINE.format(
        a=c.n_attempts, tr=host(tr), lc=host(torch.sqrt(norm2_cauchy)),
        lg=host(lg), st=int(step_type), ls=host(torch.sqrt(norm2_step)),
        e=host(expected), o=host(observed), r=host(rho), acc=accept,
        tr2=host(tr_new)))


def _attempt(products_fn: ProductsFn, c: SolverState,
             prm: DoglegParameters, ns, max_attempts: int,
             debug: bool = False, shards=None) -> SolverState:
    """One step attempt: the body of the reference's retry loop
    (dogleg.c:1380-1468). shards: as init_solver_state's; ns then sums
    over the same axis."""
    tr = c.trustregion
    tr_sq = tr * tr

    # Cauchy step, once per operating point (dogleg.c:529-617).
    if c.have_cauchy:
        cauchy, norm2_cauchy = c.cauchy, c.norm2_cauchy
    else:
        n2_jtx = tv.tree_dot(c.Jt_x, c.Jt_x, shards)
        k = -n2_jtx / ns.quad_form(c.JtJ, c.Jt_x)
        cauchy, norm2_cauchy = tv.tree_scale(k, c.Jt_x), k * k * n2_jtx
    use_cauchy = bool(norm2_cauchy >= tr_sq)

    # Gauss-Newton step, lazily (dogleg.c:822-908, called at dogleg.c:1218).
    need_gn = not use_cauchy and not c.have_gn
    if need_gn:
        res = ns.gauss_newton(c.JtJ, c.Jt_x, c.lam,
                              lambda_initial=prm.lambda_initial,
                              lambda_max_tries=prm.lambda_max_tries)
        gn, norm2_gn, lam, fac_ok = (res.step, res.norm2_step, res.lam,
                                     bool(res.ok))
    else:
        gn, norm2_gn, lam, fac_ok = c.gn, c.norm2_gn, c.lam, True
    have_gn = c.have_gn or need_gn

    # Step selection (dogleg.c:1172-1297).
    use_gn = not use_cauchy and bool(norm2_gn <= tr_sq)
    interp = None
    if use_cauchy:
        step = tv.tree_scale(tr / torch.sqrt(norm2_cauchy), cauchy)
        # the reference records the UNCLAMPED Cauchy length (dogleg.c:1200)
        norm2_step, step_type = norm2_cauchy, StepType.CAUCHY
    elif use_gn:
        step, norm2_step, step_type = gn, norm2_gn, StepType.GAUSSNEWTON
    else:
        interp = dops.interpolated_step(cauchy, norm2_cauchy, gn, tr, shards)
        step, norm2_step = interp.step, interp.norm2_step
        step_type = StepType.INTERPOLATED

    expected = (-2.0 * tv.tree_dot(c.Jt_x, step, shards)
                - ns.quad_form(c.JtJ, step))
    small_step = not bool(tv.tree_any_exceeds(step, prm.update_threshold,
                                              shards))

    # Evaluate the trial point (dogleg.c:1411) unless the attempt ends here.
    p_new = tv.tree_add(c.p, step)
    if small_step or not fac_ok:
        trial = Products(c.norm2_x, c.Jt_x, c.JtJ)
    else:
        trial = products_fn(p_new)
    observed = c.norm2_x - trial.norm2_x
    rho = observed / expected
    tr_new = dops.trust_region_update(
        rho, tr, not use_gn, norm2_gn,
        decrease_factor=prm.trustregion_decrease_factor,
        decrease_threshold=prm.trustregion_decrease_threshold,
        increase_factor=prm.trustregion_increase_factor,
        increase_threshold=prm.trustregion_increase_threshold)
    accept = bool(rho > 0.0)
    n_attempts = c.n_attempts + 1
    exhausted = n_attempts >= max_attempts

    if debug:
        _debug_print(c, tr, norm2_cauchy, norm2_gn, have_gn, step_type,
                     norm2_step, expected, observed, rho,
                     accept and not small_step, tr_new)
    if c.history is not None:
        _record(c, step, norm2_step, step_type, norm2_cauchy, norm2_gn,
                use_cauchy, interp, expected, small_step, accept,
                trial.norm2_x, observed, rho, tr_new, shards)

    kept = c._replace(cauchy=cauchy, norm2_cauchy=norm2_cauchy,
                      have_cauchy=True, gn=gn, norm2_gn=norm2_gn,
                      have_gn=have_gn, lam=lam, n_attempts=n_attempts)
    if not fac_ok:
        return kept._replace(
            done=True, reason=int(StopReason.FACTORIZATION_FAILED))
    if small_step:
        return kept._replace(done=True, reason=int(StopReason.SMALL_STEP))
    if accept:
        step_count = c.step_count + 1
        if not bool(tv.tree_any_exceeds(trial.Jt_x, prm.Jt_x_threshold,
                                        shards)):
            reason = StopReason.GRADIENT_CONVERGED
        elif step_count >= prm.max_iterations:
            reason = StopReason.MAX_ITERATIONS
        elif exhausted:
            reason = StopReason.STALLED
        else:
            reason = StopReason.RUNNING
        return kept._replace(
            p=p_new, norm2_x=trial.norm2_x, Jt_x=trial.Jt_x, JtJ=trial.JtJ,
            have_cauchy=False, have_gn=False,
            prev_step=step, norm2_prev_step=norm2_step, have_prev_step=True,
            trustregion=tr_new, step_count=step_count,
            done=reason != StopReason.RUNNING, reason=int(reason))
    if bool(tr_new < prm.trustregion_threshold):
        reason = StopReason.SMALL_TRUSTREGION
    elif exhausted:
        reason = StopReason.STALLED
    else:
        reason = StopReason.RUNNING
    return kept._replace(trustregion=tr_new,
                         done=reason != StopReason.RUNNING,
                         reason=int(reason))


def _attempt_limit(n_attempts, max_new_attempts: Optional[int],
                   wavefront_unroll: int):
    """The attempt count a segment stops at: n_attempts plus
    max_new_attempts rounded up to a multiple of wavefront_unroll (the JAX
    package runs k attempts between two tests of its loop condition), or
    None for a run to the end."""
    if max_new_attempts is None:
        return None
    k = max(1, int(wavefront_unroll))
    return n_attempts + -(-int(max_new_attempts) // k) * k


def run_solver(products_fn: ProductsFn,
               state: SolverState,
               parameters: Optional[DoglegParameters] = None,
               *,
               newton_solver=None,
               max_new_attempts: Optional[int] = None,
               wavefront_unroll: int = 1,
               debug: bool = False,
               shards=None) -> SolverState:
    """Advance a single-problem solve until it terminates (default) or for
    at most max_new_attempts further attempts, the segmented form of a
    checkpointed run: resuming from the returned state continues the
    iteration exactly, since the caches, lambda and the trust region live
    in the state. With wavefront_unroll=k the budget is rounded up to a
    multiple of k, as in the JAX package; a run to the end does not depend
    on k. A finished state comes back unchanged. debug=True prints one line
    an attempt to stdout (the human diagnostic stream).

    A point-sharded state (init_solver_state's of a point-sharded start,
    or load_state_orbax's) runs on the rank's local leaves with the
    newton_solver's `shards` set to its sharding (a Schur strategy; one
    built for the unsharded problem serves) and comes back point-sharded;
    every rank of the axis calls it. shards: the PointShards of a state
    given as its local leaves, or None (the newton_solver's own `shards`
    then set by the caller)."""
    wrap = shards is None and tv.is_sharded(state.p)
    if wrap:
        from libdogleg_tpu_torch.parallel.points import point_shards
        shards, state = point_shards(state)
        if not hasattr(newton_solver, "shards"):
            raise ValueError(
                "a point-sharded solve takes a Schur strategy "
                "(TreeSchurNewtonSolver, SparseWSchurNewtonSolver); got "
                f"{type(newton_solver).__name__}")
        newton_solver = dataclasses.replace(newton_solver, shards=shards)
    prm = parameters if parameters is not None else DoglegParameters()
    ns = newton_solver if newton_solver is not None else DenseNewtonSolver()
    max_attempts = prm.resolved_max_attempts()
    limit = _attempt_limit(state.n_attempts, max_new_attempts,
                           wavefront_unroll)
    while not state.done and (limit is None or state.n_attempts < limit):
        state = _attempt(products_fn, state, prm, ns, max_attempts, debug,
                         shards)
    return shards.wrap(state) if wrap else state


def result_from_state(state: SolverState) -> SolveResult:
    """Package a single-problem solve state as a SolveResult (reason is
    RUNNING while a segmented run has not terminated)."""
    dev = tv.tree_leaves(state.p)[0].device

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    return SolveResult(
        p=state.p, norm2_x=state.norm2_x, Jt_x=state.Jt_x, JtJ=state.JtJ,
        step_count=i32(state.step_count), n_attempts=i32(state.n_attempts),
        reason=i32(state.reason), trustregion=state.trustregion,
        lam=state.lam, history=state.history)


def solve_products(products_fn: ProductsFn,
                   p0: torch.Tensor,
                   parameters: Optional[DoglegParameters] = None,
                   *,
                   newton_solver=None,
                   record_history: bool = False,
                   history_capacity: Optional[int] = None,
                   debug: bool = False) -> SolveResult:
    """Run the dog-leg trust-region optimization of one problem.

    products_fn: p (Nstate,) -> Products, the counterpart of the reference's
    callback (dogleg.c:1016). p0 may be a tree of tensors instead, such as
    {"c": (nc,), "q": (n_points, bs)}, with Jt_x the same tree and a
    newton_solver for it (TreeSchurNewtonSolver, SparseWSchurNewtonSolver).
    history_capacity defaults to the attempt cap; attempts past capacity
    overwrite the last row. debug=True prints one line an attempt to
    stdout, with the JAX package's text (its jax.debug.print); it reads
    each value on the host, so it is for diagnosis, not for timing.

    A point-sharded solve (parallel/points.py): p0 a dict whose point leaf
    is a DTensor sharded on its leading axis over one mesh axis (others
    replicated, or plain tensors), as BAProblem.shard_p_tree gives, with
    products of a problem sharded the same way and a Schur strategy
    (TreeSchurNewtonSolver, SparseWSchurNewtonSolver; one built for the
    unsharded problem serves). Every rank of the axis calls it; each
    solves on its local rows, every sum over points an all_reduce. The
    result's fields are DTensors placed as the state's
    (PointShards.wrap): p's and Jt_x's point leaves and the JtJ's point
    blocks sharded, the rest replicated; the counters plain tensors.
    """
    state = init_solver_state(products_fn, p0, parameters,
                              record_history=record_history,
                              history_capacity=history_capacity)
    return result_from_state(run_solver(products_fn, state, parameters,
                                        newton_solver=newton_solver,
                                        debug=debug))


# ---------------------------------------------------------------------------
# the masked batched solver
# ---------------------------------------------------------------------------


class BatchedSolverState(NamedTuple):
    """The masked batched solve's state between attempts, every field with
    a leading batch axis: SolverState's fields as tensors. The state
    vectors are (B, n) tensors or trees whose every leaf is (B, ...), such
    as {"c": (B, nc), "q": (B, n_points, bs)}; JtJ is what the products
    return, such as a SchurJtJ of (B, ...) fields. The last four fields
    are carried only when the History is recorded (None otherwise)."""
    p: Any                      # (B, n) or a tree
    norm2_x: torch.Tensor       # (B,)
    Jt_x: Any                   # (B, n) or a tree
    JtJ: Any                    # (B, n, n) or the strategy's form
    cauchy: Any                 # (B, n) or a tree
    norm2_cauchy: torch.Tensor  # (B,)
    have_cauchy: torch.Tensor   # (B,) bool
    gn: Any                     # (B, n) or a tree
    norm2_gn: torch.Tensor      # (B,)
    have_gn: torch.Tensor       # (B,) bool
    lam: torch.Tensor           # (B,)
    trustregion: torch.Tensor   # (B,)
    step_count: torch.Tensor    # (B,) int32
    n_attempts: torch.Tensor    # (B,) int32
    done: torch.Tensor          # (B,) bool
    reason: torch.Tensor        # (B,) int32
    # the accepted step into the current point (the History's direction
    # change)
    prev_step: Any = None               # (B, n) or a tree
    norm2_prev_step: Optional[torch.Tensor] = None  # (B,)
    have_prev_step: Optional[torch.Tensor] = None   # (B,) bool
    history: Optional[History] = None   # every field (B, cap)


def _history_rows(c: BatchedSolverState, step, norm2_step, step_type,
                  norm2_cauchy, norm2_gn, use_cauchy, use_gn, interp,
                  expected, small_step, accept, trial_norm2, observed, rho,
                  tr_new) -> History:
    """The History with this attempt's row written for every element, at
    row min(n_attempts, cap - 1) of each (JAX solver.py:478-536; _record's
    row), on tensors: no value is read on the host. The caller keeps the
    old History of the elements that are frozen."""
    h = c.history
    cap = h.iteration.shape[1]
    idx = torch.clamp(c.n_attempts, max=cap - 1).long()[:, None]
    inf = torch.full_like(norm2_step, math.inf)
    cos_dc = tv.batch_dot(step, c.prev_step) / torch.sqrt(
        norm2_step * c.norm2_prev_step)
    dc_deg = torch.where(
        cos_dc >= 1.0, torch.zeros_like(cos_dc),
        torch.where(cos_dc <= -1.0, torch.full_like(cos_dc, 180.0),
                    torch.rad2deg(torch.arccos(cos_dc.clamp(-1.0, 1.0)))))
    interpolated = ~use_cauchy & ~use_gn
    row = History(
        iteration=c.step_count,
        # the small-step termination row is recorded as accepted, matching
        # the reference's emit at dogleg.c:1404-1406
        step_accepted=(accept | small_step).to(torch.int32),
        norm2x_before=c.norm2_x,
        norm2x_after=torch.where(small_step, inf, trial_norm2),
        step_len_cauchy=torch.sqrt(norm2_cauchy),
        step_len_gauss_newton=torch.where(use_cauchy, inf,
                                          torch.sqrt(norm2_gn)),
        step_len_interpolated=torch.where(interpolated,
                                          torch.sqrt(interp.norm2_step), inf),
        k_cauchy_to_gn=torch.where(interpolated, interp.k, inf),
        step_len=torch.sqrt(norm2_step),
        step_type=step_type,
        step_direction_change_deg=torch.where(c.have_prev_step, dc_deg, inf),
        expected_improvement=expected,
        observed_improvement=torch.where(small_step, inf, observed),
        rho=torch.where(small_step, inf, rho),
        trustregion_before=c.trustregion,
        trustregion_after=torch.where(small_step, inf, tr_new))
    return History(*(buf.scatter(1, idx, val.to(buf.dtype)[:, None])
                     for buf, val in zip(h, row)))


def _batched_attempt(products_fn: ProductsFn, c: BatchedSolverState,
                     prm: DoglegParameters, ns, max_attempts: int,
                     frozen: torch.Tensor,
                     traced: bool = False) -> BatchedSolverState:
    """One attempt for every element; the caller keeps the old state of the
    `frozen` elements (done, or out of this segment's attempts). Every
    reduction is per element (ops/treevec.py's batch_* form), so nothing
    of one element, a NaN included, reaches another. traced=True reads no
    value on the host: whether any element needs a Gauss-Newton step is a
    cond (ops/traced.py), which torch.export captures."""
    R = StopReason
    tr = c.trustregion
    tr_sq = tr * tr

    n2_jtx = tv.batch_dot(c.Jt_x, c.Jt_x)
    k = -n2_jtx / ns.quad_form(c.JtJ, c.Jt_x)
    cauchy = tv.batch_where(c.have_cauchy, c.cauchy,
                            tv.batch_scale(k, c.Jt_x))
    norm2_cauchy = torch.where(c.have_cauchy, c.norm2_cauchy, k * k * n2_jtx)
    use_cauchy = norm2_cauchy >= tr_sq

    # Gauss-Newton under the masked escalating lambda: only elements that
    # need a fresh GN step escalate.
    need_gn = ~use_cauchy & ~c.have_gn & ~frozen

    def fresh_gn(JtJ, Jt_x, gn, norm2_gn, lam, need_gn):
        res = ns.gauss_newton(JtJ, Jt_x, lam,
                              lambda_initial=prm.lambda_initial,
                              lambda_max_tries=prm.lambda_max_tries,
                              active=need_gn)
        return (tv.batch_where(need_gn, res.step, gn),
                torch.where(need_gn, res.norm2_step, norm2_gn),
                torch.where(need_gn, res.lam, lam), res.ok | ~need_gn)

    def kept_gn(JtJ, Jt_x, gn, norm2_gn, lam, need_gn):
        return (tv.tree_map(torch.clone, gn), norm2_gn.clone(), lam.clone(),
                torch.ones_like(need_gn))

    operands = (c.JtJ, c.Jt_x, c.gn, c.norm2_gn, c.lam, need_gn)
    if traced:
        from libdogleg_tpu_torch.ops import traced as hop
        gn, norm2_gn, lam, fac_ok = hop.cond(need_gn.any(), fresh_gn,
                                             kept_gn, operands)
    elif bool(need_gn.any()):
        gn, norm2_gn, lam, fac_ok = fresh_gn(*operands)
    else:
        gn, norm2_gn, lam = c.gn, c.norm2_gn, c.lam
        fac_ok = torch.ones_like(c.done)
    have_gn = c.have_gn | need_gn

    use_gn = ~use_cauchy & (norm2_gn <= tr_sq)
    interp = dops.interpolated_step(cauchy, norm2_cauchy, gn, tr)
    step = tv.batch_where(
        use_cauchy, tv.batch_scale(tr / torch.sqrt(norm2_cauchy), cauchy),
        tv.batch_where(use_gn, gn, interp.step))
    expected = -2.0 * tv.batch_dot(c.Jt_x, step) - ns.quad_form(c.JtJ, step)
    small_step = ~tv.batch_any_exceeds(step, prm.update_threshold)

    # The trial products run for every element and are masked out where the
    # attempt ends before evaluating them. JtJ is taken only where the step
    # is accepted, which implies the trial ran.
    p_new = tv.tree_add(c.p, step)
    trial = products_fn(p_new)
    skip = small_step | ~fac_ok
    t_norm2 = torch.where(skip, c.norm2_x, trial.norm2_x)
    t_jtx = tv.batch_where(skip, c.Jt_x, trial.Jt_x)

    observed = c.norm2_x - t_norm2
    rho = observed / expected
    tr_new = dops.trust_region_update(
        rho, tr, ~use_gn, norm2_gn,
        decrease_factor=prm.trustregion_decrease_factor,
        decrease_threshold=prm.trustregion_decrease_threshold,
        increase_factor=prm.trustregion_increase_factor,
        increase_threshold=prm.trustregion_increase_threshold)
    accept = rho > 0.0
    n_attempts = c.n_attempts + 1
    exhausted = n_attempts >= max_attempts
    step_count_acc = c.step_count + 1

    conv_t = ~tv.batch_any_exceeds(t_jtx, prm.Jt_x_threshold)
    max_iters = step_count_acc >= prm.max_iterations
    acc_done = conv_t | max_iters | exhausted
    running = torch.full_like(c.reason, int(R.RUNNING))
    acc_reason = torch.where(
        conv_t, int(R.GRADIENT_CONVERGED),
        torch.where(max_iters, int(R.MAX_ITERATIONS),
                    torch.where(exhausted, int(R.STALLED), running)))
    small_tr = tr_new < prm.trustregion_threshold
    rej_done = small_tr | exhausted
    rej_reason = torch.where(small_tr, int(R.SMALL_TRUSTREGION),
                             torch.where(exhausted, int(R.STALLED), running))

    # path combination, as solver.py's nested
    # where(~fac_ok, failed, where(small_step, small, where(accept, ...)))
    m_fail = ~fac_ok
    m_small = fac_ok & small_step
    m_acc = fac_ok & ~small_step & accept
    m_end = m_fail | m_small
    out = BatchedSolverState(
        p=tv.batch_where(m_acc, p_new, c.p),
        norm2_x=torch.where(m_acc, t_norm2, c.norm2_x),
        Jt_x=tv.batch_where(m_acc, t_jtx, c.Jt_x),
        JtJ=tv.batch_where(m_acc, trial.JtJ, c.JtJ),
        cauchy=cauchy, norm2_cauchy=norm2_cauchy, have_cauchy=~m_acc,
        gn=gn, norm2_gn=norm2_gn, have_gn=have_gn & ~m_acc,
        lam=lam,
        trustregion=torch.where(m_end, tr, tr_new),
        step_count=torch.where(m_acc, step_count_acc, c.step_count),
        n_attempts=n_attempts,
        done=m_end | torch.where(m_acc, acc_done, rej_done),
        reason=torch.where(
            m_fail, int(R.FACTORIZATION_FAILED),
            torch.where(m_small, int(R.SMALL_STEP),
                        torch.where(m_acc, acc_reason, rej_reason))))
    if c.history is None:
        return out
    # the recorded step length is the UNCLAMPED Cauchy length on a Cauchy
    # step (reference dogleg.c:1200)
    norm2_step = torch.where(use_cauchy, norm2_cauchy,
                             torch.where(use_gn, norm2_gn, interp.norm2_step))
    step_type = torch.where(
        use_cauchy, int(StepType.CAUCHY),
        torch.where(use_gn, int(StepType.GAUSSNEWTON),
                    int(StepType.INTERPOLATED))).to(torch.int32)
    return out._replace(
        prev_step=tv.batch_where(m_acc, step, c.prev_step),
        norm2_prev_step=torch.where(m_acc, norm2_step, c.norm2_prev_step),
        have_prev_step=c.have_prev_step | m_acc,
        history=_history_rows(c, step, norm2_step, step_type, norm2_cauchy,
                              norm2_gn, use_cauchy, use_gn, interp, expected,
                              small_step, accept, t_norm2, observed, rho,
                              tr_new))


def init_batched_state(products_fn: ProductsFn, p0,
                       parameters: Optional[DoglegParameters] = None,
                       *,
                       record_history: bool = False,
                       history_capacity: Optional[int] = None
                       ) -> BatchedSolverState:
    """Evaluate the initial operating points of a batch and build the
    masked solver's state, including the initial convergence test.

    products_fn: p (B, Nstate) -> Products with leading batch axes
    ((B,), (B, n), (B, n, n)); p0 may be a tree whose every leaf has the
    leading batch axis, with the products' Jt_x the same tree and JtJ the
    strategy's form. record_history allocates one (B, cap) History, cap
    being history_capacity or the attempt cap."""
    prm = parameters if parameters is not None else DoglegParameters()
    first = tv.tree_leaves(p0)[0]
    B, dtype, dev = first.shape[0], first.dtype, first.device
    init = products_fn(p0)
    zeros = torch.zeros(B, dtype=dtype, device=dev)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    i0 = torch.zeros(B, dtype=torch.int32, device=dev)
    done = ~tv.batch_any_exceeds(init.Jt_x, prm.Jt_x_threshold)
    state = BatchedSolverState(
        p=p0, norm2_x=init.norm2_x, Jt_x=init.Jt_x, JtJ=init.JtJ,
        cauchy=tv.tree_zeros_like(p0), norm2_cauchy=zeros, have_cauchy=no,
        gn=tv.tree_zeros_like(p0), norm2_gn=zeros, have_gn=no,
        lam=zeros, trustregion=torch.full_like(zeros, prm.trustregion0),
        step_count=i0, n_attempts=i0, done=done,
        reason=torch.where(done, int(StopReason.GRADIENT_CONVERGED), i0))
    if not record_history:
        return state
    cap = history_capacity or prm.resolved_max_attempts()
    one = _empty_history(cap, dtype, dev)
    return state._replace(
        prev_step=tv.tree_zeros_like(p0), norm2_prev_step=zeros,
        have_prev_step=no,
        history=History(*(h.expand(B, cap).clone() for h in one)))


def run_batched_solver(products_fn: ProductsFn, state: BatchedSolverState,
                       parameters: Optional[DoglegParameters] = None,
                       *,
                       newton_solver=None,
                       max_new_attempts: Optional[int] = None,
                       wavefront_unroll: int = 1
                       ) -> BatchedSolverState:
    """Advance every element of a batched solve until it terminates
    (default) or for at most max_new_attempts further attempts of its own,
    the segmented form: resuming from the returned state continues each
    element's iteration exactly, since the caches, lambda and the trust
    region live in the state. wavefront_unroll=k rounds the budget up to a
    multiple of k, as run_solver does. A structured JtJ (not a tensor)
    needs a newton_solver that takes a batch of it."""
    prm = parameters if parameters is not None else DoglegParameters()
    if newton_solver is None and not isinstance(state.JtJ, torch.Tensor):
        raise ValueError(
            f"a batch of {type(state.JtJ).__name__} systems needs a "
            f"newton_solver for it, such as TreeSchurNewtonSolver (tree "
            f"states) or SchurNewtonSolver (flat states)")
    ns = newton_solver if newton_solver is not None else DenseNewtonSolver()
    max_attempts = prm.resolved_max_attempts()
    c = state
    limit = _attempt_limit(state.n_attempts, max_new_attempts,
                           wavefront_unroll)
    while True:
        frozen = c.done if limit is None else c.done | (c.n_attempts >= limit)
        if bool(frozen.all()):
            return c
        out = _batched_attempt(products_fn, c, prm, ns, max_attempts, frozen)
        c = tv.batch_where(frozen, c, out)


def run_batched_solver_traced(products_fn: ProductsFn,
                              state: BatchedSolverState,
                              parameters: Optional[DoglegParameters] = None,
                              *,
                              newton_solver=None) -> BatchedSolverState:
    """run_batched_solver to the end in the form torch.export captures:
    the wavefront loop is a while_loop over the state while any element
    runs, the Gauss-Newton step a cond, and every escalating lambda a
    while_loop of its own (ops/traced.py, ops/cholesky.traced_loops). No
    value is read on the host, so the same function runs eagerly (a Python
    loop over the same body) and traced, with the same decisions as
    run_batched_solver. The History is not recorded here."""
    from libdogleg_tpu_torch.ops import cholesky as chol
    from libdogleg_tpu_torch.ops import traced as hop
    prm = parameters if parameters is not None else DoglegParameters()
    if state.history is not None:
        raise ValueError("the traced solve records no History")
    ns = newton_solver if newton_solver is not None else DenseNewtonSolver()
    max_attempts = prm.resolved_max_attempts()

    def body(c):
        out = _batched_attempt(products_fn, c, prm, ns, max_attempts, c.done,
                               traced=True)
        return (tv.batch_where(c.done, c, out),)

    with chol.traced_loops():
        (c,) = hop.while_loop(lambda c: (~c.done).any(), body, (state,))
    return c


def result_from_batched_state(state: BatchedSolverState) -> SolveResult:
    """Package a batched solve state as a batch-leading SolveResult, with
    its History when one was recorded."""
    c = state
    return SolveResult(p=c.p, norm2_x=c.norm2_x, Jt_x=c.Jt_x, JtJ=c.JtJ,
                       step_count=c.step_count, n_attempts=c.n_attempts,
                       reason=c.reason, trustregion=c.trustregion, lam=c.lam,
                       history=c.history)


def solve_products_batched(products_fn: ProductsFn,
                           p0,
                           parameters: Optional[DoglegParameters] = None,
                           *,
                           newton_solver=None,
                           record_history: bool = False,
                           history_capacity: Optional[int] = None
                           ) -> SolveResult:
    """Solve a batch of independent problems with the masked tensor program.

    products_fn: p (B, Nstate) -> Products with leading batch axes
    ((B,), (B, n), (B, n, n)), or over batched trees and structured JtJ
    (init_batched_state). Each element takes exactly the decisions of its
    own single solve. Returns a batch-leading SolveResult, with the (B,
    cap) History when record_history is set.
    """
    state = init_batched_state(products_fn, p0, parameters,
                               record_history=record_history,
                               history_capacity=history_capacity)
    return result_from_batched_state(run_batched_solver(
        products_fn, state, parameters, newton_solver=newton_solver))
