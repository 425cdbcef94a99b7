"""Faults planted underneath the timed path, for the checks that `correct`
comes out false when the program is broken (benchmark/tests/ and
calibrate.py). Each is a context manager that patches the program's batched
entry points, which the drivers reach through their module's attributes:

- unchanged: every step returns its state unchanged (the program run with
  a zero trust region, so every step is nought and the solve stops where it
  started);
- half: half of each batch left out (each call solves its first half and
  hands back the second half's starts);
- altered: one answer altered where it is produced (one problem's first
  parameter of every call moved by 0.01);
- stopping: the stopping rule's cap off by one (the program run with
  max_iterations one below the configuration's).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _entries_wrapped(wrap):
    """Each batched entry point replaced by wrap(entry point)."""
    from libdogleg_tpu_torch.parallel import batched
    names = ("batched_optimize", "batched_optimize_compacted")
    saved = {name: getattr(batched, name) for name in names}
    for name in names:
        setattr(batched, name, wrap(saved[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(batched, name, saved[name])


def _with_parameters(change):
    def wrap(fn):
        def call(products, p0, prm, **kw):
            return fn(products, p0, change(prm), **kw)
        return call
    return _entries_wrapped(wrap)


def unchanged():
    return _with_parameters(lambda prm: prm.replace(trustregion0=0.0))


def stopping():
    return _with_parameters(
        lambda prm: prm.replace(max_iterations=prm.max_iterations - 1))


def half():
    import torch

    def wrap(fn):
        def call(products, p0, prm, problem_data=None, **kw):
            h = p0.shape[0] // 2
            r = fn(products, p0[:h], prm, problem_data=problem_data[:h],
                   **kw)
            rest = p0[h:]
            n = rest.shape[0]
            return r._replace(
                p=torch.cat([r.p, rest]),
                norm2_x=torch.cat([r.norm2_x, r.norm2_x[:n]]),
                reason=torch.cat([r.reason, r.reason[:n]]),
                step_count=torch.cat([r.step_count, r.step_count[:n]]))
        return call
    return _entries_wrapped(wrap)


def altered():
    def wrap(fn):
        def call(*args, **kw):
            r = fn(*args, **kw)
            r.p[r.p.shape[0] // 3, 0] += 0.01
            return r
        return call
    return _entries_wrapped(wrap)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "stopping": stopping}
