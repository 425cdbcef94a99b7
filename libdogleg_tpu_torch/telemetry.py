"""Spans of the port's per-call host path, on torch.profiler's clock.

`span(name)` marks one stretch of host work. While a torch.profiler
records, it is a host range recorded as an operation
(`torch._C._profiler._RecordFunctionFast`, the range torch's own
generated kernels mark their launches with): the span lands in the same
trace as the device's operations, on the same clock, and nests in the
span it was opened inside. Unlike `torch.profiler.record_function`,
whose ranges the profile lists as user annotations with a mirror on the
device's timeline, it is listed among the host's operations and has no
mirror, so a reader that takes the host's operations and the device's
kernels from `prof.events()` sees it where it sees `aten::` operations.
Where the torch at hand lacks it, the span is a `record_function`.
Otherwise it is one shared no-op context, so that the hot path pays a
flag check and no profiler call.

The spans, one call's all inside its `dogleg.call`:

- `dogleg.call`: one public call of parallel/batched.py's
  `batched_optimize` or `batched_optimize_compacted`, whole.
- `dogleg.route`: `_prepare`, the checks, the rank's blocks and the
  choice of path.
- `dogleg.plan`: auto-promotion's plan-cache key and lookup
  (parallel/mega_auto.plan_megakernel); a miss's trace lies inside it.
- `dogleg.launch`: K1's wrapper on CUDA tensors (ops/mega.py): checks,
  contiguous inputs, the library lookup, the outputs and the entry call.

The spans are kept and written out by the profiler that records them
(`prof.events()`, `key_averages()`, `export_chrome_trace`); nothing is
kept here.
"""

from __future__ import annotations

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)


class _Off:
    """The no-op context (cheaper to enter than contextlib.nullcontext)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str):
    """A context that marks `name` in the trace while a torch.profiler
    records, else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RANGE(name)
