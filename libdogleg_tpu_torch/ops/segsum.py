"""Sums in a fixed order where several terms land on one target.

`base.index_add_(dim, targets, terms)` adds with atomics on a CUDA device:
where targets repeat, the order of the adds, and so the last bits of each
sum, can differ from run to run. A float32 sparse solve then gave other
bits on a second run, and ranks that solve the same replicated system
after a collective could take other decisions and part. Here the order is
fixed once, on the host, from the targets alone (AddPlan), and the device
adds in that order: each target's value first, then its terms in index
order, which is the order in which index_add_ adds them on the CPU. So the
CPU gives the bits it gave before and the card gives the same bits on
every run.

CUDA tensors go to the segment-add kernel (csrc/segsum.cu, one launch an
add): plain ones by a direct launch, the others (traced, batched by
torch.func.vmap, or under a dispatch mode) through its operator
libdogleg_tpu_torch::segment_add. CPU tensors go to its plain version,
`reference`, which adds in rounds: round r adds every target's r-th term
with one index_add_ whose targets are distinct, so no two adds meet on one
address; a plan takes as many rounds as the most terms on one target. (On
the CPU it beat a torch.segment_reduce form at the sparse path's sizes:
artifacts/exp_torch_segsum_cpu.py.)

A schedule's levels take their plans from one pass over all of them
(level_plans): one sort by (level, target, index), each level a slice of
it, and on a device one copy of the operands for every level.

A plan keeps what a direct launch needs at each (shapes, dim, dtype,
device, sign) it has been called with (`_launch_record`): the entry point,
the operands' pointers and the integer arguments, made at the first such
call after every check. A later call checks the tensors' type, device,
dtype and shapes by that record's key and their contiguity, and makes one
ctypes call (the kernel's launcher picks its instance from the alignment).
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.ops.traced import real_constant

# the kernel's launches (its wrapper counts one where it launches)
launch_count = 0


def _stable_order(major, minor):
    """The permutation that sorts by (major, minor), ties in index order:
    both non-negative int64."""
    width = int(minor.max()) + 1 if minor.size else 1
    return np.argsort(major * width + minor, kind="stable")


def _heads(keys, off):
    """Where a run of equal keys starts in keys, sorted within each level
    off[k]:off[k + 1]; a level starts a run."""
    head = np.ones(keys.size, bool)
    np.not_equal(keys[1:], keys[:-1], out=head[1:])
    head[off[:-1][off[:-1] < keys.size]] = True
    return np.flatnonzero(head)


class _Runs:
    """The fixed order of the adds of a schedule's levels, built in one
    pass on the host: level k adds terms off[k]:off[k + 1] into the targets
    `targets[off[k]:off[k + 1]]`, its terms numbered from 0.

    Sorted once by (level, target, index): run r, one level's one target,
    adds into uniq[r] its terms term_pos[run_ptr[r]:run_ptr[r + 1]], each
    by its number in its level, in index order; level k's runs are
    run_off[k]:run_off[k + 1]. The plain version's rounds are a second sort,
    by (level, rank among the terms of its target, index): round j adds the
    terms round_pos[round_ptr[j]:round_ptr[j + 1]] into round_tgt's, whose
    targets are distinct; level k's rounds are
    round_off[k]:round_off[k + 1]."""

    def __init__(self, targets, offsets):
        t = np.asarray(targets, np.int64).reshape(-1)
        off = np.asarray(offsets, np.int64)
        n = t.size
        level = np.repeat(np.arange(off.size - 1), np.diff(off))
        # one stable sort by (level, target) keeps index order within each
        # run (an argsort of one key: a fifth of lexsort's time on config
        # 6b's 1.4 million UPDATE ops)
        order = _stable_order(level, t)
        # the levels are blocks of the input, so they stay where they were
        self.term_pos = order - off[level]
        ts = t[order]
        starts = _heads(ts, off)
        self.targets, self.off, self.level = t, off, level
        self.uniq = ts[starts]
        self.run_ptr = np.append(starts, n)
        self.run_off = np.searchsorted(starts, off)
        self._order = order
        self._device: Dict = {}

    @functools.cached_property
    def rounds(self):
        """round_pos, round_tgt, round_ptr, round_off (see the class),
        built at the plain version's first use."""
        n, level = self.targets.size, self.level
        rank = np.empty(n, np.int64)
        rank[self._order] = np.arange(n) - np.repeat(
            self.run_ptr[:-1], np.diff(self.run_ptr))
        order = _stable_order(level, rank)
        starts = _heads(rank[order], self.off)
        return (order - self.off[level], self.targets[order],
                np.append(starts, n), np.searchsorted(starts, self.off))

    def kernel_operands(self, device):
        """Each level's kernel operands on a device, (uniq, run_ptr,
        term_pos) as int32 views of one copy, made once."""
        key = ("kernel", device)
        ops = self._device.get(key)
        if ops is None:
            parts = (self.uniq, self.run_ptr, self.term_pos)
            flat = np.concatenate(parts).astype(np.int32)
            ro = self.run_off.tolist()

            def make():
                u, rp, tp = torch.as_tensor(flat, device=device).split(
                    [a.size for a in parts])
                return [(u[a:b], rp[a:b + 1], tp)
                        for a, b in zip(ro[:-1], ro[1:])]
            # real tensors even while torch.export traces: the cache keeps
            # them
            ops = self._device[key] = real_constant(make)
        return ops

    def rounds_on(self, device):
        """Each level's rounds on a device: (positions, targets) a round,
        the targets of one round distinct; positions an int64 tensor, or
        (start, length) where they are a range of the level's terms."""
        key = ("rounds", device)
        out = self._device.get(key)
        if out is None:
            pos_h, tgt_h, ptr, off = self.rounds
            flat = np.concatenate((pos_h, tgt_h))
            n, cut, off = pos_h.size, ptr.tolist(), off.tolist()

            def make():
                whole = torch.as_tensor(flat, device=device)
                pos, tgt = whole[:n], whole[n:]

                def where(a, b):
                    first = int(pos_h[a])
                    return ((first, b - a)
                            if int(pos_h[b - 1]) - first == b - a - 1
                            else pos[a:b])
                rounds = [(where(a, b), tgt[a:b])
                          for a, b in zip(cut[:-1], cut[1:])]
                return [rounds[off[k]:off[k + 1]]
                        for k in range(len(off) - 1)]
            out = self._device[key] = real_constant(make)
        return out


class AddPlan:
    """The fixed order of `base[targets[i]] += terms[i]` over i, built on
    the host from the targets: AddPlan(targets) on its own, or one level
    of a schedule (level_plans).

    n: the number of terms; top: the largest target (-1 without terms);
    uniq, run_ptr, term_pos: run r adds into uniq[r] the terms
    term_pos[run_ptr[r]:run_ptr[r + 1]], in index order (term_pos is the
    schedule's, shared by its levels; the kernel's operands)."""

    def __init__(self, targets=None, *, runs: _Runs = None, level: int = 0):
        if runs is None:
            t = np.asarray(targets, np.int64).reshape(-1)
            runs = _Runs(t, [0, t.size])
        self._runs, self._level = runs, level
        lo, hi = runs.off[level], runs.off[level + 1]
        ra, rb = runs.run_off[level], runs.run_off[level + 1]
        self.n = int(hi - lo)
        self.targets = runs.targets[lo:hi]
        self.uniq = runs.uniq[ra:rb]
        self.run_ptr = runs.run_ptr[ra:rb + 1]
        self.term_pos = runs.term_pos
        self.top = int(self.uniq[-1]) if self.uniq.size else -1
        self._launches: Dict = {}

    @property
    def rounds(self) -> int:
        """The plain version's rounds: the most terms on one target."""
        off = self._runs.rounds[3]
        return int(off[self._level + 1] - off[self._level])

    def kernel_operands(self, device):
        """uniq, run_ptr, term_pos as int32 tensors on a CUDA device."""
        return self._runs.kernel_operands(device)[self._level]

    def rounds_on(self, device):
        """The plain version's rounds on a device: (positions, targets) of
        each, the targets of one round distinct; positions are an int64
        tensor, or (start, length) where they are a range of the terms."""
        return self._runs.rounds_on(device)[self._level]


def level_plans(targets, offsets) -> List[AddPlan]:
    """One AddPlan a level: level k adds terms off[k]:off[k + 1] into
    targets[off[k]:off[k + 1]]. Built in one pass, the levels' device
    operands copied in one piece."""
    runs = _Runs(targets, offsets)
    return [AddPlan(runs=runs, level=k) for k in range(len(offsets) - 1)]


def _check(base, dim, plan: AddPlan, terms) -> int:
    dim = dim % base.dim()
    if terms.dim() != base.dim() or terms.shape[dim] != plan.n:
        raise ValueError(f"terms {tuple(terms.shape)} do not hold the "
                         f"plan's {plan.n} terms along dim {dim} of base "
                         f"{tuple(base.shape)}")
    if plan.top >= base.shape[dim]:
        raise ValueError(f"the plan adds into index {plan.top}, past base's "
                         f"{base.shape[dim]} along dim {dim}")
    return dim


def add_(base: torch.Tensor, dim: int, plan: AddPlan, terms: torch.Tensor,
         *, alpha: float = 1) -> torch.Tensor:
    """`base.index_add_(dim, targets, terms, alpha=alpha)` in the plan's
    fixed order, alpha 1 or -1: the kernel on CUDA tensors, its plain
    version on CPU tensors. In place and returns base, but the kernel's
    operator (tensors that are not plain: traced, batched, under a
    dispatch mode) and a base that is not contiguous give a new tensor:
    use the result."""
    if base.is_cuda and _direct(base, terms):
        return _launch(base, dim, plan, terms, alpha, in_place=True)
    dim = _check(base, dim, plan, terms)
    if plan.n == 0:
        return base
    if base.device.type == "cpu":
        return _rounds(base, dim, plan, terms, alpha, in_place=True)
    return _kernel(base, dim, plan, terms, alpha)


def add(base: torch.Tensor, dim: int, plan: AddPlan,
        terms: torch.Tensor) -> torch.Tensor:
    """add_ out of place (torch.func.vmap batches it): a new tensor."""
    if base.is_cuda and _direct(base, terms):
        return _launch(base, dim, plan, terms, 1, in_place=False)
    dim = _check(base, dim, plan, terms)
    if plan.n == 0:
        return base
    if base.device.type == "cpu":
        return _rounds(base, dim, plan, terms, 1, in_place=False)
    return _kernel(base, dim, plan, terms, 1)


def reference(base, dim, plan: AddPlan, terms, *, alpha: float = 1,
              in_place: bool = False) -> torch.Tensor:
    """The kernel's plain version on any device, in the same order: round
    by round, one index_add_ a round, whose targets are distinct. In
    place with in_place=True; returns the sums."""
    return _rounds(base, _check(base, dim, plan, terms), plan, terms, alpha,
                   in_place)


def _rounds(base, dim, plan: AddPlan, terms, alpha, in_place: bool):
    for pos, tgt in plan.rounds_on(base.device):
        part = (terms.narrow(dim, *pos) if isinstance(pos, tuple)
                else terms.index_select(dim, pos))
        if in_place:
            base.index_add_(dim, tgt, part, alpha=alpha)
        else:
            base = base.index_add(dim, tgt, part, alpha=alpha)
    return base


_transform_level = torch._C._functorch.maybe_current_level
_mode_depth = torch._C._len_torch_dispatch_stack
_tls_includes = torch._C._dispatch_tls_is_dispatch_key_included
_PRE_DISPATCH = torch._C.DispatchKey.PreDispatch


def _direct(base, terms) -> bool:
    """Whether base and terms are plain tensors outside every torch.func
    transform, dispatch mode and pre-dispatch trace: then the kernel is
    launched on their data. A fake or functional tensor is of a subclass,
    a batched one lives only inside a transform, and make_fx records
    through a mode; all of them take the operator (`_kernel`)."""
    return (type(base) is torch.Tensor and type(terms) is torch.Tensor
            and _transform_level() is None and not _mode_depth()
            and not _tls_includes(_PRE_DISPATCH))


def _kernel(base, dim, plan: AddPlan, terms, alpha):
    """The kernel's operator on CUDA tensors that are not plain (traced,
    batched by torch.func, or under a dispatch mode): a new tensor."""
    if base.device.type != "cuda":
        raise ValueError(f"the segment-add kernel takes CUDA tensors on one "
                         f"device; got {base.device} and {terms.device}")
    _validate(base, terms, alpha)
    return _op(base, terms, dim, *plan.kernel_operands(base.device),
               alpha == -1)


def _validate(base, terms, alpha) -> None:
    """Raise unless the kernel takes these tensors and alpha: float32 or
    float64 of one dtype on one device, alpha 1 or -1."""
    if terms.device != base.device:
        raise ValueError(f"the segment-add kernel takes CUDA tensors on one "
                         f"device; got {base.device} and {terms.device}")
    if alpha not in (1, -1):
        raise ValueError(f"alpha must be 1 or -1, got {alpha}")
    if base.dtype not in (torch.float32, torch.float64) \
            or terms.dtype != base.dtype:
        raise ValueError(f"the segment-add kernel takes float32 or float64 "
                         f"of one dtype; got {base.dtype}, {terms.dtype}")


class _LaunchArgs(ctypes.Structure):
    """A direct launch's operand pointers and integer arguments, the record
    that dogleg_segment_add_planned reads (csrc/segsum.cu's
    SegmentAddArgs, field for field)."""
    _fields_ = [("uniq", ctypes.c_void_p), ("run_ptr", ctypes.c_void_p),
                ("term_pos", ctypes.c_void_p), ("inner", ctypes.c_int64),
                ("n_runs", ctypes.c_int32), ("outer", ctypes.c_int32),
                ("nbase", ctypes.c_int32), ("nterm", ctypes.c_int32),
                ("negate", ctypes.c_int32), ("device", ctypes.c_int32),
                ("elem_bytes", ctypes.c_int32), ("unused", ctypes.c_int32)]


class _Launch(NamedTuple):
    """A plan's direct launch at one (shapes, dim, dtype, device, sign):
    the entry point (None where the plan adds nothing), the address of
    its argument record (`record`, kept here), the device's index, whose
    current stream each launch takes, and the operand tensors whose
    pointers the record holds."""
    entry: Optional[Callable]
    address: int
    record: Optional[_LaunchArgs]
    index: int
    operands: tuple


def _launch_record(plan: AddPlan, base, dim, terms, alpha) -> _Launch:
    """The plan's launch for these tensors' shapes, dim, dtypes, devices
    and alpha: made, after every check, at the first call with them, then
    kept on the plan."""
    key = (base.shape, terms.shape, dim, base.dtype, terms.dtype,
           base.device, terms.device, alpha)
    rec = plan._launches.get(key)
    if rec is None:
        rec = plan._launches[key] = _new_launch(plan, base, dim, terms,
                                                alpha)
    return rec


def _new_launch(plan: AddPlan, base, dim, terms, alpha) -> _Launch:
    _validate(base, terms, alpha)
    d = _check(base, dim, plan, terms)
    if plan.n == 0:
        return _Launch(None, 0, None, 0, ())
    ops = plan.kernel_operands(base.device)
    outer, nbase, nterm, inner = _sizes(base.shape, terms.shape, d)
    index = base.device.index or 0
    record = _LaunchArgs(uniq=ops[0].data_ptr(), run_ptr=ops[1].data_ptr(),
                         term_pos=ops[2].data_ptr(), inner=inner,
                         n_runs=ops[0].numel(), outer=outer, nbase=nbase,
                         nterm=nterm, negate=int(alpha == -1), device=index,
                         elem_bytes=base.element_size())
    return _Launch(_planned_entry(), ctypes.addressof(record), record, index,
                   ops)


def _sizes(base_shape, terms_shape, dim: int) -> tuple:
    """(outer, nbase, nterm, inner) of base (outer, nbase, inner) and terms
    (outer, nterm, inner) around dim; raises where they differ elsewhere."""
    if terms_shape[:dim] != base_shape[:dim] \
            or terms_shape[dim + 1:] != base_shape[dim + 1:]:
        raise ValueError(f"terms {tuple(terms_shape)} do not match base "
                         f"{tuple(base_shape)} but along dim {dim}")
    return (math.prod(base_shape[:dim]), base_shape[dim], terms_shape[dim],
            math.prod(base_shape[dim + 1:]))


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device `index`
    (native/loader.launch_target's, without the device object)."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _RAW_STREAM(index)


def _launch(base, dim, plan: AddPlan, terms, alpha, in_place: bool):
    """The direct launch on plain CUDA tensors through the plan's record:
    in place on a contiguous base, else on a contiguous copy."""
    global launch_count
    rec = _launch_record(plan, base, dim, terms, alpha)
    if rec.entry is None:
        return base
    if not (in_place and base.is_contiguous()):
        base = base.clone(memory_format=torch.contiguous_format)
    if not terms.is_contiguous():
        terms = terms.contiguous()
    err = rec.entry(base.data_ptr(), terms.data_ptr(), rec.address,
                    _stream(rec.index))
    if err:
        raise RuntimeError(f"{rec.entry.__name__} launch failed: "
                           f"cudaError_t {err}")
    launch_count += 1
    return base


def segment_add_kernel(base: torch.Tensor, terms: torch.Tensor, dim: int,
                       uniq: torch.Tensor, run_ptr: torch.Tensor,
                       term_pos: torch.Tensor, negate: bool) -> None:
    """The kernel's launch (csrc/segsum.cu), in place on the contiguous
    CUDA tensor base: along `dim`, base[uniq[r]] gets run r's terms,
    terms[term_pos[run_ptr[r]:run_ptr[r + 1]]], added one after the other
    (negated with `negate`); the int32 operands are an AddPlan's."""
    global launch_count
    terms = terms.contiguous()
    entry = _entry(base.dtype)
    err = entry(base.data_ptr(), terms.data_ptr(), uniq.data_ptr(),
                run_ptr.data_ptr(), term_pos.data_ptr(), uniq.numel(),
                *_sizes(base.shape, terms.shape, dim), int(negate),
                base.device.index or 0, _stream(base.device.index or 0))
    if err:
        raise RuntimeError(f"{entry.__name__} launch failed: cudaError_t "
                           f"{err}")
    launch_count += 1


_ENTRIES: Dict = {}


def _entry(dtype):
    """The library's entry point for dtype, looked up once."""
    fn = _ENTRIES.get(dtype)
    if fn is None:
        from libdogleg_tpu_torch.native.loader import load_library
        dt = "f32" if dtype == torch.float32 else "f64"
        fn = _ENTRIES[dtype] = getattr(load_library(),
                                       f"dogleg_segment_add_{dt}")
    return fn


def _planned_entry():
    """The library's entry point that reads a launch record."""
    fn = _ENTRIES.get("planned")
    if fn is None:
        from libdogleg_tpu_torch.native.loader import load_library
        fn = _ENTRIES["planned"] = load_library().dogleg_segment_add_planned
    return fn


@torch.library.custom_op("libdogleg_tpu_torch::segment_add",
                         mutates_args=(), device_types="cuda")
def _op(base: torch.Tensor, terms: torch.Tensor, dim: int,
        uniq: torch.Tensor, run_ptr: torch.Tensor, term_pos: torch.Tensor,
        negate: bool) -> torch.Tensor:
    """The kernel as an operator, out of place: the node a traced solve
    (export.py) carries, and what torch.func.vmap batches."""
    out = base.clone(memory_format=torch.contiguous_format)
    segment_add_kernel(out, terms, dim, uniq, run_ptr, term_pos, negate)
    return out


@_op.register_fake
def _(base, terms, dim, uniq, run_ptr, term_pos, negate):
    return torch.empty_like(base, memory_format=torch.contiguous_format)


def _vmap_rule(info, in_dims, base, terms, dim, uniq, run_ptr, term_pos,
               negate):
    """A batch of adds as one launch: the vmapped axis becomes the leading
    one of both tensors (an unbatched one expanded), dim moves past it."""
    bd, td = in_dims[0], in_dims[1]
    if any(d is not None for d in in_dims[2:]):
        raise ValueError("the segment-add operator batches base and terms "
                         "only")
    n = info.batch_size
    base = (base.movedim(bd, 0) if bd is not None
            else base.expand((n,) + tuple(base.shape)))
    terms = (terms.movedim(td, 0) if td is not None
             else terms.expand((n,) + tuple(terms.shape)))
    return _op(base, terms, dim + 1, uniq, run_ptr, term_pos, negate), 0


_op.register_vmap(_vmap_rule)


_PLANS: Dict[int, Dict] = {}


def plan_of(owner: np.ndarray, name: str,
            make: Callable[[], np.ndarray], also: np.ndarray = None
            ) -> AddPlan:
    """The AddPlan of the targets make() derives from the host array
    `owner` (and `also`, where they depend on a second array), told apart
    by `name`: built once and kept for as long as owner (and also) live
    (as ops/bcsr_kernels.device_indices keeps index arrays)."""
    held = _PLANS.get(id(owner))
    if held is None:
        held = _PLANS[id(owner)] = {}
        weakref.finalize(owner, _PLANS.pop, id(owner), None)
    key = name if also is None else (name, id(also))
    plan = held.get(key)
    if plan is None:
        plan = held[key] = AddPlan(make())
        if also is not None:
            weakref.finalize(also, held.pop, key, None)
    return plan
