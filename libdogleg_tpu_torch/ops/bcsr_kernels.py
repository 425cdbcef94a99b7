"""Kernels K3 and K4: block-sparse Jacobian products in CUDA (counterpart of
libdogleg_tpu/ops/pallas_bcsr.py).

K3 forms the blocks of J^T J over a static schedule of block pairs sorted by
output block (`build_jtj_schedule`, the host-side symbolic analysis); K4
forms J v. K3 forms the lower JtJ blocks of the block-sparse path
(ops/bcsr.bcsr_jtj_lower_blocks) on a CUDA device, one launch for a whole
batch of Jacobians that share a structure. Under torch.func.vmap it is
reached through the custom operator libdogleg_tpu_torch::bcsr_jtj_blocks,
whose vmap rule is that batched launch, so torch.func.vmap of a products
function launches it once for the batch; so is a traced call
(ops/traced.is_traced: torch.export's fake tensors, or make_fx recording),
which is how an exported artifact (export.py) carries it. Other values
launch it directly. K4 is opt-in, as in the JAX package. Each kernel's
wrapper launches the hand-written kernel in csrc/bcsr.cu for CUDA tensors
and runs its plain twin (`*_reference`) for CPU tensors; a CUDA tensor
launches the kernel or raises.

A structure's and a schedule's index arrays are numpy arrays on the host.
The wrappers copy each to the card once (`device_indices`) and keep the
tensor for as long as the array lives, so a second product on one structure
copies nothing. The copy is a real tensor even when made while torch.export
traces (ops/traced.real_constant), so a trace leaves no fake tensor
behind. The arrays are static by contract: one changed in place after its
first product would leave a stale copy behind.
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.native.loader import launch_target, load_library
from libdogleg_tpu_torch.ops.bcsr import (BCSRJacobian, BCSRStructure,
                                         JtJLowerSchedule, _index,
                                         bcsr_matvec, jtj_pair_sum)
from libdogleg_tpu_torch.ops.traced import is_traced, real_constant

# Kernel launches made in this process, per wrapper.
launch_counts = {"bcsr_jtj_blocks_kernel": 0, "bcsr_matvec_kernel": 0}


class JtJSchedule(NamedTuple):
    """Static work list for block-JtJ formation: one block product per pair
    of stored blocks sharing a block row, pairs sorted by output block so
    that each output block is one contiguous run (the one-time symbolic
    analysis, reference dogleg.c:649-654)."""
    pair_i: np.ndarray    # (npairs,) int32 index into values
    pair_j: np.ndarray    # (npairs,) int32 index into values
    out_idx: np.ndarray   # (npairs,) int32 index into the output block list
    out_ci: np.ndarray    # (nnzb_out,) block-row (state) coordinate
    out_cj: np.ndarray    # (nnzb_out,) block-col (state) coordinate


def build_jtj_schedule(s: BCSRStructure) -> JtJSchedule:
    """The schedule of pallas_bcsr.py:56-75, identical arrays to the JAX
    package's: from the host library (csrc/host/symbolic.cpp) where it is
    available, else in numpy (`build_jtj_schedule_python`)."""
    from libdogleg_tpu_torch.native.symbolic import jtj_schedule_native
    nat = jtj_schedule_native(s.indptr, s.indices, s.nbcol)
    if nat is not None:
        return JtJSchedule(*nat)
    return build_jtj_schedule_python(s)


def build_jtj_schedule_python(s: BCSRStructure) -> JtJSchedule:
    """build_jtj_schedule in numpy, the host library's plain version."""
    pi, pj = s.jtj_pairs()
    ci = s.indices[pi]
    cj = s.indices[pj]
    order = np.lexsort((cj, ci))
    pi, pj, ci, cj = pi[order], pj[order], ci[order], cj[order]
    keys = ci.astype(np.int64) * s.nbcol + cj
    uniq, out_idx = np.unique(keys, return_inverse=True)
    return JtJSchedule(pair_i=pi.astype(np.int32),
                       pair_j=pj.astype(np.int32),
                       out_idx=out_idx.astype(np.int32),
                       out_ci=(uniq // s.nbcol).astype(np.int32),
                       out_cj=(uniq % s.nbcol).astype(np.int32))


def supports_kernels(s: BCSRStructure, dtype=torch.float32) -> bool:
    """Whether the CUDA kernels take this structure and dtype: any block
    shape, float32 or float64 values, and index ranges within int32. (The
    TPU kernels wanted (8, 128)-friendly blocks; these do not.)"""
    return (dtype in (torch.float32, torch.float64)
            and s.nnzb * s.block_rows * s.block_cols < 2 ** 31
            and s.nmeas < 2 ** 31)


def _check(J: BCSRJacobian, batched: bool = False) -> None:
    """The values' shape, (nnzb, bm, bn) or, where `batched`, with any
    leading axes, and the structure and dtype within the kernels' range."""
    v, s = J.values, J.structure
    want = (s.nnzb, s.block_rows, s.block_cols)
    if tuple(v.shape[-3:] if batched else v.shape) != want:
        lead = "(..., " if batched else "("
        raise ValueError(f"values must be {lead}{', '.join(map(str, want))})"
                         f", got {tuple(v.shape)}")
    if not supports_kernels(s, v.dtype):
        raise ValueError("structure or dtype outside the kernels' range "
                         "(see supports_kernels)")


# id(owner array) -> {(name, device): int32 tensor}; an entry goes when its
# owner is collected.
_DEVICE_INDICES: dict = {}


def device_indices(owner: np.ndarray, device, name: str = "",
                   make: Optional[Callable[[], np.ndarray]] = None
                   ) -> torch.Tensor:
    """The index array `owner` (or, with `make`, an array derived from it,
    told apart by `name`) as an int32 tensor on `device`: copied there once
    and kept for as long as `owner` lives."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    held = _DEVICE_INDICES.get(id(owner))
    if held is None:
        held = _DEVICE_INDICES[id(owner)] = {}
        weakref.finalize(owner, _DEVICE_INDICES.pop, id(owner), None)
    t = held.get((name, device))
    if t is None:
        a = owner if make is None else make()
        # a copy on every device: a tensor sharing the array's memory would
        # keep the owner alive; a real tensor even while traced
        t = held[(name, device)] = real_constant(lambda: torch.tensor(
            np.ascontiguousarray(a, np.int32), device=device))
    return t


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _nout(schedule) -> int:
    """The output blocks of a JtJSchedule or a JtJLowerSchedule."""
    return int((schedule.out_ci if isinstance(schedule, JtJSchedule)
                else schedule.rows).shape[0])


def _jtj_operands(schedule) -> np.ndarray:
    """K3's int32 operands in one array: pair_i, pair_j, then the offsets
    of each output block's run in the output-sorted schedule (a JtJSchedule
    or a JtJLowerSchedule), so that a product finds them on the card with
    one lookup."""
    counts = np.bincount(_host(schedule.out_idx), minlength=_nout(schedule))
    return np.concatenate([_host(schedule.pair_i), _host(schedule.pair_j),
                           [0], np.cumsum(counts)])


def matvec_instance(bm: int, bn: int, dtype) -> str:
    """Which of K4's kernels csrc/bcsr.cu launches for 16-byte-aligned
    (bm, bn) blocks of `dtype`: "words" (a group of lanes per block row, one
    16-byte word of a block per lane) for the grid model's (8, 8) blocks,
    "rows" (one thread per measurement row, any block shape) otherwise, as
    for operands that are not aligned. The launcher decides; this names its
    rule."""
    if (bm, bn) == (8, 8) and dtype in (torch.float32, torch.float64):
        return "words"
    return "rows"


def jtj_instance(bm: int, bn: int, dtype) -> str:
    """Which of K3's kernels csrc/bcsr.cu launches for 16-byte-aligned
    (bm, bn) blocks of `dtype`: "words" (a group of lanes per output block,
    one 16-byte word of it per lane) for the grid model's (8, 8) blocks,
    "entries" (a thread block per output block, a thread per entry, any
    block shape) otherwise, as for values that are not aligned. Both sum in
    the same order. The launcher decides; this names its rule."""
    if (bm, bn) == (8, 8) and dtype in (torch.float32, torch.float64):
        return "words"
    return "entries"


def bcsr_jtj_blocks_reference(J: BCSRJacobian,
                              schedule: JtJSchedule) -> torch.Tensor:
    """K3's plain twin: (nnzb_out, bn, bn) blocks of J^T J in the schedule's
    output order, out of place (ops/bcsr.jtj_pair_sum)."""
    return jtj_pair_sum(J.values, schedule.pair_i, schedule.pair_j,
                        schedule.out_idx, int(schedule.out_ci.shape[0]))


def _jtj_batched_launch(values: torch.Tensor, operands: torch.Tensor,
                        npairs: int, nout: int) -> torch.Tensor:
    """K3's launch on CUDA values (B, nnzb, bm, bn): the (B, nout, bn, bn)
    blocks, every element summed over the one schedule in `operands`
    (_jtj_operands, int32 on the values' device)."""
    B, nnzb, bm, bn = values.shape
    vals = values.contiguous()
    out = vals.new_empty((B, nout, bn, bn))
    if B and nout:
        lib = load_library()
        entry = (lib.dogleg_bcsr_jtj_f32 if vals.dtype == torch.float32
                 else lib.dogleg_bcsr_jtj_f64)
        ops = operands.data_ptr()
        err = entry(vals.data_ptr(), bm, bn, ops, ops + 4 * npairs,
                    ops + 8 * npairs, nout, B, nnzb, out.data_ptr(),
                    *launch_target(vals.device))
        if err:
            raise RuntimeError(f"bcsr_jtj_blocks_kernel launch failed: "
                               f"cudaError_t {err}")
        launch_counts["bcsr_jtj_blocks_kernel"] += 1
    return out


@torch.library.custom_op("libdogleg_tpu_torch::bcsr_jtj_blocks",
                         mutates_args=(), device_types="cuda")
def _jtj_op(values: torch.Tensor, operands: torch.Tensor, npairs: int,
            nout: int) -> torch.Tensor:
    """_jtj_batched_launch as an operator, so that torch.func.vmap reaches
    it through its vmap rule (_jtj_op_vmap) and a traced program (make_fx,
    torch.export) keeps it as a node. The operator's dispatch costs the
    host about 20 us a call (measured beside the direct launch on an H100
    machine), so only values under a functorch transform or traced take it
    (_jtj_launcher)."""
    return _jtj_batched_launch(values, operands, npairs, nout)


def _jtj_op_vmap(info, in_dims, values, operands, npairs, nout):
    """The batch written out: the vmapped axis joins the op's own batch
    axis, and the whole batch is one launch."""
    vdim, odim = in_dims[0], in_dims[1]
    if odim is not None:
        raise ValueError("K3's schedule is shared by the batch; its operands "
                         "cannot carry a batch axis")
    if vdim is None:
        return _jtj_op(values, operands, npairs, nout), None
    v = values.movedim(vdim, 0)
    out = _jtj_op(v.reshape((-1,) + tuple(v.shape[2:])), operands, npairs,
                  nout)
    return out.reshape(tuple(v.shape[:2]) + tuple(out.shape[1:])), 0


torch.library.register_vmap(_jtj_op, _jtj_op_vmap)


@_jtj_op.register_fake
def _(values, operands, npairs, nout):
    B, bn = values.shape[0], values.shape[-1]
    return values.new_empty((B, nout, bn, bn))


def _jtj_launcher(values: torch.Tensor):
    """K3's launch for `values`: the operator _jtj_op for values under a
    functorch transform (torch.func.vmap gives a BatchedTensor, which has
    no data pointer; the operator's vmap rule folds its batch into one
    launch) and for traced values (ops/traced.is_traced: the operator is
    the node the graph keeps), else _jtj_batched_launch itself, without
    the operator's dispatch."""
    if (torch._C._functorch.is_functorch_wrapped_tensor(values)
            or is_traced(values)):
        return _jtj_op
    return _jtj_batched_launch


def _jtj_launch(values: torch.Tensor, owner: np.ndarray,
                schedule) -> torch.Tensor:
    """K3 over a schedule's pairs, whose operands are kept on the card for
    as long as `owner`, one of its numpy arrays, lives. values (..., nnzb,
    bm, bn) with any leading axes, under torch.func.vmap or not."""
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    ops = device_indices(owner, values.device, "jtj",
                         lambda: _jtj_operands(schedule))
    lead = values.shape[:-3]
    v = values.reshape((-1,) + tuple(values.shape[-3:]))
    out = _jtj_launcher(v)(v, ops, int(schedule.pair_i.shape[0]),
                           _nout(schedule))
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


def bcsr_jtj_blocks_kernel(J: BCSRJacobian,
                           schedule: Optional[JtJSchedule] = None):
    """Block-sparse J^T J. Returns (blocks (nnzb_out, bn, bn), schedule):
    the blocks in the schedule's output pattern; jtj_blocks_to_dense
    materializes them. Values with leading batch axes (..., nnzb, bm, bn)
    give (..., nnzb_out, bn, bn), one launch for all (under
    torch.func.vmap too). CUDA values go to kernel K3 (of its two kernels
    the one `jtj_instance` names), CPU values to
    bcsr_jtj_blocks_reference."""
    _check(J, batched=True)
    if schedule is None:
        schedule = build_jtj_schedule(J.structure)
    v = J.values
    if v.device.type == "cpu":
        return bcsr_jtj_blocks_reference(J, schedule), schedule
    return _jtj_launch(v, schedule.out_idx, schedule), schedule


def bcsr_jtj_lower_kernel(J: BCSRJacobian,
                          sched: JtJLowerSchedule) -> torch.Tensor:
    """The lower JtJ blocks of ops/bcsr.bcsr_jtj_lower_blocks, (...,
    nnzb_jtj, bn, bn), by kernel K3 for CUDA values of any leading batch
    axes (and under torch.func.vmap), one launch for all of them; CPU
    values take the plain form, ops/bcsr.jtj_pair_sum. The schedule's
    pair_i, pair_j and out_idx may be numpy arrays or tensors; its `rows`
    array keys the operands kept on the card."""
    _check(J, batched=True)
    v = J.values
    if v.device.type == "cpu":
        return jtj_pair_sum(v, sched.pair_i, sched.pair_j, sched.out_idx,
                            _nout(sched))
    return _jtj_launch(v, sched.rows, sched)


def jtj_blocks_to_dense(blocks: torch.Tensor, schedule: JtJSchedule,
                        s: BCSRStructure) -> torch.Tensor:
    """Scatter schedule-ordered JtJ blocks into a dense (nstate, nstate)
    matrix (one write per output block, no accumulation)."""
    out = torch.zeros((s.nbcol, s.nbcol, s.block_cols, s.block_cols),
                      dtype=blocks.dtype, device=blocks.device)
    out[_index(schedule.out_ci, blocks),
        _index(schedule.out_cj, blocks)] = blocks
    return out.permute(0, 2, 1, 3).reshape(s.nstate, s.nstate)


def bcsr_jtj_dense_kernel(J: BCSRJacobian,
                          schedule: Optional[JtJSchedule] = None
                          ) -> torch.Tensor:
    """Dense J^T J through bcsr_jtj_blocks_kernel."""
    blocks, schedule = bcsr_jtj_blocks_kernel(J, schedule)
    return jtj_blocks_to_dense(blocks, schedule, J.structure)


def bcsr_matvec_reference(J: BCSRJacobian, vec: torch.Tensor) -> torch.Tensor:
    """K4's plain twin: J v as a gather, a batched product and a segment
    sum (ops/bcsr.bcsr_matvec)."""
    return bcsr_matvec(J, vec)


def bcsr_matvec_kernel(J: BCSRJacobian, vec: torch.Tensor) -> torch.Tensor:
    """J v for a (nstate,) vector. CUDA values go to kernel K4 (of its two
    kernels the one `matvec_instance` names), CPU values to
    bcsr_matvec_reference."""
    _check(J)
    s, v = J.structure, J.values
    if (tuple(vec.shape) != (s.nstate,) or vec.dtype != v.dtype
            or vec.device != v.device):
        raise ValueError(f"v must be ({s.nstate},) of {v.dtype} on "
                         f"{v.device}")
    if v.device.type == "cpu":
        return bcsr_matvec_reference(J, vec)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    lib = load_library()
    entry = (lib.dogleg_bcsr_matvec_f32 if v.dtype == torch.float32
             else lib.dogleg_bcsr_matvec_f64)
    vals, x = v.contiguous(), vec.contiguous()
    indptr = device_indices(s.indptr, v.device)
    indices = device_indices(s.indices, v.device)
    out = torch.empty(s.nmeas, dtype=v.dtype, device=v.device)
    err = entry(vals.data_ptr(), s.block_rows, s.block_cols,
                indptr.data_ptr(), indices.data_ptr(), x.data_ptr(), s.nmeas,
                out.data_ptr(), *launch_target(v.device))
    if err:
        raise RuntimeError(f"bcsr_matvec_kernel launch failed: "
                           f"cudaError_t {err}")
    launch_counts["bcsr_matvec_kernel"] += 1
    return out
