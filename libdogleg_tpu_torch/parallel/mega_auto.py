"""Auto-promotion of batched solves into the whole-solve kernel K1
(counterpart of libdogleg_tpu/parallel/mega_auto.py).

`batched_optimize` and `batched_optimize_compacted` hand a batch to K1 when
its products function is an ORDINARY per-element torch function, a (B, n <=
16) state and a dense (n, n) JtJ, under the JAX package's rules:

  * `adapt_products` traces the per-element function once with
    torch.fx.experimental.proxy_tensor.make_fx (fake tensors, so nothing
    runs and data-dependent control flow fails the trace) into an aten
    graph, and hoists the tensors it closes over (sampling grids, design
    matrices, ...) into explicit shared inputs. The graph, evaluated by
    PyTorch, is the plain version of the generated functor.
  * `generate_source` writes the CUDA C++ of one products functor from that
    graph, in one of two forms. The row form, where the three products are
    sums over one row axis (x @ x, J.T @ x, J.T @ J over the measurements):
    the values without that axis (the prologue) once an evaluation, then
    one loop over the rows, each row's values scalars or short arrays with
    constant indices (registers), the sums accumulated for the entries
    Products holds only, the rows split over ROW_GROUP lanes a problem.
    The array form, for other graphs: every value has a static shape and
    lives in a fixed-size local array (or is a strided view of one, of the
    state, of a problem's data or of a constant), each supported aten op
    becomes plain loops, and the arrays are reused once their values are
    dead. An op outside SUPPORTED_OPS, a dtype other than the state's, or
    arrays over MAX_LOCAL_VALUES raise UnsupportedProducts. The source
    includes csrc/dogleg_auto.cuh, which instantiates K1's solve (csrc/
    dogleg_solve.cuh) on the functor, and also compiles as host C++ (g++),
    which is how the CPU tests run the very text nvcc compiles.
  * `plan_megakernel` decides the regime statically, before anything is
    built, and returns a plan or None; the trace and the source are cached
    by the function's code, closure and globals and the inputs' shapes (the
    plan cache), and the tensors a call's function closes over are read
    from that call. A plan's call builds the source with nvcc
    (native/loader.build_generated: cached under _build/ by the hash of the
    source, the headers and the flags) and launches the kernel
    (ops/mega.megakernel_optimize_generated).

There is no compile probe and no fallback once a plan exists: an nvcc error
or a launch error raises, in auto mode too. The JAX package wraps its plan
in try/except and falls back to the XLA path (parallel/batched.py:115-119),
which would hide the kernel; here the regime is decided before any build,
so a failure is a fault to see, not a path to take.

Not ported: the jaxpr rewrite (libdogleg_tpu/parallel/mega_auto.py:53-320),
which exists only for Mosaic lowering faults, and the lane-tile choice and
padding: K1 takes any batch, and lanes past it write nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import math
import os
import threading
import time
import types
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import Products, SolveResult
from libdogleg_tpu_torch.telemetry import span

# The kernel unrolls the step math over Nstate (the JAX package's cap).
MEGA_MAX_N = 16
# Auto-selection engages only from this batch: an nvcc build of a new
# function costs seconds (PERF.md §6), as a Mosaic compile did. A forced
# call (use_megakernel=True) has no floor.
AUTO_MEGA_MIN_BATCH = 1024
# Input pointers a functor may take (csrc/dogleg_auto.cuh AUTO_MAX_INPUTS).
MAX_INPUTS = 32
# Values a functor's local arrays may hold, after reuse, a problem. ptxas
# puts them in local memory: at Nstate 16 config 8's tanh family (1424
# values) gives the float64 solve kernel a 16128-byte stack frame (7536 in
# float32; H100, PERF.md §6), and the card reserves the frame for each of
# its 132 x 2048 resident threads, 4.4 GB there. 2048 values keep that
# under 6 GB in float64.
MAX_LOCAL_VALUES = 2048
# Lanes a problem in the row form: the rows of a problem split over a group
# of one warp's lanes, as the named general instance splits its
# measurements (csrc/mega.cu). Chosen by the grid of G in {1, 2, 4, 8}
# measured on the H100 for the three functions chip_smoke.py promotes at
# B = 1024 and 10000 (PERF.md §6, artifacts/exp_torch_k1_auto_groups.py):
# 8 was the fastest, or within 3% of it, in five of the six cells (config
# 8 at B = 10000, its spills the bound, ran fastest at 2). The array form
# has one lane.
ROW_GROUP = 8


class UnsupportedProducts(ValueError):
    """The products function is outside what the code generator takes."""


# ---------------------------------------------------------------------------
# The adapter


@dataclasses.dataclass(frozen=True)
class AdaptedProducts:
    """A per-element products function as an aten graph.

    graph(p, *data_leaves, *consts) -> (norm2_x, Jt_x, JtJ) for one element:
    p (n,), each data leaf one element's slice of a problem_data leaf, the
    consts the tensors the function closes over, hoisted out of it."""
    graph: torch.fx.GraphModule
    consts: Tuple[torch.Tensor, ...]
    n_data: int
    nstate: int

    def plain(self, p: torch.Tensor, *data_leaves: torch.Tensor,
              consts: Optional[Sequence[torch.Tensor]] = None) -> Products:
        """The graph evaluated by PyTorch for one element, with `consts`
        in place of the hoisted constants where given: the plain version
        of the generated functor. torch.func.vmap batches it."""
        n2, jtx, jtj = self.graph(
            p, *data_leaves, *(self.consts if consts is None else consts))
        return Products(norm2_x=n2.reshape(()), Jt_x=jtx, JtJ=jtj)


# In-place view ops that make_fx records (matmul's decomposition squeezes
# its result in place) and their out-of-place forms.
_INPLACE_VIEWS = {
    "aten.squeeze_.dim": torch.ops.aten.squeeze.dim,
    "aten.squeeze_.dims": torch.ops.aten.squeeze.dims,
    "aten.squeeze_.default": torch.ops.aten.squeeze.default,
    "aten.unsqueeze_.default": torch.ops.aten.unsqueeze.default,
    "aten.t_.default": torch.ops.aten.t.default,
    "aten.transpose_.default": torch.ops.aten.transpose.int,
}


def adapt_products(products_fn, p0_elem: torch.Tensor,
                   data_elem: Any = None) -> AdaptedProducts:
    """Trace a per-element products function into an aten graph.

    products_fn: p -> Products (data_elem None) or (p, data) -> Products.
    p0_elem: one (n,) state; data_elem: one element's problem data (a
    tensor or a tree of tensors), or None. Nothing is computed: the trace
    runs on fake tensors, so a function whose control flow depends on
    values fails to trace.

    Raises TypeError where the JtJ is not a dense (n, n) tensor (structured
    JtJ such as SchurJtJ have no K1 path), or Jt_x is not (n,) and norm2_x
    not one value."""
    from torch.fx.experimental.proxy_tensor import make_fx
    n = p0_elem.shape[-1]
    if data_elem is None:
        leaves, spec = [], None
    else:
        leaves, spec = pytree.tree_flatten(data_elem)
    nd = len(leaves)

    def f(p, *dl):
        pr = (products_fn(p) if spec is None else
              products_fn(p, pytree.tree_unflatten(list(dl), spec)))
        jtj, jtx, n2 = pr.JtJ, pr.Jt_x, pr.norm2_x
        if not isinstance(jtj, torch.Tensor) or tuple(jtj.shape) != (n, n):
            raise TypeError(f"the megakernel needs a dense ({n}, {n}) JtJ, "
                            f"got {type(jtj).__name__}")
        if (not isinstance(jtx, torch.Tensor) or tuple(jtx.shape) != (n,)
                or not isinstance(n2, torch.Tensor) or n2.numel() != 1):
            raise TypeError(f"the megakernel needs Jt_x ({n},) and one "
                            "norm2_x")
        return n2, jtx, jtj

    gm = make_fx(f, tracing_mode="fake",
                 _allow_non_fake_inputs=True)(p0_elem, *leaves)
    graph = gm.graph
    last = [node for node in graph.nodes if node.op == "placeholder"][-1]
    consts, hoisted = [], {}
    for node in list(graph.nodes):
        if node.op == "get_attr":
            if node.target not in hoisted:
                with graph.inserting_after(last):
                    last = graph.placeholder(f"const{len(consts)}")
                last.meta = dict(node.meta)
                hoisted[node.target] = last
                consts.append(getattr(gm, node.target))
            node.replace_all_uses_with(hoisted[node.target])
            graph.erase_node(node)
        elif (node.op == "call_function"
              and str(node.target) in _INPLACE_VIEWS
              and len(node.args[0].users) == 1):
            node.target = _INPLACE_VIEWS[str(node.target)]
    graph.lint()
    return AdaptedProducts(graph=torch.fx.GraphModule(torch.nn.Module(),
                                                      graph),
                           consts=tuple(consts), n_data=nd, nstate=n)


# ---------------------------------------------------------------------------
# The code generator

class _Buf:
    """A local array of the functor: defined at node `start`, read last at
    node `end`."""

    def __init__(self, ident: int, size: int, start: int):
        self.ident, self.size, self.start, self.end = ident, size, start, start
        self.inplace_of: List[_Buf] = []
        self.name = ""

    @property
    def token(self) -> str:
        return f"@{self.ident}@"


@dataclasses.dataclass
class _Val:
    """A value of the graph: a strided view of a storage (the state `p`, a
    data leaf `d<k>`, a constant `c<k>` or a local array), or a literal that
    every element equals. In the row body of the row form a value holds one
    row: its row axis has size 1, and a leaf's view adds `row` times
    `row_stride` to its offset."""
    shape: Tuple[int, ...]
    strides: Tuple[int, ...] = ()
    offset: int = 0
    base: Optional[str] = None
    buf: Optional[_Buf] = None
    literal: Optional[str] = None
    load: bool = False      # a leaf in device memory, read by dl_ld
    row_stride: int = 0

    def at(self, idx: Sequence[str]) -> str:
        if self.literal is not None:
            return self.literal
        terms = [str(self.offset)] if self.offset else []
        if self.row_stride:
            terms.append("row" if self.row_stride == 1
                         else f"row * {self.row_stride}")
        for i, s in zip(idx, self.strides):
            if s:
                terms.append(i if s == 1 else f"{i} * {s}")
        flat = " + ".join(terms) or "0"
        return (f"dl_ld({self.base} + {flat})" if self.load
                else f"{self.base}[{flat}]")

    def flat(self, idx: Sequence[int]) -> int:
        """The index into its storage of the element at integer `idx`."""
        return self.offset + sum(i * s for i, s in zip(idx, self.strides))

    def viewed(self, shape, strides, offset) -> "_Val":
        return dataclasses.replace(self, shape=tuple(shape),
                                   strides=tuple(strides), offset=offset)

    def is_identity(self) -> bool:
        """Element i of the value is element i of its local array."""
        return (self.buf is not None and self.offset == 0
                and math.prod(self.shape) == self.buf.size
                and self.strides == _contiguous(self.shape))


def _contiguous(shape) -> Tuple[int, ...]:
    strides, s = [], 1
    for d in reversed(shape):
        strides.append(s if d != 1 else 0)
        s *= d
    return tuple(reversed(strides))


def _is_contiguous(v: _Val) -> bool:
    return all(s == c for d, s, c in zip(v.shape, v.strides,
                                          _contiguous(v.shape)) if d != 1)


def _lit(v) -> str:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise UnsupportedProducts(f"scalar {v!r} is no number")
    v = float(v)
    if not math.isfinite(v):
        raise UnsupportedProducts(f"scalar {v!r} is not finite")
    return f"T({v.hex()})" if v != int(v) or abs(v) >= 2 ** 53 \
        else f"T({int(v)})"


# elementwise functions of one value: C expression of x
_UNARY = {
    "aten.neg.default": "-({x})",
    "aten.exp.default": "exp({x})",
    "aten.log.default": "log({x})",
    "aten.tanh.default": "tanh({x})",
    "aten.sin.default": "sin({x})",
    "aten.cos.default": "cos({x})",
    "aten.sqrt.default": "dl_sqrt({x})",
    "aten.rsqrt.default": "dl_div(T(1), dl_sqrt({x}))",
    "aten.reciprocal.default": "dl_div(T(1), {x})",
    "aten.abs.default": "fabs({x})",
}
# elementwise functions of two values, with their alpha argument's role
_BINARY = {
    "aten.add.Tensor": "dl_add", "aten.add.Scalar": "dl_add",
    "aten.sub.Tensor": "dl_sub", "aten.sub.Scalar": "dl_sub",
    "aten.rsub.Tensor": "rsub", "aten.rsub.Scalar": "rsub",
    "aten.mul.Tensor": "dl_mul", "aten.mul.Scalar": "dl_mul",
    "aten.div.Tensor": "dl_div", "aten.div.Scalar": "dl_div",
}
_ALIASES = ("aten.alias.default", "aten.detach.default",
            "aten.lift_fresh_copy.default", "aten.clone.default",
            "aten._to_copy.default")
_VIEWS = ("aten.select.int", "aten.slice.Tensor", "aten.unsqueeze.default",
          "aten.squeeze.dim", "aten.squeeze.dims", "aten.squeeze.default",
          "aten.expand.default", "aten.permute.default", "aten.t.default",
          "aten.transpose.int", "aten.view.default",
          "aten._unsafe_view.default", "aten.reshape.default")
_FILLS = ("aten.ones_like.default", "aten.zeros_like.default",
          "aten.full_like.default", "aten.ones.default",
          "aten.zeros.default", "aten.full.default",
          "aten.new_ones.default", "aten.new_zeros.default",
          "aten.new_full.default", "aten.scalar_tensor.default")
_REDUCTIONS = ("aten.sum.dim_IntList", "aten.sum.default", "aten.dot.default",
               "aten.mv.default", "aten.mm.default")
_OTHER = ("aten.pow.Tensor_Scalar", "aten.stack.default", "aten.cat.default")
SUPPORTED_OPS = frozenset(_UNARY) | frozenset(_BINARY) | frozenset(
    _ALIASES + _VIEWS + _FILLS + _REDUCTIONS + _OTHER)


@dataclasses.dataclass(frozen=True)
class GeneratedSource:
    """The CUDA C++ (and host C++) source of one products functor with K1
    around it, and what it holds."""
    text: str
    nstate: int
    n_inputs: int
    local_values: int      # values of its local arrays, after reuse
    operations: int        # floating-point operations of one evaluation
    data_numel: Tuple[int, ...]   # values of each data leaf per element
    const_numel: Tuple[int, ...]  # values of each constant
    form: str = "array"    # "row" (a loop over the row axis) or "array"
    group: int = 1         # lanes a problem
    rows: int = 0          # the row axis's size in the row form


class _NoRows(Exception):
    """The graph has no row axis that the row form can take."""


def _shape(node) -> Tuple[int, ...]:
    return tuple(int(d) for d in node.meta["val"].shape)


def _inputs(node) -> List[torch.fx.Node]:
    """The tensors an op reads (a stack's or a cat's list spread out)."""
    out = []
    for x in node.args:
        for y in (x if isinstance(x, (list, tuple)) else [x]):
            if isinstance(y, torch.fx.Node):
                out.append(y)
    return out


def _final_sums(output):
    """The row axis of the products: each of norm2_x, Jt_x and JtJ must end,
    through views that only it reads, in a sum over one axis of one size M
    (x @ x, J.T @ x, J.T @ J, or a sum over one axis). Returns the three
    sums, the views after them, what each sum reads as its row axis
    {(sum, input): axis}, and M."""
    finals, chain, demand, sizes = [], set(), {}, set()
    for x in output.args[0]:
        node = x
        while (isinstance(node, torch.fx.Node) and node.op == "call_function"
               and str(node.target) in _ALIASES + _VIEWS
               and len(node.users) == 1):
            chain.add(node)
            node = node.args[0]
        if (not isinstance(node, torch.fx.Node) or node.op != "call_function"
                or str(node.target) not in _REDUCTIONS
                or len(node.users) != 1 or node in finals):
            raise _NoRows("a product does not end in a sum")
        name, args = str(node.target), node.args
        if name == "aten.dot.default":
            reads = [(args[0], 0), (args[1], 0)]
        elif name in ("aten.mv.default", "aten.mm.default"):
            reads = [(args[0], 1), (args[1], 0)]
        else:
            x_shape = _shape(args[0])
            dims = (range(len(x_shape)) if name == "aten.sum.default"
                    or not args[1] else args[1])
            dims = {d % max(len(x_shape), 1) for d in dims}
            if len(dims) != 1:
                raise _NoRows("a sum over more than one axis")
            reads = [(args[0], dims.pop())]
        for y, k in reads:
            if (not isinstance(y, torch.fx.Node)
                    or demand.setdefault((node, y), k) != k):
                raise _NoRows("a sum reads one value over two axes")
            sizes.add(_shape(y)[k])
        finals.append(node)
    if len(sizes) != 1 or min(sizes) < 2:
        raise _NoRows("the products' sums run over different axes")
    return finals, chain, demand, sizes.pop()


def _reads(node, d: Optional[int]):
    """[(input, axis)]: the axis along which `node`, whose own row axis is d
    (None: it has none), reads each input's row axis (None: the input is
    read whole, broadcast over the rows). Raises _NoRows where an op would
    mix rows."""
    name, args, out = str(node.target), node.args, _shape(node)
    if name in _FILLS:
        return []          # a fill reads its input's shape, not its values
    if d is None:
        return [(x, None) for x in _inputs(node)]
    if name in _UNARY or name in _BINARY or name == "aten.pow.Tensor_Scalar":
        res = []
        for x in _inputs(node):
            s = _shape(x)
            k = d - (len(out) - len(s))
            res.append((x, None if k < 0 or s[k] == 1 else k))
        return res
    if name in _ALIASES:
        return [(args[0], d)]
    if name in ("aten.stack.default", "aten.cat.default"):
        nd = len(out)
        dim = (args[1] if len(args) > 1 else 0) % nd
        if dim == d:
            raise _NoRows(f"{name} along the row axis")
        k = d if name == "aten.cat.default" or d < dim else d - 1
        return [(x, k if math.prod(_shape(x)) else None) for x in args[0]]
    x = args[0]
    s = _shape(x)
    r = len(s)
    if name == "aten.select.int":
        dim = args[1] % r
        return [(x, d if d < dim else d + 1)]
    if name == "aten.slice.Tensor":
        dim = (args[1] if len(args) > 1 else 0) % r
        step = args[4] if len(args) > 4 else 1
        if dim == d and (out[d] != s[d] or step != 1):
            raise _NoRows("a slice of the row axis")
        return [(x, d)]
    if name == "aten.unsqueeze.default":
        dim = args[1] % (r + 1)
        return [(x, d if d < dim else d - 1)]
    if name.startswith("aten.squeeze"):
        return [(x, [k for k in range(r)
                     if k not in _squeezed(name, args, s)][d])]
    if name == "aten.expand.default":
        k = d - (len(out) - r)
        return [(x, None if k < 0 or s[k] == 1 else k)]
    if name == "aten.permute.default":
        return [(x, [k % r for k in args[1]][d])]
    if name == "aten.t.default":
        return [(x, d if r < 2 else 1 - d)]
    if name == "aten.transpose.int":
        d0, d1 = args[1] % r, args[2] % r
        return [(x, d1 if d == d0 else d0 if d == d1 else d)]
    if name in _VIEWS:     # view / reshape: the row axis stays whole
        before = math.prod(out[:d])
        for k in range(r):
            if math.prod(s[:k]) == before and s[k] == out[d]:
                return [(x, k)]
        raise _NoRows("a reshape that splits the row axis")
    if name == "aten.sum.dim_IntList":
        dims = (set(range(r)) if not args[1]
                else {k % r for k in args[1]})
        keepdim = bool(args[2] if len(args) > 2
                       else node.kwargs.get("keepdim", False))
        return [(x, d if keepdim else
                 [k for k in range(r) if k not in dims][d])]
    if name == "aten.mv.default":
        return [(args[0], 0), (args[1], None)]
    if name == "aten.mm.default":
        return ([(args[0], 0), (args[1], None)] if d == 0
                else [(args[0], None), (args[1], 1)])
    raise _NoRows(f"{name} over the rows")


def _squeezed(name, args, shape) -> set:
    """The axes a squeeze drops, from its input's whole shape."""
    nd = len(shape)
    if name == "aten.squeeze.default":
        return {k for k in range(nd) if shape[k] == 1}
    dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
    return {k % nd for k in dims if shape[k % nd] == 1}


def _row_axes(nodes, finals, chain, demand, M):
    """Backward over the graph: the row axis of each computed value, from
    what its readers read (None: it has none and goes to the prologue), and
    the axis each reader reads a leaf along {(reader, leaf): axis}. Raises
    _NoRows where a value would be read along two axes, or read whole by a
    value without rows (a sum over rows that is not one of the products)."""
    want: Dict[torch.fx.Node, set] = {}
    leaf_reads: Dict[tuple, Optional[int]] = {}

    def read(reader, x, k):
        if k is not None and _shape(x)[k] != M:
            raise _NoRows("a row axis of another size")
        if x.op == "placeholder":
            if leaf_reads.setdefault((reader, x), k) != k:
                raise _NoRows("a leaf read along two axes")
        else:
            want.setdefault(x, set()).add(k)

    for (reader, x), k in demand.items():
        read(reader, x, k)
    axes: Dict[torch.fx.Node, Optional[int]] = {}
    for node in reversed(nodes):
        if (node.op != "call_function" or node in chain or node in finals
                or not node.users):
            continue
        ks = want.get(node, {None})
        if len(ks) != 1:
            raise _NoRows(f"{node.target} read along two axes")
        axes[node] = d = next(iter(ks))
        for x, k in _reads(node, d):
            read(node, x, k)
    return axes, leaf_reads


class _Gen:
    """One pass over the graph in order: a _Val per node, C++ lines per op
    with local arrays as tokens; then the arrays' live ranges decide which
    physical arrays they share.

    The row form (form "row") splits the graph at its row axis: the
    prologue, the values without it, is emitted first as the array form
    emits it; then the values with it, one row at a time (their row axis of
    size 1, a leaf read at `row`), inside a loop over the rows that lane
    `lane` of a group of G takes; and the three products' sums become
    accumulators of their read elements only. Inner loops are unrolled
    (DOGLEG_UNROLL), so that a row's values stay in registers."""

    def __init__(self, adapted: AdaptedProducts, dtype: torch.dtype,
                 form: str = "array", group: int = 1):
        self.a, self.dtype, self.form, self.group = adapted, dtype, form, group
        self.vals: Dict[torch.fx.Node, _Val] = {}
        self.bufs: List[_Buf] = []
        self.row_bufs: List[_Buf] = []
        self.lines: List[str] = []
        self.ops = 0
        self.i = 0           # index of the node being emitted
        self.loop_depth = 0
        self.unroll = form == "row"
        self.in_rows = False     # emitting the row body
        self.scale = 1           # rows each emitted operation runs over
        self.cur: Optional[torch.fx.Node] = None
        self.axes: Dict[torch.fx.Node, Optional[int]] = {}
        self.leaf_reads: Dict[tuple, Optional[int]] = {}
        self.demand: Dict[tuple, int] = {}

    # -- values and arrays --------------------------------------------------

    def new_buf(self, shape) -> _Val:
        b = _Buf(len(self.bufs) + len(self.row_bufs),
                 max(math.prod(shape), 1), self.i)
        if self.in_rows:
            b.name = f"r{len(self.row_bufs)}"
            self.row_bufs.append(b)
        else:
            self.bufs.append(b)
        return _Val(tuple(shape), _contiguous(shape), 0, b.token, b)

    def use(self, v: _Val) -> _Val:
        if v.buf is not None:
            v.buf.end = max(v.buf.end, self.i)
        return v

    def arg(self, x) -> _Val:
        if isinstance(x, torch.fx.Node):
            v = self.vals[x]
            k = (self.leaf_reads.get((self.cur, x)) if self.in_rows
                 and x.op == "placeholder" else None)
            if k is not None:    # one row of a leaf
                shape, st = list(v.shape), list(v.strides)
                row_stride, shape[k], st[k] = st[k], 1, 0
                v = dataclasses.replace(v.viewed(shape, st, v.offset),
                                        row_stride=row_stride)
            return self.use(v)
        return _Val((), (), literal=_lit(x))

    def emit(self, line: str) -> None:
        self.lines.append("  " * (2 + self.loop_depth) + line)

    def emit_for(self, var: str, d: int) -> None:
        if self.unroll:
            self.emit("DOGLEG_UNROLL")
        self.emit(f"for (int {var} = 0; {var} < {d}; ++{var})")

    def loops(self, shape, body) -> None:
        """Nested loops i0, i1, ... over shape around body(idx), in a
        block of their own; an axis of size 1 has index 0 and no loop."""
        idx = [f"i{k}" if d != 1 else "0" for k, d in enumerate(shape)]
        self.emit("{")
        self.loop_depth += 1
        for k, d in enumerate(shape):
            if d != 1:
                self.emit_for(f"i{k}", d)
        body(idx)
        self.loop_depth -= 1
        self.emit("}")

    @staticmethod
    def broadcast(v: _Val, shape) -> _Val:
        if v.literal is not None:
            return dataclasses.replace(v, shape=tuple(shape))
        lead = len(shape) - len(v.shape)
        if lead < 0:
            raise UnsupportedProducts("a value wider than its result")
        strides = [0] * lead + [
            0 if d == 1 else s for d, s in zip(v.shape, v.strides)]
        return v.viewed(shape, strides, v.offset)

    def elementwise(self, shape, ins: List[_Val], fn) -> _Val:
        """A new array of `shape`, element idx fn(each input at idx); it
        may take over the array of an input read only here, element for
        element."""
        out = self.new_buf(shape)
        ins = [self.broadcast(v, shape) for v in ins]
        for v in ins:
            if (v.buf is not None and v.buf.size == out.buf.size
                    and v.is_identity()
                    and all(w.is_identity() for w in ins
                            if w.buf is v.buf)):
                out.buf.inplace_of.append(v.buf)
        self.ops += math.prod(shape) * self.scale

        def body(idx):
            self.emit(f"  {out.at(idx)} = "
                      f"{fn(*(v.at(idx) for v in ins))};")
        self.loops(shape, body)
        return out

    def copy_into(self, dst: _Val, src: _Val) -> None:
        src = self.broadcast(src, dst.shape)

        def body(idx):
            self.emit(f"  {dst.at(idx)} = {src.at(idx)};")
        self.loops(dst.shape, body)

    def reduce(self, out_shape, terms, inner, fn) -> _Val:
        """out[idx] = the sum over j of fn(idx, j) for j over `inner`, in
        order; `terms` the operations each output element costs."""
        out = self.new_buf(out_shape)
        self.ops += max(math.prod(out_shape), 1) * terms * self.scale

        def body(idx):
            self.emit("  {")
            self.emit("    T s = T(0);")
            red = [f"j{k}" for k in range(len(inner))]
            self.loop_depth += 2
            for k, d in enumerate(inner):
                self.emit_for(f"j{k}", d)
            self.loop_depth -= 2
            self.emit(f"      s = dl_add(s, {fn(idx, red)});")
            self.emit(f"    {out.at(idx)} = s;")
            self.emit("  }")
        self.loops(out_shape, body)
        return out

    # -- ops ----------------------------------------------------------------

    def node(self, node: torch.fx.Node) -> _Val:
        name = str(node.target)
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            raise UnsupportedProducts(f"{name} gives no tensor")
        if val.dtype != self.dtype:
            raise UnsupportedProducts(
                f"{name} gives {val.dtype}, not the state's {self.dtype}")
        shape = [int(d) for d in val.shape]
        if self.in_rows:
            shape[self.axes[node]] = 1
        shape = tuple(shape)
        args = node.args
        if name in _UNARY:
            return self.elementwise(shape, [self.arg(args[0])],
                                    lambda x: _UNARY[name].format(x=x))
        if name in _BINARY:
            return self.binary(name, shape, node)
        if name == "aten.pow.Tensor_Scalar":
            return self.power(shape, self.arg(args[0]), args[1])
        if name in _ALIASES:
            if name == "aten._to_copy.default" and set(node.kwargs) - {
                    "dtype", "device", "layout", "memory_format"}:
                raise UnsupportedProducts(f"{name} with {node.kwargs}")
            return self.arg(args[0])
        if name in _VIEWS:
            return self.view(name, shape, node)
        if name in _FILLS:
            return self.fill(name, shape, node)
        if name in _REDUCTIONS:
            return self.reduction(name, shape, node)
        if name in ("aten.stack.default", "aten.cat.default"):
            return self.join(name, shape, node)
        raise UnsupportedProducts(f"no code for {name}")

    def binary(self, name, shape, node) -> _Val:
        a, b = self.arg(node.args[0]), self.arg(node.args[1])
        alpha = node.kwargs.get("alpha", 1)
        op = _BINARY[name]
        if op == "rsub":
            a, b, op = b, a, "dl_sub"
        if alpha != 1:
            lit = _lit(alpha)
            return self.elementwise(
                shape, [a, b], lambda x, y: f"{op}({x}, dl_mul({y}, {lit}))")
        return self.elementwise(shape, [a, b],
                                lambda x, y: f"{op}({x}, {y})")

    def power(self, shape, x: _Val, e) -> _Val:
        """x ** e for a constant e, as PyTorch's pow special-cases it."""
        forms = {2.0: "dl_mul({x}, {x})",
                 3.0: "dl_mul(dl_mul({x}, {x}), {x})",
                 0.5: "dl_sqrt({x})", 1.0: "{x}", 0.0: "T(1)",
                 -1.0: "dl_div(T(1), {x})",
                 -2.0: "dl_div(T(1), dl_mul({x}, {x}))",
                 -0.5: "dl_div(T(1), dl_sqrt({x}))"}
        form = forms.get(float(e), "pow({x}, " + _lit(e) + ")")
        return self.elementwise(shape, [x], lambda v: form.format(x=v))

    def view(self, name, shape, node) -> _Val:
        x = self.arg(node.args[0])
        args = node.args[1:]
        if x.literal is not None:
            return dataclasses.replace(x, shape=shape)
        nd = len(x.shape)
        st = list(x.strides)
        if name == "aten.select.int":
            d, i = args[0] % nd, args[1] % x.shape[args[0] % nd]
            return x.viewed(shape, st[:d] + st[d + 1:], x.offset + i * st[d])
        if name == "aten.slice.Tensor":
            d = (args[0] if args else 0) % nd
            start = args[1] if len(args) > 1 and args[1] is not None else 0
            step = args[3] if len(args) > 3 else 1
            if start < 0:
                start += x.shape[d]
            start = min(max(start, 0), x.shape[d])
            st2 = list(st)
            st2[d] = st[d] * step
            return x.viewed(shape, st2, x.offset + start * st[d])
        if name == "aten.unsqueeze.default":
            d = args[0] % (nd + 1)
            return x.viewed(shape, st[:d] + [0] + st[d:], x.offset)
        if name.startswith("aten.squeeze"):
            # from the input's whole shape: in the row body its row axis
            # has size 1 and stays
            drop = _squeezed(name, node.args, _shape(node.args[0]))
            return x.viewed(shape, [s for k, s in enumerate(st)
                                    if k not in drop], x.offset)
        if name == "aten.expand.default":
            lead = len(shape) - nd
            return x.viewed(shape, [0] * lead + [
                s if x.shape[k] == shape[lead + k] else 0
                for k, s in enumerate(st)], x.offset)
        if name in ("aten.permute.default", "aten.t.default",
                    "aten.transpose.int"):
            if name == "aten.permute.default":
                perm = [k % nd for k in args[0]]
            else:
                perm = list(range(nd))
                if nd >= 2:
                    d0, d1 = ((args[0] % nd, args[1] % nd)
                              if name == "aten.transpose.int" else (0, 1))
                    perm[d0], perm[d1] = perm[d1], perm[d0]
            return x.viewed(shape, [st[k] for k in perm], x.offset)
        # view / reshape: a new shape over contiguous values
        if not _is_contiguous(x):
            y = self.new_buf(x.shape)
            self.copy_into(y, x)
            x = y
        return x.viewed(shape, _contiguous(shape), x.offset)

    def fill(self, name, shape, node) -> _Val:
        args = node.args
        if name in ("aten.ones_like.default", "aten.ones.default",
                    "aten.new_ones.default"):
            lit = "T(1)"
        elif name in ("aten.zeros_like.default", "aten.zeros.default",
                      "aten.new_zeros.default"):
            lit = "T(0)"
        elif name == "aten.scalar_tensor.default":
            lit = _lit(args[0])
        else:   # full(size, v), full_like(x, v), new_full(x, size, v)
            lit = _lit(args[-1])
        return _Val(shape, (0,) * len(shape), literal=lit)

    def reduction(self, name, shape, node) -> _Val:
        args = node.args
        if name in ("aten.sum.dim_IntList", "aten.sum.default"):
            x = self.arg(args[0])
            nd = len(x.shape)
            dims = (set(range(nd)) if name == "aten.sum.default"
                    or not args[1] else {d % nd for d in args[1]})
            keep = [k for k in range(nd) if k not in dims]
            inner = [x.shape[k] for k in sorted(dims)]
            keepdim = bool(args[2] if len(args) > 2
                           else node.kwargs.get("keepdim", False))

            def term(idx, red):
                ri = iter(red)
                ki = iter([idx[k] for k in keep] if keepdim else idx)
                return x.at([next(ri) if k in dims else next(ki)
                             for k in range(nd)])
            return self.reduce(shape, math.prod(inner), inner, term)
        a, b = self.arg(args[0]), self.arg(args[1])
        if name == "aten.dot.default":
            k = a.shape[0]
            return self.reduce(shape, 2 * k, [k], lambda idx, j: (
                f"dl_mul({a.at(j)}, {b.at(j)})"))
        if name == "aten.mv.default":
            k = a.shape[1]
            return self.reduce(shape, 2 * k, [k], lambda idx, j: (
                f"dl_mul({a.at([idx[0], j[0]])}, {b.at(j)})"))
        k = a.shape[1]   # mm
        return self.reduce(shape, 2 * k, [k], lambda idx, j: (
            f"dl_mul({a.at([idx[0], j[0]])}, {b.at([j[0], idx[1]])})"))

    def join(self, name, shape, node) -> _Val:
        parts = [self.arg(t) for t in node.args[0]]
        nd = len(shape)
        dim = (node.args[1] if len(node.args) > 1 else 0) % nd
        out = self.new_buf(shape)
        st = list(out.strides)
        at = 0
        for v in parts:
            if name == "aten.stack.default":
                dst = out.viewed(v.shape, st[:dim] + st[dim + 1:],
                                 at * st[dim])
                at += 1
            else:
                if math.prod(v.shape) == 0:
                    continue
                dst = out.viewed(v.shape, st, at * st[dim])
                at += v.shape[dim]
            self.copy_into(dst, v)
        return out


    # -- the whole functor ---------------------------------------------------

    def run(self) -> GeneratedSource:
        a = self.a
        nodes = list(a.graph.graph.nodes)
        placeholders = [nd for nd in nodes if nd.op == "placeholder"]
        data_numel, const_numel = [], []
        for k, ph in enumerate(placeholders):
            val = ph.meta.get("val")
            if not isinstance(val, torch.Tensor) or val.dtype != self.dtype:
                raise UnsupportedProducts(
                    f"input {k} is not a {self.dtype} tensor")
            shape = tuple(int(d) for d in val.shape)
            if k == 0:
                base = "p"
            elif k <= a.n_data:
                base = f"d{k - 1}"
                data_numel.append(math.prod(shape))
            else:
                base = f"c{k - 1 - a.n_data}"
                const_numel.append(math.prod(shape))
            self.vals[ph] = _Val(shape, _contiguous(shape), 0, base,
                                 load=k > 0)
        n_inputs = len(data_numel) + len(const_numel)
        if n_inputs > MAX_INPUTS:
            raise UnsupportedProducts(
                f"{n_inputs} inputs, more than the kernel's {MAX_INPUTS}")
        for nd in nodes:
            if nd.op not in ("placeholder", "call_function", "output"):
                raise UnsupportedProducts(f"graph node {nd.op} {nd.target}")
        output = nodes[-1]
        if any(not isinstance(x, torch.fx.Node) for x in output.args[0]):
            raise UnsupportedProducts("the products are not all tensors")
        if self.form == "row":
            body, rows, extra = self.rows_body(nodes, output)
        else:
            body, rows, extra = self.array_body(nodes, output), 0, 0
        decls, local_values = self.allocate()
        text = "\n".join(decls + body)
        for b in self.bufs + self.row_bufs:
            text = text.replace(b.token, b.name)
        return GeneratedSource(
            text=self.source(text, data_numel, const_numel),
            nstate=a.nstate, n_inputs=n_inputs,
            local_values=local_values + extra, operations=self.ops,
            data_numel=tuple(data_numel), const_numel=tuple(const_numel),
            form=self.form, group=self.group, rows=rows)

    def array_body(self, nodes, output) -> List[str]:
        """Every value an array of its own shape, in the graph's order; the
        products copied out of the arrays of the three outputs."""
        n = self.a.nstate
        for self.i, nd in enumerate(nodes):
            if nd.op == "call_function" and nd.users:
                # a value nothing reads costs nothing
                self.vals[nd] = self.node(nd)
        outs = [self.arg(x) for x in output.args[0]]
        for v in outs:
            if v.buf is not None:
                v.buf.end = len(nodes)
        n2, jtx, jtj = outs
        self.i = len(nodes)
        self.loop_depth = 0
        self.emit(f"out.norm2 = {n2.at(['0'] * len(n2.shape))};")
        self.emit(f"for (int a = 0; a < {n}; ++a) out.jtx[a] = "
                  f"{jtx.at(['a'])};")
        self.emit(f"for (int a = 0; a < {n}; ++a)")
        self.emit(f"  for (int c = 0; c <= a; ++c) out.jtj[pk(a, c)] = "
                  f"{jtj.at(['a', 'c'])};")
        return self.lines

    def rows_body(self, nodes, output):
        """The row form's body: the prologue, the loop over a lane's rows
        and the accumulators of the read elements of the three sums, combined
        over the group (group_row_sums, csrc/dogleg_auto.cuh). Returns the
        lines, M and the accumulators' count. Raises _NoRows where the graph
        has no row axis."""
        n, G = self.a.nstate, self.group
        finals, chain, demand, M = _final_sums(output)
        self.demand = demand
        self.axes, self.leaf_reads = _row_axes(nodes, finals, chain, demand, M)
        # each element of the products as an element of one of the sums
        for k, R in enumerate(finals):
            shape = _shape(R)
            self.vals[R] = _Val(shape, _contiguous(shape), 0, f"#{k}")
        for nd in nodes:
            if nd in chain:
                self.vals[nd] = self.node(nd)
        outs = [self.vals[x] for x in output.args[0]]
        if self.bufs or any(v.base != f"#{k}" for k, v in enumerate(outs)):
            raise _NoRows("a product is a copy of its sum")
        n2, jtx, jtj = outs
        reads = ([(0, n2.flat([0] * len(n2.shape)))]
                 + [(1, jtx.flat([a])) for a in range(n)]
                 + [(2, jtj.flat([a, c])) for a in range(n)
                    for c in range(a + 1)])
        # the prologue, once an evaluation
        order = 0
        for nd in nodes:
            if nd in self.axes and self.axes[nd] is None:
                self.i, self.cur = order, nd
                self.vals[nd] = self.node(nd)
                order += 1
        prologue, self.lines = self.lines, []
        # one row of each value with the row axis
        self.in_rows, self.scale, self.loop_depth = True, M, 2
        for nd in nodes:
            if self.axes.get(nd) is not None:
                self.i, self.cur = order, nd
                self.vals[nd] = self.node(nd)
                order += 1
        for j, (k, e) in enumerate(reads):
            R = finals[k]
            self.i, self.cur = order, R
            self.emit(f"acc[{j}] = dl_add(acc[{j}], "
                      f"{self.row_term(R, _unravel(e, _shape(R)))});")
        for R in finals:
            terms = 1 if "sum" in str(R.target) else 2
            self.ops += max(math.prod(_shape(R)), 1) * terms * M
        body = self.lines
        K = len(reads)
        decls = [f"    T {b.name}[{b.size}];" for b in self.row_bufs]
        lines = prologue + [
            f"    auto rows = [&](int lane, T (&acc)[{K}]) {{",
            f"      for (int row = lane; row < {M}; row += {G}) {{",
            *("    " + d for d in decls),
            *body,
            "      }",
            "    };",
            f"    T acc[{K}];",
            f"    group_row_sums<{G}>(rows, acc);",
            "    out.norm2 = acc[0];",
            f"    for (int a = 0; a < {n}; ++a) out.jtx[a] = acc[1 + a];",
            f"    for (int q = 0; q < {n * (n + 1) // 2}; ++q) "
            f"out.jtj[q] = acc[{1 + n} + q];",
        ]
        return lines, M, K + sum(b.size for b in self.row_bufs)

    def row_term(self, R, idx) -> str:
        """The term one row adds to element idx of the sum R, as the array
        form's reduce computes it."""
        name, args = str(R.target), R.args
        a = self.arg(args[0])
        if name == "aten.dot.default":
            return f"dl_mul({a.at(['0'])}, {self.arg(args[1]).at(['0'])})"
        if name == "aten.mv.default":
            return (f"dl_mul({a.at([str(idx[0]), '0'])}, "
                    f"{self.arg(args[1]).at(['0'])})")
        if name == "aten.mm.default":
            return (f"dl_mul({a.at([str(idx[0]), '0'])}, "
                    f"{self.arg(args[1]).at(['0', str(idx[1])])})")
        k = self.demand[(R, args[0])]    # a sum over the row axis k
        at = [str(i) for i in idx]
        if len(at) < len(a.shape):
            at.insert(k, "0")
        else:
            at[k] = "0"
        return a.at(at)

    def allocate(self):
        """Physical arrays for the local arrays, in order of definition: an
        array whose values are dead is reused, by one at least its size, and
        an elementwise result takes over an input's array where that input
        is read last by it, element for element."""
        phys: List[list] = []      # [name, size, busy_until]
        for b in self.bufs:
            taken = None
            for src in b.inplace_of:
                p = next((p for p in phys if p[0] == src.name), None)
                if p is not None and src.end == b.start and p[1] == b.size:
                    taken = p
                    break
            if taken is None:
                free = [p for p in phys if p[2] < b.start and p[1] >= b.size]
                taken = min(free, key=lambda p: p[1]) if free else None
            if taken is None:
                taken = [f"v{len(phys)}", b.size, 0]
                phys.append(taken)
            taken[2] = max(b.end, b.start)
            b.name = taken[0]
        decls = [f"    T {name}[{size}];" for name, size, _ in phys]
        return decls, sum(p[1] for p in phys)

    def source(self, body, data_numel, const_numel) -> str:
        n = self.a.nstate
        fields, init = [], []
        for k, numel in enumerate(data_numel):
            fields.append(f"  const T* __restrict__ d{k};")
            init.append(f"    f.d{k} = static_cast<const T*>(ins[{k}]) + "
                        f"static_cast<size_t>(b) * {numel};")
        for k, _ in enumerate(const_numel):
            j = len(data_numel) + k
            fields.append(f"  const T* __restrict__ c{k};")
            init.append(f"    f.c{k} = static_cast<const T*>(ins[{j}]);")
        lines = [
            "// Generated by libdogleg_tpu_torch/parallel/mega_auto.py from "
            "a traced products",
            "// function: kernel K1 (csrc/dogleg_auto.cuh) on its functor.",
            f"// Nstate {n}; {len(data_numel)} problem-data leaves "
            f"({', '.join(map(str, data_numel)) or 'none'} values an "
            f"element); {len(const_numel)} shared constants "
            f"({', '.join(map(str, const_numel)) or 'none'} values); "
            f"the {self.form} form, {self.group} lane(s) a problem.",
            "#include \"dogleg_auto.cuh\"",
            "",
            "namespace {",
            "",
            "template <typename T>",
            "struct AutoProducts {",
            f"  static constexpr int kInputs = "
            f"{len(data_numel) + len(const_numel)};",
            f"  static constexpr int kGroup = {self.group};",
            *fields,
            "",
            "  static DOGLEG_DEVICE AutoProducts at(const void* const* ins, "
            "int b) {",
            "    AutoProducts f{};",
            *init,
            "    (void)ins;",
            "    (void)b;",
            "    return f;",
            "  }",
            "",
            f"  DOGLEG_DEVICE void operator()(const T (&p)[{n}], "
            f"Products<T, {n}>& out) const {{",
            body,
            "  }",
            "};",
            "",
            "}  // namespace",
            "",
            f"DOGLEG_AUTO_ENTRIES(AutoProducts, {n})",
            "",
        ]
        return "\n".join(lines)


def _unravel(e: int, shape) -> Tuple[int, ...]:
    idx = []
    for d in reversed(shape):
        idx.append(e % d)
        e //= d
    return tuple(reversed(idx))


def generate_source(adapted: AdaptedProducts, dtype: torch.dtype, *,
                    _form: Optional[str] = None,
                    _group: Optional[int] = None) -> GeneratedSource:
    """The C++ source of K1 on a functor that computes `adapted`'s products.
    The text is the same for float32 and float64 (the functor is a template
    on the type) and holds both types' entry points; `dtype` is the type
    the graph was traced in, which every value must have.

    The row form where the graph has a row axis (each product a sum over
    one axis of size M, every value on the way a function of one row or of
    none), with ROW_GROUP lanes a problem; else the array form, one lane a
    problem. `_form` ("row" or "array") and `_group` force a form and the
    row form's lanes, for tests and for timing others; a forced row form
    raises UnsupportedProducts where there is no row axis. Raises
    UnsupportedProducts where an op, a type or the arrays' size is outside
    what it takes."""
    if _form not in (None, "row", "array"):
        raise ValueError(f"no form {_form!r}")
    src = None
    if _form != "array":
        try:
            src = _Gen(adapted, dtype, "row", _group or ROW_GROUP).run()
        except _NoRows as e:
            if _form == "row":
                raise UnsupportedProducts(f"no row form: {e}") from None
    if src is None:
        src = _Gen(adapted, dtype).run()
    if src.local_values > MAX_LOCAL_VALUES:
        raise UnsupportedProducts(
            f"the products need {src.local_values} local values a problem, "
            f"more than {MAX_LOCAL_VALUES}")
    return src


# ---------------------------------------------------------------------------
# Kernels and plans


class GeneratedKernel:
    """K1 on a generated functor: the source and the adapted products (its
    plain version). The library is built by native/loader.build_generated
    (nvcc) at the first launch, and found again by the hash of the source.
    A plan's kernel holds its call's own constants in `adapted.consts`
    (MegaPlan.consts), read fresh by ops/mega at each launch."""

    def __init__(self, adapted: AdaptedProducts, source: GeneratedSource):
        self.adapted, self.source = adapted, source

    def on(self, consts: Tuple[torch.Tensor, ...]):
        """(the same graph and source with `consts` as its constants,
        consts)."""
        return (GeneratedKernel(dataclasses.replace(self.adapted,
                                                    consts=consts),
                                self.source), consts)

    def library(self):
        """The nvcc build of the source, bound (loader.load_generated)."""
        from libdogleg_tpu_torch.native.loader import load_generated
        return load_generated(self.source.text)


class MegaPlan:
    """A batched solve that kernel K1 takes: call it to run the solve.
    `consts` are the tensors the function closes over, as this call's
    function holds them."""

    def __init__(self, kernel: GeneratedKernel, p0: torch.Tensor,
                 data_leaves: Tuple[torch.Tensor, ...],
                 parameters: DoglegParameters,
                 consts: Tuple[torch.Tensor, ...]):
        self.kernel, self.p0, self.data_leaves = kernel, p0, data_leaves
        self.parameters, self.consts = parameters, consts

    def __call__(self) -> SolveResult:
        from libdogleg_tpu_torch.ops.mega import megakernel_optimize_generated
        return megakernel_optimize_generated(self.kernel, self.p0,
                                             self.data_leaves,
                                             self.parameters, self.consts)


# ---------------------------------------------------------------------------
# The plan cache (P11)

# make_fx traces made by plan_megakernel in this process, one per miss of
# the plan cache, as ops/mega.auto_launch_count counts K1-auto's launches,
# and the seconds they took with their code generation (perf_counter).
trace_count = 0
trace_seconds = 0.0
PLAN_CACHE_SIZE = 64
# key -> (kernel, const indices), or ((the exception's type, args), ())
_PLANS: Dict[tuple, tuple] = {}
_PLANS_LOCK = threading.Lock()
# Attribute names through which a function could read a tensor's values in
# Python, outside the traced ops (a trace would then depend on them).
_VALUE_READS = frozenset({"numpy", "tolist", "item", "__array__",
                          "data_ptr", "untyped_storage", "storage"})
_SCALARS = (type(None), bool, int, float, complex, str, bytes)
# Packages whose modules, classes and builtins are keyed by identity: no
# user changes their attributes. Any other module or class is keyed by the
# attributes that the code names on it.
_FIXED_PACKAGES = frozenset({"torch", "math", "cmath", "operator",
                             "builtins"})
# Descriptors in C (a tuple's methods, a named tuple's fields, slots): a
# class's attribute of this kind is keyed by identity.
_C_DESCRIPTORS = (types.MemberDescriptorType, types.GetSetDescriptorType,
                  types.MethodDescriptorType, types.WrapperDescriptorType,
                  type(collections.namedtuple("_Pair", "a").a))
_MAX_DEPTH = 8
_MISSING = object()


class _Uncacheable(Exception):
    """The key cannot show that a trace would give the same plan."""


def _names(code) -> frozenset:
    """The names a code object and the code nested in it look up."""
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _names(c)
    return frozenset(names)


def _fixed(v) -> bool:
    """A module, class or builtin of _FIXED_PACKAGES."""
    if isinstance(v, types.ModuleType):
        name = v.__name__
    elif isinstance(v, types.BuiltinFunctionType):
        owner = v.__self__
        if owner is not None and not isinstance(owner, (types.ModuleType,
                                                        type)):
            return False        # a method bound to some object
        name = v.__module__ or getattr(owner, "__name__", "")
    else:
        name = getattr(v, "__module__", None) or ""
    return name.split(".")[0] in _FIXED_PACKAGES


class _Key:
    """The plan cache's key of what a function reaches. `tensors` are the
    tensors it reaches, in the key's order. A function, module or class
    reached again (a module or class with the same names) is keyed by the
    place where it was first."""

    def __init__(self):
        self.tensors: list = []
        self._seen: Dict[tuple, int] = {}

    def _again(self, v, names=frozenset()):
        """("again", place) where `v` was keyed before, else None (and `v`
        takes the next place)."""
        k = (id(v), names)
        if k in self._seen:
            return ("again", self._seen[k])
        self._seen[k] = len(self._seen)
        return None

    def value(self, v, depth: int, names: frozenset):
        """What a trace can depend on in a value that code looking up
        `names` reaches: a Python scalar by value, a tensor by type, shape,
        dtype, strides and device (never its values; it is appended to
        `tensors`), a function by its own key, a module, class or builtin
        of _FIXED_PACKAGES by identity, any other module or class by the
        attributes among `names` that it has. Anything else (an object
        whose attributes the function may read, a bound method) raises
        _Uncacheable."""
        if isinstance(v, _SCALARS) or isinstance(v, (torch.dtype,
                                                     torch.device)):
            return (type(v), v)
        if isinstance(v, torch.Tensor):
            self.tensors.append(v)
            return (type(v), tuple(v.shape), v.dtype, v.stride(), v.device)
        if isinstance(v, (tuple, list)):
            return (type(v), tuple(self.value(x, depth, names) for x in v))
        if isinstance(v, types.FunctionType):
            return self.function(v, depth + 1)
        if isinstance(v, (types.ModuleType, type,
                          types.BuiltinFunctionType)) and _fixed(v):
            return ("fixed", v)
        if isinstance(v, types.ModuleType) or type(v) is type:
            return self._attributes(v, depth + 1, names)
        raise _Uncacheable(type(v).__name__)

    def _attributes(self, v, depth: int, names: frozenset) -> tuple:
        """A module or a class outside _FIXED_PACKAGES, by the attributes
        among `names` that it has (a class's as its own dict and its
        bases' hold them)."""
        if depth > _MAX_DEPTH:
            raise _Uncacheable("too deep")
        again = self._again(v, names)
        if again is not None:
            return again
        found = []
        for name in sorted(names):
            if isinstance(v, types.ModuleType):
                a = v.__dict__.get(name, _MISSING)
                if a is _MISSING and "__getattr__" in v.__dict__:
                    raise _Uncacheable("a module's __getattr__")
            else:
                a = inspect.getattr_static(v, name, _MISSING)
                if isinstance(a, staticmethod):
                    a = a.__func__
                elif isinstance(a, property):
                    a = (a.fget, a.fset, a.fdel)
                elif isinstance(a, _C_DESCRIPTORS):
                    found.append((name, ("fixed", a)))
                    continue
            if a is not _MISSING:
                found.append((name, self.value(a, depth, names)))
        return ("attributes", v, tuple(found))

    def function(self, fn, depth: int = 0) -> tuple:
        """A plain function's key: its code, its defaults' values, its
        closure cells' and the globals its code names."""
        if not isinstance(fn, types.FunctionType) or depth > _MAX_DEPTH:
            raise _Uncacheable("no plain function")
        again = self._again(fn)
        if again is not None:
            return again
        code = fn.__code__
        names = _names(code)
        if names & _VALUE_READS:
            raise _Uncacheable("reads values in Python")
        try:
            cells = tuple(self.value(c.cell_contents, depth, names)
                          for c in fn.__closure__ or ())
        except ValueError:      # an empty cell
            raise _Uncacheable("an empty cell") from None
        g = fn.__globals__
        return (code, self.value(fn.__defaults__, depth, names),
                self.value(sorted((fn.__kwdefaults__ or {}).items()),
                           depth, names),
                cells,
                tuple((name, self.value(g[name], depth, names))
                      for name in sorted(names) if name in g))


def _elem_key(t: torch.Tensor) -> tuple:
    """What a trace sees of a batched tensor: one element's shape, dtype,
    strides and device (not the batch's size)."""
    e = t[0]
    return (tuple(e.shape), e.dtype, e.stride(), e.device)


def _trace(products_fn, p0_batch, data_elem):
    """A fresh trace and generation: the kernel, or the error a trace
    raises."""
    global trace_count, trace_seconds
    trace_count += 1
    t0 = time.perf_counter()
    try:
        adapted = adapt_products(products_fn, p0_batch[0], data_elem)
        return GeneratedKernel(adapted, generate_source(adapted,
                                                        p0_batch.dtype))
    except Exception as e:      # the plan's answer: None, or the raise
        return e
    finally:
        trace_seconds += time.perf_counter() - t0


def _planned(products_fn, p0_batch, problem_data, data_elem):
    """(kernel or error, constants) of a products function, from the plan
    cache where its key shows that a fresh trace would give the same graph
    and source, else from a fresh trace. The key: the function (_Key), one
    element's shape, dtype, strides and device of p0 and of every data
    leaf, and the data's tree. The constants are the tensors the call's
    function closes over, and the returned kernel's `adapted.consts`; a
    constant a trace made itself (not one the key holds) makes the entry
    uncacheable, as it could hold values.

    An entry holds no tensor of the call that made it: a cached kernel's
    constants are meta tensors of their shapes, and a refusal is kept as
    the exception's type and arguments, raised anew each call."""
    keyer = _Key()
    try:
        leaves, spec = (([], None) if problem_data is None
                        else pytree.tree_flatten(problem_data))
        key = (keyer.function(products_fn), _elem_key(p0_batch),
               tuple(_elem_key(t) for t in leaves), str(spec))
    except _Uncacheable:
        key = None
    tensors = keyer.tensors
    if key is not None:
        with _PLANS_LOCK:
            hit = _PLANS.get(key)
        if hit is not None:
            kernel, index = hit
            if not isinstance(kernel, GeneratedKernel):
                kind, args = kernel
                return kind(*args), ()
            return kernel.on(tuple(tensors[j] for j in index))
    kernel = _trace(products_fn, p0_batch, data_elem)
    if isinstance(kernel, Exception):
        consts: tuple = ()
        entry: Any = (type(kernel), kernel.args)
        try:        # cached only where it can be raised anew
            entry[0](*entry[1])
            index: Optional[tuple] = ()
        except Exception:
            index = None
    else:
        consts = kernel.adapted.consts
        at: Dict[int, List[int]] = {}
        for j, t in enumerate(tensors):
            at.setdefault(id(t), []).append(j)
        # each constant one tensor of the key, at one place in it
        index = tuple(at[id(c)][0] if len(at.get(id(c), ())) == 1
                      else None for c in consts)
        if None in index:
            index = None
        entry = kernel
    if key is not None and index is not None:
        if entry is kernel:
            entry = kernel.on(tuple(torch.empty_like(c, device="meta")
                                    for c in consts))[0]
        with _PLANS_LOCK:
            if len(_PLANS) >= PLAN_CACHE_SIZE:
                _PLANS.pop(next(iter(_PLANS)))
            _PLANS[key] = (entry, index)
    return kernel, consts


def plan_megakernel(products_fn, p0_batch,
                    parameters: Optional[DoglegParameters], *,
                    problem_data: Any = None,
                    forced: bool = False,
                    global_batch: Optional[int] = None
                    ) -> Optional[MegaPlan]:
    """A plan that runs this batched solve on kernel K1, or None where the
    solve is outside the kernel's regime (the counterpart of the JAX
    package's plan_megakernel, mega_auto.py:390-490).

    None where the start is not one (B, n) tensor, n > MEGA_MAX_N, and,
    unless forced: the dtype is not float32, B < AUTO_MEGA_MIN_BATCH, the
    tensors lie on the CPU, or the adapter or the code generator refuses
    the function (a forced call re-raises their error). Nothing is built
    here. The trace and the generated source are cached (the plan cache,
    _planned): a later call with the same function, shapes and closed-over
    scalars traces nothing (trace_count) and reads the tensors the call's
    function closes over, whatever their values; the library is found by
    the hash of the generated source.

    The plan's call builds the kernel and launches it, and raises on an
    nvcc or launch error whatever `forced` says: there is no compile probe
    and no fallback once a plan exists (the JAX package falls back to its
    XLA path on any fault, which would hide the kernel). On CPU tensors a
    forced plan runs the kernel's plain version: the masked batched solver
    on the vmapped graph (ops/mega.megakernel_optimize_generated).

    Under a mesh p0_batch and problem_data are the rank's blocks and the
    kernel runs on them; B < AUTO_MEGA_MIN_BATCH reads global_batch, the
    whole batch, as the JAX package's threshold does. The plan cache's key
    does not see the batch: a mesh changes which block is passed, not the
    generated source."""
    if not isinstance(p0_batch, torch.Tensor) or p0_batch.dim() != 2:
        return None
    B, n = p0_batch.shape
    if n > MEGA_MAX_N or n < 1:
        return None
    if p0_batch.dtype not in (torch.float32, torch.float64):
        return None
    if not forced and (p0_batch.dtype != torch.float32
                       or (global_batch or B) < AUTO_MEGA_MIN_BATCH
                       or p0_batch.device.type == "cpu"):
        return None
    if problem_data is None:
        leaves = []
    else:
        leaves = pytree.tree_leaves(problem_data)
        if not all(isinstance(t, torch.Tensor) and t.dim() >= 1
                   and t.shape[0] == B for t in leaves):
            if forced:
                raise ValueError("problem_data's leaves must be tensors "
                                 "with the batch's leading axis")
            return None
    prm = parameters if parameters is not None else DoglegParameters()
    with span("dogleg.plan"):
        data_elem = (None if problem_data is None
                     else pytree.tree_map(lambda a: a[0], problem_data))
        kernel, consts = _planned(products_fn, p0_batch, problem_data,
                                  data_elem)
    if isinstance(kernel, Exception):
        if forced:
            raise kernel
        return None
    return MegaPlan(kernel, p0_batch, tuple(leaves), prm, consts)


def _env_disabled() -> bool:
    return os.environ.get("LIBDOGLEG_TPU_NO_MEGAKERNEL", "") not in ("", "0")
