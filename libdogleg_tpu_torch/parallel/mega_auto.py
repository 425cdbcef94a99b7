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
    graph: every value has a static shape and lives in a fixed-size local
    array (or is a strided view of one, of the state, of a problem's data or
    of a constant), each supported aten op becomes plain loops, and the
    arrays are reused once their values are dead. An op outside
    SUPPORTED_OPS, a dtype other than the state's, or arrays over
    MAX_LOCAL_VALUES raise UnsupportedProducts. The source includes
    csrc/dogleg_auto.cuh, which instantiates K1's solve (csrc/
    dogleg_solve.cuh) on the functor, and also compiles as host C++ (g++),
    which is how the CPU tests run the very text nvcc compiles.
  * `plan_megakernel` decides the regime statically, before anything is
    built, and returns a plan or None. A plan's call builds the source with
    nvcc (native/loader.build_generated: cached under _build/ by the hash of
    the source, the headers and the flags) and launches the kernel
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

import dataclasses
import math
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import Products, SolveResult

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
    every element equals."""
    shape: Tuple[int, ...]
    strides: Tuple[int, ...] = ()
    offset: int = 0
    base: Optional[str] = None
    buf: Optional[_Buf] = None
    literal: Optional[str] = None

    def at(self, idx: Sequence[str]) -> str:
        if self.literal is not None:
            return self.literal
        terms = [str(self.offset)] if self.offset else []
        for i, s in zip(idx, self.strides):
            if s:
                terms.append(i if s == 1 else f"{i} * {s}")
        return f"{self.base}[{' + '.join(terms) or '0'}]"

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


class _Gen:
    """One pass over the graph in order: a _Val per node, C++ lines per op
    with local arrays as tokens; then the arrays' live ranges decide which
    physical arrays they share."""

    def __init__(self, adapted: AdaptedProducts, dtype: torch.dtype):
        self.a, self.dtype = adapted, dtype
        self.vals: Dict[torch.fx.Node, _Val] = {}
        self.bufs: List[_Buf] = []
        self.lines: List[str] = []
        self.ops = 0
        self.i = 0           # index of the node being emitted
        self.loop_depth = 0

    # -- values and arrays --------------------------------------------------

    def new_buf(self, shape) -> _Val:
        b = _Buf(len(self.bufs), max(math.prod(shape), 1), self.i)
        self.bufs.append(b)
        return _Val(tuple(shape), _contiguous(shape), 0, b.token, b)

    def use(self, v: _Val) -> _Val:
        if v.buf is not None:
            v.buf.end = max(v.buf.end, self.i)
        return v

    def arg(self, x) -> _Val:
        if isinstance(x, torch.fx.Node):
            return self.use(self.vals[x])
        return _Val((), (), literal=_lit(x))

    def emit(self, line: str) -> None:
        self.lines.append("  " * (2 + self.loop_depth) + line)

    def loops(self, shape, body) -> None:
        """Nested loops i0, i1, ... over shape around body(idx), in a
        block of their own."""
        idx = [f"i{k}" for k in range(len(shape))]
        self.emit("{")
        self.loop_depth += 1
        for k, d in enumerate(shape):
            self.emit(f"for (int i{k} = 0; i{k} < {d}; ++i{k})")
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
        self.ops += math.prod(shape)

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
        self.ops += max(math.prod(out_shape), 1) * terms

        def body(idx):
            self.emit("  {")
            self.emit("    T s = T(0);")
            red = [f"j{k}" for k in range(len(inner))]
            for k, d in enumerate(inner):
                self.emit(f"    for (int j{k} = 0; j{k} < {d}; ++j{k})")
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
        shape = tuple(int(d) for d in val.shape)
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
            if name == "aten.squeeze.default":
                drop = {k for k in range(nd) if x.shape[k] == 1}
            else:
                dims = args[0] if isinstance(args[0], (list, tuple)) \
                    else [args[0]]
                drop = {k % nd for k in dims if x.shape[k % nd] == 1}
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
        a, n = self.a, self.a.nstate
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
            self.vals[ph] = _Val(shape, _contiguous(shape), 0, base)
        n_inputs = len(data_numel) + len(const_numel)
        if n_inputs > MAX_INPUTS:
            raise UnsupportedProducts(
                f"{n_inputs} inputs, more than the kernel's {MAX_INPUTS}")
        outs = None
        for self.i, nd in enumerate(nodes):
            if nd.op == "call_function":
                if nd.users:    # a value nothing reads costs nothing
                    self.vals[nd] = self.node(nd)
            elif nd.op == "output":
                outs = [self.arg(x) if isinstance(x, torch.fx.Node) else None
                        for x in nd.args[0]]
            elif nd.op != "placeholder":
                raise UnsupportedProducts(f"graph node {nd.op} {nd.target}")
        if outs is None or any(v is None for v in outs):
            raise UnsupportedProducts("the products are not all tensors")
        for v in outs:
            if v.buf is not None:
                v.buf.end = len(nodes)
        n2, jtx, jtj = outs
        self.i = len(nodes)
        body = list(self.lines)
        self.lines = []
        self.loop_depth = 0
        self.emit(f"out.norm2 = {n2.at(['0'] * len(n2.shape))};")
        self.emit(f"for (int a = 0; a < {n}; ++a) out.jtx[a] = "
                  f"{jtx.at(['a'])};")
        self.emit(f"for (int a = 0; a < {n}; ++a)")
        self.emit(f"  for (int c = 0; c <= a; ++c) out.jtj[pk(a, c)] = "
                  f"{jtj.at(['a', 'c'])};")
        body += self.lines
        decls, local_values = self.allocate()
        text = "\n".join(body)
        for b in self.bufs:
            text = text.replace(b.token, b.name)
        return GeneratedSource(
            text=self.source(decls, text, data_numel, const_numel),
            nstate=n, n_inputs=n_inputs, local_values=local_values,
            operations=self.ops, data_numel=tuple(data_numel),
            const_numel=tuple(const_numel))

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
        decls = [f"T {name}[{size}];" for name, size, _ in phys]
        return decls, sum(p[1] for p in phys)

    def source(self, decls, body, data_numel, const_numel) -> str:
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
            f"({', '.join(map(str, const_numel)) or 'none'} values).",
            "#include \"dogleg_auto.cuh\"",
            "",
            "namespace {",
            "",
            "template <typename T>",
            "struct AutoProducts {",
            f"  static constexpr int kInputs = "
            f"{len(data_numel) + len(const_numel)};",
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
            *("    " + d for d in decls),
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


def generate_source(adapted: AdaptedProducts,
                    dtype: torch.dtype) -> GeneratedSource:
    """The C++ source of K1 on a functor that computes `adapted`'s products.
    The text is the same for float32 and float64 (the functor is a template
    on the type) and holds both types' entry points; `dtype` is the type
    the graph was traced in, which every value must have. Raises
    UnsupportedProducts where an op, a type or the arrays' size is outside
    what it takes."""
    src = _Gen(adapted, dtype).run()
    if src.local_values > MAX_LOCAL_VALUES:
        raise UnsupportedProducts(
            f"the products need {src.local_values} local values a problem, "
            f"more than {MAX_LOCAL_VALUES}")
    return src


# ---------------------------------------------------------------------------
# Kernels and plans


class GeneratedKernel:
    """K1 on a generated functor: the source, the adapted products (its
    plain version) and, once built, the library. The library is built by
    native/loader.build_generated (nvcc) at the first launch, and found
    again by the hash of the source."""

    def __init__(self, adapted: AdaptedProducts, source: GeneratedSource):
        self.adapted, self.source = adapted, source
        self._consts: Dict[Tuple[torch.device, torch.dtype],
                           Tuple[torch.Tensor, ...]] = {}
        self._lock = threading.Lock()

    def library(self):
        """The nvcc build of the source, bound (loader.load_generated)."""
        from libdogleg_tpu_torch.native.loader import load_generated
        return load_generated(self.source.text)

    def consts_on(self, device, dtype) -> Tuple[torch.Tensor, ...]:
        """The shared constants on `device` in `dtype`, contiguous, made
        once per kernel."""
        key = (torch.device(device), dtype)
        with self._lock:
            if key not in self._consts:
                self._consts[key] = tuple(
                    c.to(device=device, dtype=dtype).contiguous()
                    for c in self.adapted.consts)
            return self._consts[key]


class MegaPlan:
    """A batched solve that kernel K1 takes: call it to run the solve."""

    def __init__(self, kernel: GeneratedKernel, p0: torch.Tensor,
                 data_leaves: Tuple[torch.Tensor, ...],
                 parameters: DoglegParameters):
        self.kernel, self.p0, self.data_leaves = kernel, p0, data_leaves
        self.parameters = parameters

    def __call__(self) -> SolveResult:
        from libdogleg_tpu_torch.ops.mega import megakernel_optimize_generated
        return megakernel_optimize_generated(self.kernel, self.p0,
                                             self.data_leaves,
                                             self.parameters)


def plan_megakernel(products_fn, p0_batch,
                    parameters: Optional[DoglegParameters], *,
                    problem_data: Any = None,
                    forced: bool = False) -> Optional[MegaPlan]:
    """A plan that runs this batched solve on kernel K1, or None where the
    solve is outside the kernel's regime (the counterpart of the JAX
    package's plan_megakernel, mega_auto.py:390-490).

    None where the start is not one (B, n) tensor, n > MEGA_MAX_N, and,
    unless forced: the dtype is not float32, B < AUTO_MEGA_MIN_BATCH, the
    tensors lie on the CPU, or the adapter or the code generator refuses
    the function (a forced call re-raises their error). Nothing is built
    here; the function is traced again on every call (the library is found
    by the hash of the generated source).

    The plan's call builds the kernel and launches it, and raises on an
    nvcc or launch error whatever `forced` says: there is no compile probe
    and no fallback once a plan exists (the JAX package falls back to its
    XLA path on any fault, which would hide the kernel). On CPU tensors a
    forced plan runs the kernel's plain version: the masked batched solver
    on the vmapped graph (ops/mega.megakernel_optimize_generated)."""
    if not isinstance(p0_batch, torch.Tensor) or p0_batch.dim() != 2:
        return None
    B, n = p0_batch.shape
    if n > MEGA_MAX_N or n < 1:
        return None
    if p0_batch.dtype not in (torch.float32, torch.float64):
        return None
    if not forced and (p0_batch.dtype != torch.float32
                       or B < AUTO_MEGA_MIN_BATCH
                       or p0_batch.device.type == "cpu"):
        return None
    if problem_data is None:
        leaves, data_elem = [], None
    else:
        leaves = pytree.tree_leaves(problem_data)
        if not all(isinstance(t, torch.Tensor) and t.dim() >= 1
                   and t.shape[0] == B for t in leaves):
            if forced:
                raise ValueError("problem_data's leaves must be tensors "
                                 "with the batch's leading axis")
            return None
        data_elem = pytree.tree_map(lambda a: a[0], problem_data)
    prm = parameters if parameters is not None else DoglegParameters()
    try:
        adapted = adapt_products(products_fn, p0_batch[0], data_elem)
        source = generate_source(adapted, p0_batch.dtype)
    except Exception:
        if forced:
            raise
        return None
    return MegaPlan(GeneratedKernel(adapted, source), p0_batch,
                    tuple(leaves), prm)


def _env_disabled() -> bool:
    return os.environ.get("LIBDOGLEG_TPU_NO_MEGAKERNEL", "") not in ("", "0")
