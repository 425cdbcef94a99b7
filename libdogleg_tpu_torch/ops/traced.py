"""Tensor control flow that torch.export captures (the counterpart of JAX's
lax.while_loop and lax.cond in the JAX package's export path).

`while_loop(cond, body, carry)` and `cond(pred, true_fn, false_fn,
operands)` take and return pytrees of tensors. Called eagerly they run the
same functions as a Python loop and a Python branch (torch's own dense
implementations), so the traced form of a solve can be run and checked
without tracing it. Under torch.export (or any make_fx trace) they become
the higher-order operators while_loop and cond, with their bodies traced
once as subgraphs.

Two things make a body exportable here that torch's public wrappers, which
trace the body with dynamo, would not:
* The body is traced by make_fx, so it may run any Python that does not
  read a tensor's value (numpy index arrays, dataclasses, ctypes queries
  of the card).
* A real tensor that a body closes over (a problem's data held in a
  products graph, a cached index array) would be a constant of the
  subgraph, which torch.export.save refuses. Each such constant becomes an
  extra input of the loop or the branch instead (`_hoist`), and so a
  constant of the exported program, lifted like any other.

`is_traced(t)` tells a kernel's wrapper that it is being traced, so that it
reaches its kernel through its custom operator (a node of the graph) rather
than through a direct launch, which needs a data pointer.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def _tracer_active() -> bool:
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    return get_proxy_mode() is not None


def is_traced(t: torch.Tensor) -> bool:
    """Whether `t` is being traced: a fake tensor (torch.export), or any
    tensor while make_fx records (torch.export's own trace, or make_fx with
    real tensors, whose ops run but must also land in the graph)."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t) or _tracer_active()


def real_constant(make):
    """make() evaluated outside every dispatch mode: a real tensor even while
    torch.export traces with fake tensors, so that a cache may keep it and
    the trace takes it as a constant."""
    from torch.utils._python_dispatch import _disable_current_modes
    if not _tracer_active():
        return make()
    with _disable_current_modes():
        return make()


def _fresh(outs, ins) -> tuple:
    """The outputs, contiguous, with every tensor that is also an input, or
    an earlier output, cloned: a loop body or a branch may not return its
    inputs, and its outputs' strides must be those of its (contiguous)
    inputs or of the other branch's."""
    seen = {id(t) for t in ins}
    res = []
    for o in outs:
        if isinstance(o, torch.Tensor):
            o = o.clone() if id(o) in seen else o.contiguous()
            seen.add(id(o))
        res.append(o)
    return tuple(res)


def _hoist(graphs) -> list:
    """Turn the real tensor constants of `graphs` (subgraphs of one loop or
    branch) into placeholders appended after their inputs, the same list
    for every graph; returns the tensors, to be passed as extra inputs."""
    consts, index = [], {}
    for gm in graphs:
        for node in gm.graph.nodes:
            val = (getattr(gm, node.target) if node.op == "get_attr"
                   else None)
            if isinstance(val, torch.Tensor) and id(val) not in index:
                index[id(val)] = len(consts)
                consts.append(val)
    for gm in graphs:
        g = gm.graph
        anchor = [n for n in g.nodes if n.op == "placeholder"][-1]
        new = []
        for k in range(len(consts)):
            with g.inserting_after(anchor):
                anchor = g.placeholder(f"constant_{k}")
            new.append(anchor)
        for node in list(g.nodes):
            if node.op == "get_attr":
                val = getattr(gm, node.target)
                if isinstance(val, torch.Tensor):
                    node.replace_all_uses_with(new[index[id(val)]])
                    g.erase_node(node)
        gm.recompile()
    return consts


_TENSOR = object()


class _Leaves:
    """A pytree's leaves split into its tensors, which the operators carry,
    and everything else (None fields), which stays where it is."""

    def __init__(self, tree):
        leaves, self.spec = pytree.tree_flatten(tree)
        self.static = [_TENSOR if isinstance(x, torch.Tensor) else x
                       for x in leaves]
        self.tensors = [x for x in leaves if isinstance(x, torch.Tensor)]

    def tensors_of(self, tree) -> list:
        return [x for x in pytree.tree_leaves(tree)
                if isinstance(x, torch.Tensor)]

    def rebuild(self, tensors):
        it = iter(tensors)
        return pytree.tree_unflatten(
            [next(it) if x is _TENSOR else x for x in self.static], self.spec)


def materialized(t):
    """t, or real zeros in place of an efficient zero tensor (forward-mode
    AD makes those for a Jacobian block that is zero), which the loop and
    branch operators have no kernel for."""
    if not isinstance(t, torch.Tensor) or not torch._is_zerotensor(t):
        return t
    return real_constant(lambda: torch.zeros(t.shape, dtype=t.dtype,
                                             device=t.device))


def _subgraphs(fns, flat):
    from torch._higher_order_ops.utils import reenter_make_fx
    graphs = [reenter_make_fx(fn)(*flat) for fn in fns]
    return graphs, tuple(materialized(t) for t in _hoist(graphs))


def while_loop(cond_fn, body_fn, carry):
    """while cond_fn(*carry): carry = body_fn(*carry); returns carry.
    carry is a tuple of pytrees of tensors whose shapes and dtypes the
    body keeps; cond_fn returns a 0-d bool tensor."""
    from torch._higher_order_ops.while_loop import while_loop_op
    leaves = _Leaves(tuple(carry))
    # a tensor carried in two places (three fields made from one zeros)
    # becomes two: the loop's inputs may not alias each other
    flat = list(_fresh(leaves.tensors, ()))
    n = len(flat)

    def flat_cond(*args):
        return cond_fn(*leaves.rebuild(args[:n]))

    def flat_body(*args):
        out = body_fn(*leaves.rebuild(args[:n]))
        return _fresh(leaves.tensors_of(tuple(out)), args)

    if _tracer_active():
        (c, b), consts = _subgraphs((flat_cond, flat_body), flat)
        out = while_loop_op(c, b, tuple(flat), consts)
    else:
        out = while_loop_op(flat_cond, flat_body, tuple(flat), ())
    return leaves.rebuild(out)


def cond(pred, true_fn, false_fn, operands):
    """true_fn(*operands) if pred else false_fn(*operands), pred a 0-d bool
    tensor. Both branches return pytrees of one structure, shapes and
    dtypes, and neither may return an operand as it is (clone it)."""
    from torch._higher_order_ops.cond import cond_op
    leaves = _Leaves(tuple(operands))
    flat = list(_fresh(leaves.tensors, ()))
    n = len(flat)
    out_leaves = []

    def branch(fn):
        def flat_fn(*args):
            out = _Leaves(fn(*leaves.rebuild(args[:n])))
            out_leaves[:] = [out]
            return _fresh(out.tensors, args)
        return flat_fn

    if _tracer_active():
        (t, f), consts = _subgraphs((branch(true_fn), branch(false_fn)), flat)
        out = cond_op(pred, t, f, tuple(flat) + consts)
    else:
        out = cond_op(pred, branch(true_fn), branch(false_fn), tuple(flat))
    return out_leaves[0].rebuild(out)
