"""Vector operations on solver states that are trees of tensors
(counterpart of libdogleg_tpu/ops/treevec.py).

A state (p, Jt_x, a step) is a tensor, or a dict, tuple or list of tensors:
{"c": cameras, "q": points} for bundle adjustment. Dict leaves are visited in
sorted key order, as jax.tree_util does, so tree_dot sums its leaves in the
JAX package's order. A bare tensor is one leaf, and on one the functions run
exactly the flat ops the solver ran before states became trees:
(a * b).sum(-1), (|v| > t).any(-1), a + b. None is an empty tree (a state
field that is not carried).

The batch_* functions are the batched form, for trees whose every leaf has
a leading batch axis of the same size B (the masked batched solver's
states, and NamedTuples such as SchurJtJ, Products or History): each leaf
is reduced over every axis except the leading one, and the leaves are
summed in visiting order, so no reduction crosses the batch axis. On a
bare (B, n) tensor they are the flat batched solver's ops as well.

A point-sharded state (parallel/points.py) holds only a rank's rows of its
point leaves. tree_dot, tree_dots and tree_any_exceeds then take its
PointShards: the sharded leaves' local parts are summed over the mesh axis
in one all_reduce and added to the replicated leaves' parts in visiting
order, so every rank gets the same bits. Without one they run exactly the
ops they ran before.
"""

from __future__ import annotations

import sys
from typing import Callable, List

import torch


def tree_leaves(t) -> List[torch.Tensor]:
    """The tensors of `t` in visiting order (dicts by sorted key)."""
    if isinstance(t, torch.Tensor):
        return [t]
    if t is None:
        return []
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in tree_leaves(t[k])]
    if isinstance(t, (tuple, list)):
        return [x for item in t for x in tree_leaves(item)]
    raise TypeError(f"not a tree of tensors: {type(t).__name__}")


def is_sharded(t) -> bool:
    """Whether any leaf of `t` is a DTensor (a point-sharded tree,
    parallel/points.py). None can exist before torch.distributed.tensor is
    imported, and this does not import it (a second's import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(x, mod.DTensor)
                                   for x in tree_leaves(t))


def tree_map(f: Callable, t, *rest):
    """f applied leaf by leaf to `t` and the trees in `rest`, which have
    t's structure; the result has that structure too."""
    if isinstance(t, torch.Tensor):
        return f(t, *rest)
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(f, t[k], *(r[k] for r in rest)) for k in t}
    if isinstance(t, (tuple, list)):
        items = [tree_map(f, *parts) for parts in zip(t, *rest)]
        if isinstance(t, list):
            return items
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
    raise TypeError(f"not a tree of tensors: {type(t).__name__}")


def _sharded_leaves(t, shards) -> List[bool]:
    """For each leaf of t in visiting order, whether it is sharded (it lies
    under a top-level key of shards.keys)."""
    if shards is None or not isinstance(t, dict):
        return [False] * len(tree_leaves(t))
    return [k in shards.keys for k in sorted(t) for _ in tree_leaves(t[k])]


def _sum_in_order(parts):
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def tree_dot(a, b, shards=None) -> torch.Tensor:
    """Inner product of two trees: the sum over leaves of sum(x * y).
    shards: the PointShards of a point-sharded state, or None."""
    if isinstance(a, torch.Tensor):
        return (a * b).sum(-1)
    return tree_dots([(a, b)], shards)[0]


def tree_dots(pairs, shards=None) -> List[torch.Tensor]:
    """tree_dot of each (a, b) of `pairs`, with one all_reduce for all of
    them where the trees are point-sharded."""
    parts = [[(x * y).sum() for x, y in zip(tree_leaves(a), tree_leaves(b))]
             for a, b in pairs]
    at = [(i, j) for i, (a, _) in enumerate(pairs)
          for j, s in enumerate(_sharded_leaves(a, shards)) if s]
    if at:
        for (i, j), v in zip(at, shards.sum([parts[i][j] for i, j in at])):
            parts[i][j] = v
    return [_sum_in_order(p) for p in parts]


def tree_scale(k, a):
    return tree_map(lambda x: k * x, a)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_where(pred, a, b):
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_any_exceeds(a, threshold: float, shards=None) -> torch.Tensor:
    """Whether any element of any leaf exceeds `threshold` in absolute
    value (a NaN exceeds nothing). shards: as tree_dot's; a sharded leaf's
    flags are counted over the axis, exactly."""
    if isinstance(a, torch.Tensor):
        return (a.abs() > threshold).any(-1)
    leaves = tree_leaves(a)
    flags = [(x.abs() > threshold).any() for x in leaves]
    at = [j for j, s in enumerate(_sharded_leaves(a, shards)) if s]
    if at:
        counts = shards.sum([flags[j].to(leaves[j].dtype) for j in at])
        for j, n in zip(at, counts):
            flags[j] = n > 0
    out = flags[0]
    for flag in flags[1:]:
        out = out | flag
    return out


# ---------------------------------------------------------------------------
# the batched form: every leaf (B, ...)
# ---------------------------------------------------------------------------


def _per_element(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor viewed to broadcast over x's trailing axes."""
    return m.view(m.shape + (1,) * (x.dim() - m.dim()))


def batch_dot(a, b) -> torch.Tensor:
    """(B,) inner products of two batched trees, element by element."""
    if isinstance(a, torch.Tensor):
        return (a * b).sum(-1)
    parts = [(x * y).reshape(x.shape[0], -1).sum(-1)
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def batch_scale(k: torch.Tensor, a):
    """Each element of the batched tree `a` times its own k (B,)."""
    return tree_map(lambda x: _per_element(k, x) * x, a)


def batch_where(mask: torch.Tensor, a, b):
    """torch.where with a (B,) mask broadcast over each leaf's trailing
    axes: element i of every leaf from a where mask[i], else from b."""
    return tree_map(lambda x, y: torch.where(_per_element(mask, x), x, y),
                    a, b)


def batch_any_exceeds(a, threshold: float) -> torch.Tensor:
    """(B,): whether any entry of an element, over all leaves, exceeds
    `threshold` in absolute value (a NaN exceeds nothing)."""
    if isinstance(a, torch.Tensor):
        return (a.abs() > threshold).any(-1)
    flags = [(x.abs() > threshold).reshape(x.shape[0], -1).any(-1)
             for x in tree_leaves(a)]
    out = flags[0]
    for flag in flags[1:]:
        out = out | flag
    return out
