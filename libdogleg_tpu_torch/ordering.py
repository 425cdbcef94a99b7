"""Fill-reducing orderings for the block-sparse Cholesky (counterpart of
libdogleg_tpu/ordering.py).

The reference leaves the ordering to CHOLMOD: cholmod_analyze picks a
fill-reducing permutation before the symbolic factorization (reference
dogleg.c:649-654). Without one, simplicial Cholesky can fill
catastrophically: an "arrow" matrix whose dense row comes first factors
completely full, while the reverse order has zero fill.

Host-side numpy and Python, run once per sparsity pattern, and identical in
output to the JAX package's functions. `mindeg_ordering` runs the minimum
degree in the host library (csrc/host/symbolic.cpp, native/symbolic.py)
where it is available, and its Python form, of the same tie-breaking,
otherwise.
"""

from __future__ import annotations

import collections
import heapq

import numpy as np


def _mindeg_python(rows: np.ndarray, cols: np.ndarray,
                   n: int) -> np.ndarray:
    """Exact minimum degree with a lazy heap: ties go to the smallest current
    degree, then the smallest vertex index."""
    adj = [set() for _ in range(n)]
    for i, j in zip(rows, cols):
        i, j = int(i), int(j)
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    heap = [(len(adj[v]), v) for v in range(n)]
    heapq.heapify(heap)
    eliminated = np.zeros(n, bool)
    perm = np.empty(n, np.int32)
    for k in range(n):
        v = -1
        while heap:
            d, u = heapq.heappop(heap)
            if not eliminated[u] and len(adj[u]) == d:
                v = u
                break
        if v < 0:
            v = int(np.flatnonzero(~eliminated)[0])
        perm[k] = v
        eliminated[v] = True
        nbrs = sorted(adj[v])
        for u in nbrs:
            adj[u].discard(v)
        for a in range(len(nbrs)):
            for c in range(a + 1, len(nbrs)):
                adj[nbrs[a]].add(nbrs[c])
                adj[nbrs[c]].add(nbrs[a])
        for u in nbrs:
            heapq.heappush(heap, (len(adj[u]), u))
        adj[v].clear()
    return perm


def mindeg_ordering(rows: np.ndarray, cols: np.ndarray,
                    n: int) -> np.ndarray:
    """Fill-reducing permutation for the symmetric pattern given by the
    stored (row, col) coordinate lists (either triangle; diagonal entries
    ignored). Returns perm with perm[k] = original index eliminated k-th."""
    from libdogleg_tpu_torch.native.symbolic import mindeg_native
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    perm = mindeg_native(rows, cols, n)
    return perm if perm is not None else _mindeg_python(rows, cols, n)


def _adjacency(rows, cols, n):
    adj = [[] for _ in range(n)]
    for i, j in zip(np.asarray(rows), np.asarray(cols)):
        i, j = int(i), int(j)
        if i != j:
            adj[i].append(j)
            adj[j].append(i)
    return adj


def rcm_ordering(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee, the bandwidth-minimizing companion of
    supernodal amalgamation (supernodal.py): consecutive columns stay
    adjacent in the graph, so grouped supernodes stay banded. BFS from a
    minimum-degree start node of each component, neighbors visited in
    degree order, the result reversed."""
    adj = _adjacency(rows, cols, n)
    deg = np.array([len(a) for a in adj])
    for a in adj:
        a.sort(key=lambda v: deg[v])
    visited = np.zeros(n, bool)
    order = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        queue = collections.deque([int(start)])
        visited[start] = True
        while queue:
            v = queue.popleft()
            order.append(v)
            for u in adj[v]:
                if not visited[u]:
                    visited[u] = True
                    queue.append(u)
    return np.asarray(order[::-1], np.int32)


def nd_ordering(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Nested dissection by recursive level-set bisection, which keeps the
    elimination tree shallow: the level-scheduled factorization pays per
    dependency level. Halves are eliminated first (recursively), the
    separator last: perm = [A..., B..., sep...]. Separators come from BFS
    level structures (pseudo-peripheral start, split at the cumulative-count
    median)."""
    adj = _adjacency(rows, cols, n)
    out = []

    def bfs_levels(start, members):
        level = {start: 0}
        q = collections.deque([start])
        order = [start]
        while q:
            v = q.popleft()
            for u in adj[v]:
                if u in members and u not in level:
                    level[u] = level[v] + 1
                    q.append(u)
                    order.append(u)
        return level, order

    def dissect(nodes):
        if len(nodes) <= 2:
            out.extend(sorted(nodes))
            return
        remaining = set(nodes)
        while remaining:
            seed = min(remaining)
            _, comp = bfs_levels(seed, remaining)
            comp_set = set(comp)
            remaining -= comp_set
            if len(comp) <= 2:
                out.extend(sorted(comp))
                continue
            # pseudo-peripheral restart from the farthest node
            lv, _ = bfs_levels(comp[-1], comp_set)
            nlv = max(lv.values()) + 1
            if nlv <= 2:
                # (near-)clique: no useful separator
                out.extend(sorted(comp))
                continue
            counts = np.zeros(nlv, np.int64)
            for v in comp:
                counts[lv[v]] += 1
            med = int(np.searchsorted(np.cumsum(counts), len(comp) // 2))
            med = min(max(med, 1), nlv - 2)
            dissect([v for v in comp if lv[v] < med])
            dissect([v for v in comp if lv[v] > med])
            out.extend(sorted(v for v in comp if lv[v] == med))

    dissect(list(range(n)))
    return np.asarray(out, np.int32)


def resolve_ordering(ordering, rows: np.ndarray, cols: np.ndarray,
                     n: int) -> np.ndarray:
    """Normalize an ordering spec ("mindeg"/"amd", "rcm", "nd", "natural",
    or an explicit permutation array) to perm (perm[k] = original index
    k-th in elimination order). None means the default fill-reducing
    choice, mindeg, not natural."""
    if ordering is None:
        ordering = "mindeg"
    if isinstance(ordering, str):
        if ordering == "natural":
            return np.arange(n, dtype=np.int32)
        if ordering in ("mindeg", "amd"):
            return mindeg_ordering(rows, cols, n)
        if ordering == "rcm":
            return rcm_ordering(rows, cols, n)
        if ordering == "nd":
            return nd_ordering(rows, cols, n)
        raise ValueError(f"unknown ordering {ordering!r}")
    perm = np.asarray(ordering, np.int32)
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError(
            f"explicit ordering must be a permutation of 0..{n - 1}; "
            f"got shape {perm.shape}")
    return perm
