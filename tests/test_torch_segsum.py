"""Sums in a fixed order on the sparse path (ops/segsum.py): each entry
point against index_add_ on the CPU, where index_add_ adds in index order,
in float64 (bit for bit, so within 1e-12), and the same bits on a second
run; the plans of a schedule's levels against plans of their own; the
block-sparse factorization, its substitutions and the block-CSR products
against index_add_."""

import numpy as np
import pytest
import torch

from libdogleg_tpu_torch import SparseNewtonSolver
from libdogleg_tpu_torch import sparse_cholesky as sc
from libdogleg_tpu_torch import supernodal as sn
from libdogleg_tpu_torch.models import grid_mrf
from libdogleg_tpu_torch.ops import bcsr, segsum

ENTRIES = ("add_", "add", "reference")


def _add(entry, base, dim, plan, terms, alpha=1):
    if entry == "add_":
        return segsum.add_(base, dim, plan, terms, alpha=alpha)
    if entry == "add":
        # out of place, alpha 1: a negated term is exact
        return segsum.add(base, dim, plan, terms * alpha)
    return segsum.reference(base, dim, plan, terms, alpha=alpha)


@pytest.fixture
def index_add():
    """segsum's two entry points as index_add_ on the plan's targets: the
    form before the fixed order, for the whole-solve comparisons."""
    shipped = segsum.add_, segsum.add

    def add_(base, dim, plan, terms, *, alpha=1):
        return base.index_add_(dim, torch.as_tensor(plan.targets), terms,
                               alpha=alpha)

    def add(base, dim, plan, terms):
        return base.index_add(dim, torch.as_tensor(plan.targets), terms)
    segsum.add_, segsum.add = add_, add
    yield
    segsum.add_, segsum.add = shipped


def _case(seed, n_targets, n_terms, shape, dim):
    rng = np.random.default_rng(seed)
    # a skewed draw: some targets take many terms, some none
    targets = np.minimum(rng.geometric(0.3, n_terms) - 1, n_targets - 1)
    rng.shuffle(targets)
    base_shape = list(shape)
    base_shape.insert(dim, n_targets)
    term_shape = list(shape)
    term_shape.insert(dim, n_terms)
    base = torch.as_tensor(rng.normal(size=base_shape))
    terms = torch.as_tensor(rng.normal(size=term_shape) * 1e3)
    return targets, base, terms


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("dim,shape", [(0, ()), (0, (3,)), (1, (2, 4, 4)),
                                       (1, (5,))])
@pytest.mark.parametrize("alpha", [1, -1])
def test_add_is_index_add_bit_for_bit(entry, dim, shape, alpha):
    targets, base, terms = _case(0, 17, 200, shape, dim)
    plan = segsum.AddPlan(targets)
    want = base.clone().index_add_(dim, torch.as_tensor(targets), terms,
                                   alpha=alpha)
    got = _add(entry, base.clone(), dim, plan, terms, alpha)
    again = _add(entry, base.clone(), dim, plan, terms, alpha)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("entry", ENTRIES)
def test_level_plans_add_as_plans_of_their_own(entry):
    """A schedule's levels, planned in one pass, each add as a plan of its
    own targets does, and as index_add_, an empty level included."""
    rng = np.random.default_rng(1)
    sizes = [60, 0, 1, 35, 90]
    targets = np.concatenate([rng.integers(0, 9, k) for k in sizes])
    off = np.r_[0, np.cumsum(sizes)]
    plans = segsum.level_plans(targets, off)
    assert len(plans) == len(sizes)
    base = torch.as_tensor(rng.normal(size=(9, 2)))
    for k, plan in enumerate(plans):
        own = segsum.AddPlan(targets[off[k]:off[k + 1]])
        assert plan.n == own.n == sizes[k]
        assert plan.rounds == own.rounds
        np.testing.assert_array_equal(plan.uniq, own.uniq)
        terms = torch.as_tensor(rng.normal(size=(sizes[k], 2)))
        got = _add(entry, base.clone(), 0, plan, terms)
        assert torch.equal(got, _add(entry, base.clone(), 0, own, terms))
        assert torch.equal(got, base.clone().index_add_(
            0, torch.as_tensor(own.targets), terms))


def test_plan_rounds_have_distinct_targets():
    targets, _, _ = _case(2, 13, 150, (), 0)
    plan = segsum.AddPlan(targets)
    rounds = [(np.arange(p[0], p[0] + p[1]) if isinstance(p, tuple)
               else p.numpy(), t.numpy())
              for p, t in plan.rounds_on(torch.device("cpu"))]
    assert len(rounds) == plan.rounds == int(np.bincount(targets).max())
    pos = np.concatenate([p for p, _ in rounds])
    assert sorted(pos.tolist()) == list(range(len(targets)))
    for p, t in rounds:
        assert len(np.unique(t)) == len(t)
        np.testing.assert_array_equal(targets[p], t)
    # every target's terms keep their index order across the rounds
    for t in np.unique(targets):
        assert np.all(np.diff(pos[targets[pos] == t]) > 0)


def test_a_round_over_a_range_of_terms_takes_them_as_they_are():
    """Where a round's terms are a range (a level whose targets are
    distinct, or a first round before any repeat), the plain version
    narrows the terms in place of gathering them."""
    plan = segsum.AddPlan([4, 0, 2, 5, 5])
    rounds = plan.rounds_on(torch.device("cpu"))
    assert rounds[0][0] == (0, 4) and rounds[1][0] == (4, 1)
    np.testing.assert_array_equal(rounds[0][1].numpy(), [4, 0, 2, 5])
    plan = segsum.AddPlan([3, 3, 0])
    rounds = plan.rounds_on(torch.device("cpu"))
    assert torch.equal(rounds[0][0], torch.tensor([0, 2]))
    assert rounds[1][0] == (1, 1)


@pytest.mark.parametrize("level", [None, 0, 2])
def test_out_of_place_add_under_vmap(level):
    """The block-CSR products' form: out of place, batched by vmap; a plan
    of its own or a schedule's level."""
    targets, base, terms = _case(3, 11, 90, (3,), 0)
    if level is None:
        plan = segsum.AddPlan(targets)
    else:
        lead = np.random.default_rng(level).integers(0, 11, 7 * level)
        plan = segsum.level_plans(np.r_[lead, targets, lead],
                                  [0, lead.size, lead.size + 90,
                                   2 * lead.size + 90])[1]
    tb = torch.stack([terms, 2 * terms, -terms])
    idx = torch.as_tensor(targets)
    want = torch.func.vmap(lambda t: base.index_add(0, idx, t))(tb)
    got = torch.func.vmap(lambda t: segsum.add(base, 0, plan, t))(tb)
    assert torch.equal(got, want)


def _grid(amalgamate):
    g = grid_mrf.make_grid_mrf(8, 8, 4, dtype=torch.float64, device="cpu")
    sched = bcsr.jtj_lower_schedule(g.structure)
    x, J = g.problem().jacobian(torch.linspace(-1, 1, g.nstate,
                                               dtype=torch.float64))
    ns = SparseNewtonSolver.analyze(sched.rows, sched.cols,
                                    g.structure.nbcol, 4,
                                    amalgamate=amalgamate)
    return g, sched, x, J, ns


def _factor_and_solve(ns, blocks, rhs):
    be = ns._backend()
    L, ok = be.factorize(ns.symbolic, blocks, torch.tensor([1e-3, 1e-2]))
    return L, ok, be.solve(ns.symbolic, L, rhs)


@pytest.mark.parametrize("amalgamate", [1, 4])
def test_sparse_factor_and_solve_same_as_index_add(request, amalgamate):
    """The factorization (UPDATE) and both substitutions (pair steps) on
    a batch of two against index_add_: the same bits in float64 on the
    CPU, and on a second run."""
    g, sched, x, J, ns = _grid(amalgamate)
    blocks = bcsr.bcsr_jtj_lower_blocks(J, sched)
    blocks = torch.stack([blocks, blocks * 1.5])
    rhs = torch.stack([bcsr.bcsr_jt_x(J, x), -bcsr.bcsr_jt_x(J, x)])
    got = _factor_and_solve(ns, blocks, rhs)
    for a, b in zip(got, _factor_and_solve(ns, blocks, rhs)):
        assert torch.equal(a, b)
    request.getfixturevalue("index_add")
    want = _factor_and_solve(ns, blocks, rhs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=1e-12, atol=0)
    assert bool(got[1].all())


def test_cuda_tensors_take_the_kernel_only(monkeypatch):
    """add_ and add hand every tensor that is not on the CPU to the
    kernel, which takes CUDA tensors only: it raises, it does not fall
    back to the plain version."""
    targets, base, terms = _case(4, 5, 20, (2,), 0)
    plan = segsum.AddPlan(targets)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segsum.add_(base.to("meta"), 0, plan, terms.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        segsum._kernel(base, 0, plan, terms, 1)
    calls = []
    monkeypatch.setattr(segsum, "_kernel",
                        lambda *a, **k: calls.append(a[0].device))
    segsum.add(base.to("meta"), 0, plan, terms.to("meta"))
    segsum.add(base, 0, plan, terms)
    assert calls == [torch.device("meta")]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("fault", ["terms", "target"])
def test_a_plan_that_does_not_fit_raises(entry, fault):
    """A plan whose term count differs from the terms', or whose targets
    reach past base, raises before anything is added (the kernel would
    read and write out of bounds)."""
    targets, base, terms = _case(6, 7, 30, (2,), 0)
    if fault == "terms":
        terms = terms[:-1]
        match = "terms"
    else:
        base = base[:int(targets.max())]
        match = "past base"
    before = base.clone()
    with pytest.raises(ValueError, match=match):
        _add(entry, base, 0, segsum.AddPlan(targets), terms)
    assert torch.equal(base, before)


def test_plan_kernel_operands_are_the_runs():
    """run_ptr and term_pos list each target's terms in index order, for
    a plan of its own and for a schedule's levels, whose kernel operands
    are views of one copy."""
    targets, _, _ = _case(5, 7, 60, (), 0)
    plans = [segsum.AddPlan(targets)] + segsum.level_plans(
        np.r_[targets, targets[::-1]], [0, 60, 120])
    for plan, want in zip(plans, (targets, targets, targets[::-1])):
        for r, t in enumerate(plan.uniq):
            pos = plan.term_pos[plan.run_ptr[r]:plan.run_ptr[r + 1]]
            np.testing.assert_array_equal(pos, np.flatnonzero(want == t))
        assert plan.top == int(want.max())
    cpu = torch.device("cpu")
    ptrs = {t.untyped_storage().data_ptr()
            for p in plans[1:] for t in p.kernel_operands(cpu)}
    assert len(ptrs) == 1
    assert all(t.dtype == torch.int32 for t in plans[1].kernel_operands(cpu))


def test_update_levels_repeat_targets():
    """The simplicial grid's UPDATE levels do put several terms on one
    block, so the order matters there; the plans are built once."""
    _, _, _, _, ns = _grid(1)
    plans = sc._level_plans(ns.symbolic, "sched", "upd_tgt", "upd_off")
    assert max(p.rounds for p in plans) > 1
    assert sum(p.n for p in plans) == len(ns.symbolic.sched.upd_tgt)
    assert sc._level_plans(ns.symbolic, "sched", "upd_tgt",
                           "upd_off") is plans


def test_supernodal_assembly_targets_are_distinct():
    """supernodal._super_blocks adds each input entry, each mirrored entry
    and each unit diagonal into a zeroed tensor with index_add_: its
    targets never repeat, so no two adds meet on one address."""
    _, _, _, _, ns = _grid(4)
    sym = ns.symbolic
    allidx = np.concatenate([sym.scatter_idx, sym.mirror_idx, sym.ones_idx])
    assert len(np.unique(allidx)) == len(allidx)
    assert isinstance(sym, sn.AmalgamatedSymbolic)


def _jtj_dense_index_put(J):
    """bcsr_jtj_dense as it was before its sums took the plan's order:
    index_put_'s accumulation of the pair products into their blocks."""
    s, v = J.structure, J.values
    pi, pj = s.jtj_pairs()
    contrib = v[torch.as_tensor(pi).long()].mT @ v[torch.as_tensor(pj).long()]
    out = torch.zeros((s.nbcol, s.nbcol, s.block_cols, s.block_cols),
                      dtype=v.dtype)
    out.index_put_((torch.as_tensor(s.indices[pi]).long(),
                    torch.as_tensor(s.indices[pj]).long()), contrib,
                   accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(s.nstate, s.nstate)


@pytest.mark.parametrize("case", ["float64", "float32", "vmap"])
def test_bcsr_products_same_as_index_add(request, case):
    """J^T x, J v and the dense J^T J in the plan's order give index_add_'s
    bits, and the dense J^T J index_put_'s (its form before): in float64,
    float32 and under vmap (each element against its own)."""
    g, sched, x, J, ns = _grid(1)
    dtype = torch.float32 if case == "float32" else torch.float64
    J = bcsr.BCSRJacobian(J.structure, J.values.to(dtype))
    x = x.to(dtype)
    p = torch.linspace(0, 1, g.nstate, dtype=dtype)
    vs = torch.stack([J.values, 2 * J.values, -J.values])

    def products():
        if case == "vmap":
            xs, ps = torch.stack([x, -x]), torch.stack([p, 2 * p])
            return (torch.func.vmap(lambda v: bcsr.bcsr_jt_x(J, v))(xs),
                    torch.func.vmap(lambda v: bcsr.bcsr_matvec(J, v))(ps),
                    torch.func.vmap(lambda v: bcsr.bcsr_jtj_dense(
                        bcsr.BCSRJacobian(J.structure, v)))(vs))
        return (bcsr.bcsr_jt_x(J, x), bcsr.bcsr_matvec(J, p),
                bcsr.bcsr_jtj_dense(J))
    got = products()
    if case == "vmap":
        want = torch.stack([_jtj_dense_index_put(
            bcsr.BCSRJacobian(J.structure, v)) for v in vs])
    else:
        want = _jtj_dense_index_put(J)
    assert torch.equal(got[2], want)
    request.getfixturevalue("index_add")
    for a, b in zip(got, products()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("level", [None, 1])
@pytest.mark.parametrize("dim,shape", [(0, ()), (1, (2, 4, 4)),
                                       (2, (2, 3, 5))])
def test_launch_record_is_the_plans_arguments(monkeypatch, level, dim,
                                              shape):
    """The launch record a plan keeps for a direct launch holds the kernel's
    operands and arguments as numpy gives them from the targets: the
    distinct targets, each one's terms in index order, the runs' count and
    base's and terms' sizes around dim; the same call finds it again, and
    another shape, dtype, device or sign makes another."""
    import ctypes
    import math
    monkeypatch.setattr(segsum, "_planned_entry", lambda: "the entry")
    tgts, base, terms = _case(7, 11, 80, shape, dim)
    if level is None:
        plan = segsum.AddPlan(tgts)
    else:
        lead = np.random.default_rng(8).integers(0, 11, 30)
        plan = segsum.level_plans(np.r_[lead, tgts], [0, 30, 110])[1]
    rec = segsum._launch_record(plan, base, dim, terms, -1)
    uniq, counts = np.unique(tgts, return_counts=True)
    u, rp, tp = (t.numpy() for t in rec.operands)
    np.testing.assert_array_equal(u, uniq)
    np.testing.assert_array_equal(np.diff(rp), counts)
    for r, t in enumerate(uniq):
        np.testing.assert_array_equal(tp[rp[r]:rp[r + 1]],
                                      np.flatnonzero(tgts == t))
    r = rec.record
    assert rec.entry == "the entry"
    assert rec.address == ctypes.addressof(r)
    assert (r.uniq, r.run_ptr, r.term_pos) == tuple(
        t.data_ptr() for t in rec.operands)
    assert (r.n_runs, r.outer, r.nbase, r.nterm, r.inner, r.negate,
            r.device, r.elem_bytes) == (len(uniq), math.prod(shape[:dim]),
                                        11, 80, math.prod(shape[dim:]), 1,
                                        0, 8)
    assert segsum._launch_record(plan, base, dim, terms, -1) is rec
    longer = torch.cat([base, base.narrow(dim, 0, 1)], dim)
    for b, t, alpha in ((longer, terms, -1),
                        (base.float(), terms.float(), -1),
                        (base.to("meta"), terms.to("meta"), -1),
                        (base, terms, 1)):
        other = segsum._launch_record(plan, b, dim, t, alpha)
        assert other is not rec
        assert (other.record.nbase, other.record.negate,
                other.record.elem_bytes) == (
            b.shape[dim], int(alpha == -1), t.element_size())
    assert len(plan._launches) == 5


def test_launch_record_of_a_plan_without_terms_adds_nothing(monkeypatch):
    """A level without terms keeps a record without an entry point; the
    direct launch then returns base as it is."""
    monkeypatch.setattr(segsum, "_planned_entry", lambda: "the entry")
    plan = segsum.level_plans(np.array([2, 0, 1]), [0, 3, 3])[1]
    base, terms = torch.zeros(4, 2), torch.zeros(0, 2)
    rec = segsum._launch_record(plan, base, 0, terms, 1)
    assert rec.entry is None and plan.n == 0
