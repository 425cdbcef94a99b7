"""The port's host library of the symbolic analysis (csrc/host/*.cpp, built
with g++ by native/loader.build_host, bound in native/symbolic.py) against
its Python forms in the port and against the JAX package's native
library, array for array, and the four callers that take it first:
ordering.mindeg_ordering, sparse_cholesky.analyze,
sparsity.bcsr_from_scalar_csr and ops/bcsr_kernels.build_jtj_schedule.

Replays tests/test_native.py:51-104 and tests/test_sparse_cholesky.py:
119-162 on numpy-seeded patterns, and adds the 64x64x8 grid MRF's pattern
(config 6b) where tests/test_native.py:106 asserts a speed: the port's
tests hold outputs only, no timing.
"""

import functools

import numpy as np
import pytest
import torch

from libdogleg_tpu import ordering as jord
from libdogleg_tpu import sparse_cholesky as jsc
from libdogleg_tpu.native import native_available
from libdogleg_tpu.native import symbolic as jnat
from libdogleg_tpu.ops import bcsr as jbcsr
from libdogleg_tpu.ops import pallas_bcsr
from libdogleg_tpu.sparsity import bcsr_from_scalar_csr as j_from_csr
from libdogleg_tpu_torch import ordering as tord
from libdogleg_tpu_torch import sparse_cholesky as tsc
from libdogleg_tpu_torch import sparsity as tsparsity
from libdogleg_tpu_torch.models import grid_mrf as tgrid
from libdogleg_tpu_torch.native import loader
from libdogleg_tpu_torch.native import symbolic as tnat
from libdogleg_tpu_torch.ops import bcsr as tbcsr
from libdogleg_tpu_torch.ops import bcsr_kernels as tk

torch.set_num_threads(1)


@pytest.fixture
def jax_native():
    if not native_available():
        pytest.skip("the JAX package's native library is unavailable")


@pytest.fixture
def no_host_library(monkeypatch):
    """Every wrapper of native/symbolic.py as without the library."""
    monkeypatch.setattr(tnat, "load_host_library", lambda: None)


def _random_structure(seed, nbrow=200, nbcol=40, density=0.1):
    """tests/test_native.py's random block pattern."""
    rng = np.random.default_rng(seed)
    indptr = np.zeros(nbrow + 1, np.int32)
    cols = []
    for r in range(nbrow):
        k = max(1, rng.binomial(nbcol, density))
        c = np.sort(rng.choice(nbcol, size=k, replace=False)).astype(np.int32)
        cols.append(c)
        indptr[r + 1] = indptr[r] + k
    return tbcsr.BCSRStructure(nmeas=nbrow * 4, nstate=nbcol * 3,
                               block_rows=4, block_cols=3, indptr=indptr,
                               indices=np.concatenate(cols))


@functools.lru_cache(maxsize=None)
def _grid_structure(width, height, b):
    return tgrid.make_grid_mrf(width, height, b, device="cpu").structure


def _structure(name):
    if name == "grid64x64x8":
        return _grid_structure(64, 64, 8)
    return _random_structure(int(name[-1]))


def _lower_pattern(name):
    """A lower block pattern (rows, cols, nb): a random one
    (tests/test_sparse_cholesky.py's construction) or a grid MRF's lower
    JtJ pattern."""
    if name.startswith("grid"):
        w = int(name[4:].split("x")[0])
        s = _grid_structure(w, w, 8)
        sched = tbcsr.jtj_lower_schedule(s)
        return sched.rows, sched.cols, s.nbcol
    rng = np.random.default_rng(int(name[-1]))
    nb = 40
    pairs = {(j, j) for j in range(nb)}
    while len(pairs) < nb + 70:
        i = int(rng.integers(1, nb))
        pairs.add((i, int(rng.integers(0, i))))
    rows, cols = map(np.asarray, zip(*sorted(pairs)))
    return rows, cols, nb


def _assert_same(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_host_library_builds_with_gxx():
    """The library is built from the port's own sources with g++, under a
    name hashed from them, and loads with every entry point bound."""
    info = loader.build_host()
    assert info.path == loader.host_library_path()
    assert info.path.parent == loader._BUILD_DIR
    assert [s.name for s in loader.host_sources()] == [
        "chol_symbolic.cpp", "symbolic.cpp"]
    assert all(s.parent == loader._SRC / "host"
               for s in loader.host_sources())
    lib = loader.load_host_library()
    assert lib is not None
    for name in ("mindeg_order", "jtj_pair_count", "jtj_schedule",
                 "bcsr_block_pattern", "chol_symbolic_build",
                 "chol_symbolic_counts", "chol_symbolic_export",
                 "chol_symbolic_free"):
        assert getattr(lib, name).argtypes, name


def test_host_source_edit_renames_the_library(tmp_path, monkeypatch):
    import shutil
    original = loader.host_library_path()
    for s in loader.host_sources():
        shutil.copy(s, tmp_path / s.name)
    monkeypatch.setattr(loader, "_HOST_SRC", tmp_path)
    assert loader.host_library_path() == original
    names = {original.name}
    for s in sorted(tmp_path.glob("*.cpp")):
        s.write_text(s.read_text() + "\n// edited\n")
        names.add(loader.host_library_path().name)
    assert len(names) == 3
    # the CUDA library's name does not depend on the host sources
    assert "host" not in loader.library_path().name


def test_unavailable_library_gives_none(no_host_library):
    s = _random_structure(0)
    rows, cols, nb = _lower_pattern("random1")
    assert tnat.jtj_schedule_native(s.indptr, s.indices, s.nbcol) is None
    assert tnat.mindeg_native(rows, cols, nb) is None
    assert tnat.chol_symbolic_native(rows, cols, nb) is None
    assert tnat.bcsr_pattern_native(np.zeros(2, np.int64),
                                     np.zeros(0, np.int32), 1, 1, 1,
                                     1) is None


@pytest.mark.parametrize("name", ["random0", "random1", "random3",
                                  "grid64x64x8"])
def test_jtj_schedule_native_equals_python_and_jax(name, jax_native):
    s = _structure(name)
    nat = tnat.jtj_schedule_native(s.indptr, s.indices, s.nbcol)
    py = tk.build_jtj_schedule_python(s)
    for got, want in zip(nat, py):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(nat, jnat.jtj_schedule_native(s.indptr, s.indices,
                                                       s.nbcol)):
        np.testing.assert_array_equal(got, want)
    before = tnat.native_calls["jtj_schedule"]
    sched = tk.build_jtj_schedule(s)
    assert tnat.native_calls["jtj_schedule"] == before + 1
    _assert_same(sched, py, tk.JtJSchedule._fields)


def test_jtj_schedule_falls_back_to_python(no_host_library):
    s = _random_structure(1)
    js = jbcsr.BCSRStructure(*s)
    _assert_same(tk.build_jtj_schedule(s),
                 pallas_bcsr.build_jtj_schedule(js),
                 tk.JtJSchedule._fields)


def _scalar_csr(seed, nmeas=64, nstate=24):
    rng = np.random.default_rng(seed)
    rowptr, colidx = [0], []
    for _ in range(nmeas):
        k = rng.integers(1, 6)
        colidx.extend(np.sort(rng.choice(nstate, size=k, replace=False)))
        rowptr.append(len(colidx))
    return np.asarray(rowptr), np.asarray(colidx, np.int32)


@pytest.mark.parametrize("seed,blocks", [(2, (4, 3)), (3, (2, 2)),
                                         (4, (8, 6))])
def test_bcsr_pattern_native_equals_python_and_jax(seed, blocks, jax_native,
                                                   monkeypatch):
    rowptr, colidx = _scalar_csr(seed, nmeas=96, nstate=24)
    bm, bn = blocks
    nat = tnat.bcsr_pattern_native(rowptr, colidx, 96, 24, bm, bn)
    jn = jnat.bcsr_pattern_native(rowptr, colidx, 96, 24, bm, bn)
    before = tnat.native_calls["bcsr_pattern"]
    s = tsparsity.bcsr_from_scalar_csr(rowptr, colidx, 96, 24, bm, bn)
    assert tnat.native_calls["bcsr_pattern"] == before + 1
    monkeypatch.setattr(tnat, "load_host_library", lambda: None)
    py = tsparsity.bcsr_from_scalar_csr(rowptr, colidx, 96, 24, bm, bn)
    js = j_from_csr(rowptr, colidx, 96, 24, bm, bn)
    for arr in (nat[0], jn[0], s.indptr, js.indptr):
        np.testing.assert_array_equal(arr, py.indptr)
    for arr in (nat[1], jn[1], s.indices, js.indices):
        np.testing.assert_array_equal(arr, py.indices)


@pytest.mark.parametrize("name", ["random1", "random2", "grid32x32x8",
                                  "grid64x64x8"])
def test_mindeg_native_equals_python_and_jax(name, jax_native):
    rows, cols, nb = _lower_pattern(name)
    nat = tnat.mindeg_native(rows, cols, nb)
    before = tnat.native_calls["mindeg"]
    perm = tord.mindeg_ordering(rows, cols, nb)
    assert tnat.native_calls["mindeg"] == before + 1
    np.testing.assert_array_equal(perm, nat)
    np.testing.assert_array_equal(nat, jord.mindeg_ordering(rows, cols, nb))
    if nb <= 1024:   # the Python form at 4096 blocks adds seconds, no case
        np.testing.assert_array_equal(
            nat, tord._mindeg_python(np.asarray(rows, np.int32),
                                     np.asarray(cols, np.int32), nb))
    assert np.array_equal(np.sort(nat), np.arange(nb))


@functools.lru_cache(maxsize=None)
def _analyses(name, ordering):
    """(native analysis, Python analysis) of the port, and the JAX
    package's (its native one)."""
    rows, cols, nb = _lower_pattern(name)
    nat = tsc.analyze(rows, cols, nb, 2, ordering=ordering)
    lib = tnat.load_host_library
    tnat.load_host_library = lambda: None
    try:
        py = tsc.analyze(rows, cols, nb, 2, ordering=ordering)
    finally:
        tnat.load_host_library = lib
    return nat, py, jsc.analyze(rows, cols, nb, 2, ordering=ordering)


def _assert_same_analysis(a, b):
    for f in ("rows", "cols", "a_slot_of_input", "a_transpose", "perm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    _assert_same(a.sched, b.sched, tsc.OpSchedule._fields)
    for phase in ("fwd", "bwd"):
        _assert_same(getattr(a, phase), getattr(b, phase),
                     tsc.SolveSchedule._fields)


@pytest.mark.parametrize("name,ordering", [
    ("random1", "mindeg"), ("random2", "natural"), ("random3", "rcm"),
    ("grid32x32x8", "mindeg"), ("grid64x64x8", "rcm")])
def test_chol_symbolic_native_equals_python_and_jax(name, ordering,
                                                    jax_native):
    nat, py, jx = _analyses(name, ordering)
    _assert_same_analysis(nat, py)
    _assert_same_analysis(nat, jx)


def test_analyze_takes_the_native_path():
    rows, cols, nb = _lower_pattern("random1")
    before = dict(tnat.native_calls)
    tsc.analyze(rows, cols, nb, 2)
    assert tnat.native_calls["chol_symbolic"] == before["chol_symbolic"] + 1
    assert tnat.native_calls["mindeg"] == before["mindeg"] + 1


def test_grid_64_analyses():
    """Config 6b's two analyses: the default simplicial one (mindeg) has
    611 levels; the rcm/amalgamate-16 supernodal one 45 levels of 1691
    slots of 128x128."""
    from libdogleg_tpu_torch.problems import SparseProblem
    g = tgrid.make_grid_mrf(64, 64, 8, device="cpu")
    before = dict(tnat.native_calls)
    simp = g.problem().default_newton_solver().symbolic
    sup = SparseProblem(f=None, structure=g.structure, jtj="sparse",
                        ordering="rcm",
                        amalgamate=16).default_newton_solver().symbolic
    assert simp.sched.nlevels == 611
    assert sup.inner.sched.nlevels == 45
    assert (sup.inner.nslots, sup.sb) == (1691, 128)
    assert tnat.native_calls["chol_symbolic"] >= before["chol_symbolic"] + 3
    assert tnat.native_calls["jtj_schedule"] == before["jtj_schedule"] + 2
