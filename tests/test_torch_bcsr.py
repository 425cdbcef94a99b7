"""The port's block-CSR products (ops/bcsr.py), the symbolic helpers
(sparsity.py, build_jtj_schedule) and the plain twins of kernels K3 and K4
(ops/bcsr_kernels.py) against the JAX package, on numpy-seeded inputs.

Host-side structures and schedules must be identical arrays. Products sum
in another order than XLA's: float64 agrees to rtol 1e-12, and the float32
twins agree with the JAX Pallas kernels (run in interpret mode, as
tests/test_pallas_bcsr.py runs them) to rtol 1e-5, atol 1e-3 on values of
order 1-100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdogleg_tpu import sparsity as jsparsity
from libdogleg_tpu.ops import bcsr as jbcsr
from libdogleg_tpu.ops import pallas_bcsr as jpallas
from libdogleg_tpu_torch import sparsity as tsparsity
from libdogleg_tpu_torch.ops import bcsr as tbcsr
from libdogleg_tpu_torch.ops import bcsr_kernels as tk

torch.set_num_threads(1)


def _pattern(seed, nbrow=6, nbcol=5, density=0.5):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(nbrow, nbcol)) < density
    mask[:, 0] = True
    mask[2] = False          # an empty block row
    indptr = np.zeros(nbrow + 1, np.int32)
    cols = []
    for r in range(nbrow):
        c = np.nonzero(mask[r])[0].astype(np.int32)
        cols.append(c)
        indptr[r + 1] = indptr[r] + len(c)
    return indptr, np.concatenate(cols), rng


def _both(seed, bm, bn, dtype, **kw):
    """The same block-CSR Jacobian in both packages."""
    indptr, indices, rng = _pattern(seed, **kw)
    nbrow, nbcol = len(indptr) - 1, kw.get("nbcol", 5)
    args = dict(nmeas=nbrow * bm, nstate=nbcol * bn, block_rows=bm,
                block_cols=bn, indptr=indptr, indices=indices)
    values = rng.normal(size=(len(indices), bm, bn)).astype(dtype)
    Jj = jbcsr.BCSRJacobian(jbcsr.BCSRStructure(**args), jnp.asarray(values))
    Jt = tbcsr.BCSRJacobian(tbcsr.BCSRStructure(**args),
                            torch.as_tensor(values))
    return Jj, Jt, rng


def test_structure_helpers_equal_jax():
    Jj, Jt, _ = _both(0, 3, 2, np.float64, nbrow=9, nbcol=7)
    sj, st = Jj.structure, Jt.structure
    assert (st.nbrow, st.nbcol, st.nnzb) == (sj.nbrow, sj.nbcol, sj.nnzb)
    np.testing.assert_array_equal(st.row_of_block(), sj.row_of_block())
    for a, b in zip(st.jtj_pairs(), sj.jtj_pairs()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    sched_t, sched_j = tk.build_jtj_schedule(st), jpallas.build_jtj_schedule(sj)
    for name in tk.JtJSchedule._fields:
        a, b = getattr(sched_t, name), getattr(sched_j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_sparsity_equals_jax():
    rng = np.random.default_rng(1)
    nmeas, nstate = 12, 10
    dense = rng.uniform(size=(nmeas, nstate)) < 0.3
    rowptr = np.concatenate([[0], np.cumsum(dense.sum(1))]).astype(np.int32)
    colidx = np.nonzero(dense)[1].astype(np.int32)
    for bm, bn in [(1, 1), (3, 2), (4, 5)]:
        a = tsparsity.bcsr_from_scalar_csr(rowptr, colidx, nmeas, nstate,
                                           bm, bn)
        b = jsparsity.bcsr_from_scalar_csr(rowptr, colidx, nmeas, nstate,
                                           bm, bn)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        c = tsparsity.dense_structure(nmeas, nstate, bm, bn)
        d = jsparsity.dense_structure(nmeas, nstate, bm, bn)
        np.testing.assert_array_equal(c.indptr, d.indptr)
        np.testing.assert_array_equal(c.indices, d.indices)
    with pytest.raises(ValueError):
        tsparsity.dense_structure(10, 10, 3, 1)


def test_products_equal_jax_f64():
    Jj, Jt, rng = _both(2, 3, 2, np.float64, nbrow=9, nbcol=7)
    s = Jt.structure
    x = rng.normal(size=s.nmeas)
    v = rng.normal(size=s.nstate)
    dense_t = tbcsr.bcsr_to_dense(Jt).numpy()
    np.testing.assert_array_equal(dense_t, np.asarray(jbcsr.bcsr_to_dense(Jj)))
    np.testing.assert_array_equal(
        tbcsr.dense_to_bcsr_values(torch.as_tensor(dense_t), s).numpy(),
        np.asarray(jbcsr.dense_to_bcsr_values(jnp.asarray(dense_t),
                                              Jj.structure)))
    for got, want, ref in [
            (tbcsr.bcsr_jt_x(Jt, torch.as_tensor(x)),
             jbcsr.bcsr_jt_x(Jj, jnp.asarray(x)), dense_t.T @ x),
            (tbcsr.bcsr_matvec(Jt, torch.as_tensor(v)),
             jbcsr.bcsr_matvec(Jj, jnp.asarray(v)), dense_t @ v),
            (tbcsr.bcsr_jtj_dense(Jt), jbcsr.bcsr_jtj_dense(Jj),
             dense_t.T @ dense_t)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def _grid_like_both(seed, bm, bn, dtype, nbrow=6, nbcol=4):
    """A Jacobian whose block rows store 1 and 2 blocks in turn, as the grid
    model's prior and coupling rows do, in both packages."""
    cols = [[r % nbcol] if r % 2 == 0
            else sorted({r % nbcol, (r + 1) % nbcol}) for r in range(nbrow)]
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    indices = np.concatenate(cols)
    args = dict(nmeas=nbrow * bm, nstate=nbcol * bn, block_rows=bm,
                block_cols=bn, indptr=indptr.astype(np.int32),
                indices=indices.astype(np.int32))
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(len(indices), bm, bn)).astype(dtype)
    Jj = jbcsr.BCSRJacobian(jbcsr.BCSRStructure(**args), jnp.asarray(values))
    Jt = tbcsr.BCSRJacobian(tbcsr.BCSRStructure(**args),
                            torch.as_tensor(values))
    return Jj, Jt, rng


@pytest.mark.parametrize("bm,bn", [(8, 128), (3, 2), (8, 8)])
def test_kernel_twins_match_jax_pallas_f32(bm, bn):
    """K3's and K4's twins (the wrappers on CPU tensors) against the JAX
    Pallas kernels in interpret mode, on a (8, 128)-tile structure like
    tests/test_pallas_bcsr.py's, on small odd blocks, and on the grid
    model's (8, 8) blocks in rows of 1 and 2 blocks."""
    if (bm, bn) == (8, 8):
        Jj, Jt, rng = _grid_like_both(3, bm, bn, np.float32)
    else:
        Jj, Jt, rng = _both(3, bm, bn, np.float32, nbrow=5, nbcol=4)
    s = Jt.structure
    counts = dict(tk.launch_counts)
    blocks, sched = tk.bcsr_jtj_blocks_kernel(Jt)
    jblocks, jsched = jpallas.bcsr_jtj_blocks_pallas(Jj, interpret=True)
    np.testing.assert_array_equal(sched.out_idx, jsched.out_idx)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jblocks),
                               rtol=1e-5, atol=1e-3)
    dense = tk.bcsr_jtj_dense_kernel(Jt, sched)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jpallas.jtj_blocks_to_dense(
            jblocks, jsched, Jj.structure)), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dense.numpy(), tbcsr.bcsr_jtj_dense(Jt).numpy(),
                               rtol=1e-5, atol=1e-3)
    v = rng.normal(size=s.nstate).astype(np.float32)
    got = tk.bcsr_matvec_kernel(Jt, torch.as_tensor(v))
    want = jpallas.bcsr_matvec_pallas(Jj, jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    assert tk.launch_counts == counts   # CPU tensors take the twins


def test_supports_kernels_takes_any_block_shape():
    _, Jt, _ = _both(4, 3, 2, np.float32)
    assert tk.supports_kernels(Jt.structure, torch.float32)
    assert tk.supports_kernels(Jt.structure, torch.float64)
    assert not tk.supports_kernels(Jt.structure, torch.float16)
    with pytest.raises(ValueError):
        tk.bcsr_matvec_kernel(Jt, torch.zeros(3))


@pytest.mark.parametrize("np_dtype,rtol", [(np.float64, 1e-12),
                                           (np.float32, 1e-5)])
@pytest.mark.parametrize("bm,bn", [(8, 8), (4, 8), (3, 5)])
def test_matvec_wrapper_matches_jax_matvec(bm, bn, np_dtype, rtol):
    """bcsr_matvec_kernel on CPU tensors (K4's plain version) against the
    JAX package's bcsr_matvec, on the block shapes of K4's two kernels, with
    an empty block row (row 2 of _pattern)."""
    Jj, Jt, rng = _both(5, bm, bn, np_dtype, nbrow=7, nbcol=6)
    s = Jt.structure
    assert s.indptr[2] == s.indptr[3]
    v = rng.normal(size=s.nstate).astype(np_dtype)
    got = tk.bcsr_matvec_kernel(Jt, torch.as_tensor(v))
    want = np.asarray(jbcsr.bcsr_matvec(Jj, jnp.asarray(v)))
    assert got.dtype == torch.as_tensor(v).dtype and want.dtype == np_dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    assert not got[2 * bm:3 * bm].any()


@pytest.mark.parametrize("bm,bn,dtype,want", [
    (8, 8, torch.float32, "words"), (8, 8, torch.float64, "words"),
    (4, 8, torch.float32, "rows"), (4, 4, torch.float64, "rows"),
    (3, 5, torch.float32, "rows"), (3, 5, torch.float64, "rows"),
    (32, 128, torch.float32, "rows"), (4, 6, torch.float64, "rows"),
    (8, 8, torch.float16, "rows")])
def test_matvec_instance(bm, bn, dtype, want):
    """The 16-byte-word kernel for the grid model's (8, 8) blocks, the
    generic one for every other shape."""
    assert tk.matvec_instance(bm, bn, dtype) == want


@pytest.mark.parametrize("bm,bn,dtype,want", [
    (8, 8, torch.float32, "words"), (8, 8, torch.float64, "words"),
    (4, 8, torch.float32, "entries"), (8, 4, torch.float64, "entries"),
    (3, 5, torch.float32, "entries"), (3, 5, torch.float64, "entries"),
    (8, 128, torch.float32, "entries"), (16, 16, torch.float64, "entries"),
    (8, 8, torch.float16, "entries")])
def test_jtj_instance(bm, bn, dtype, want):
    """K3's word kernel for the grid model's (8, 8) blocks in float32 and
    float64, the generic one for every other shape and type."""
    assert tk.jtj_instance(bm, bn, dtype) == want


def test_device_indices_are_cached_per_array():
    """A structure's index arrays go to the device once: a second call
    returns the same tensors, another structure gets its own, a derived
    array is told apart by its name, and the tensors hold int32 copies."""
    _, Jt, _ = _both(6, 4, 8, np.float32)
    _, Jo, _ = _both(6, 4, 8, np.float32)
    s, o = Jt.structure, Jo.structure
    a = tk.device_indices(s.indptr, "cpu")
    b = tk.device_indices(s.indices, "cpu")
    assert tk.device_indices(s.indptr, "cpu") is a
    assert tk.device_indices(s.indices, torch.device("cpu")) is b
    assert a.dtype == b.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), s.indptr)
    np.testing.assert_array_equal(b.numpy(), s.indices)
    assert not np.shares_memory(a.numpy(), s.indptr)
    c = tk.device_indices(o.indptr, "cpu")
    assert c is not a and torch.equal(c, a)
    made = []
    d = tk.device_indices(s.indptr, "cpu", "doubled",
                          lambda: made.append(1) or 2 * s.indptr)
    assert d is not a and torch.equal(d, 2 * a)
    assert tk.device_indices(s.indptr, "cpu", "doubled", None) is d
    assert made == [1]


def test_device_indices_go_with_their_array():
    """The cache holds no reference to the array: when the structure is
    collected, its tensors are dropped."""
    import gc
    indptr, indices, _ = _pattern(7)
    before = len(tk._DEVICE_INDICES)
    tk.device_indices(indptr, "cpu")
    tk.device_indices(indices, "cpu")
    assert len(tk._DEVICE_INDICES) == before + 2
    del indptr, indices
    gc.collect()
    assert len(tk._DEVICE_INDICES) == before


def test_jtj_wrapper_caches_its_schedule_on_the_device():
    """K3's wrapper takes its operands from the same cache, held with the
    schedule's out_idx: pair_i, pair_j and the run pointers in one int32
    array, the run pointers the offsets of each output block's run."""
    _, Jt, _ = _both(8, 3, 2, np.float64)
    sched = tk.build_jtj_schedule(Jt.structure)
    ops = tk.device_indices(sched.out_idx, "cpu", "jtj",
                            lambda: tk._jtj_operands(sched))
    assert tk.device_indices(sched.out_idx, "cpu", "jtj") is ops
    npairs = len(sched.pair_i)
    assert ops.dtype == torch.int32
    np.testing.assert_array_equal(ops[:npairs].numpy(), sched.pair_i)
    np.testing.assert_array_equal(ops[npairs:2 * npairs].numpy(), sched.pair_j)
    rp = ops[2 * npairs:]
    assert rp[0] == 0 and rp[-1] == npairs
    assert len(rp) == len(sched.out_ci) + 1
    for o in range(len(sched.out_ci)):
        assert (sched.out_idx[rp[o]:rp[o + 1]] == o).all()
