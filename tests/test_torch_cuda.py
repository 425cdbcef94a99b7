"""Kernels K1-K7 (K1 in its two named instances and on generated functors)
on a CUDA card against their plain twins on the same card.

These tests need an NVIDIA GPU and skip without one. This file imports no
jax, so it runs on a machine that has only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from libdogleg_tpu_torch import DoglegParameters
from libdogleg_tpu_torch.models import quadratic_surface as qs
from libdogleg_tpu_torch.ops import mega
from libdogleg_tpu_torch.parallel import batched_optimize

torch.set_num_threads(1)
BENCH = DoglegParameters(max_iterations=10, Jt_x_threshold=1e-3,
                         update_threshold=1e-5, trustregion_threshold=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernels_run(fn, names, want, reps=3):
    """Which of `names` the kernels that `reps` calls of fn launched hold in
    their names, from a profiler trace. A trace now and then loses an event,
    so it is taken again, up to six times, until it shows exactly `want`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        keys = [ev.key.lower() for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]
        found = {name for name in names if any(name in k for k in keys)}
        if found == set(want):
            break
    return found


def _instances(seed, batch, dtype, device):
    g = torch.Generator().manual_seed(seed)
    meas = qs.simulate(g, dtype, device, batch=(batch,))
    p0 = qs.initial_state(g, dtype, device, batch=(batch,))
    gx, gy = qs.make_grid(dtype)  # no device given: the card
    return p0, meas, gx, gy


@pytest.mark.cuda
def test_kernel_f64_decisions_equal_twin(cuda):
    args = _instances(0, 1000, torch.float64, cuda)  # not a block multiple
    before = mega.launch_count
    r_k = mega.megakernel_optimize(*args)
    torch.cuda.synchronize()
    assert mega.launch_count == before + 1
    r_t = mega.megakernel_optimize_reference(*args)
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r_k, field), getattr(r_t, field)), field
    np.testing.assert_allclose(r_k.p.cpu().numpy(), r_t.p.cpu().numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r_k.JtJ.cpu().numpy(), r_t.JtJ.cpu().numpy(),
                               rtol=1e-9)


@pytest.mark.cuda
def test_kernel_f32_agrees_with_twin(cuda):
    args = _instances(1, 2048, torch.float32, cuda)
    r_k = mega.megakernel_optimize(*args, BENCH)
    r_t = mega.megakernel_optimize_reference(*args, BENCH)
    same = ((r_k.step_count == r_t.step_count)
            & (r_k.n_attempts == r_t.n_attempts)).float().mean().item()
    assert same >= 0.85
    np.testing.assert_allclose(r_k.norm2_x.cpu().numpy(),
                               r_t.norm2_x.cpu().numpy(), rtol=1e-2,
                               atol=1e-4)
    err = np.abs(r_k.p.cpu().double().numpy() - qs.P_TRUE)
    assert np.mean(np.all(err < 0.2, axis=1)) >= 0.99


@pytest.mark.cuda
def test_batched_optimize_launches_kernel(cuda):
    p0, meas, _, _ = _instances(2, 256, torch.float32, cuda)
    before = mega.launch_count
    r = batched_optimize(qs.products, p0, BENCH, problem_data=meas)
    assert mega.launch_count == before + 1
    assert r.p.is_cuda and r.p.shape == (256, qs.NSTATE)
    r_m = batched_optimize(qs.products, p0, BENCH, problem_data=meas,
                           use_megakernel=False)
    assert mega.launch_count == before + 1
    assert r_m.p.is_cuda


def _spd(n, rng, batch=()):
    A = rng.normal(size=batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("p", [16, 32, 64, 128, 240, 256])
def test_panel_kernel_matches_twin(cuda, p, dtype, tol):
    """K2 against its twin on the card: L and inv(L) within tol relative to
    their largest entry, L inv(L) the identity, zeros above both diagonals,
    ok identical, and a negative pivot caught."""
    from libdogleg_tpu_torch.ops import panelchol
    rng = np.random.default_rng(p)
    W = _spd(p, rng, batch=(3,))
    W[2, p // 2, p // 2] = -W[2, p // 2, p // 2]
    Wt = torch.as_tensor(W, dtype=dtype, device=cuda)
    before = panelchol.launch_count
    L, Linv, ok = panelchol.panel_factor(Wt)
    torch.cuda.synchronize()
    assert panelchol.launch_count == before + 1
    Lr, Linvr, okr = panelchol.panel_factor_reference(Wt)
    assert ok.dtype == torch.bool
    assert ok.tolist() == okr.tolist() == [True, True, False]
    for got, want in ((L, Lr), (Linv, Linvr)):
        err = (got[:2] - want[:2]).abs().max() / want[:2].abs().max()
        assert float(err) < tol
    eye = torch.eye(p, dtype=dtype, device=cuda)
    assert float((L[:2] @ Linv[:2] - eye).abs().max()) < tol
    assert bool((torch.triu(L, 1) == 0).all())
    assert bool((torch.triu(Linv[:2], 1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_panel_kernel_batch_with_a_nan_entry(cuda, dtype, tol):
    """A batch of 8 panels at p = 256, one with a NaN entry: ok False for
    that one only, from the kernel and the twin, nothing hangs, and the
    other panels within tol."""
    from libdogleg_tpu_torch.ops import panelchol
    W = _spd(256, np.random.default_rng(8), batch=(8,))
    W[5, 200, 3] = W[5, 3, 200] = np.nan
    Wt = torch.as_tensor(W, dtype=dtype, device=cuda)
    L, Linv, ok = panelchol.panel_factor(Wt)
    torch.cuda.synchronize()
    Lr, Linvr, okr = panelchol.panel_factor_reference(Wt)
    want = [True] * 5 + [False] + [True] * 2
    assert ok.tolist() == okr.tolist() == want
    good = [0, 1, 2, 3, 4, 6, 7]
    for got, ref in ((L, Lr), (Linv, Linvr)):
        err = (got[good] - ref[good]).abs().max() / ref[good].abs().max()
        assert float(err) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_panel_kernel_takes_a_panel_that_is_not_aligned(cuda, dtype, tol):
    """A contiguous panel one element into a larger buffer, so that its rows
    are no whole 16-byte words: K2 copies it in by elements."""
    from libdogleg_tpu_torch.ops import panelchol
    p = 64
    W = torch.as_tensor(_spd(p, np.random.default_rng(5)), dtype=dtype,
                        device=cuda)
    buf = torch.zeros(p * p + 1, dtype=dtype, device=cuda)
    Wv = buf[1:].view(p, p).copy_(W)
    assert Wv.is_contiguous() and Wv.data_ptr() % 16
    L, Linv, ok = panelchol.panel_factor(Wv)
    Lr, Linvr, okr = panelchol.panel_factor(W)
    assert bool(ok) and bool(okr)
    assert torch.equal(L, Lr) and torch.equal(Linv, Linvr)
    want = panelchol.panel_factor_reference(W)[0]
    assert float((L - want).abs().max() / want.abs().max()) < tol


@pytest.mark.cuda
def test_large_cholesky_kernel_path(cuda):
    from libdogleg_tpu_torch.ops import largechol, panelchol
    rng = np.random.default_rng(1)
    A = _spd(640, rng)
    At = torch.as_tensor(A, device=cuda)
    before = panelchol.launch_count
    L, ok = largechol.large_cholesky(At, panel_impl="cuda")
    torch.cuda.synchronize()
    assert bool(ok) and panelchol.launch_count == before + 3
    np.testing.assert_allclose(L.cpu().numpy(), np.linalg.cholesky(A),
                               rtol=1e-10, atol=1e-10 * 640)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bcsr_kernels_match_twins(cuda, dtype):
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian
    g = grid_mrf.make_grid_mrf(6, 5, 3, coupling="dense", dtype=dtype,
                               device=cuda)
    _, values = g.problem(jtj="dense").f(g.p_true)
    J = BCSRJacobian(g.structure, values)
    before = dict(tk.launch_counts)
    blocks, sched = tk.bcsr_jtj_blocks_kernel(J)
    v = torch.linspace(-1, 1, g.nstate, dtype=dtype, device=cuda)
    Jv = tk.bcsr_matvec_kernel(J, v)
    torch.cuda.synchronize()
    assert all(tk.launch_counts[k] == before[k] + 1 for k in before)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(blocks, tk.bcsr_jtj_blocks_reference(J, sched),
                               rtol=rtol, atol=rtol)
    torch.testing.assert_close(Jv, tk.bcsr_matvec_reference(J, v), rtol=rtol,
                               atol=rtol)


@pytest.mark.cuda
def test_grid_solve_launches_panel_kernel(cuda):
    """The slice at a small width on the card: K2 on every panel, and in
    float64 the decisions of the twin-panel solve."""
    from libdogleg_tpu_torch import BlockedDenseNewtonSolver, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import panelchol
    g = grid_mrf.make_grid_mrf(10, 8, 4, device=cuda)
    prob = g.problem(jtj="dense")
    p0 = torch.zeros(g.nstate, dtype=torch.float64, device=cuda)
    before = panelchol.launch_count
    r_k = optimize(prob, p0, newton_solver=BlockedDenseNewtonSolver())
    assert panelchol.launch_count >= before + 2
    r_t = optimize(prob, p0,
                   newton_solver=BlockedDenseNewtonSolver(panel_impl="torch"))
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r_k, field)) == int(getattr(r_t, field)), field
    torch.testing.assert_close(r_k.p, r_t.p, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("n", [8, 16, 24, 33, 40, 48, 64, 100, 128, 250,
                               256])
def test_tile_kernels_match_twins(cuda, n, dtype, tol):
    """K6 and K7 against their twins on the card, on tiles a warp takes
    (n <= 32) and tiles a block takes, n that is and is not a multiple of
    the panel width, in shared memory and in place: L and X within tol of
    their largest entry, ok identical, and a negative pivot caught in its
    own tile only."""
    from libdogleg_tpu_torch.ops import tilechol
    rng = np.random.default_rng(n)
    S = _spd(n, rng, batch=(5,))
    S[4, n // 2, n // 2] = -S[4, n // 2, n // 2]
    St = torch.as_tensor(S, dtype=dtype, device=cuda)
    C = torch.as_tensor(rng.normal(size=(5, 3, n)), dtype=dtype, device=cuda)
    before = dict(tilechol.launch_counts)
    L, ok = tilechol.tile_cholesky(St)
    Lr, okr = tilechol.tile_cholesky_reference(St)
    X = tilechol.tri_solve_right(Lr[:4], C[:4])
    torch.cuda.synchronize()
    assert all(tilechol.launch_counts[k] == before[k] + 1 for k in before)
    assert ok.dtype == torch.bool and L.is_contiguous()
    assert ok.tolist() == okr.tolist() == [True] * 4 + [False]
    assert bool((torch.triu(L, 1) == 0).all())
    err = (L[:4] - Lr[:4]).abs().max() / Lr[:4].abs().max()
    assert float(err) < tol
    Xr = tilechol.tri_solve_right_reference(Lr[:4], C[:4])
    assert float((X - Xr).abs().max() / Xr.abs().max()) < tol
    # tiles one element into a larger buffer: not 16-byte aligned
    buf = torch.zeros(4 * n * n + 1, dtype=dtype, device=cuda)
    Sv = buf[1:].view(4, n, n).copy_(St[:4])
    Lv, okv = tilechol.tile_cholesky(Sv)
    assert bool(okv.all()) and torch.equal(Lv, L[:4])


@pytest.mark.cuda
@pytest.mark.parametrize("amalgamate", [1, 4])
def test_sparse_solve_launches_tile_kernels(cuda, amalgamate):
    """The block-sparse grid solve on the card (simplicial g.problem() and
    the rcm/amalgamated problem): K6 and K7 launched, and in float64 the
    decisions of the same code on a CPU tensor, where the twins run."""
    from libdogleg_tpu_torch import SparseProblem, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import tilechol
    results = []
    for dev in (cuda, torch.device("cpu")):
        g = grid_mrf.make_grid_mrf(10, 8, 4, device=dev)
        prob = g.problem()
        if amalgamate > 1:
            prob = SparseProblem(f=prob.f, structure=prob.structure,
                                 jtj="sparse", ordering="rcm",
                                 amalgamate=amalgamate)
        p0 = torch.zeros(g.nstate, dtype=torch.float64, device=dev)
        before = dict(tilechol.launch_counts)
        results.append(optimize(prob, p0))
        launched = {k: tilechol.launch_counts[k] - before[k] for k in before}
        if dev.type == "cuda":
            assert all(v > 0 for v in launched.values()), launched
        else:
            assert not any(launched.values()), launched
    r_k, r_t = results
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r_k, field)) == int(getattr(r_t, field)), field
    assert int(r_k.reason) > 0
    np.testing.assert_allclose(r_k.p.cpu().numpy(), r_t.p.numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_default_device_is_the_card(cuda):
    from libdogleg_tpu_torch import interop
    from libdogleg_tpu_torch.device import resolve_device
    assert resolve_device(None).type == "cuda"
    assert resolve_device("cpu").type == "cpu"
    assert interop.from_numpy(np.zeros(3)).is_cuda
    assert qs.make_grid()[0].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("n", [32, 64, 128])
def test_batched_blocked_cholesky_matches_plain_version(cuda, n, dtype, tol):
    """K5 against its plain version on the card: the factors within tol of
    the largest entry, identical ok flags with one matrix not SPD, zeros
    above the diagonal, one launch."""
    from libdogleg_tpu_torch.ops import batchchol
    rng = np.random.default_rng(n)
    A = torch.as_tensor(rng.normal(size=(9, n, n)), device=cuda)
    S = (A @ A.mT + n * torch.eye(n, dtype=A.dtype, device=cuda)).to(dtype)
    S[4, n // 2, n // 2] = -S[4, n // 2, n // 2]
    before = batchchol.launch_count
    L, ok = batchchol.batched_blocked_cholesky(S)
    torch.cuda.synchronize()
    assert batchchol.launch_count == before + 1
    Lr, okr = batchchol.batched_blocked_cholesky_reference(S)
    assert ok.tolist() == okr.tolist() == [True] * 4 + [False] + [True] * 4
    assert bool((torch.triu(L, 1) == 0).all())
    good = ok.nonzero()[:, 0]
    err = float((L[good] - Lr[good]).abs().max() / Lr[good].abs().max())
    assert err < tol, err


def k5_digest(dtype, device) -> str:
    """SHA-256 of K5's factors of fixed (11, n, n) batches, n in {32, 64,
    128, 256}: matrices (R + R^T) / 2 + n I with R uniform in [0, 1) from a
    numpy seed, formed elementwise so that every machine gets the same
    bits."""
    import hashlib

    from libdogleg_tpu_torch.ops import batchchol
    h = hashlib.sha256()
    for n in (32, 64, 128, 256):
        R = np.random.default_rng(n).uniform(size=(11, n, n))
        S = (R + np.swapaxes(R, -1, -2)) / 2 + n * np.eye(n)
        L, ok = batchchol.batched_blocked_cholesky(
            torch.as_tensor(S, dtype=dtype, device=device))
        assert bool(ok.all())
        h.update(L.cpu().numpy().tobytes())
    return h.hexdigest()


# k5_digest of the kernel as it stood before its stage moved into
# csrc/cholstage.cuh (H100, CUDA 12.8): the move changed no bit of K5's result
K5_DIGESTS = {
    torch.float32:
        "85a37be0a37619c4e3e258d7f7f3b4759adfcaa2c1585023a1c93e77f2c3fdcd",
    torch.float64:
        "beb1f479859f5ce7156b493f76e70ef5593bf1d0888a66f0a22bc86fcaa70a3d",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_blocked_cholesky_bits_unchanged(cuda, dtype):
    assert k5_digest(dtype, cuda) == K5_DIGESTS[dtype]


K5_KERNELS = ("batchchol_streamed", "batchchol_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,n,kernel", [
    (512, 64, "batchchol_streamed"), (256, 128, "batchchol_streamed"),
    (7, 48, "batchchol_streamed"), (7, 32, "batchchol_kernel"),
    (7, 256, "batchchol_kernel")])
def test_batched_blocked_cholesky_kernel_by_shape(cuda, k, n, kernel,
                                                  dtype):
    """Which of K5's kernels runs, read from a profiler trace: the streamed
    one at the mid-size path's shapes and wherever rows of 48 <= n fit in
    shared memory, cholstage.cuh's blocked_cholesky for a warp's n <= 32
    and, in place, at n = 256; the factors within 1e-5 (float32) or 1e-10
    of the plain version's largest entry."""
    from libdogleg_tpu_torch.ops import batchchol
    rng = np.random.default_rng(k + n)
    A = torch.as_tensor(rng.normal(size=(k, n, n)), device=cuda)
    S = (A @ A.mT / n + torch.eye(n, dtype=A.dtype, device=cuda)).to(dtype)
    ran = _kernels_run(lambda: batchchol.batched_blocked_cholesky(S),
                       K5_KERNELS, {kernel})
    assert ran == {kernel}
    L, ok = batchchol.batched_blocked_cholesky(S)
    Lr, _ = batchchol.batched_blocked_cholesky_reference(S)
    assert bool(ok.all())
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    assert float((L - Lr).abs().max() / Lr.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("batch", [1, 7])
def test_batched_blocked_cholesky_hard_cases(cuda, batch, dtype, tol):
    """K5 where it is hard: n = 40, padded to 48, a single matrix, and a
    batch of 7 whose matrix 3 is not SPD. ok is torch.bool and flags that
    matrix alone; the others are within tol of the plain version's largest
    entry; zeros above the diagonal; one launch."""
    from libdogleg_tpu_torch.ops import batchchol
    n = 40
    rng = np.random.default_rng(batch)
    A = torch.as_tensor(rng.normal(size=(batch, n, n)), device=cuda)
    S = (A @ A.mT + n * torch.eye(n, dtype=A.dtype, device=cuda)).to(dtype)
    want = [True] * batch
    if batch > 3:
        S[3, 30, 30] = -S[3, 30, 30]
        want[3] = False
    before = batchchol.launch_count
    L, ok = batchchol.batched_blocked_cholesky(S)
    torch.cuda.synchronize()
    assert batchchol.launch_count == before + 1
    assert ok.dtype == torch.bool and L.shape == S.shape
    Lr, okr = batchchol.batched_blocked_cholesky_reference(S)
    assert ok.tolist() == okr.tolist() == want
    assert bool((torch.triu(L, 1) == 0).all())
    good = ok.nonzero()[:, 0]
    err = float((L[good] - Lr[good]).abs().max() / Lr[good].abs().max())
    assert err < tol, err


def k3_digest(dtype, device) -> str:
    """SHA-256 of K3's blocks of J^T J on the 32x32x8 grid model's
    dense-coupling structure (the word kernel's case), with values uniform
    in [-1, 1) from a numpy seed, drawn in float64 and rounded to dtype
    elementwise, so that every machine gets the same bits."""
    import hashlib

    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian
    s = grid_mrf.make_grid_mrf(32, 32, 8, coupling="dense", dtype=dtype,
                               device=device).structure
    vals = np.random.default_rng(3).uniform(
        -1.0, 1.0, size=(s.nnzb, s.block_rows, s.block_cols))
    blocks, _ = tk.bcsr_jtj_blocks_kernel(
        BCSRJacobian(s, torch.as_tensor(vals, dtype=dtype, device=device)))
    return hashlib.sha256(blocks.cpu().numpy().tobytes()).hexdigest()


# k3_digest of the kernel as it stood before the word kernel (one thread
# block per output block, H100, CUDA 12.8): the word kernel sums in the
# same order and changes no bit
K3_DIGESTS = {
    torch.float32:
        "81e0a27f04091f190c397d0a75dbe43317fa4160a9ad296a4addc58995c2ce77",
    torch.float64:
        "6d89bd152a1e7965b92205a26cb853c170a008ddaff351145938647f77e1791c",
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bcsr_jtj_bits_unchanged(cuda, dtype):
    assert k3_digest(dtype, cuda) == K3_DIGESTS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", ["grid", (8, 8), (3, 5), (4, 8)])
def test_jtj_kernel_instances(cuda, case, dtype, rtol):
    """K3's two kernels against its plain version on the card, within rtol
    of the largest entry: the grid model's J and random patterns with empty
    block rows; an (8, 8) J also through values that are not 16-byte
    aligned, which take the generic kernel and give the same bits. The
    kernel that ran, read from a profiler trace, is the one jtj_instance
    names for aligned values, and jtj_blocks for the unaligned ones."""
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian
    if case == "grid":
        g = grid_mrf.make_grid_mrf(9, 7, 8, coupling="dense", dtype=dtype,
                                   device=cuda)
        J = BCSRJacobian(g.structure, g.problem(jtj="dense").f(g.p_true)[1])
    else:
        J = _random_bcsr(61, 13, *case, seed=sum(case) + 1, dtype=dtype,
                         device=cuda)
    s = J.structure
    want = tk.bcsr_jtj_blocks_reference(J, tk.build_jtj_schedule(s))
    before = tk.launch_counts["bcsr_jtj_blocks_kernel"]
    got, sched = tk.bcsr_jtj_blocks_kernel(J)
    torch.cuda.synchronize()
    assert tk.launch_counts["bcsr_jtj_blocks_kernel"] == before + 1
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))
    kernels = {"words": "jtj_words", "entries": "jtj_blocks"}
    instance = tk.jtj_instance(s.block_rows, s.block_cols, dtype)
    assert instance == ("words" if (s.block_rows, s.block_cols) == (8, 8)
                        else "entries")
    ran = _kernels_run(lambda: tk.bcsr_jtj_blocks_kernel(J, sched),
                       kernels.values(), {kernels[instance]})
    assert ran == {kernels[instance]}
    if instance == "words":
        buf = torch.empty(J.values.numel() + 1, dtype=dtype, device=cuda)
        shifted = buf[1:].view(J.values.shape)
        shifted.copy_(J.values)
        assert shifted.data_ptr() % 16
        Js = BCSRJacobian(s, shifted)
        other, _ = tk.bcsr_jtj_blocks_kernel(Js, sched)
        torch.cuda.synchronize()
        assert torch.equal(other, got)
        ran = _kernels_run(lambda: tk.bcsr_jtj_blocks_kernel(Js, sched),
                           kernels.values(), {"jtj_blocks"})
        assert ran == {"jtj_blocks"}


def _midsize(nstate, batch, dtype, device):
    """The tanh residual family r = A tanh(B p) + C p - d, one instance per
    element."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(batch, 4 * nstate, nstate))
    Bm = rng.normal(size=(batch, nstate, nstate)) * 0.5 / np.sqrt(nstate)
    C = rng.normal(size=(batch, 4 * nstate, nstate)) * 0.3
    p_true = rng.normal(size=(batch, nstate))
    d = (np.einsum('bms,bs->bm', A,
                   np.tanh(np.einsum('bst,bt->bs', Bm, p_true)))
         + np.einsum('bms,bs->bm', C, p_true)
         + rng.normal(size=(batch, 4 * nstate)) * 0.01)
    p0 = p_true + rng.normal(size=(batch, nstate)) * 0.1

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return (t(A), t(Bm), t(C), t(d)), t(p0), p_true


def _midsize_products(p, data):
    from libdogleg_tpu_torch import Products
    Ab, Bb, Cb, db = data
    t = torch.tanh(Bb @ p)
    x = Ab @ t + Cb @ p - db
    J = Ab @ ((1.0 - t * t)[:, None] * Bb) + Cb
    return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)


@pytest.mark.cuda
def test_midsize_batched_optimize_launches_k5(cuda):
    """Nstate 64, batch 128: the gate's strategy factors with K5 on the
    card and takes the CPU's decisions in float64; the compacted entry
    point gives the same."""
    from libdogleg_tpu_torch.ops import batchchol
    from libdogleg_tpu_torch.parallel import batched_optimize_compacted
    data, p0, p_true = _midsize(64, 128, torch.float64, cuda)
    before, k1 = batchchol.launch_count, mega.launch_count
    r = batched_optimize(_midsize_products, p0, problem_data=data)
    torch.cuda.synchronize()
    assert batchchol.launch_count > before and mega.launch_count == k1
    assert bool((r.reason > 0).all())
    assert np.all(np.abs(r.p.cpu().numpy() - p_true) < 0.05)
    data_c, p0_c, _ = _midsize(64, 128, torch.float64, "cpu")
    r_c = batched_optimize(_midsize_products, p0_c, problem_data=data_c)
    r_k = batched_optimize_compacted(_midsize_products, p0,
                                     problem_data=data, compact_capacity=4)
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r, field).cpu(), getattr(r_c, field))
        assert torch.equal(getattr(r_k, field), getattr(r, field))
    np.testing.assert_allclose(r.p.cpu().numpy(), r_c.p.numpy(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(r_k.p.cpu().numpy(), r.p.cpu().numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("n", [8, 24, 40, 100, 128, 256])
def test_tri_solve_right_shapes(cuda, n, k, dtype, tol):
    """K7 against its plain version on the card: both of its kernels (one
    thread per row of X up to n = 32, the blocked one above), n that is and
    is not a multiple of a column block or of a 16-byte word, m below and
    above a block's rows, one launch per call, and a view whose rows do not
    start on 16 bytes."""
    from libdogleg_tpu_torch.ops import tilechol
    rng = np.random.default_rng(100 * n + k)
    D = torch.linalg.cholesky(
        torch.as_tensor(_spd(n, rng, batch=(k,)), device=cuda)).to(dtype)
    for m in (1, 3, 37, n, 130):
        C = torch.as_tensor(rng.normal(size=(k, m, n)), dtype=dtype,
                            device=cuda)
        before = tilechol.launch_counts["tri_solve_right"]
        X = tilechol.tri_solve_right(D, C)
        torch.cuda.synchronize()
        assert tilechol.launch_counts["tri_solve_right"] == before + 1
        Xr = tilechol.tri_solve_right_reference(D, C)
        assert X.shape == C.shape
        assert float((X - Xr).abs().max() / Xr.abs().max()) < tol, m
    # a row of NaN in C stays in its row
    C[k - 1, 2] = float("nan")
    bad = torch.isnan(tilechol.tri_solve_right(D, C))
    assert bool(bad[k - 1, 2].all()) and int(bad.sum()) == n
    # operands one element into a larger buffer: not 16-byte aligned
    buf = torch.zeros(k * n * n + 1, dtype=dtype, device=cuda)
    Dv = buf[1:].view(k, n, n).copy_(D)
    X = tilechol.tri_solve_right(Dv, C[:, :5].contiguous())
    Xr = tilechol.tri_solve_right_reference(D, C[:, :5].contiguous())
    keep = ~torch.isnan(Xr)
    assert float((X[keep] - Xr[keep]).abs().max() / Xr[keep].abs().max()) < tol


def _random_bcsr(nbrow, nbcol, bm, bn, seed, dtype, device):
    """A block-CSR Jacobian on a random pattern whose first, middle and
    last block rows are empty."""
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian, BCSRStructure
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(nbrow, nbcol)) < 0.3
    mask[:, 0] = True
    mask[[0, nbrow // 2, nbrow - 1]] = False
    indptr = np.concatenate([[0], np.cumsum(mask.sum(1))]).astype(np.int32)
    indices = np.nonzero(mask)[1].astype(np.int32)
    s = BCSRStructure(nmeas=nbrow * bm, nstate=nbcol * bn, block_rows=bm,
                      block_cols=bn, indptr=indptr, indices=indices)
    values = torch.as_tensor(rng.normal(size=(s.nnzb, bm, bn)), dtype=dtype,
                             device=device)
    return BCSRJacobian(s, values)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("case", ["grid", (8, 8), (4, 8), (4, 4), (3, 5),
                                  (32, 128)])
def test_matvec_kernel_shapes(cuda, case, dtype, rtol):
    """K4 against its plain version on the card: the grid model's J and
    random patterns with empty block rows, the block shapes of both of its
    kernels; the second call on a structure finds its indices on the card;
    a v that is not 16-byte aligned takes the generic kernel."""
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian
    if case == "grid":
        g = grid_mrf.make_grid_mrf(9, 7, 8, coupling="dense", dtype=dtype,
                                   device=cuda)
        J = BCSRJacobian(g.structure, g.problem(jtj="dense").f(g.p_true)[1])
    else:
        J = _random_bcsr(61, 13, *case, seed=sum(case), dtype=dtype,
                         device=cuda)
    s = J.structure
    rng = np.random.default_rng(3)
    buf = torch.as_tensor(rng.normal(size=s.nstate + 1), dtype=dtype,
                          device=cuda)
    for v in (buf[:-1], buf[1:]):
        want = tk.bcsr_matvec_reference(J, v)
        before = tk.launch_counts["bcsr_matvec_kernel"]
        got = tk.bcsr_matvec_kernel(J, v)
        torch.cuda.synchronize()
        assert tk.launch_counts["bcsr_matvec_kernel"] == before + 1
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()))
    held = tk._DEVICE_INDICES[id(s.indptr)]
    assert list(held) == [("", J.values.device)]
    assert tk.device_indices(s.indptr, J.values.device) is held[
        ("", J.values.device)]


@pytest.mark.cuda
def test_launch_target_is_the_current_stream(cuda):
    """The handle the kernels launch on is PyTorch's current stream, on the
    default stream and inside a stream context."""
    from libdogleg_tpu_torch.native.loader import launch_target
    assert launch_target(cuda) == (
        cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert launch_target(cuda)[1] == side.cuda_stream


def _error_free_pairs(n, seed, dtype, device):
    """n pairs with exponents spanning -60..60, the pair's exponents summing
    to at least -96, so that the exact error of a * b is no subnormal."""
    rng = np.random.default_rng(seed)
    ea = rng.integers(-60, 61, n)
    eb = rng.integers(np.maximum(-60, -96 - ea), 61)

    def draw(e):
        m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
        return torch.as_tensor(np.ldexp(m, e), dtype=dtype, device=device)
    return draw(ea), draw(eb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_error_free_transforms_exact_on_card(cuda, dtype):
    """Hazard F2: the kernel's two_prod (fma) and two_sum (uncontracted)
    are exact, and bit for bit the eager split forms."""
    a, b = _error_free_pairs(1 << 16, 7, dtype, cuda)
    got = mega.error_free_transforms(a, b)
    want = mega.error_free_transforms_reference(a, b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if dtype == torch.float32:
        p, e, s, es = (t.double() for t in got)
        assert torch.equal(p + e, a.double() * b.double())
        assert torch.equal(s + es, a.double() + b.double())


def _factored_instances(seed, batch, dtype, device):
    p0, meas, _, _ = _instances(seed, batch, dtype, device)
    return (p0, *qs.factored_statistics(meas),
            qs.gram_pair(dtype, device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,rtol_jtj",
                         [(torch.float64, 1e-12, 1e-12),
                          (torch.float32, 1e-6, 1e-5)])
def test_factored_products_device_function_matches_twin(cuda, dtype, rtol,
                                                        rtol_jtj):
    """The tolerances of tests/test_pallas_mega.py:177-183."""
    p0, hh, hl, nh, nl, G = _factored_instances(3, 1000, dtype, cuda)
    for p in (p0, torch.as_tensor(qs.P_TRUE, dtype=dtype, device=cuda)
              + 1e-3 * p0):
        n2, jtx, jtj = mega.factored_products_device(p, (hh, hl, nh, nl), G)
        tn2, tjtx, tjtj = qs.factored_products_minor(
            p.t(), hh.t(), hl.t(), nh[None], nl[None], *G)
        np.testing.assert_allclose(n2.cpu().numpy(), tn2[0].cpu().numpy(),
                                   rtol=rtol)
        np.testing.assert_allclose(jtx.cpu().numpy(),
                                   tjtx.t().cpu().numpy(), rtol=rtol,
                                   atol=1e-8)
        # the kernel computes JtJ's lower triangle and mirrors it; the
        # twin's upper triangle sums the same terms in another order
        assert torch.equal(jtj, jtj.mT)
        np.testing.assert_allclose(
            torch.tril(jtj).cpu().numpy(),
            torch.tril(tjtj.permute(2, 0, 1)).cpu().numpy(), rtol=rtol_jtj)


@pytest.mark.cuda
def test_factored_kernel_f64_decisions_equal_twin(cuda):
    args = _factored_instances(0, 1000, torch.float64, cuda)
    before = mega.factored_launch_count
    r_k = mega.megakernel_optimize_factored(*args)
    torch.cuda.synchronize()
    assert mega.factored_launch_count == before + 1
    r_t = mega.megakernel_optimize_factored_reference(*args)
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r_k, field), getattr(r_t, field)), field
    np.testing.assert_allclose(r_k.p.cpu().numpy(), r_t.p.cpu().numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_batched_optimize_launches_factored_kernel(cuda):
    p0, hh, hl, nh, nl, G = _factored_instances(2, 256, torch.float32, cuda)
    before = (mega.launch_count, mega.factored_launch_count)
    r = batched_optimize(qs.factored_products_fn(G), p0, BENCH,
                         problem_data=(hh, hl, nh, nl))
    assert (mega.launch_count, mega.factored_launch_count) == (
        before[0], before[1] + 1)
    assert r.p.is_cuda and r.p.shape == (256, qs.NSTATE)
    assert bool((r.reason > 0).all())
    err = np.abs(r.p.cpu().double().numpy() - qs.P_TRUE)
    assert np.mean(np.all(err < 0.2, axis=1)) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_products_device_function_matches_grouped_order(cuda, dtype, rtol):
    """The general device function against its order of summation in plain
    PyTorch, with the library's lanes per problem: nvcc fuses a product and
    a sum where the plain version rounds twice, so each result is within
    rtol of products_magnitude, at the starts and near the truth."""
    p0, meas, gx, gy = _instances(4, 1000, dtype, cuda)
    near = torch.as_tensor(qs.P_TRUE, dtype=dtype, device=cuda) + 1e-2 * p0
    for p in (p0, near):
        got = mega.products_device(p, meas, gx, gy)
        want = mega.grouped_products_reference(p, meas, gx, gy,
                                               mega.kernel_group())
        for g, w, m in zip(got, want,
                           mega.products_magnitude(p, meas, gx, gy)):
            assert bool(((g - w).abs() <= rtol * m).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 1000, 8193])
@pytest.mark.parametrize("factored", [False, True])
def test_kernel_f64_decisions_at_ragged_batches(cuda, batch, factored):
    """Batches that are no multiple of a group, a warp or a block: a lane
    past the batch computes and writes nothing."""
    if factored:
        args = _factored_instances(10 + batch % 7, batch, torch.float64, cuda)
        fn, twin = (mega.megakernel_optimize_factored,
                    mega.megakernel_optimize_factored_reference)
    else:
        args = _instances(10 + batch % 7, batch, torch.float64, cuda)
        fn, twin = mega.megakernel_optimize, mega.megakernel_optimize_reference
    r_k, r_t = fn(*args), twin(*args)
    torch.cuda.synchronize()
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r_k, field), getattr(r_t, field)), field
    np.testing.assert_allclose(r_k.p.cpu().numpy(), r_t.p.cpu().numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r_k.JtJ.cpu().numpy(), r_t.JtJ.cpu().numpy(),
                               rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("factored", [False, True])
def test_kernel_f32_rule_at_b8192(cuda, factored):
    """Float32 under the benchmark rule: decision agreement with the twin
    (>= 0.85 general, >= 0.99 factored), recovered_frac >= 0.99, norm2 within
    the tolerances of test_kernel_f32_agrees_with_twin."""
    if factored:
        args = _factored_instances(1, 8192, torch.float32, cuda)
        fn, twin = (mega.megakernel_optimize_factored,
                    mega.megakernel_optimize_factored_reference)
    else:
        args = _instances(1, 8192, torch.float32, cuda)
        fn, twin = mega.megakernel_optimize, mega.megakernel_optimize_reference
    r_k, r_t = fn(*args, BENCH), twin(*args, BENCH)
    same = ((r_k.step_count == r_t.step_count)
            & (r_k.n_attempts == r_t.n_attempts)).float().mean().item()
    assert same >= (0.99 if factored else 0.85)
    np.testing.assert_allclose(r_k.norm2_x.cpu().numpy(),
                               r_t.norm2_x.cpu().numpy(), rtol=1e-2,
                               atol=1e-4)
    err = np.abs(r_k.p.cpu().double().numpy() - qs.P_TRUE)
    assert np.mean(np.all(err < 0.2, axis=1)) >= 0.99


@pytest.mark.cuda
def test_public_call_does_not_wait_for_the_card(cuda):
    """After its first call, batched_optimize on the kernel's path copies
    nothing from the host and synchronizes nothing."""
    p0, meas, _, _ = _instances(2, 256, torch.float32, cuda)
    batched_optimize(qs.products, p0, BENCH, problem_data=meas)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched_optimize(qs.products, p0, BENCH, problem_data=meas)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# bundle adjustment through Schur elimination (no kernel of K1-K7 on its
# path): float64 decisions on the card against the CPU, and the camera-axis
# reductions deterministic
# ---------------------------------------------------------------------------

def _ba_small(name, device):
    """(products, strategy, start) of a small float64 BA instance, the same
    on every device (the pinhole starts from one CPU generator)."""
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    if name.startswith("linear"):
        ba = lba.make_synthetic(seed=3, nc=8, n_points=50,
                                dtype=torch.float64, device=device)
        if name == "linear-tree":
            return ba.products_tree, ba.tree_newton_solver(), ba.p0_tree()
        return (ba.products, ba.newton_solver(),
                torch.zeros(ba.nstate, dtype=torch.float64, device=device))
    ba = (pba.make_synthetic(seed=0, ncam=4, npts=60, device=device)
          if name == "dense" else
          pba.make_synthetic_sparse(seed=0, ncam=8, npts=80, k_obs=3,
                                    device=device))
    return (ba.products, ba.newton_solver(),
            ba.p0(torch.Generator().manual_seed(2), jitter=0.02))


def _flat_p(p):
    if isinstance(p, dict):
        return torch.cat([p["c"].reshape(-1), p["q"].reshape(-1)]).cpu()
    return p.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["linear", "linear-tree", "dense",
                                  "sparse"])
def test_ba_f64_decisions_card_equal_cpu(cuda, name):
    from libdogleg_tpu_torch import solve_products
    out = []
    for device in (cuda, torch.device("cpu")):
        fn, ns, p0 = _ba_small(name, device)
        out.append(solve_products(fn, p0, DoglegParameters(),
                                  newton_solver=ns, record_history=True))
    r_d, r_c = out
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r_d, field)) == int(getattr(r_c, field)), field
    assert torch.equal(r_d.history.step_type.cpu(), r_c.history.step_type)
    np.testing.assert_allclose(_flat_p(r_d.p).numpy(), _flat_p(r_c.p).numpy(),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_ba_camera_reductions_deterministic(cuda):
    """The one-hot camera reduction (chunked at 25.6M one-hot elements),
    the sparse and generic pinhole products and the Schur factor give the
    same bits on two runs, and the reduction agrees with float64 on the
    CPU."""
    import dataclasses

    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.ops import newton
    rng = np.random.default_rng(0)
    cam_of = torch.as_tensor(rng.integers(0, 128, size=(50000, 4)),
                             device=cuda)
    vals = torch.as_tensor(rng.normal(size=(50000, 4, 6)),
                           dtype=torch.float32, device=cuda)
    a = newton.onehot_cam_reduce(cam_of, vals, 128)
    b = newton.onehot_cam_reduce(cam_of, vals, 128)
    assert torch.equal(a, b)
    want = newton.onehot_cam_reduce(cam_of.cpu(), vals.double().cpu(), 128)
    np.testing.assert_allclose(a.double().cpu().numpy(), want.numpy(),
                               rtol=0, atol=1e-4 * float(want.abs().max()))

    ba = pba.make_synthetic_sparse(seed=1, ncam=16, npts=4000, k_obs=4,
                                   dtype=torch.float32, device=cuda)
    dense = pba.make_synthetic(seed=1, ncam=4, npts=300, dtype=torch.float32,
                               device=cuda)
    perm = torch.as_tensor(np.random.default_rng(2).permutation(dense.nobs),
                           device=cuda)
    generic = dataclasses.replace(dense, cam_idx=dense.cam_idx[perm],
                                  pt_idx=dense.pt_idx[perm],
                                  obs=dense.obs[perm])
    assert not generic.dense_grid
    for model in (ba, dense, generic):
        p = model.p0(torch.Generator().manual_seed(3), jitter=0.02)
        ns = model.newton_solver()
        pr = [model.products(p) for _ in range(2)]
        assert torch.equal(pr[0].Jt_x["c"], pr[1].Jt_x["c"])
        assert torch.equal(pr[0].Jt_x["q"], pr[1].Jt_x["q"])
        assert torch.equal(pr[0].JtJ.U, pr[1].JtJ.U)
        assert torch.equal(pr[0].JtJ.V, pr[1].JtJ.V)
        lam = torch.tensor(1e-3, device=cuda)
        (Lv1, Ls1), ok1 = ns.factor(pr[0].JtJ, lam)
        (Lv2, Ls2), ok2 = ns.factor(pr[1].JtJ, lam)
        assert bool(ok1) and bool(ok2)
        assert torch.equal(Lv1, Lv2) and torch.equal(Ls1, Ls2)


@pytest.mark.cuda
def test_ba_constructors_default_to_the_card(cuda):
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    assert lba.make_synthetic(nc=4, n_points=5).A.is_cuda
    assert pba.make_synthetic(ncam=2, npts=5).obs.is_cuda
    assert pba.make_synthetic_sparse(ncam=4, npts=5, k_obs=2).cam_of.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(8, 5), (8, 8), (64, 10), (64, 64)])
def test_cholesky_solve_matrix_rhs_on_card(cuda, n, k):
    """cholesky_solve's (n, k) right-hand sides on the card against the
    CPU, float64, both branches."""
    from libdogleg_tpu_torch.ops.cholesky import cholesky_solve
    rng = np.random.default_rng(n + k)
    L = torch.linalg.cholesky(torch.as_tensor(_spd(n, rng)))
    b = torch.as_tensor(rng.normal(size=(n, k)))
    got = cholesky_solve(L.to(cuda), b.to(cuda)).cpu()
    want = cholesky_solve(L, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("feature_size", [1, 2, 4])
def test_outlierness_factors_card_equal_cpu(cuda, feature_size):
    """get_outlierness_factors on the card, float64, against the CPU
    (rtol 1e-9), and in float32 finite and within 1e-3 of float64."""
    from libdogleg_tpu_torch.analysis import get_outlierness_factors
    from libdogleg_tpu_torch.ops.cholesky import factorize_jtj
    rng = np.random.default_rng(5)
    J_np, x_np = rng.normal(size=(4000, 64)), rng.normal(size=4000)
    out = {}
    for device, dtype in ((cuda, torch.float64), ("cpu", torch.float64),
                          (cuda, torch.float32)):
        J = torch.as_tensor(J_np, dtype=dtype, device=device)
        x = torch.as_tensor(x_np, dtype=dtype, device=device)
        L = factorize_jtj(J.T @ J, torch.zeros((), dtype=dtype,
                                               device=device)).L
        out[(str(device), dtype)] = get_outlierness_factors(
            x, J, L, feature_size=feature_size)[0].cpu()
    f_card, f_cpu = out[("cuda", torch.float64)], out[("cpu", torch.float64)]
    f32 = out[("cuda", torch.float32)]
    np.testing.assert_allclose(f_card.numpy(), f_cpu.numpy(), rtol=1e-9)
    assert bool(torch.isfinite(f32).all())
    np.testing.assert_allclose(f32.double().numpy(), f_cpu.numpy(),
                               rtol=1e-3)


@pytest.mark.cuda
def test_ba_outlierness_on_card(cuda):
    """get_outlierness_factors_ba at a small size in float64: the card
    against the CPU (rtol 1e-7: the factors of this instance amplify
    rounding ~1e8 times), two passes the same bits, the factorization
    passed in the bits of the fresh one, NaN everywhere when it fails."""
    from libdogleg_tpu_torch import solve_products
    from libdogleg_tpu_torch.analysis import get_outlierness_factors_ba
    from libdogleg_tpu_torch.models import pinhole_ba as pba

    def same_bits(a, b):
        return torch.equal(a.view(torch.int64), b.view(torch.int64))

    out, r = [], None
    for device in (torch.device("cpu"), cuda):
        ba = pba.make_synthetic_sparse(seed=3, ncam=6, npts=60, k_obs=3,
                                       dtype=torch.float64, device=device)
        if r is None:
            r = solve_products(ba.products, ba.p0(
                torch.Generator().manual_seed(2), jitter=0.02),
                DoglegParameters(), newton_solver=ba.newton_solver())
        p = {k: v.to(device) for k, v in r.p.items()}
        robs, Jc, Jq = ba.observation_jacobians(p)
        JtJ, ns = ba.products(p).JtJ, ba.newton_solver()
        lam, n2 = r.lam.to(device), r.norm2_x.to(device)
        nmeas = 2 * ba.nobs + 6 + 3 * ba.npts

        def run(**kw):
            return get_outlierness_factors_ba(robs, Jc, Jq, JtJ, lam, n2,
                                              nmeas, ns, chunk=16, **kw)[0]
        f = run()
        assert same_bits(f, run())
        assert same_bits(f, run(factorization=ns.factor(JtJ, lam)))
        bad = get_outlierness_factors_ba(
            robs, Jc, Jq, JtJ, torch.full_like(lam, -1e6), n2, nmeas, ns)[0]
        assert bool(torch.isnan(bad).all())
        out.append(f.cpu())
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), rtol=1e-7,
                               atol=1e-10)


@pytest.mark.cuda
def test_windowed_traces_on_card_sparse_factor(cuda):
    """Windowed query traces on the card off a small grid's supernodal
    factor (kernels K6, K7) against its dense factor, float64, windows
    past both ends."""
    from libdogleg_tpu_torch import SparseProblem
    from libdogleg_tpu_torch.analysis import (
        outlierness_trace_new_features_windowed)
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops.cholesky import factorize_jtj
    g = grid_mrf.make_grid_mrf(6, 5, 3, dtype=torch.float64, device=cuda)
    prob = SparseProblem(f=g.problem(jtj="dense").f, structure=g.structure,
                         jtj="sparse", ordering="rcm", amalgamate=4)
    p = torch.zeros(g.nstate, dtype=torch.float64, device=cuda)
    pr = prob.products(p)
    sn = prob.default_newton_solver()
    be = sn._backend()
    zero = torch.zeros((), dtype=torch.float64, device=cuda)
    Lb, ok = be.factorize(sn.symbolic, pr.JtJ, zero)
    assert bool(ok)
    Ld = factorize_jtj(g.problem(jtj="dense").products(p).JtJ, zero).L
    rng = np.random.default_rng(4)
    Jq = torch.as_tensor(rng.normal(size=(20, 2, 6)), device=cuda)
    starts = torch.as_tensor(rng.integers(-4, g.nstate - 2, size=20),
                             device=cuda)
    t_sp = outlierness_trace_new_features_windowed(
        Jq, starts, None, pr.norm2_x, 500, nstate=g.nstate,
        solve_fn=lambda r: be.solve(sn.symbolic, Lb, r))
    t_d = outlierness_trace_new_features_windowed(Jq, starts, Ld,
                                                  pr.norm2_x, 500)
    assert t_sp.is_cuda
    np.testing.assert_allclose(t_sp.cpu().numpy(), t_d.cpu().numpy(),
                               rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [["--diag", "vnlog", "dense"],
                                  ["--diag", "human", "sparse"],
                                  ["--test-gradients", "residual"],
                                  ["--test-gradients",
                                   "dense-products-unpacked"]])
def test_sample_diagnostic_streams_on_card(cuda, argv, capsys):
    from libdogleg_tpu_torch import sample
    assert sample.main(["--device", "cuda"] + argv) == 0
    out = capsys.readouterr().out
    assert out.startswith({"vnlog": "# iteration step_accepted",
                           "human": "libdogleg-tpu: attempt 0:"}.get(
        argv[1], "# ivar "))


@pytest.mark.cuda
def test_profile_op_summary_sums_device_events(cuda):
    from libdogleg_tpu_torch.diagnostics import profile_op_summary
    a = torch.ones(512, 512, device=cuda)
    lines = profile_op_summary(lambda: a @ a, top=4).split("\n")
    assert lines[0].split() == ["ms", "calls", "op"] and len(lines) >= 2
    assert not any(row.split(None, 2)[2].startswith("aten::")
                   for row in lines[1:])


def _pinhole_batch(device, dtype, batch=6, npts=48):
    """A config 9 batch at a small size: per-element observations obs +
    0.5 N(0, 1) and starts p_true + 0.02 N(0, 1) from CPU generators, so
    every device gets the same inputs."""
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    ba = pba.make_synthetic(seed=0, ncam=4, npts=npts, dtype=dtype,
                            device=device)
    g = torch.Generator().manual_seed(8)
    obs_b = ba.obs[None] + 0.5 * torch.randn(
        (batch,) + tuple(ba.obs.shape), generator=g,
        dtype=dtype).to(device)
    p0 = {k: v[None] + 0.02 * torch.randn(
        (batch,) + tuple(v.shape), generator=g, dtype=dtype).to(device)
        for k, v in sorted(ba.p_true.items())}
    return ba, obs_b, p0


def _batched_schur_solve(device, dtype, **kw):
    ba, obs_b, p0 = _pinhole_batch(device, dtype)
    return batched_optimize(ba.products_obs, p0, BENCH, problem_data=obs_b,
                            newton_solver=ba.newton_solver(), **kw)


@pytest.mark.cuda
def test_batched_schur_f64_card_equal_cpu(cuda):
    """The batched tree solve (TreeSchurNewtonSolver, per-element
    observations, History) takes the same decisions on the card as on the
    CPU in float64."""
    r_d = _batched_schur_solve(cuda, torch.float64, record_history=True)
    r_c = _batched_schur_solve("cpu", torch.float64, record_history=True)
    for field in ("step_count", "n_attempts", "reason", "lam"):
        assert torch.equal(getattr(r_d, field).cpu(), getattr(r_c, field))
    assert torch.equal(r_d.history.step_type.cpu(), r_c.history.step_type)
    for name in ("c", "q"):
        np.testing.assert_allclose(r_d.p[name].cpu().numpy(),
                                   r_c.p[name].numpy(), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.cuda
def test_batched_schur_f32_two_runs_same_bits(cuda):
    from libdogleg_tpu_torch.ops import treevec as tv
    a = _batched_schur_solve(cuda, torch.float32)
    b = _batched_schur_solve(cuda, torch.float32)
    for x, y in zip(tv.tree_leaves(a), tv.tree_leaves(b)):
        assert torch.equal(x, y)
    assert bool((a.reason > 0).all())


@pytest.mark.cuda
def test_block_diag_and_batched_schur_factor_card_equal_cpu(cuda):
    """block_diag bit for bit and the batched Schur factor within 1e-10 of
    the CPU's largest entry in float64 (S = U - sum W Vhat^-1 W^T cancels
    against the 1e6 gauge prior: the card's and the CPU's orders of
    summation differ by 1.1e-11 of it on this instance), with one
    element's point block singular: only that element's ok is False."""
    from libdogleg_tpu_torch.ops import newton
    rng = np.random.default_rng(3)
    blocks = torch.as_tensor(rng.normal(size=(3, 5, 3, 3)))
    assert torch.equal(newton.block_diag(blocks.to(cuda)).cpu(),
                       newton.block_diag(blocks))
    ba, obs_b, p0 = _pinhole_batch("cpu", torch.float64)
    pr = torch.func.vmap(ba.products_obs)(p0, obs_b)
    V = pr.JtJ.V.clone()
    V[2, 5] = 0.0
    jtj = newton.SchurJtJ(U=pr.JtJ.U, W=pr.JtJ.W, V=V)
    lam = torch.zeros(6, dtype=torch.float64)
    ns = ba.newton_solver()
    (Lv, Ls), ok = ns.factor(jtj, lam)
    (Lv_d, Ls_d), ok_d = ns.factor(
        newton.SchurJtJ(*(t.to(cuda) for t in jtj)), lam.to(cuda))
    assert ok.tolist() == [True, True, False, True, True, True]
    assert torch.equal(ok_d.cpu(), ok)
    for got, want in ((Lv_d, Lv), (Ls_d, Ls)):
        good = want[ok]
        np.testing.assert_allclose(got.cpu()[ok].numpy(), good.numpy(),
                                   rtol=0,
                                   atol=1e-10 * float(good.abs().max()))


def _same_state_bits(a, b):
    """Every field of two solve states equal, tensors bit for bit."""
    from libdogleg_tpu_torch.ops import treevec as tv
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or isinstance(x, (bool, int)):
            assert x == y and type(x) is type(y), name
            continue
        for u, v in zip(tv.tree_leaves(x), tv.tree_leaves(y)):
            if u.dtype in ints:
                u, v = u.view(ints[u.dtype]), v.view(ints[v.dtype])
            assert u.shape == v.shape and torch.equal(u, v), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segmented_single_solve_same_bits_on_card(cuda, dtype):
    """curve_fit (config 2's family) on the card: one attempt a segment
    gives the one-shot run's bits, History included."""
    from libdogleg_tpu_torch import init_solver_state, run_solver
    from libdogleg_tpu_torch.models import curve_fit as cf
    g = torch.Generator().manual_seed(3)
    meas = cf.simulate(g, dtype=dtype, device=cuda)
    p0 = cf.initial_state(g, dtype=dtype, device=cuda)
    prod = cf.make_dense_problem(meas).products
    one = run_solver(prod, init_solver_state(prod, p0, BENCH,
                                             record_history=True), BENCH)
    st = init_solver_state(prod, p0, BENCH, record_history=True)
    while not st.done:
        st = run_solver(prod, st, BENCH, max_new_attempts=1)
    assert st.n_attempts == one.n_attempts > 1
    _same_state_bits(st, one)


@pytest.mark.cuda
def test_checkpoint_round_trip_onto_card(cuda, tmp_path):
    """The mid-size batch (K5 on the card) after 2 attempts, saved, loaded
    onto the card by default, and run on: the one-shot run's bits, K5
    launched in both segments."""
    from libdogleg_tpu_torch import (BlockedDenseNewtonSolver, checkpoint,
                                     init_batched_state, run_batched_solver)
    from libdogleg_tpu_torch.ops import batchchol
    data, p0, _ = _midsize(64, 128, torch.float32, cuda)
    vf = torch.func.vmap(_midsize_products)

    def products(p):
        return vf(p, data)
    ns = BlockedDenseNewtonSolver()
    one = run_batched_solver(products, init_batched_state(products, p0,
                                                          BENCH),
                             BENCH, newton_solver=ns)
    before = batchchol.launch_count
    st = run_batched_solver(products, init_batched_state(products, p0,
                                                         BENCH),
                            BENCH, newton_solver=ns, max_new_attempts=2)
    first = batchchol.launch_count - before
    path = str(tmp_path / "mid.npz")
    checkpoint.save_state(path, st)
    loaded = checkpoint.load_state(path)
    assert loaded.p.is_cuda
    _same_state_bits(loaded, st)
    before = batchchol.launch_count
    fin = run_batched_solver(products, loaded, BENCH, newton_solver=ns)
    assert first >= 1 and batchchol.launch_count > before
    _same_state_bits(fin, one)


@pytest.mark.cuda
def test_batched_sparse_w_f64_card_equal_cpu(cuda):
    """The batched sparse-W Schur solve (SparseWSchurNewtonSolver with a
    batch axis, S chunked) takes the CPU's decisions in float64, with and
    without refinement."""
    import dataclasses

    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.ops import newton
    runs = []
    for device in (cuda, "cpu"):
        ba = pba.make_synthetic_sparse(seed=0, ncam=8, npts=80, k_obs=3,
                                       device=device)
        g = torch.Generator().manual_seed(8)
        obs_b = ba.obs[None] + 0.5 * torch.randn(
            (4,) + tuple(ba.obs.shape), generator=g,
            dtype=torch.float64).to(device)
        p0 = {k: v[None] + 0.02 * torch.randn(
            (4,) + tuple(v.shape), generator=g,
            dtype=torch.float64).to(device)
            for k, v in sorted(ba.p_true.items())}
        ns = dataclasses.replace(ba.newton_solver(), s_chunk_limit=4096)
        refined = dataclasses.replace(
            ns, refine_iters=2,
            cam_gather=newton.build_cam_gather(ba.cam_of, ba.ncam))
        runs.append([batched_optimize(ba.products_obs, p0, BENCH,
                                      problem_data=obs_b, newton_solver=s,
                                      record_history=True)
                     for s in (ns, refined)])
    for r_d, r_c in zip(*runs):
        for field in ("step_count", "n_attempts", "reason", "lam"):
            assert torch.equal(getattr(r_d, field).cpu(),
                               getattr(r_c, field)), field
        assert torch.equal(r_d.history.step_type.cpu(),
                           r_c.history.step_type)
        assert bool((r_d.reason > 0).all())
        for name in ("c", "q"):
            np.testing.assert_allclose(r_d.p[name].cpu().numpy(),
                                       r_c.p[name].numpy(), rtol=1e-9,
                                       atol=1e-9)


def _grid_batch(batch, width, b, dtype, device, amalgamate=1):
    """A batch of grid MRFs (coupling "dense", element s made with seed s)
    that share one structure: (products(p, data), zeros (B, n), data
    (z_prior, z_edge, mix) (B, ...), the strategy on the lower JtJ
    pattern). The products are the ones a user writes from the public
    functions."""
    import math

    from libdogleg_tpu_torch import Products, SparseNewtonSolver
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr
    gs = [grid_mrf.make_grid_mrf(width, width, b, coupling="dense", seed=s,
                                 dtype=dtype, device=device)
          for s in range(batch)]
    g = gs[0]
    sched = bcsr.jtj_lower_schedule(g.structure)
    n, ne = g.n_nodes, g.edges.shape[0]
    eu = torch.as_tensor(g.edges[:, 0], device=device)
    ev = torch.as_tensor(g.edges[:, 1], device=device)
    sp, se = math.sqrt(g.w_prior), math.sqrt(g.w_edge)
    eye = torch.eye(b, dtype=dtype, device=device)

    def products(p, data):
        zp, ze, mix = data
        pb = p.reshape(n, b)
        x = torch.cat([(sp * (pb - zp)).reshape(-1),
                       (se * ((mix @ pb[ev][..., None])[..., 0] - pb[eu]
                              - ze)).reshape(-1)])
        values = torch.cat([
            (sp * eye).expand(n, b, b),
            torch.stack([(-se * eye).expand(ne, b, b), se * mix],
                        1).reshape(2 * ne, b, b)])
        J = bcsr.BCSRJacobian(g.structure, values)
        return Products(norm2_x=x @ x, Jt_x=bcsr.bcsr_jt_x(J, x),
                        JtJ=bcsr.bcsr_jtj_lower_blocks(J, sched))
    data = tuple(torch.stack([getattr(x, k) for x in gs])
                 for k in ("z_prior", "z_edge", "mix"))
    ns = SparseNewtonSolver.analyze(sched.rows, sched.cols, g.structure.nbcol,
                                    b, amalgamate=amalgamate)
    return products, torch.zeros(batch, g.nstate, dtype=dtype,
                                 device=device), data, ns


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("bm,bn", [(8, 8), (3, 5)])
def test_k3_batched_matches_plain_version(cuda, bm, bn, dtype, rtol):
    """K3 on a batch of Jacobians that share a structure: one launch for
    the batch, within rtol of the largest entry of the plain version
    (ops/bcsr.jtj_pair_sum), and each element the bits of its own
    launch."""
    from libdogleg_tpu_torch.ops import bcsr
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    J = _random_bcsr(61, 13, bm, bn, seed=bm + bn, dtype=dtype, device=cuda)
    s = J.structure
    sched = bcsr.jtj_lower_schedule(s)
    V = torch.as_tensor(np.random.default_rng(5).normal(
        size=(5, s.nnzb, bm, bn)), dtype=dtype, device=cuda)
    Jb = bcsr.BCSRJacobian(s, V)
    before = tk.launch_counts["bcsr_jtj_blocks_kernel"]
    got = tk.bcsr_jtj_lower_kernel(Jb, sched)
    torch.cuda.synchronize()
    assert tk.launch_counts["bcsr_jtj_blocks_kernel"] == before + 1
    assert torch.equal(bcsr.bcsr_jtj_lower_blocks(Jb, sched), got)
    want = bcsr.jtj_pair_sum(V, sched.pair_i, sched.pair_j, sched.out_idx,
                             len(sched.rows))
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))
    for i in range(5):
        one = tk.bcsr_jtj_lower_kernel(bcsr.BCSRJacobian(s, V[i]), sched)
        assert torch.equal(one, got[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_batched_keeps_the_recorded_bits(cuda, dtype):
    """The recorded K3_DIGESTS Jacobian as element 1 of a batch of three:
    the batched launch gives it the bits of the single one, directly and
    through the operator under torch.func.vmap."""
    import hashlib

    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian
    s = grid_mrf.make_grid_mrf(32, 32, 8, coupling="dense", dtype=dtype,
                               device=cuda).structure
    vals = torch.as_tensor(np.random.default_rng(3).uniform(
        -1.0, 1.0, size=(s.nnzb, s.block_rows, s.block_cols)), dtype=dtype,
        device=cuda)
    V = torch.stack([2.0 * vals, vals, -vals])
    blocks, sched = tk.bcsr_jtj_blocks_kernel(BCSRJacobian(s, V))
    before = tk.launch_counts["bcsr_jtj_blocks_kernel"]
    mapped = torch.func.vmap(
        lambda v: tk._jtj_launch(v, sched.out_idx, sched))(V)
    assert tk.launch_counts["bcsr_jtj_blocks_kernel"] == before + 1
    for got in (blocks[1], mapped[1]):
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        assert digest == K3_DIGESTS[dtype]


@pytest.mark.cuda
def test_k3_lower_blocks_raise_outside_the_kernels_range(cuda):
    """On the card the sparse path's JtJ blocks come from K3 or nowhere:
    values K3 does not take (float16 here) raise, and are never formed in
    plain PyTorch on the card."""
    from libdogleg_tpu_torch.ops import bcsr
    J = _random_bcsr(61, 13, 8, 8, seed=4, dtype=torch.float16,
                     device=cuda)
    sched = bcsr.jtj_lower_schedule(J.structure)
    with pytest.raises(ValueError, match="kernels' range"):
        bcsr.bcsr_jtj_lower_blocks(J, sched)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-4)])
def test_k3_under_vmap(cuda, dtype, rtol):
    """torch.func.vmap of a products function that forms its JtJ blocks
    with bcsr_jtj_lower_blocks launches K3 once for the whole batch (the
    operator's vmap rule), and each element's blocks are those of its own
    products within rtol of the largest entry."""
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    products, p0, data, _ = _grid_batch(4, 6, 4, dtype, cuda)
    products_cpu = _grid_batch(4, 6, 4, dtype, torch.device("cpu"))[0]
    P = p0 + torch.as_tensor(np.random.default_rng(2).normal(
        size=tuple(p0.shape)), dtype=dtype, device=cuda)
    before = tk.launch_counts["bcsr_jtj_blocks_kernel"]
    pr = torch.func.vmap(products)(P, data)
    torch.cuda.synchronize()
    assert tk.launch_counts["bcsr_jtj_blocks_kernel"] == before + 1
    assert pr.JtJ.shape[0] == 4
    for i in range(4):
        one = products(P[i], tuple(d[i] for d in data))
        assert torch.equal(one.JtJ, pr.JtJ[i])
        cpu = products_cpu(P[i].cpu(), tuple(d[i].cpu() for d in data))
        torch.testing.assert_close(pr.JtJ[i].cpu(), cpu.JtJ, rtol=rtol,
                                   atol=rtol * float(cpu.JtJ.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("amalgamate", [1, 4])
def test_batched_sparse_solve_f64_card_equals_cpu(cuda, amalgamate):
    """A small float64 batched block-sparse solve (B 4, 8x8 grids, b 4)
    through batched_optimize with SparseNewtonSolver: the card (K3, K6, K7)
    takes the CPU's decisions (the plain versions), p within 1e-9; a
    factorization of the batch launches K6 and K7 as often as one single
    factorization does."""
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops import tilechol
    from libdogleg_tpu_torch.parallel import batched_optimize
    runs = []
    for device in (cuda, torch.device("cpu")):
        products, p0, data, ns = _grid_batch(4, 8, 4, torch.float64, device,
                                             amalgamate)
        before = (tk.launch_counts["bcsr_jtj_blocks_kernel"],
                  dict(tilechol.launch_counts))
        runs.append(batched_optimize(products, p0, BENCH, problem_data=data,
                                     newton_solver=ns, record_history=True))
        if device.type == "cuda":
            assert tk.launch_counts["bcsr_jtj_blocks_kernel"] > before[0]
            assert all(tilechol.launch_counts[k] > before[1][k]
                       for k in before[1])
            blocks = torch.func.vmap(products)(p0, data).JtJ
            be = ns._backend()
            counts = []
            for blk, lam in ((blocks, torch.zeros(4, dtype=torch.float64,
                                                  device=cuda)),
                             (blocks[0], 0.0)):
                start = dict(tilechol.launch_counts)
                be.factorize(ns.symbolic, blk, lam)
                counts.append({k: tilechol.launch_counts[k] - start[k]
                               for k in start})
            assert counts[0] == counts[1] and all(counts[0].values())
    r_d, r_c = runs
    for field in ("step_count", "n_attempts", "reason", "lam"):
        assert torch.equal(getattr(r_d, field).cpu(), getattr(r_c, field))
    assert torch.equal(r_d.history.step_type.cpu(), r_c.history.step_type)
    assert bool((r_d.reason > 0).all())
    np.testing.assert_allclose(r_d.p.cpu().numpy(), r_c.p.numpy(),
                               rtol=1e-9, atol=1e-9)


def _smoke():
    """chip_smoke.py of this tree, for its inputs and recorded digests."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["config 3", "config 2", "config 8 n16"])
def test_generated_k1_f64_decisions_equal_plain_version(cuda, case):
    """K1 on a generated functor (Nstate 6, 3 and 16) against its plain
    version on the card: identical decisions, p within 1e-10; the functor
    alone against the traced graph on the CPU within 1e-12."""
    from libdogleg_tpu_torch.parallel import mega_auto
    c = _smoke()
    cases = {label: rest for label, *rest in
             c.auto_cases(torch.float64, cuda, (256, 256, 64))}
    fn, p0, data = cases[case]
    plan = mega_auto.plan_megakernel(fn, p0, None, problem_data=data,
                                     forced=True)
    before = mega.auto_launch_count
    r = plan()
    assert mega.auto_launch_count == before + 1
    ref = mega.megakernel_optimize_generated_reference(plan.kernel, p0,
                                                       plan.data_leaves)
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r, field), getattr(ref, field)), field
    assert torch.allclose(r.p, ref.p, rtol=1e-10, atol=1e-12)
    got = mega.products_generated(plan.kernel, p0, plan.data_leaves)
    want = mega.products_generated(plan.kernel, p0.cpu(),
                                   tuple(t.cpu() for t in plan.data_leaves))
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max() / w.abs().max()) <= 1e-12


@pytest.mark.cuda
def test_ordinary_closure_is_promoted_to_k1(cuda):
    """Config 3's ordinary closure through batched_optimize_compacted at
    B=1024 float32: one K1-auto launch, no masked run, recovered."""
    c = _smoke()
    _, fn, p0, meas = c.auto_cases(torch.float32, cuda, (1024, 1, 1))[0]
    before = mega.auto_launch_count
    with c.masked_runs() as masked:
        from libdogleg_tpu_torch.parallel import batched_optimize_compacted
        r = batched_optimize_compacted(fn, p0, BENCH, problem_data=meas)
        torch.cuda.synchronize()
    assert mega.auto_launch_count == before + 1
    assert masked.count == 0
    assert bool((r.reason > 0).all())
    assert c.recovered_frac(r.p) >= 0.99


@pytest.mark.cuda
def test_named_k1_bits_unchanged(cuda):
    """Both named instances give the parent's bits (chip_smoke.K1_DIGESTS,
    recorded before dogleg_solve moved into csrc/dogleg_solve.cuh)."""
    c = _smoke()
    assert c.k1_digests(cuda) == c.K1_DIGESTS


def _operator_cases(dtype, device):
    """Each kernel's operator with inputs at a shape of the export path:
    (name, operator, its direct launch, arguments)."""
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import batchchol, bcsr_kernels, tilechol
    from libdogleg_tpu_torch.problems import SparseProblem
    g = torch.Generator().manual_seed(5)

    def spd(k, n):
        a = torch.randn(k, n, n, dtype=dtype, generator=g)
        return (a @ a.mT + n * torch.eye(n, dtype=dtype)).to(device)
    A, T = spd(6, 64), spd(5, 40)
    L = torch.linalg.cholesky(T)
    C = torch.randn(5, 9, 40, dtype=dtype, generator=g).to(device)
    grid = grid_mrf.make_grid_mrf(4, 4, 8, dtype=dtype, device=device)
    sched = SparseProblem(f=None, structure=grid.structure,
                          jtj="sparse")._jtj_sched
    values = torch.randn((3, grid.structure.nnzb, 8, 8), dtype=dtype,
                         generator=g).to(device)
    ops = torch.as_tensor(bcsr_kernels._jtj_operands(sched),
                          dtype=torch.int32, device=device)
    npairs, nout = len(sched.pair_i), bcsr_kernels._nout(sched)
    from libdogleg_tpu_torch.ops import segsum
    plan = segsum.AddPlan(np.random.default_rng(5).integers(0, 7, 40))
    base = torch.randn(3, 9, 8, 8, dtype=dtype, generator=g).to(device)
    terms = torch.randn(3, 40, 8, 8, dtype=dtype, generator=g).to(device)

    def segment_add_direct(base, terms, dim, *ops):
        out = base.clone()
        segsum.segment_add_kernel(out, terms, dim, *ops)
        return out
    return [
        ("segment add", segsum._op, segment_add_direct,
         (base, terms, 1, *plan.kernel_operands(device), True)),
        ("K3", bcsr_kernels._jtj_op, bcsr_kernels._jtj_batched_launch,
         (values, ops, npairs, nout)),
        ("K5", batchchol._op, batchchol._launch, (A,)),
        ("K6", tilechol._tile_cholesky_op, tilechol._tile_cholesky_launch,
         (T,)),
        ("K7", tilechol._tri_solve_right_op, tilechol._tri_solve_right_launch,
         (L, C)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_export_operators_opcheck_and_bits(cuda, dtype):
    """The operators that carry K3, K5, K6 and K7 inside an exported
    artifact: torch.library.opcheck (schema, fake tensor, dispatch), and
    each operator's output is its direct launch's, bit for bit."""
    for name, op, launch, args in _operator_cases(dtype, cuda):
        torch.library.opcheck(op, args)
        got, want = op(*args), launch(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_export_grid_artifact_on_card(cuda, tmp_path):
    """A float64 supernodal grid solve exported on the card: the artifact
    launches K3, K6 and K7, takes the eager solve's decisions and the
    traced loop's p within 1e-12."""
    from libdogleg_tpu_torch import SparseProblem, export, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels, tilechol
    g = grid_mrf.make_grid_mrf(8, 8, 8, dtype=torch.float64, device=cuda)
    prob = SparseProblem(f=g.problem(jtj="dense").f, structure=g.structure,
                         jtj="sparse", ordering="rcm", amalgamate=16)
    ns = prob.default_newton_solver()
    z = torch.zeros(g.nstate, dtype=torch.float64, device=cuda)
    exp = export.export_solver(prob.products, g.nstate, BENCH,
                               dtype=torch.float64, newton_solver=ns)
    path = str(tmp_path / "grid.pt2")
    export.save_exported(path, exp)
    solver = export.load_exported(path)
    k3 = bcsr_kernels.launch_counts["bcsr_jtj_blocks_kernel"]
    k6, k7 = (tilechol.launch_counts[k] for k in ("tile_cholesky",
                                                  "tri_solve_right"))
    r = solver.call(z)
    torch.cuda.synchronize()
    assert bcsr_kernels.launch_counts["bcsr_jtj_blocks_kernel"] > k3
    assert tilechol.launch_counts["tile_cholesky"] > k6
    assert tilechol.launch_counts["tri_solve_right"] > k7
    live = optimize(prob, z, BENCH)
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r, field), getattr(live, field)), field
    loop = export.solve_traced(
        export.flatten_products(prob.products, z[None], batched=False), z,
        BENCH, newton_solver=ns, batched=False)
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r, field), getattr(loop, field)), field
    torch.testing.assert_close(r.p, loop.p, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("amalgamate", [1, 16])
def test_sparse_solve_f32_same_bits_twice(cuda, amalgamate):
    """The block-sparse path sums where several terms meet one target in a
    fixed order (ops/segsum.py): a float32 grid solve, simplicial or
    supernodal, gives the same bits on a second run, and the plain
    version's sums on the card (segsum.reference) the kernel's."""
    from libdogleg_tpu_torch import SparseProblem, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import segsum
    g = grid_mrf.make_grid_mrf(16, 16, 8, dtype=torch.float32, device=cuda)
    prob = SparseProblem(f=g.problem(jtj="dense").f, structure=g.structure,
                         jtj="sparse", amalgamate=amalgamate)
    z = torch.zeros(g.nstate, dtype=torch.float32, device=cuda)
    r1, r2 = optimize(prob, z, BENCH), optimize(prob, z, BENCH)
    assert torch.equal(r1.p.view(torch.int32), r2.p.view(torch.int32))
    shipped = segsum.add_, segsum.add
    try:
        segsum.add_ = segsum.reference
        segsum.add = segsum.reference
        r = optimize(prob, z, BENCH)
    finally:
        segsum.add_, segsum.add = shipped
    assert torch.equal(r.p.view(torch.int32), r1.p.view(torch.int32))


@pytest.mark.cuda
def test_mesh_world_of_one_on_card(cuda):
    """make_mesh on the card without a process group makes a world of one
    on NCCL; batched_optimize(mesh=) gives the unsharded call's bits as a
    DTensor sharded on the batch axis, and the group is destroyed after."""
    import torch.distributed as dist

    from libdogleg_tpu_torch.parallel import make_mesh
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(("dp",))
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        args = _instances(5, 1024, torch.float32, cuda)
        p0, meas = args[0], args[1]
        u = batched_optimize(qs.products, p0, BENCH, problem_data=meas)
        r = batched_optimize(qs.products, p0, BENCH, problem_data=meas,
                             mesh=mesh)
        assert str(tuple(r.p.placements)) == "(Shard(dim=0),)"
        assert torch.equal(r.p.to_local().view(torch.int32),
                           u.p.view(torch.int32))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
def test_dp_by_meas_batch_on_card_is_not_promoted(cuda):
    """A batch of starts over a measurement-sharded problem on a dp x meas
    mesh (a world of one on NCCL) at a batch that auto-promotion would
    take: its products hold an all_reduce, so K1 is never planned (no
    trace, no launch), and the masked driver gives the bits of the same
    call without the mesh."""
    import torch.distributed as dist

    from libdogleg_tpu_torch.parallel import (MeasurementShardedProblem,
                                              make_mesh, mega_auto)
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(("dp", "meas"), (1, 1))
        p0, meas, gx, gy = _instances(8, 1024, torch.float32, cuda)

        def f_shard(p, data):
            gx_s, gy_s, m_s = data
            return (qs.model(p, gx_s, gy_s) - m_s,
                    qs.jacobian(p, gx_s, gy_s))
        sharded = MeasurementShardedProblem(f_shard, (gx, gy, meas[0]),
                                            mesh, "meas")
        traces, launches = mega_auto.trace_count, mega.auto_launch_count
        r = batched_optimize(sharded.products, p0, BENCH, mesh=mesh,
                             axis_name="dp")
        assert mega_auto.trace_count == traces
        assert mega.auto_launch_count == launches
        u = batched_optimize(sharded.products, p0, BENCH,
                             use_megakernel=False)
        assert str(tuple(r.p.placements)) == "(Shard(dim=0), Replicate())"
        assert torch.equal(r.p.to_local().view(torch.int32),
                           u.p.view(torch.int32))
        assert bool((u.reason > 0).all())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
def test_point_sharded_ba_world_of_one_on_card(cuda):
    """BAProblem.shard and shard_p_tree over a world of one on NCCL, made
    and destroyed here: config 4's tree form at a test size (nc 64, 2000
    points, float32, PRM) gives the unsharded solve's bits on the card in
    every result field, q a DTensor sharded over "pts", c replicated."""
    import torch.distributed as dist

    from libdogleg_tpu_torch import solve_products
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.parallel import make_mesh
    assert not dist.is_initialized()
    try:
        ba = lba.make_synthetic(seed=0, nc=64, n_points=2000,
                                dtype=torch.float32)
        u = solve_products(ba.products_tree, ba.p0_tree(), BENCH,
                           newton_solver=ba.tree_newton_solver())
        mesh = make_mesh(("pts",))
        assert dist.get_backend() == "nccl"
        ba_s = ba.shard(mesh)
        r = solve_products(ba_s.products_tree,
                           ba.shard_p_tree(ba.p0_tree(), mesh), BENCH,
                           newton_solver=ba_s.tree_newton_solver())
        assert str(tuple(r.p["q"].placements)) == "(Shard(dim=0),)"
        assert str(tuple(r.p["c"].placements)) == "(Replicate(),)"
        got = {"p": {k: v.to_local() for k, v in r.p.items()},
               "Jt_x": {k: v.to_local() for k, v in r.Jt_x.items()}}
        for name in ("p", "Jt_x"):
            for k in ("c", "q"):
                assert torch.equal(got[name][k].view(torch.int32),
                                   getattr(u, name)[k].view(torch.int32))
        for f in ("norm2_x", "trustregion", "lam"):
            assert torch.equal(getattr(r, f).view(torch.int32),
                               getattr(u, f).view(torch.int32)), f
        for f in ("step_count", "n_attempts", "reason"):
            assert torch.equal(getattr(r, f), getattr(u, f)), f
        for a, b in zip(r.JtJ, u.JtJ):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert float(u.norm2_x) < 1e-3
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _segment_targets(kind, rng):
    """A case's targets and its base's length: a skewed draw (some targets
    take many terms, some none), one run longer than a chunk, more runs
    than one grid dimension holds, or no terms at all."""
    if kind == "skewed":
        return np.minimum(rng.geometric(0.2, 300) - 1, 30), 31
    if kind == "few":
        return np.minimum(rng.geometric(0.3, 40) - 1, 8), 9
    if kind.startswith("one run of "):
        return np.full(int(kind.split()[-1]), 3), 5
    if kind == "70000 runs":
        return rng.permutation(70000), 70000
    assert kind == "no terms"
    return np.zeros(0, np.int64), 4


# (dim, shape, targets, where): shape[:dim] is the outer shape and
# shape[dim:] a row, so base is shape[:dim] + (nbase,) + shape[dim:]: rows of
# 1, 3, 5, 8, 64, 128 (a full warp tile of 16-byte float32 words) and 16384
# elements (many tiles), several outer indices, and base and terms, or the
# terms alone, one element past a 16-byte boundary (one element a copy)
SEGMENT_CASES = [
    (0, (5,), "skewed", "aligned"), (1, (4, 8, 8), "skewed", "aligned"),
    (1, (2, 8, 1), "skewed", "aligned"), (0, (1,), "skewed", "aligned"),
    (1, (3, 3), "skewed", "aligned"), (0, (8,), "skewed", "aligned"),
    (1, (2, 64), "skewed", "aligned"), (1, (3, 128), "skewed", "aligned"),
    (1, (2, 16384), "few", "aligned"),
    (1, (2, 8), "one run of 300", "aligned"),
    (1, (2, 8), "one run of 1000", "aligned"),
    (0, (1,), "one run of 1000", "aligned"),
    (1, (3, 128), "one run of 300", "aligned"),
    (1, (2, 8), "skewed", "unaligned"), (1, (2, 64), "skewed", "unaligned"),
    (1, (2, 128), "skewed", "unaligned"),
    (1, (2, 128), "skewed", "terms unaligned"),
    (1, (2, 8), "one run of 300", "unaligned"),
    (0, (2,), "70000 runs", "aligned"), (1, (3, 8), "no terms", "aligned"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim,shape,kind,where", SEGMENT_CASES)
def test_segment_add_kernel_is_its_plain_version(cuda, dtype, dim, shape,
                                                 kind, where):
    """The segment-add kernel against its plain version (segsum.reference
    on the same CUDA tensors and on the CPU): the same bits, alpha 1 and
    -1, a single plan and a schedule's level, and the same bits on a second
    run; index_add_ within rounding."""
    from libdogleg_tpu_torch.ops import segsum
    rng = np.random.default_rng(3)
    targets, nbase = _segment_targets(kind, rng)
    levels = segsum.level_plans(np.r_[rng.integers(0, nbase, 50), targets],
                                [0, 50, 50 + len(targets)])
    lead, inner = shape[:dim], shape[dim:]
    g = torch.Generator().manual_seed(4)
    base = torch.randn(lead + (nbase,) + inner, dtype=dtype, generator=g)
    terms = torch.randn(lead + (len(targets),) + inner, dtype=dtype,
                        generator=g)

    def on_card(t, is_terms=False):
        if where == "aligned" or (where == "terms unaligned"
                                  and not is_terms):
            return t.to(cuda, copy=True)
        # one element into a buffer: a contiguous view, not 16-byte aligned
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view
    for plan in (segsum.AddPlan(targets), levels[1]):
        for alpha in (1, -1):
            want = segsum.add_(base.clone(), dim, plan, terms, alpha=alpha)
            plain = segsum.reference(on_card(base), dim, plan,
                                     on_card(terms, True), alpha=alpha)
            before = segsum.launch_count
            got = segsum.add_(on_card(base), dim, plan,
                              on_card(terms, True), alpha=alpha)
            again = segsum.add_(on_card(base), dim, plan,
                                on_card(terms, True), alpha=alpha)
            assert segsum.launch_count - before == (2 if plan.n else 0)
            assert torch.equal(got.cpu(), want)
            assert torch.equal(got, plain)
            assert torch.equal(got, again)
            ref = base.clone().index_add_(dim, torch.as_tensor(targets),
                                          terms, alpha=alpha)
            torch.testing.assert_close(got.cpu(), ref)


@pytest.mark.cuda
def test_dense_jtj_same_bits_twice(cuda):
    """Config 6's dense-JtJ leg (bcsr_jtj_dense on the 32x32x8 grid, float32)
    sums each block's pair products in a fixed order through the segment
    add: two evaluations give the same bits, and index_put_'s accumulation
    (atomics on the card) agrees within rounding."""
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr, segsum
    g = grid_mrf.make_grid_mrf(32, 32, 8, dtype=torch.float32, device=cuda)
    _, J = g.problem(jtj="dense").jacobian(
        torch.linspace(-1, 1, g.nstate, device=cuda))
    before = segsum.launch_count
    a, b = bcsr.bcsr_jtj_dense(J), bcsr.bcsr_jtj_dense(J)
    assert segsum.launch_count - before == 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    s, v = J.structure, J.values
    pi, pj = s.jtj_pairs()
    contrib = v[torch.as_tensor(pi, device=cuda).long()].mT \
        @ v[torch.as_tensor(pj, device=cuda).long()]
    out = torch.zeros((s.nbcol, s.nbcol, s.block_cols, s.block_cols),
                      dtype=v.dtype, device=cuda)
    out.index_put_((torch.as_tensor(s.indices[pi], device=cuda).long(),
                    torch.as_tensor(s.indices[pj], device=cuda).long()),
                   contrib, accumulate=True)
    torch.testing.assert_close(
        a, out.permute(0, 2, 1, 3).reshape(s.nstate, s.nstate))


@pytest.mark.cuda
def test_segment_add_operator_under_vmap(cuda):
    """The out-of-place add under torch.func.vmap goes through the
    operator's vmap rule: one launch for the batch, each element its plain
    version's bits."""
    from libdogleg_tpu_torch.ops import segsum
    plan = segsum.AddPlan(np.random.default_rng(6).integers(0, 12, 90))
    g = torch.Generator().manual_seed(7)
    base = torch.randn(12, 3, dtype=torch.float32, generator=g)
    terms = torch.randn(5, 90, 3, dtype=torch.float32, generator=g)
    want = torch.stack([segsum.add(base, 0, plan, t) for t in terms])
    before = segsum.launch_count
    got = torch.func.vmap(lambda t: segsum.add(base.to(cuda), 0, plan, t))(
        terms.to(cuda))
    assert segsum.launch_count - before == 1
    assert torch.equal(got.cpu(), want)

