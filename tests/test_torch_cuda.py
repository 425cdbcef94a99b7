"""Kernels K1-K4 on a CUDA card against their plain twins on the same card.

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


def _instances(seed, batch, dtype, device):
    g = torch.Generator().manual_seed(seed)
    meas = qs.simulate(g, dtype, device, batch=(batch,))
    p0 = qs.initial_state(g, dtype, device, batch=(batch,))
    gx, gy = qs.make_grid(dtype, device)
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
@pytest.mark.parametrize("p", [16, 64, 256])
def test_panel_kernel_matches_twin(cuda, p, dtype, tol):
    """K2 against its twin on the card: L and inv(L) within tol relative to
    their largest entry, ok identical, and a negative pivot caught."""
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
    assert ok.tolist() == okr.tolist() == [True, True, False]
    for got, want in ((L, Lr), (Linv, Linvr)):
        err = (got[:2] - want[:2]).abs().max() / want[:2].abs().max()
        assert float(err) < tol
    assert bool((torch.triu(L, 1) == 0).all())


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
