"""Galerkin (RAP) multi-shift multigrid for coefficient-weighted operators.

Weighted spatial forms are not translation invariant, so the constant-stencil
hierarchy of ops/multigrid.MultiShiftMultigrid cannot serve them; the
Galerkin variant coarsens the assembled fine matrix through the exact nested-
P1 interpolation (host-side sparse RAP) and runs the same per-row-shift
V-cycle with DIA level operators.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from spacetime.fem import P1System, unit_cube_mesh, unit_square_mesh, uniform_time_grid
from spacetime.fem.assembly import assemble_p1
from spacetime.models import get_problem
from spacetime.ops.multigrid import (
    GalerkinMultiShiftMultigrid,
    _transfer_fast,
    galerkin_coarsen,
    p1_interpolation_matrix,
)
from spacetime.solver.heateq import HeatSolver

KAPPA = lambda X: 1.0 + X[:, 0] + 0.5 * np.sin(np.pi * X[:, 1])
REACT = lambda X: 1.0 + X[:, 1]


@pytest.mark.parametrize("dim,nc", [(2, 4), (2, 8), (3, 4)])
def test_interpolation_matrix_matches_device_transfer(dim, nc):
    rng = np.random.default_rng(0)
    P = p1_interpolation_matrix(dim, nc)
    C = rng.standard_normal((nc - 1,) * dim)
    fine_dev = np.asarray(_transfer_fast(jnp.asarray(C), dim, restrict=False))
    np.testing.assert_allclose(
        (P @ C.ravel()).reshape((2 * nc - 1,) * dim), fine_dev,
        rtol=1e-14, atol=1e-15,
    )
    # Restriction is the exact transpose.
    F = rng.standard_normal((2 * nc - 1,) * dim)
    coarse_dev = np.asarray(_transfer_fast(jnp.asarray(F), dim, restrict=True))
    np.testing.assert_allclose(
        (P.T @ F.ravel()).reshape((nc - 1,) * dim), coarse_dev,
        rtol=1e-14, atol=1e-15,
    )


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 8)])
def test_rap_equals_reassembly_for_constant_coefficients(dim, n):
    """For κ ≡ 1 the Galerkin coarse operator must equal re-assembly on the
    coarse mesh exactly (nested P1) — the identity the constant-stencil
    hierarchy relies on, here validated through the explicit P matrix."""
    make = unit_square_mesh if dim == 2 else unit_cube_mesh
    fine = P1System.from_mesh(make(n))
    coarse = P1System.from_mesh(make(n // 2))
    Ac = galerkin_coarsen(fine.A, dim, n // 2)
    Mc = galerkin_coarsen(fine.M, dim, n // 2)
    np.testing.assert_allclose(Ac.toarray(), coarse.A.toarray(), atol=1e-12)
    np.testing.assert_allclose(Mc.toarray(), coarse.M.toarray(), atol=1e-14)


def test_weighted_rap_spd_and_pattern():
    mesh = unit_square_mesh(16)
    sys_w = P1System.from_mesh(mesh, kappa=KAPPA, reaction=REACT)
    Ac = galerkin_coarsen(sys_w.A, 2, 8)
    from spacetime.ops.sparse import DiaMatrix

    fine_ndiag = DiaMatrix.from_csr(sys_w.A).ndiag
    assert DiaMatrix.from_csr(Ac).ndiag == fine_ndiag  # 7-point preserved
    w = np.linalg.eigvalsh(Ac.toarray())
    assert w.min() > 0
    np.testing.assert_allclose(Ac.toarray(), Ac.toarray().T, atol=1e-14)


def test_weighted_vcycle_contracts():
    mesh = unit_square_mesh(32)
    sys_w = P1System.from_mesh(mesh, kappa=KAPPA, reaction=REACT)
    msmg, (A_c, M_c) = GalerkinMultiShiftMultigrid.build(
        2, 32, sys_w.A, sys_w.M, n_coarse=8
    )
    T = 4
    omegas = np.array([0.0, 4.0, 64.0, 1024.0])
    lps = msmg.row_params(omegas, jnp.float64)
    cinvs = np.stack(
        [np.linalg.inv(A_c + w * M_c) for w in omegas]
    )

    def coarse(bc):
        # The V-cycle runs in grid layout internally — flatten per row.
        flat = bc.reshape(bc.shape[0], -1)
        out = jnp.einsum("tm,tmk->tk", flat, jnp.asarray(cinvs))
        return out.reshape(bc.shape)

    rng = np.random.default_rng(1)
    x_true = rng.standard_normal((T, sys_w.m))
    A = sys_w.A.toarray()
    M = sys_w.M.toarray()
    b = np.stack([(A + w * M) @ x_true[i] for i, w in enumerate(omegas)])
    x = msmg.solve(jnp.asarray(b), lps, coarse, cycles=2)
    err = np.linalg.norm(np.asarray(x) - x_true, axis=1)
    err0 = np.linalg.norm(x_true, axis=1)
    assert np.all(err / err0 < 0.05), err / err0


@pytest.mark.slow
def test_varcoef_mg_matches_dense_inner():
    prob = get_problem("varcoef2d")
    system = P1System.from_problem(prob, unit_square_mesh(16))
    grid = uniform_time_grid(4)
    rd = HeatSolver(prob, system, grid, inner="dense").solve(tol=1e-6)
    rm = HeatSolver(prob, system, grid, inner="mg", mg_coarse=8).solve(tol=1e-6)
    assert rm.converged
    assert abs(rm.iterations - rd.iterations) <= 2
    np.testing.assert_allclose(rm.l2_error, rd.l2_error, rtol=1e-4)


def test_varcoef_mg_auto_selected_at_scale():
    prob = get_problem("varcoef2d")
    system = P1System.from_problem(prob, unit_square_mesh(128))
    solver = HeatSolver(prob, system, uniform_time_grid(3))
    assert solver.inner == "mg" and solver._mg_weighted
    assert [lev.n for lev in solver.msmg.levels] == [128, 64]


def test_varcoef_mg_sharded_matches_serial():
    from spacetime.parallel import ShardedHeatSolver, make_time_mesh

    prob = get_problem("varcoef2d")
    system = P1System.from_problem(prob, unit_square_mesh(16))
    grid = uniform_time_grid(4)
    kw = dict(inner="mg", mg_coarse=8)
    r1 = HeatSolver(prob, system, grid, **kw).solve(tol=1e-6, compute_error=False)
    r8 = ShardedHeatSolver(prob, system, grid, make_time_mesh(8), **kw).solve(
        tol=1e-6, compute_error=False
    )
    assert r8.iterations == r1.iterations
    np.testing.assert_allclose(r8.residuals, r1.residuals, rtol=1e-12)


def test_varcoef_mg_mixed_precision_refinement():
    """f32 weighted-mg inner PCG + f64 residual loop reaches 1e-8 (the
    refinement path casts the Galerkin level params per dtype)."""
    prob = get_problem("varcoef2d")
    system = P1System.from_problem(prob, unit_square_mesh(16))
    s = HeatSolver(
        prob, system, uniform_time_grid(4),
        dtype=jnp.float32, inner="mg", mg_coarse=8,
    )
    r = s.solve_refined(tol=1e-8)
    assert r.converged
    assert r.residuals[-1] / r.residuals[0] <= 1e-8


def test_varcoef3d_mg_smoke():
    prob = get_problem("varcoef3d")
    system = P1System.from_problem(prob, unit_cube_mesh(8))
    grid = uniform_time_grid(3)
    r = HeatSolver(prob, system, grid, inner="mg", mg_coarse=4).solve(tol=1e-6)
    assert r.converged and r.iterations < 20
    rd = HeatSolver(prob, system, grid, inner="dense").solve(tol=1e-6)
    np.testing.assert_allclose(r.l2_error, rd.l2_error, rtol=1e-3)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
