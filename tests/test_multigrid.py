"""Geometric multigrid tests: transfer operators (adjoint + Galerkin
consistency from nestedness), V-cycle contraction across shifts, and
solver-level agreement of the mg inner path with exact dense inverses."""

import numpy as np
import jax.numpy as jnp
import pytest

from spacetime.fem import P1System, unit_cube_mesh, unit_square_mesh
from spacetime.fem.timegrid import uniform_time_grid
from spacetime.models import get_problem
from spacetime.ops.multigrid import (
    ShiftedMultigrid,
    _interp2d,
    _interp3d,
    _restrict2d,
    _restrict3d,
    chebyshev_inverse,
    mass_spectral_bounds,
)
from spacetime.ops.sparse import DiaMatrix
from spacetime.ops.stencil import StencilOperator
from spacetime.solver.heateq import HeatSolver


class TestTransfers:
    def test_2d_adjoint(self):
        rng = np.random.default_rng(0)
        C = jnp.asarray(rng.standard_normal((2, 15, 15)))
        F = jnp.asarray(rng.standard_normal((2, 31, 31)))
        lhs = jnp.vdot(_interp2d(C, 16), F)
        rhs = jnp.vdot(C, _restrict2d(F, 16))
        assert abs(float(lhs - rhs)) < 1e-11

    def test_3d_adjoint(self):
        rng = np.random.default_rng(1)
        C = jnp.asarray(rng.standard_normal((7, 7, 7)))
        F = jnp.asarray(rng.standard_normal((15, 15, 15)))
        lhs = jnp.vdot(_interp3d(C, 8), F)
        rhs = jnp.vdot(C, _restrict3d(F, 8))
        assert abs(float(lhs - rhs)) < 1e-11

    @pytest.mark.parametrize("dim,n", [(2, 32), (3, 16)])
    def test_galerkin_consistency(self, dim, n):
        # Nested P1 spaces: restrict(A_fine(interp(x))) == A_coarse(x) exactly.
        mg, _ = ShiftedMultigrid.build(dim, n, 0.0, n_coarse=n // 4)
        nc = n // 2
        shape = (nc - 1,) * dim
        rng = np.random.default_rng(2)
        C = jnp.asarray(rng.standard_normal(shape))
        interp = _interp2d if dim == 2 else _interp3d
        restrict = _restrict2d if dim == 2 else _restrict3d
        fine = mg.levels[0].stencil.apply(interp(C, nc))
        got = restrict(fine, nc)
        want = mg.levels[1].stencil.apply(C)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)


class TestVCycle:
    @pytest.mark.parametrize("omega", [0.0, 50.0, 5000.0])
    def test_contraction(self, omega):
        cache = {}
        mg, cinv = ShiftedMultigrid.build(2, 64, omega, _system_cache=cache)
        cinv = jnp.asarray(cinv)
        rng = np.random.default_rng(3)
        b = jnp.asarray(rng.standard_normal((63, 63)))
        x = jnp.zeros_like(b)
        norms = [float(jnp.linalg.norm(b))]
        for _ in range(3):
            r = b - mg.levels_apply(mg.levels[0], x)
            x = x + mg.vcycle(r, cinv)
            norms.append(float(jnp.linalg.norm(b - mg.levels_apply(mg.levels[0], x))))
        # At least ~0.25 contraction per cycle for every shift.
        assert norms[3] / norms[0] < 0.25**3

    def test_chebyshev_mass_inverse(self):
        sys2 = P1System.from_mesh(unit_square_mesh(32))
        M_st = StencilOperator.from_dia(
            DiaMatrix.from_csr(sys2.M), sys2.mesh.grid_shape
        )
        lmin, lmax = mass_spectral_bounds(2)
        center = dict(zip(M_st.disps, M_st.weights))[(0, 0)]
        f = chebyshev_inverse(M_st, 1.0 / center, lmin, lmax, 30)
        rng = np.random.default_rng(4)
        b = jnp.asarray(rng.standard_normal((31, 31)))
        x = f(b)
        res = float(jnp.linalg.norm(b - M_st.apply(x)) / jnp.linalg.norm(b))
        assert res < 1e-10


class TestSolverIntegration:
    def test_mg_matches_dense_inner(self):
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(16))
        grid = uniform_time_grid(4)
        r_dense = HeatSolver(problem, system, grid, inner="dense").solve(tol=1e-6)
        r_mg = HeatSolver(
            problem, system, grid, inner="mg", mg_cycles=3
        ).solve(tol=1e-6)
        assert r_mg.converged
        assert abs(r_mg.iterations - r_dense.iterations) <= 2
        assert abs(r_mg.l2_error - r_dense.l2_error) < 0.02 * r_dense.l2_error

    @pytest.mark.slow
    def test_reduced_cycle_presets(self):
        """The speed presets (K_Y 2 cycles, K_X sandwich 1 cycle per shifted
        solve) stay convergent with near-flat iteration counts and an
        unchanged discrete solution (measured tradeoff in BASELINE.md)."""
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(16))
        grid = uniform_time_grid(4)
        ref = HeatSolver(problem, system, grid, inner="mg").solve(tol=1e-6)
        fast = HeatSolver(
            problem, system, grid, inner="mg", mg_cycles=2, mg_cycles_kx=1
        ).solve(tol=1e-6)
        assert fast.converged
        # inexact inner solves may cost a few extra outer iterations but
        # must not change the computed solution at this error scale
        assert fast.iterations - ref.iterations <= 3
        assert abs(fast.l2_error - ref.l2_error) < 0.01 * ref.l2_error

    @pytest.mark.parametrize("problem_name,make,n,levels", [
        ("smooth2d", unit_square_mesh, 16, 4),
        ("smooth3d", unit_cube_mesh, 8, 3),
    ])
    @pytest.mark.slow
    def test_kx_nu_preset(self, problem_name, make, n, levels):
        """mg_nu_kx strengthens only the K_X sandwich smoother: with one
        stronger cycle (cycles_kx=1, nu_kx=3) the solve must converge to
        the SAME discrete solution (K_Y untouched) at near-flat outer
        iteration counts — the 3D speed preset's correctness contract."""
        problem = get_problem(problem_name)
        system = P1System.from_mesh(make(n))
        grid = uniform_time_grid(levels)
        ref = HeatSolver(problem, system, grid, inner="mg").solve(tol=1e-6)
        fast = HeatSolver(
            problem, system, grid, inner="mg",
            mg_cycles_kx=1, mg_nu_kx=3,
        ).solve(tol=1e-6)
        assert fast.converged
        assert fast.iterations - ref.iterations <= 2
        # K_Y (and hence the normal-equations fixed point) is unchanged
        assert abs(fast.l2_error - ref.l2_error) < 1e-3 * ref.l2_error

    def test_kx_nu_validation(self):
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(3)
        with pytest.raises(ValueError, match="smoothing step"):
            HeatSolver(problem, system, grid, inner="mg", mg_nu_kx=0)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))


@pytest.mark.slow
def test_conv_transfers_match_scatter_forms():
    """The conv-based prolongation/restriction must equal the strided
    scatter/slice reference forms exactly (they are the same operator)."""
    import jax.numpy as jnp
    from spacetime.ops.multigrid import (
        _interp2d, _interp2d_scatter, _restrict2d, _restrict2d_slices,
        _interp3d, _interp3d_scatter, _restrict3d, _restrict3d_slices)

    rng = np.random.default_rng(3)
    for nc in (4, 8):
        C = jnp.asarray(rng.standard_normal((5, nc - 1, nc - 1)))
        F = jnp.asarray(rng.standard_normal((5, 2 * nc - 1, 2 * nc - 1)))
        np.testing.assert_allclose(
            np.asarray(_interp2d(C, nc)), np.asarray(_interp2d_scatter(C, nc)),
            atol=1e-13)
        np.testing.assert_allclose(
            np.asarray(_restrict2d(F, nc)), np.asarray(_restrict2d_slices(F, nc)),
            atol=1e-13)
        C3 = jnp.asarray(rng.standard_normal((3,) + (nc - 1,) * 3))
        F3 = jnp.asarray(rng.standard_normal((3,) + (2 * nc - 1,) * 3))
        np.testing.assert_allclose(
            np.asarray(_interp3d(C3, nc)), np.asarray(_interp3d_scatter(C3, nc)),
            atol=1e-13)
        np.testing.assert_allclose(
            np.asarray(_restrict3d(F3, nc)), np.asarray(_restrict3d_slices(F3, nc)),
            atol=1e-13)


@pytest.mark.slow
def test_nu_post_asymmetric_cycles():
    """V(nu, nu_post) cycles: default nu_post=None is bit-identical to the
    symmetric path; V(2,1) holds outer iteration counts (within +2) with
    matching solutions — the post-smooth is the largest V-cycle stage at
    the 3D flagship (BASELINE.md), so this is the measured-iteration-
    neutral way to cut it."""
    import jax.numpy as jnp

    from spacetime.fem import P1System, unit_square_mesh
    from spacetime.fem.timegrid import uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    prob = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(16))
    grid = uniform_time_grid(4)
    kw = dict(dtype=jnp.float32, inner="mg", space_n=16, rhs="device")
    ref = HeatSolver(prob, system, grid, **kw).solve(
        tol=1e-6, compute_error=False
    )
    same = HeatSolver(prob, system, grid, mg_nu_post=2, **kw).solve(
        tol=1e-6, compute_error=False
    )
    np.testing.assert_array_equal(ref.residuals, same.residuals)
    v21 = HeatSolver(prob, system, grid, mg_nu_post=1, **kw).solve(
        tol=1e-6, compute_error=False
    )
    assert v21.converged
    assert v21.iterations <= ref.iterations + 2
    np.testing.assert_allclose(v21.U, ref.U, atol=1e-4)


