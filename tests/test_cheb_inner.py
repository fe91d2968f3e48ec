"""Chebyshev polynomial inner solver (the generic-mesh scale path).

inner='cheb' replaces exact/dense spatial solves with fixed Chebyshev
polynomials in the Jacobi-normalized operators — linear and symmetric, so
the outer normal equations stay SPD. These tests pin: the polynomial really
approximates the inverse, the full solve converges on unstructured meshes
beyond the dense-inverse regime, and the auto rule picks it there.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime.fem import P1System, l_shape_mesh, unit_square_mesh
from spacetime.fem.timegrid import uniform_time_grid
from spacetime.models import get_problem
from spacetime.ops.multigrid import (
    chebyshev_degree,
    chebyshev_generic,
    generic_spectral_bounds,
)
from spacetime.solver.heateq import HeatSolver


def test_chebyshev_generic_approximates_inverse():
    system = P1System.from_mesh(l_shape_mesh(16))
    A = system.A
    lmin, lmax = generic_spectral_bounds(A)
    invd = 1.0 / np.asarray(A.diagonal())
    deg = chebyshev_degree(lmin, lmax, 1e-6)
    solve = chebyshev_generic(lambda x: A @ x, invd, lmin, lmax, deg)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    x = solve(b)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-5


def test_bounds_contain_spectrum():
    import scipy.sparse as sp
    import scipy.linalg as sla

    system = P1System.from_mesh(l_shape_mesh(12))
    for Op in (system.A, system.M):
        lmin, lmax = generic_spectral_bounds(Op)
        d = np.asarray(Op.diagonal())
        s = 1.0 / np.sqrt(d)
        B = sp.csr_matrix(Op).multiply(s[:, None]).multiply(s[None, :])
        w = sla.eigvalsh(B.toarray())
        assert lmin <= w[0] * 1.0001
        assert lmax >= w[-1] * 0.9999


class TestChebSolve:
    def test_matches_dense_inner_quick(self):
        # Quick-tier representative of the dense-inner parity invariant
        # (round-4 advisor: every invariant class keeps one small unmarked
        # test so the default dev loop still guards it; the full-size
        # variant below stays in the slow tier).
        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(12))
        grid = uniform_time_grid(3)
        r_dense = HeatSolver(problem, system, grid, inner="dense").solve(
            tol=1e-6, compute_error=True
        )
        r_cheb = HeatSolver(problem, system, grid, inner="cheb").solve(
            tol=1e-6, compute_error=True
        )
        assert r_cheb.converged
        assert r_cheb.iterations <= r_dense.iterations + 5
        np.testing.assert_allclose(
            r_cheb.l2_error, r_dense.l2_error, rtol=2e-2
        )

    def test_sharded_matches_serial_quick(self):
        # Quick-tier representative of the serial-vs-sharded equality
        # invariant on the cheb inner (CLAUDE.md invariants; full-size
        # variant in the slow tier below).
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        from spacetime.parallel import ShardedHeatSolver, make_time_mesh

        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(10))
        grid = uniform_time_grid(3)
        r1 = HeatSolver(problem, system, grid, inner="cheb").solve(
            tol=1e-6, compute_error=False
        )
        r4 = ShardedHeatSolver(
            problem, system, grid, make_time_mesh(4), inner="cheb"
        ).solve(tol=1e-6, compute_error=False)
        assert r4.converged
        assert r4.iterations == r1.iterations
        np.testing.assert_allclose(r4.residuals, r1.residuals, rtol=1e-9)

    @pytest.mark.slow
    def test_matches_dense_inner_on_small_problem(self):
        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(24))
        grid = uniform_time_grid(4)
        r_dense = HeatSolver(problem, system, grid, inner="dense").solve(
            tol=1e-6, compute_error=True
        )
        r_cheb = HeatSolver(problem, system, grid, inner="cheb").solve(
            tol=1e-6, compute_error=True
        )
        assert r_cheb.converged
        # inexact inner solves may cost a few extra outer iterations but
        # must not change the computed solution at discretization accuracy
        assert r_cheb.iterations <= r_dense.iterations + 5
        np.testing.assert_allclose(
            r_cheb.l2_error, r_dense.l2_error, rtol=2e-2
        )

    def test_structured_mesh_forced_cheb(self):
        # cheb also works on the structured stencil path when forced
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(16))
        grid = uniform_time_grid(4)
        r = HeatSolver(problem, system, grid, inner="cheb").solve(
            tol=1e-6, compute_error=True
        )
        assert r.converged and r.iterations <= 25
        np.testing.assert_allclose(r.l2_error, 3.6711e-03, rtol=2e-2)

    def test_auto_picks_cheb_for_large_unstructured(self):
        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(78))  # m > 4096
        assert system.m > 4096
        grid = uniform_time_grid(3)
        solver = HeatSolver(problem, system, grid, dtype=jnp.float64)
        assert solver.inner == "cheb"
        # bounded smoke solve: residual must fall fast even at this size
        r = solver.solve(tol=1e-6, maxiter=30, compute_error=False)
        assert r.converged
        assert r.iterations <= 25

    def test_graded_grid(self):
        from spacetime.fem.timegrid import graded_time_grid

        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(16))
        r = HeatSolver(
            problem, system, graded_time_grid(3, 3), inner="cheb"
        ).solve(tol=1e-6, compute_error=True)
        assert r.converged and r.iterations <= 15
        np.testing.assert_allclose(r.l2_error, 1.2909e-02, rtol=2e-2)

    def test_mixed_precision_refinement(self):
        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(16))
        grid = uniform_time_grid(3)
        r = HeatSolver(problem, system, grid, inner="cheb").solve_refined(
            tol=1e-8
        )
        assert r.converged
        assert r.residuals[-1] < 1e-8

    def test_blocked_ell_f32(self):
        # the generic-mesh scale combo: flat-DIA SpMV + Chebyshev
        # polynomial inner solves, f32
        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(16))
        grid = uniform_time_grid(3)
        r = HeatSolver(
            problem, system, grid, inner="cheb", spatial_format="dia",
            dtype=jnp.float32,
        ).solve(tol=1e-5, compute_error=True)
        assert r.converged and r.iterations <= 12
        np.testing.assert_allclose(r.l2_error, 1.2885e-02, rtol=2e-2)

    @pytest.mark.slow
    def test_sharded_matches_serial(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from spacetime.parallel import ShardedHeatSolver, make_time_mesh

        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(16))
        grid = uniform_time_grid(3)
        r1 = HeatSolver(problem, system, grid, inner="cheb").solve(
            tol=1e-6, compute_error=False
        )
        r8 = ShardedHeatSolver(
            problem, system, grid, make_time_mesh(8), inner="cheb"
        ).solve(tol=1e-6, compute_error=False)
        assert r8.converged
        assert r8.iterations == r1.iterations
        np.testing.assert_allclose(r8.residuals, r1.residuals, rtol=1e-9)

    def test_explicit_matches_serial(self):
        """cheb inner on the explicit (shard_map) backend: the polynomial
        inverses are per-row local, boundary slots blend coarse levels only
        (see _cheb_levelwise_local) — histories must match the serial
        solver's to reduction-order rounding."""
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        from spacetime.parallel import ExplicitHeatSolver, make_time_mesh

        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(16))
        grid = uniform_time_grid(4)  # 16 ts over 4 devices
        r1 = HeatSolver(problem, system, grid, inner="cheb").solve(
            tol=1e-6, compute_error=False
        )
        r4 = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(4), inner="cheb"
        ).solve(tol=1e-6, compute_error=False)
        assert r4.converged
        assert r4.iterations == r1.iterations
        np.testing.assert_allclose(r4.residuals, r1.residuals, rtol=1e-9)

    def test_explicit_ell_f32(self):
        """The generic-mesh scale combo on the explicit backend: flat-DIA
        SpMV + cheb inners + fused single-reduction PCG."""
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        from spacetime.parallel import ExplicitHeatSolver, make_time_mesh

        problem = get_problem("lshape2d")
        system = P1System.from_mesh(l_shape_mesh(16))
        grid = uniform_time_grid(4)
        r = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(4), inner="cheb",
            spatial_format="dia", dtype=jnp.float32, pcg_variant="fused",
        ).solve(tol=1e-5, compute_error=True)
        assert r.converged and r.iterations <= 12
        # spatial error floor of the 16-cell L-shape mesh (cf. the serial
        # flat-DIA test's 1.2885e-02 at 8 timesteps)
        np.testing.assert_allclose(r.l2_error, 1.291e-02, rtol=2e-2)


@pytest.mark.slow
def test_cheb_eps_knob():
    """Lower cheb_eps -> higher polynomial degrees and an L2 error closer to
    the exact-inner (dense) solve."""
    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(8))
    grid = uniform_time_grid(3)
    s1 = HeatSolver(problem, system, grid, inner="cheb")
    s2 = HeatSolver(problem, system, grid, inner="cheb", cheb_eps=1e-6)
    assert s2._cheb_spec["A"][2] > s1._cheb_spec["A"][2]
    assert s2._cheb_spec["shift"][0][3] > s1._cheb_spec["shift"][0][3]
    rd = HeatSolver(problem, system, grid, inner="dense").solve(
        tol=1e-8, compute_error=True
    )
    r2 = s2.solve(tol=1e-8, compute_error=True)
    assert abs(r2.l2_error - rd.l2_error) <= 1e-6 * abs(rd.l2_error) + 1e-12


def test_explicit_dense_ell_combo():
    """explicit + flat-DIA + dense inner."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    from spacetime.parallel import ExplicitHeatSolver, make_time_mesh
    from spacetime.solver.heateq import HeatSolver as HS

    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(8))
    grid = uniform_time_grid(3)
    r1 = HS(problem, system, grid, inner="dense", spatial_format="dia",
            dtype=jnp.float32).solve(tol=1e-5, compute_error=False)
    r4 = ExplicitHeatSolver(
        problem, system, grid, make_time_mesh(4), inner="dense",
        spatial_format="dia", dtype=jnp.float32,
    ).solve(tol=1e-5, compute_error=False)
    assert r4.converged
    assert r4.iterations == r1.iterations
    np.testing.assert_allclose(r4.residuals, r1.residuals, rtol=1e-4)


def test_explicit_cheb_structured_stencil():
    """explicit + cheb inner on the structured stencil path."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    from spacetime.parallel import ExplicitHeatSolver, make_time_mesh

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(12))
    grid = uniform_time_grid(4)
    r1 = HeatSolver(problem, system, grid, inner="cheb").solve(
        tol=1e-6, compute_error=False
    )
    r4 = ExplicitHeatSolver(
        problem, system, grid, make_time_mesh(4), inner="cheb"
    ).solve(tol=1e-6, compute_error=False)
    assert r4.converged
    assert r4.iterations == r1.iterations
    np.testing.assert_allclose(r4.residuals, r1.residuals, rtol=1e-9)
