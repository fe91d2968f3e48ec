"""Single-reduction (Chronopoulos–Gear) PCG variant.

pcg_fused merges the three per-iteration global inner products into one
reduction (solver/pcg.py). In exact arithmetic its iterates coincide with the
standard driver's, so these tests pin: identical iteration counts, residual
histories matching to recurrence-rounding tolerance in f64, and — on the
explicit shard_map path — that the sharded fused solve (whose three dots ride
one 3-vector psum, parallel/explicit.py `_dot3_local`) reproduces the serial
fused solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spacetime.fem import P1System, unit_square_mesh
from spacetime.fem.timegrid import uniform_time_grid
from spacetime.models import get_problem
from spacetime.parallel import ExplicitHeatSolver, make_time_mesh
from spacetime.solver.heateq import HeatSolver
from spacetime.solver.pcg import pcg, pcg_fused

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _solvers(pcg_variant, **kw):
    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(16))
    grid = uniform_time_grid(4)
    return HeatSolver(problem, system, grid, pcg_variant=pcg_variant, **kw)


class TestFusedSerial:
    def test_matches_standard_driver(self):
        r_std = _solvers("standard").solve(tol=1e-6, compute_error=False)
        r_fus = _solvers("fused").solve(tol=1e-6, compute_error=False)
        assert r_fus.converged
        assert r_fus.iterations == r_std.iterations
        np.testing.assert_allclose(
            r_fus.residuals, r_std.residuals, rtol=1e-9
        )
        np.testing.assert_allclose(r_fus.U, r_std.U, atol=1e-9)

    def test_precond_residual_history_matches(self):
        r_std = _solvers("standard").solve(tol=1e-6, compute_error=False)
        r_fus = _solvers("fused").solve(tol=1e-6, compute_error=False)
        np.testing.assert_allclose(
            r_fus.precond_residuals, r_std.precond_residuals, rtol=1e-9
        )

    def test_spd_system_direct(self):
        # Raw driver on a small SPD system with a nontrivial preconditioner.
        rng = np.random.default_rng(3)
        A = rng.standard_normal((40, 40))
        A = jnp.asarray(A @ A.T + 40 * np.eye(40))
        Minv = jnp.asarray(np.diag(1.0 / np.asarray(jnp.diag(A))))
        b = jnp.asarray(rng.standard_normal(40))
        std = pcg(lambda x: A @ x, lambda r: Minv @ r, b, 1e-10, 100)
        fus = pcg_fused(lambda x: A @ x, lambda r: Minv @ r, b, 1e-10, 100)
        assert bool(fus.converged)
        assert abs(int(fus.iterations) - int(std.iterations)) <= 1
        np.testing.assert_allclose(fus.U, std.U, rtol=1e-8)

    def test_maxiter_exhaustion_records_final_residual(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((30, 30))
        A = jnp.asarray(A @ A.T + 5 * np.eye(30))
        b = jnp.asarray(rng.standard_normal(30))
        ident = lambda r: r
        out = pcg_fused(lambda x: A @ x, ident, b, 1e-14, 4)
        assert not bool(out.converged)
        assert int(out.iterations) == 4
        res = np.asarray(out.residuals)
        assert np.isfinite(res[:5]).all()  # entries 0..4 recorded
        assert np.isnan(res[5:]).all()
        pres = np.asarray(out.precond_residuals)
        assert np.isfinite(pres[:5]).all()  # incl. the exhaustion-exit entry
        assert np.isnan(pres[5:]).all()
        # entry 4 is the residual of the returned iterate
        r = np.asarray(b - A @ out.U)
        np.testing.assert_allclose(res[4], np.linalg.norm(r), rtol=1e-10)

    def test_warm_start(self):
        solver = _solvers("fused")
        r0 = solver.solve(tol=1e-4, compute_error=False)
        r1 = solver.solve(tol=1e-8, x0=r0.U, compute_error=False)
        assert r1.converged
        assert r1.iterations < r0.iterations + 25
        # convergence is relative to ||f||; the warm start must only improve
        assert r1.residuals[-1] < r0.residuals[-1]


@requires_multidevice
class TestFusedExplicit:
    def test_sharded_matches_serial_fused(self):
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        r1 = HeatSolver(problem, system, grid, pcg_variant="fused").solve(
            tol=1e-6, compute_error=False
        )
        ex = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(8), pcg_variant="fused"
        )
        r2 = ex.solve(tol=1e-6, compute_error=False)
        assert r2.converged
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)
        np.testing.assert_allclose(r2.U, r1.U, atol=1e-10)

    def test_sharded_fused_matches_standard(self):
        # End to end: fused-sharded vs standard-sharded — same solve.
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        mk = lambda v: ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(8), pcg_variant=v
        ).solve(tol=1e-6, compute_error=False)
        r_std, r_fus = mk("standard"), mk("fused")
        assert r_fus.iterations == r_std.iterations
        np.testing.assert_allclose(r_fus.residuals, r_std.residuals, rtol=1e-9)

    def test_single_psum_per_iteration(self):
        # The point of the variant: ONE psum in the fused loop body vs three
        # for the standard driver. Count all-reduces in the lowered HLO of
        # the solve (while-loop body text includes the collectives).
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)

        def hlo_of(variant):
            ex = ExplicitHeatSolver(
                problem, system, grid, make_time_mesh(8), pcg_variant=variant
            )
            fn = ex._build_solve(1e-6, 10, warm=False)
            # _build_solve returns a wrapper around the jitted shard_map; the
            # jitted callable is in its closure.
            gL, gR, u0 = ex.assemble_rhs_host()
            x0 = ex._prepare_x0(None)
            jitted = fn.__closure__[0].cell_contents
            return jitted.lower(gL, gR, u0, ex._solve_params(), x0).as_text()

        def allreduce_count(hlo):
            # Dot-product reductions lower to stablehlo.all_reduce; halo and
            # wavelet traffic use collective_permute / all_gather, so this
            # isolates the reductions.
            return hlo.count("stablehlo.all_reduce")

        n_std = allreduce_count(hlo_of("standard"))
        n_fus = allreduce_count(hlo_of("fused"))
        # Standard: 3 in the loop body (alpha-dot, residual norm, beta-dot)
        # + 3 at init = 6. Fused: ONE 3-vector reduction in the body + init
        # fnorm + final-residual norm + the maxiter-exhaustion pres branch
        # (a cond, not executed on converged runs) = 4.
        assert n_std == 6
        assert n_fus == 4
