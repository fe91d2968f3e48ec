"""Flexible (Polak–Ribière) PCG variant.

pcg_flex replaces the Fletcher–Reeves beta with z⁺·(r⁺−r)/(r·z)
(solver/pcg.py): for a fixed SPD preconditioner the extra overlap term
vanishes in exact arithmetic, so histories must match the standard driver to
rounding; for NON-symmetric preconditioners — the asymmetric V(nu, nu_post)
multigrid cycles that blew standard PCG up 17→69 iterations at the 3D
flagship — it restores local conjugacy and
must converge in fewer iterations than the broken standard pairing.
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
from spacetime.solver.pcg import pcg, pcg_flex

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _solver(pcg_variant, **kw):
    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(16))
    grid = uniform_time_grid(4)
    return HeatSolver(
        problem, system, grid, pcg_variant=pcg_variant,
        inner="mg", space_n=16, **kw
    )


class TestFlexSerial:
    @pytest.mark.slow
    def test_matches_standard_on_symmetric(self):
        r_std = _solver("standard").solve(tol=1e-8, compute_error=False)
        r_flx = _solver("flex").solve(tol=1e-8, compute_error=False)
        assert r_flx.converged
        assert r_flx.iterations == r_std.iterations
        np.testing.assert_allclose(r_flx.residuals, r_std.residuals, rtol=1e-9)
        np.testing.assert_allclose(r_flx.U, r_std.U, atol=1e-9)

    @pytest.mark.slow
    def test_beats_standard_on_asymmetric_cycles(self):
        # The measured failure pairing: ONE strongly asymmetric V(2,1)
        # cycle per shifted K_X solve is a non-symmetric preconditioner.
        kw = dict(mg_cycles_kx=1, mg_nu_post=1)
        r_bad = _solver("standard", **kw).solve(
            tol=1e-8, maxiter=120, compute_error=False
        )
        r_fix = _solver("flex", **kw).solve(
            tol=1e-8, maxiter=120, compute_error=False
        )
        assert r_fix.converged
        assert r_fix.iterations < r_bad.iterations

    def test_spd_direct_nonsymmetric_preconditioner(self):
        # Raw drivers: Gauss–Seidel (lower-triangular — NOT symmetric) as
        # the preconditioner. Flexible CG must converge at least as fast.
        rng = np.random.default_rng(3)
        A = rng.standard_normal((40, 40))
        A = np.asarray(A @ A.T + 40 * np.eye(40))
        L = np.tril(A)
        Linv = jnp.asarray(np.linalg.inv(L))
        Aj = jnp.asarray(A)
        b = jnp.asarray(rng.standard_normal(40))
        std = pcg(lambda x: Aj @ x, lambda r: Linv @ r, b, 1e-10, 200)
        flx = pcg_flex(lambda x: Aj @ x, lambda r: Linv @ r, b, 1e-10, 200)
        assert bool(flx.converged)
        assert int(flx.iterations) <= int(std.iterations)
        r = np.asarray(b - Aj @ flx.U)
        assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(np.asarray(b))


@requires_multidevice
class TestFlexExplicit:
    def test_sharded_matches_serial_flex(self):
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        r1 = HeatSolver(problem, system, grid, pcg_variant="flex").solve(
            tol=1e-6, compute_error=False
        )
        ex = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(8), pcg_variant="flex"
        )
        r2 = ex.solve(tol=1e-6, compute_error=False)
        assert r2.converged
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)
        np.testing.assert_allclose(r2.U, r1.U, atol=1e-10)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
