"""2-D ('time','space') explicit shard_map mesh: parity vs the serial solver.

The spatial-domain-decomposition stretch (SURVEY.md §2 parallelism table —
the reference replicates space per rank; this is the framework's own
extension): duplicated halo rows over 'time' plus
padded plane slabs with ppermute halo exchanges over 'space' must reproduce
the serial residual histories to reduction-order rounding — including
uneven gs[0] % P_s splits (gs[0] = 2^k - 1 never divides an even P_s).
"""

import jax
import numpy as np
import pytest

from spacetime.fem import P1System, unit_cube_mesh, unit_square_mesh
from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime.models import get_problem
from spacetime.parallel import Explicit2DHeatSolver, make_spacetime_mesh
from spacetime.solver.heateq import HeatSolver

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _pair(problem_name, system, grid, pt, ps, tol=1e-6, **kw):
    problem = get_problem(problem_name)
    r1 = HeatSolver(problem, system, grid, **kw).solve(
        tol=tol, compute_error=False
    )
    ex = Explicit2DHeatSolver(
        problem, system, grid, make_spacetime_mesh(pt, ps), **kw
    )
    r2 = ex.solve(tol=tol, compute_error=False)
    assert r2.converged
    assert r2.iterations == r1.iterations
    np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)
    np.testing.assert_allclose(r2.U, r1.U, atol=1e-10)
    return ex, r1, r2


@requires_multidevice
class TestExplicit2D:
    def test_dense_inner_parity(self):
        # gs[0]=7 over P_s=2: uneven split (one padding plane).
        system = P1System.from_mesh(unit_square_mesh(8))
        _pair("smooth2d", system, uniform_time_grid(3), 4, 2)

    def test_mg_inner_parity_sharded_level(self):
        # 15 planes over P_s=2 -> Rs=8, one sharded MG level (D=1).
        system = P1System.from_mesh(unit_square_mesh(16))
        ex, _, _ = _pair(
            "smooth2d", system, uniform_time_grid(4), 4, 2,
            inner="mg", space_n=16,
        )
        assert ex._sp_depth == 1

    def test_mg_inner_parity_full_gather(self):
        # 15 planes over P_s=4: grid too thin to shard the hierarchy
        # (D=0) — exercises the gather-everything fallback.
        system = P1System.from_mesh(unit_square_mesh(16))
        ex, _, _ = _pair(
            "smooth2d", system, uniform_time_grid(4), 2, 4,
            inner="mg", space_n=16,
        )
        assert ex._sp_depth == 0

    def test_3d_parity(self):
        system = P1System.from_mesh(unit_cube_mesh(8))
        _pair("smooth3d", system, uniform_time_grid(3), 4, 2)

    @pytest.mark.slow
    def test_3d_mg_parity(self):
        system = P1System.from_mesh(unit_cube_mesh(8))
        _pair(
            "smooth3d", system, uniform_time_grid(3), 2, 2,
            inner="mg", space_n=8,
        )

    @pytest.mark.slow
    def test_graded_grid_parity(self):
        # General (graded) time layout composed with space sharding.
        system = P1System.from_mesh(unit_square_mesh(16))
        ex, _, _ = _pair(
            "singular2d", system, graded_time_grid(3, 3), 2, 4,
            inner="mg", space_n=16,
        )
        assert not ex.aligned

    @pytest.mark.slow
    def test_graded_odd_time_devices(self):
        system = P1System.from_mesh(unit_square_mesh(16))
        ex, _, _ = _pair(
            "singular2d", system, graded_time_grid(3, 3), 3, 2,
            inner="mg", space_n=16,
        )
        assert not ex.aligned

    @pytest.mark.slow
    def test_fused_pcg(self):
        system = P1System.from_mesh(unit_square_mesh(16))
        _pair(
            "smooth2d", system, uniform_time_grid(4), 2, 2,
            inner="mg", space_n=16, pcg_variant="fused",
        )

    @pytest.mark.slow
    def test_deep_sharded_hierarchy(self):
        # n=128: two stencil levels (128, 64) both sharded over P_s=4.
        system = P1System.from_mesh(unit_square_mesh(128))
        ex, _, _ = _pair(
            "smooth2d", system, uniform_time_grid(3), 2, 4,
            inner="mg", space_n=128,
        )
        assert ex._sp_depth == 2

    @pytest.mark.slow
    def test_refined(self):
        # Mixed-precision tol=1e-8 refinement over the 2-D mesh.
        import jax.numpy as jnp

        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(16))
        grid = uniform_time_grid(4)
        s = Explicit2DHeatSolver(
            problem, system, grid, make_spacetime_mesh(2, 4),
            dtype=jnp.float32, inner="mg", space_n=16,
        )
        r = s.solve_refined(tol=1e-8, compute_error=False)
        r64 = HeatSolver(problem, system, grid, inner="mg", space_n=16).solve(
            tol=1e-10, compute_error=False
        )
        assert r.residuals[-1] < 1e-8
        np.testing.assert_allclose(r.U, r64.U, atol=1e-8)

    def test_warm_start(self):
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(3)
        mk = lambda: Explicit2DHeatSolver(
            problem, system, grid, make_spacetime_mesh(4, 2)
        )
        full = mk().solve(tol=1e-10, compute_error=False)
        s = mk()
        part = s.solve(tol=1e-3, compute_error=False)
        resumed = s.solve(tol=1e-10, compute_error=False, x0=part.U)
        assert resumed.converged
        assert resumed.iterations < full.iterations
        np.testing.assert_allclose(resumed.U, full.U, rtol=0, atol=1e-9)

    def test_rejects_unsupported(self):
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(3)
        with pytest.raises(ValueError, match="dense.*or.*mg|not supported"):
            Explicit2DHeatSolver(
                get_problem("smooth2d"), system, grid,
                make_spacetime_mesh(4, 2), inner="cheb",
            )


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
