"""Distributed-path tests on the virtual 8-device CPU mesh (SURVEY.md §4:
serial vs multi-rank equality; the JAX analogue of the reference's
serial-vs-mpiexec tests)."""

import jax
import numpy as np
import pytest

from spacetime.fem import P1System, unit_square_mesh
from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime.models import get_problem
from spacetime.parallel import ShardedHeatSolver, make_time_mesh
from spacetime.solver.heateq import HeatSolver


requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@requires_multidevice
class TestSharded:
    def _solve_pair(self, problem_name, n, grid):
        problem = get_problem(problem_name)
        system = P1System.from_mesh(unit_square_mesh(n))
        serial = HeatSolver(problem, system, grid)
        r1 = serial.solve(tol=1e-6, compute_error=False)
        mesh = make_time_mesh(8)
        sharded = ShardedHeatSolver(problem, system, grid, mesh)
        r8 = sharded.solve(tol=1e-6, compute_error=False)
        return r1, r8

    def test_uniform_grid_parity(self):
        r1, r8 = self._solve_pair("smooth2d", 8, uniform_time_grid(4))
        assert r8.converged
        assert r8.iterations == r1.iterations
        np.testing.assert_allclose(r8.residuals, r1.residuals, rtol=1e-9)
        np.testing.assert_allclose(r8.U, r1.U, atol=1e-10)

    def test_graded_grid_parity(self):
        r1, r8 = self._solve_pair("singular2d", 8, graded_time_grid(3, 3))
        assert r8.converged
        assert r8.iterations == r1.iterations
        np.testing.assert_allclose(r8.residuals, r1.residuals, rtol=1e-9)

    def test_uneven_rows_per_device(self):
        # N+1 = 17 rows over 8 devices: non-divisible sharding must still work.
        r1, r8 = self._solve_pair("smooth2d", 8, uniform_time_grid(4))
        assert r8.iterations == r1.iterations

    def test_odd_device_count(self):
        # SURVEY.md §4: halo/wavelet comm correctness under odd rank counts.
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        r1 = HeatSolver(problem, system, grid).solve(tol=1e-6, compute_error=False)
        r5 = ShardedHeatSolver(problem, system, grid, make_time_mesh(5)).solve(
            tol=1e-6, compute_error=False
        )
        assert r5.converged
        assert r5.iterations == r1.iterations
        np.testing.assert_allclose(r5.residuals, r1.residuals, rtol=1e-9)

    def test_sharding_is_applied(self):
        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        mesh = make_time_mesh(8)
        s = ShardedHeatSolver(problem, system, grid, mesh)
        import jax.numpy as jnp

        gL, gR, u0 = s.assemble_rhs_host()
        x0 = jnp.zeros((s.N + 1,) + s.gs, s.dtype)
        out = s._build_solve(1e-6, 50)(gL, gR, u0, s.params, x0)
        # The solution array must actually live sharded over the time axis.
        shard_devs = {sh.device for sh in out.U.addressable_shards}
        assert len(shard_devs) == 8


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))


@requires_multidevice
def test_varcoef_sharded_parity():
    # Weighted (Galerkin-RAP mg) path: serial vs 8-device histories equal.
    problem = get_problem("varcoef2d")
    system = P1System.from_problem(problem, unit_square_mesh(8))
    grid = uniform_time_grid(3)
    kw = dict(inner="mg", mg_coarse=4)
    r1 = HeatSolver(problem, system, grid, **kw).solve(
        tol=1e-6, compute_error=False
    )
    r8 = ShardedHeatSolver(problem, system, grid, make_time_mesh(8), **kw).solve(
        tol=1e-6, compute_error=False
    )
    assert r8.converged
    assert r8.iterations == r1.iterations
    np.testing.assert_allclose(r8.residuals, r1.residuals, rtol=1e-9)


@requires_multidevice
def test_unstructured_sharded_parity():
    # Generic-mesh path (DIA operators + Chebyshev inner): serial vs sharded.
    from spacetime.fem import l_shape_mesh

    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(6))
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


@requires_multidevice
def test_3d_sharded_parity():
    from spacetime.fem import unit_cube_mesh

    problem = get_problem("smooth3d")
    system = P1System.from_mesh(unit_cube_mesh(8))
    grid = uniform_time_grid(3)
    r1 = HeatSolver(problem, system, grid).solve(tol=1e-6, compute_error=False)
    r8 = ShardedHeatSolver(problem, system, grid, make_time_mesh(8)).solve(
        tol=1e-6, compute_error=False
    )
    assert r8.converged
    assert r8.iterations == r1.iterations
    np.testing.assert_allclose(r8.residuals, r1.residuals, rtol=1e-9)


@requires_multidevice
def test_spacetime_2d_mesh_parity():
    # cfg5-stretch layout: 4 time x 2 space devices; residual history must
    # match the serial solve.
    from spacetime.parallel import make_spacetime_mesh

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(8))
    grid = uniform_time_grid(4)
    r1 = HeatSolver(problem, system, grid).solve(tol=1e-6, compute_error=False)
    mesh = make_spacetime_mesh(4, 2)
    r42 = ShardedHeatSolver(problem, system, grid, mesh).solve(
        tol=1e-6, compute_error=False
    )
    assert r42.converged
    assert r42.iterations == r1.iterations
    np.testing.assert_allclose(r42.residuals, r1.residuals, rtol=1e-9)


def test_spacetime_2d_mesh_parity_3d():
    # cfg5-stretch layout in 3D: 2 time x 4 space devices split the leading
    # spatial grid axis (nz); history must match the serial solve.
    from spacetime.fem import unit_cube_mesh
    from spacetime.parallel import make_spacetime_mesh

    problem = get_problem("smooth3d")
    system = P1System.from_mesh(unit_cube_mesh(8))
    grid = uniform_time_grid(3)
    r1 = HeatSolver(problem, system, grid).solve(tol=1e-6, compute_error=False)
    mesh = make_spacetime_mesh(2, 4)
    r24 = ShardedHeatSolver(problem, system, grid, mesh).solve(
        tol=1e-6, compute_error=False
    )
    assert r24.converged
    assert r24.iterations == r1.iterations
    np.testing.assert_allclose(r24.residuals, r1.residuals, rtol=1e-9)


@pytest.mark.slow
def test_spacetime_2d_mesh_mg_3d():
    # The production inner at scale (multi-shift multigrid) on the 2-D
    # time x space mesh, 3D, with gs[0] = 7 NOT divisible by P_s = 4 —
    # space-sharding halos land mid-stencil on uneven blocks (the path past
    # one device's capacity needs more than an iterations > 0 assert).
    from spacetime.fem import unit_cube_mesh
    from spacetime.parallel import make_spacetime_mesh

    problem = get_problem("smooth3d")
    system = P1System.from_mesh(unit_cube_mesh(8))
    grid = uniform_time_grid(3)
    kw = dict(inner="mg", space_n=8)
    r1 = HeatSolver(problem, system, grid, **kw).solve(
        tol=1e-6, compute_error=False
    )
    r24 = ShardedHeatSolver(
        problem, system, grid, make_spacetime_mesh(2, 4), **kw
    ).solve(tol=1e-6, compute_error=False)
    assert r24.converged
    assert r24.iterations == r1.iterations
    np.testing.assert_allclose(r24.residuals, r1.residuals, rtol=1e-9)


def test_spacetime_2d_mesh_refined():
    # Mixed-precision tol=1e-8 refinement over the 2-D mesh: the f64
    # residual loop and the f32 inner PCG both ride (time, space)
    # shardings; result must match the f64 serial solve.
    import jax.numpy as jnp

    from spacetime.parallel import make_spacetime_mesh

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(8))
    grid = uniform_time_grid(4)
    s = ShardedHeatSolver(
        problem, system, grid, make_spacetime_mesh(4, 2), dtype=jnp.float32
    )
    r = s.solve_refined(tol=1e-8, compute_error=False)
    r64 = HeatSolver(problem, system, grid).solve(
        tol=1e-10, compute_error=False
    )
    assert r.residuals[-1] < 1e-8
    np.testing.assert_allclose(r.U, r64.U, atol=1e-9)


def test_spacetime_2d_mesh_graded_3d():
    # Graded time grid (uneven rows over 'time': N+1 = 12 over P_t = 2)
    # x uneven space split, 3D.
    from spacetime.fem import unit_cube_mesh
    from spacetime.parallel import make_spacetime_mesh

    problem = get_problem("singular3d")
    system = P1System.from_mesh(unit_cube_mesh(8))
    grid = graded_time_grid(3, 2)
    r1 = HeatSolver(problem, system, grid).solve(tol=1e-6, compute_error=False)
    r24 = ShardedHeatSolver(
        problem, system, grid, make_spacetime_mesh(2, 4)
    ).solve(tol=1e-6, compute_error=False)
    assert r24.converged
    assert r24.iterations == r1.iterations
    np.testing.assert_allclose(r24.residuals, r1.residuals, rtol=1e-9)
