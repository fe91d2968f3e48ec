"""Device-resident load quadrature (fem/assembly.device_spacetime_loads).

The host NumPy quadrature is the parity oracle; the device path must agree
to machine precision in f64 and to f32-rounding tolerance in f32 (on an
accelerator the f32 path may additionally differ by the transcendental
functions' ulps; these CPU tests pin the algorithm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spacetime.fem import (
    P1System,
    device_spacetime_loads,
    spacetime_loads,
    unit_cube_mesh,
    unit_square_mesh,
)
from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime.models import get_problem
from spacetime.solver.heateq import HeatSolver


def _host(problem, mesh, grid):
    return spacetime_loads(problem, mesh, grid)


class TestDeviceLoads:
    def test_f64_matches_host_to_rounding(self):
        p = get_problem("smooth2d")
        mesh = unit_square_mesh(16)
        grid = uniform_time_grid(4)
        gL, gR, u0 = _host(p, mesh, grid)
        d = device_spacetime_loads(p, mesh, grid, jnp.float64)
        np.testing.assert_allclose(d[0], gL, rtol=0, atol=1e-14)
        np.testing.assert_allclose(d[1], gR, rtol=0, atol=1e-14)
        np.testing.assert_allclose(d[2], u0, rtol=0, atol=1e-14)

    def test_f32_close(self):
        p = get_problem("smooth2d")
        mesh = unit_square_mesh(16)
        grid = uniform_time_grid(4)
        gL, _, _ = _host(p, mesh, grid)
        d = device_spacetime_loads(p, mesh, grid, jnp.float32)
        err = np.abs(np.asarray(d[0], np.float64) - gL)
        big = np.abs(gL) > 0.1 * np.abs(gL).max()
        assert (err / np.abs(gL))[big].max() < 2e-5

    def test_graded_grid(self):
        p = get_problem("singular2d")
        mesh = unit_square_mesh(8)
        grid = graded_time_grid(3, 3)
        gL, gR, u0 = _host(p, mesh, grid)
        d = device_spacetime_loads(p, mesh, grid, jnp.float64)
        np.testing.assert_allclose(d[0], gL, rtol=0, atol=1e-14)
        np.testing.assert_allclose(d[1], gR, rtol=0, atol=1e-14)

    def test_3d(self):
        p = get_problem("smooth3d")
        mesh = unit_cube_mesh(6)
        grid = uniform_time_grid(3)
        gL, gR, u0 = _host(p, mesh, grid)
        d = device_spacetime_loads(p, mesh, grid, jnp.float64)
        np.testing.assert_allclose(d[0], gL, rtol=0, atol=1e-14)
        np.testing.assert_allclose(d[2], u0, rtol=0, atol=1e-14)

    def test_element_blocking_invariant(self, monkeypatch):
        # Forcing multi-block element scans (incl. a padded tail block)
        # must reproduce the single-block loads to rounding — the big-3D
        # path, where blocking bounds the quadrature's working set.
        from spacetime.fem import assembly

        p = get_problem("smooth3d")
        mesh = unit_cube_mesh(6)  # 1080 tets
        grid = uniform_time_grid(3)
        a = device_spacetime_loads(p, mesh, grid, jnp.float64)
        monkeypatch.setattr(assembly, "_POINT_BLOCK", 400)  # 100-elem blocks
        b = device_spacetime_loads(p, mesh, grid, jnp.float64)
        gL, gR, u0 = _host(p, mesh, grid)
        for x, y, h in zip(a, b, (gL, gR, u0)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=0, atol=1e-15)
            np.testing.assert_allclose(np.asarray(y), h, rtol=0, atol=1e-14)

    def test_chunking_invariant(self):
        # Different chunk sizes (incl. non-dividing -> padded tail) must
        # produce identical loads.
        p = get_problem("smooth2d")
        mesh = unit_square_mesh(8)
        grid = uniform_time_grid(4)  # 64 quadrature times
        a = device_spacetime_loads(p, mesh, grid, jnp.float64, chunk=64)
        b = device_spacetime_loads(p, mesh, grid, jnp.float64, chunk=24)
        # reduction order inside the XLA scatter varies with the batch
        # shape, so equality holds to rounding, not bitwise
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                                   rtol=0, atol=1e-15)
        np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]),
                                   rtol=0, atol=1e-15)

    def test_requires_manufactured_problem(self):
        p = get_problem("smooth2d")
        p_no_exact = p.__class__(
            name="x", dim=2, exact=None,
            g_override=lambda t, X: np.zeros(len(X)),
            u0_override=lambda X: np.zeros(len(X)),
        )
        mesh = unit_square_mesh(8)
        grid = uniform_time_grid(3)
        with pytest.raises(ValueError):
            device_spacetime_loads(p_no_exact, mesh, grid, jnp.float64)


class TestSolverRhsMode:
    def _solver(self, **kw):
        p = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(16))
        grid = uniform_time_grid(4)
        return HeatSolver(p, system, grid, **kw)

    def test_auto_rule(self):
        assert self._solver(dtype=jnp.float32).rhs_mode == "device"
        assert self._solver(dtype=jnp.float64).rhs_mode == "host"

    def test_device_rhs_solve_matches_host_rhs_solve(self):
        r_host = self._solver(dtype=jnp.float32, rhs="host").solve(
            tol=1e-5, compute_error=True
        )
        r_dev = self._solver(dtype=jnp.float32, rhs="device").solve(
            tol=1e-5, compute_error=True
        )
        assert r_dev.converged
        assert abs(r_dev.iterations - r_host.iterations) <= 1
        # same discrete problem up to f32 quadrature rounding
        np.testing.assert_allclose(
            r_dev.l2_error, r_host.l2_error, rtol=1e-3
        )

    def test_device_error_matches_host_error(self):
        from spacetime.fem.errors import (
            device_l2_error_spacetime,
            l2_error_spacetime,
        )

        p = get_problem("smooth2d")
        mesh = unit_square_mesh(16)
        grid = uniform_time_grid(4)
        rng = np.random.default_rng(5)
        U = rng.standard_normal((grid.num_intervals + 1, mesh.num_interior))
        a = l2_error_spacetime(p, mesh, grid, U)
        b = device_l2_error_spacetime(p, mesh, grid, U)
        np.testing.assert_allclose(b, a, rtol=1e-12)
        # chunk-size invariance (padded tail)
        c = device_l2_error_spacetime(p, mesh, grid, U, chunk=5)
        np.testing.assert_allclose(c, a, rtol=1e-12)

    def test_device_error_element_blocking(self, monkeypatch):
        # Forced multi-block element scans (incl. padded tail block) must
        # match the host quadrature — the big-3D path, where blocking bounds
        # the error quadrature's working set.
        from spacetime.fem import assembly
        from spacetime.fem.errors import (
            device_l2_error_spacetime,
            l2_error_spacetime,
        )

        p = get_problem("smooth3d")
        mesh = unit_cube_mesh(6)  # 1080 tets
        grid = uniform_time_grid(3)
        rng = np.random.default_rng(7)
        U = rng.standard_normal((grid.num_intervals + 1, mesh.num_interior))
        a = l2_error_spacetime(p, mesh, grid, U)
        monkeypatch.setattr(assembly, "_POINT_BLOCK", 400)  # 100-elem blocks
        b = device_l2_error_spacetime(p, mesh, grid, U)
        np.testing.assert_allclose(b, a, rtol=1e-12)

    def test_solve_reports_device_error(self):
        r_dev = self._solver(dtype=jnp.float32, rhs="device").solve(
            tol=1e-5, compute_error=True
        )
        r_host = self._solver(dtype=jnp.float64).solve(
            tol=1e-5, compute_error=True
        )
        np.testing.assert_allclose(r_dev.l2_error, r_host.l2_error, rtol=1e-3)

    def test_f64_device_mode_falls_back_to_host(self):
        # explicit rhs='device' + f64 dtype: assemble_rhs_host keeps the
        # host parity loads for an f64 solver (the oracle parity contract).
        s = self._solver(dtype=jnp.float64, rhs="device")
        gL, _, _ = s.assemble_rhs_host()
        host = spacetime_loads(s.problem, s.system.mesh, s.grid)[0]
        np.testing.assert_array_equal(
            np.asarray(gL).reshape(s.N, s.m), host
        )
