"""The XLA stencil forms of the space-time operator against the NumPy
oracle: B, Bᵀ and the stabilization term on 2-D and 3-D structured grids,
graded/ragged time grids and a large-y grid, in f64 (to rounding) and f32
(to f32 rounding)."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spacetime.fem import P1System, unit_cube_mesh, unit_square_mesh
from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime.models import get_problem
from spacetime.oracle.solver import OracleSolver
from spacetime.solver.heateq import HeatSolver

GRIDS = {
    "2d-uniform": ("smooth2d", unit_square_mesh, 16, (4, 0)),
    "2d-graded-ragged": ("smooth2d", unit_square_mesh, 16, (3, 2)),
    "3d-uniform": ("smooth3d", unit_cube_mesh, 8, (3, 0)),
    "2d-wide": ("smooth2d", unit_square_mesh, 32, (4, 0)),
    "3d-wide": ("smooth3d", unit_cube_mesh, 10, (3, 0)),
    "2d-few-steps": ("smooth2d", unit_square_mesh, 12, (1, 0)),
    "2d-large-y": ("smooth2d", unit_square_mesh, 64, (2, 0)),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    prob, mk, n, (J, extra) = GRIDS[name]
    problem = get_problem(prob)
    system = P1System.from_mesh(mk(n))
    grid = graded_time_grid(J, extra) if extra else uniform_time_grid(J)
    inner = "dense" if system.m <= 1024 else "mg"
    solver = HeatSolver(problem, system, grid, inner=inner)
    assert solver.spatial_format == "stencil"
    return solver, OracleSolver(problem, system, grid)


def _apply(solver, op, X, dtype):
    p = solver.params_for(dtype)
    Xg = jnp.asarray(X.reshape((X.shape[0],) + solver.gs), dtype)
    fn = getattr(solver, op)
    out = jax.jit(lambda x, pp: fn(x, pp))(Xg, p)
    return np.asarray(out, np.float64).reshape(out.shape[0], -1)


@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-12),
                                        (jnp.float32, 2e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("op", ["apply_B", "apply_BT", "apply_stab"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_operator_matches_oracle(grid, op, dtype, rtol):
    solver, oracle = _pair(grid)
    rng = np.random.default_rng(zlib.crc32(f"{grid}{op}".encode()))
    rows = solver.N if op == "apply_BT" else solver.N + 1
    X = rng.standard_normal((rows, solver.m))
    if dtype == jnp.float32:
        X = X.astype(np.float32).astype(np.float64)
    got = _apply(solver, op, X, dtype)
    want = getattr(oracle, op)(X)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err
