"""Point evaluation of space-time solutions (fem/evaluate.py).

The reference inherited point evaluation from NGSolve GridFunctions
(SURVEY.md §2, L0); this is the host-side equivalent over the returned
coefficient arrays.
"""

import numpy as np
import pytest

from spacetime.fem import (
    evaluate_solution,
    l_shape_mesh,
    locate_points,
    unit_cube_mesh,
    unit_square_mesh,
    uniform_time_grid,
)
from spacetime.models import get_problem
from spacetime.oracle.solver import OracleSolver
from spacetime.fem import P1System


@pytest.mark.parametrize(
    "mesh", [unit_square_mesh(7), unit_cube_mesh(4), l_shape_mesh(8)],
    ids=["square", "cube", "lshape"],
)
def test_locate_points_barycentric(mesh):
    rng = np.random.default_rng(3)
    # Random convex combinations of element vertices are inside by
    # construction — located barycentrics must reproduce the point.
    e = rng.integers(0, mesh.elements.shape[0], size=50)
    lam = rng.dirichlet(np.ones(mesh.dim + 1), size=50)
    X = np.einsum("qa,qad->qd", lam, mesh.vertices[mesh.elements[e]])
    elem, bary = locate_points(mesh, X)
    verts = mesh.vertices[mesh.elements[elem]]
    np.testing.assert_allclose(
        np.einsum("qa,qad->qd", bary, verts), X, atol=1e-12
    )
    assert bary.min() >= 0.0
    np.testing.assert_allclose(bary.sum(axis=1), 1.0, atol=1e-12)


def test_locate_rejects_outside_points():
    mesh = l_shape_mesh(8)
    with pytest.raises(ValueError, match="outside"):
        locate_points(mesh, np.array([[0.75, 0.75]]))  # the removed quadrant
    with pytest.raises(ValueError, match="outside"):
        locate_points(unit_square_mesh(4), np.array([[1.5, 0.5]]))


def test_evaluate_reproduces_p1_interpolant():
    """P1 reproduces functions linear in space exactly; hat-in-time
    reproduces functions linear in t exactly — so u(t,x) = (1+t)·g(x) with
    g linear (and zero where the Dirichlet mask applies) evaluates exactly
    at arbitrary interior points."""
    mesh = unit_square_mesh(6)
    grid = uniform_time_grid(3)
    g = lambda X: 0.3 * X[:, 0] - 0.7 * X[:, 1] + 0.2
    gv = g(mesh.vertices[mesh.interior])
    U = (1.0 + grid.t)[:, None] * gv[None, :]
    rng = np.random.default_rng(0)
    X = rng.uniform(0.2, 0.8, size=(20, 2))
    ts = rng.uniform(0.0, 1.0, size=7)
    vals = evaluate_solution(mesh, grid, U, ts, X)
    # Interior points away from the boundary strip: no Dirichlet vertex in
    # their elements at n=6 with X in [0.2, 0.8]... elements near the strip
    # may touch boundary vertices, where the interpolant is the MASKED g.
    # Build the expected value from the same masked vertex data instead.
    gfull = g(mesh.vertices) * (~mesh.boundary)
    elem, bary = locate_points(mesh, X)
    expect_space = np.einsum(
        "qa,qa->q", bary, gfull[mesh.elements[elem]]
    )
    expect = (1.0 + ts)[:, None] * expect_space[None, :]
    np.testing.assert_allclose(vals, expect, atol=1e-13)


def test_evaluate_matches_exact_solution_after_solve():
    prob = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(16))
    grid = uniform_time_grid(4)
    res = OracleSolver(prob, system, grid).solve(tol=1e-8, compute_error=False)
    pts = np.array([[0.5, 0.5], [0.25, 0.75], [0.7, 0.3]])
    ts = np.array([0.0, 0.5, 1.0])
    vals = evaluate_solution(system.mesh, grid, res.U, ts, pts)
    exact = np.stack([prob.exact_np(t, pts) for t in ts])
    # Discretization error at 17x17x16 is ~4e-3 in L2; pointwise similar.
    np.testing.assert_allclose(vals, exact, atol=2e-2)
    assert np.abs(vals - exact).max() > 1e-8  # it is the FE solution, not exact


def test_evaluate_time_nodes_and_scalars():
    mesh = unit_square_mesh(5)
    grid = uniform_time_grid(3)
    rng = np.random.default_rng(1)
    U = rng.standard_normal((grid.num_intervals + 1, mesh.num_interior))
    # Evaluating exactly at a mesh vertex and grid node returns the
    # coefficient itself.
    k = mesh.interior[4]
    x = mesh.vertices[k]
    v = evaluate_solution(mesh, grid, U, grid.t[2], x)
    assert np.ndim(v) == 0
    np.testing.assert_allclose(float(v), U[2, 4], atol=1e-13)
    with pytest.raises(ValueError, match="times"):
        evaluate_solution(mesh, grid, U, 2.0, x)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
