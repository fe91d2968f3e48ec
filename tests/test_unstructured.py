"""Unstructured-mesh path: L-shaped domain, red refinement, blocked-ELL solver.

The reference reached general (non-tensor-product) domains through NGSolve
meshes (SURVEY.md §2, L0); here the equivalents are fem.mesh.l_shape_mesh /
refine_uniform and the generic DIA / blocked-ELL spatial formats of
solver.heateq.HeatSolver.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from spacetime.fem import (
    P1System,
    l_shape_mesh,
    refine_uniform,
    unit_cube_mesh,
    unit_square_mesh,
    uniform_time_grid,
)
from spacetime.models import get_problem
from spacetime.oracle.solver import OracleSolver, solve_heat_equation
from spacetime.solver.heateq import HeatSolver


def _simplex_measure(verts):
    d = verts.shape[-1]
    e = verts[..., 1:, :] - verts[..., :1, :]
    import math

    return np.abs(np.linalg.det(e)) / math.factorial(d)


def test_lshape_mesh_geometry():
    mesh = l_shape_mesh(8)
    # Total area = 3/4; reentrant corner (1/2, 1/2) must be a boundary vertex.
    vols = _simplex_measure(mesh.vertices[mesh.elements])
    assert np.isclose(vols.sum(), 0.75)
    corner = np.flatnonzero(
        np.all(np.isclose(mesh.vertices, [0.5, 0.5]), axis=1)
    )[0]
    assert mesh.boundary[corner]
    # No vertex of the removed quadrant's interior survives.
    assert not np.any(
        (mesh.vertices[:, 0] > 0.5 + 1e-12) & (mesh.vertices[:, 1] > 0.5 + 1e-12)
    )
    # Interior nodes of the two legs: boundary = outer square + reentrant edges.
    inter = mesh.vertices[mesh.interior]
    assert np.all((inter[:, 0] < 0.5 + 1e-12) | (inter[:, 1] < 0.5 - 1e-12) | True)


@pytest.mark.parametrize("base", [unit_square_mesh(4), unit_cube_mesh(2), l_shape_mesh(4)])
def test_refine_uniform_conforming(base):
    ref = refine_uniform(base)
    # 4x (2D) / 8x (3D) elements, measure preserved.
    factor = 4 if base.dim == 2 else 8
    assert len(ref.elements) == factor * len(base.elements)
    v0 = _simplex_measure(base.vertices[base.elements]).sum()
    v1 = _simplex_measure(ref.vertices[ref.elements]).sum()
    assert np.isclose(v0, v1)
    # Refinement of a structured unit mesh covers the regenerated vertex set.
    if base.grid_shape is not None:
        n2 = (base.grid_shape[0] + 1) * 2
        regen = unit_square_mesh(n2) if base.dim == 2 else unit_cube_mesh(n2)
        sa = set(map(tuple, np.round(ref.vertices, 12)))
        sb = set(map(tuple, np.round(regen.vertices, 12)))
        assert sa == sb
        assert ref.num_interior == regen.num_interior


def test_refined_mesh_assembly_matches_regenerated():
    """P1 operators on the red-refined square agree with the regenerated
    structured mesh up to the vertex permutation."""
    ref = refine_uniform(unit_square_mesh(4))
    regen = unit_square_mesh(8)
    sys_a = P1System.from_mesh(ref)
    sys_b = P1System.from_mesh(regen)
    # Match interior nodes by coordinates.
    pa = ref.vertices[ref.interior]
    pb = regen.vertices[regen.interior]
    ia = np.lexsort((pa[:, 0], pa[:, 1]))
    ib = np.lexsort((pb[:, 0], pb[:, 1]))
    for Aa, Ab in ((sys_a.A, sys_b.A), (sys_a.M, sys_b.M)):
        Da = Aa.toarray()[np.ix_(ia, ia)]
        Db = Ab.toarray()[np.ix_(ib, ib)]
        np.testing.assert_allclose(Da, Db, atol=1e-12)


def test_lshape_oracle_convergence_and_flat_iters():
    r1 = solve_heat_equation("lshape2d", space_n=8, time_levels=3)
    r2 = solve_heat_equation("lshape2d", space_n=16, time_levels=4)
    assert r1.converged and r2.converged
    rate = r1.l2_error / r2.l2_error
    assert 3.0 < rate < 5.0  # 2nd order in (h, k)
    assert abs(r2.iterations - r1.iterations) <= 2  # flat under refinement


def test_lshape_jax_dia_matches_oracle():
    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(12))
    grid = uniform_time_grid(3)
    ro = OracleSolver(problem, system, grid).solve(tol=1e-6)
    s = HeatSolver(problem, system, grid, dtype=jnp.float64)
    assert s.spatial_format == "dia"
    r = s.solve(tol=1e-6)
    assert r.iterations == ro.iterations
    np.testing.assert_allclose(
        r.residuals, ro.residuals[: len(r.residuals)], rtol=1e-9
    )


def test_lshape_ell_solver_and_refinement():
    """Flat-DIA f32 solve + mixed-precision refinement on the unstructured
    path (the format the former blocked-ELL path was checked against)."""
    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(12))
    grid = uniform_time_grid(3)
    s64 = HeatSolver(problem, system, grid, dtype=jnp.float64)
    r64 = s64.solve(tol=1e-6)
    se = HeatSolver(problem, system, grid, dtype=jnp.float32, spatial_format="dia")
    assert se.spatial_format == "dia"
    re_ = se.solve(tol=1e-6)
    assert abs(re_.iterations - r64.iterations) <= 1
    assert np.isclose(re_.l2_error, r64.l2_error, rtol=1e-3)
    rr = se.solve_refined(tol=1e-8, max_rounds=4)
    assert rr.converged
    assert rr.residuals[-1] <= 1e-8 * rr.residuals[0]


def test_unstructured_3d_tet_solve():
    """The generic (no grid_shape) path in 3D: a red-refined tet mesh of the
    cube solves through DIA + dense inner identically to the oracle, and the
    Chebyshev generic-scale inner reproduces it to outer-iteration parity."""
    from spacetime.oracle.solver import OracleSolver

    problem = get_problem("smooth3d")
    mesh = refine_uniform(unit_cube_mesh(2))
    assert mesh.grid_shape is None and mesh.dim == 3
    system = P1System.from_mesh(mesh)
    grid = uniform_time_grid(3)
    ro = OracleSolver(problem, system, grid).solve(tol=1e-6)
    rj = HeatSolver(problem, system, grid, dtype=jnp.float64).solve(tol=1e-6)
    assert rj.iterations == ro.iterations
    np.testing.assert_allclose(rj.residuals, ro.residuals, rtol=1e-10)
    assert np.isclose(rj.l2_error, ro.l2_error, rtol=1e-10)
    rc = HeatSolver(
        problem, system, grid, dtype=jnp.float64, inner="cheb"
    ).solve(tol=1e-6)
    assert abs(rc.iterations - ro.iterations) <= 1
    assert np.isclose(rc.l2_error, ro.l2_error, rtol=1e-3)


@pytest.mark.slow
def test_refined_lshape_heat_solve():
    """A red-refined L-shape runs end-to-end (the general-mesh pipeline)."""
    problem = get_problem("lshape2d")
    mesh = refine_uniform(l_shape_mesh(8))
    system = P1System.from_mesh(mesh)
    grid = uniform_time_grid(4)
    s = HeatSolver(problem, system, grid, dtype=jnp.float64)
    r = s.solve(tol=1e-6)
    assert r.converged
    coarse = solve_heat_equation("lshape2d", space_n=8, time_levels=3)
    assert r.l2_error < coarse.l2_error / 3.0


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
