"""Parity tests: jitted JAX solver vs NumPy oracle (SURVEY.md §7.2 step 2
gate — identical iteration counts, residual histories to fp tolerance)."""

import numpy as np
import pytest

from spacetime.oracle import solve_heat_equation
from spacetime.solver import solve_heat_equation_device


@pytest.mark.parametrize(
    "problem,n,J,extra",
    [
        ("smooth2d", 8, 3, 0),
        ("smooth2d", 16, 4, 0),
        ("smooth3d", 4, 2, 0),
        ("singular2d", 8, 3, 3),
        ("moving_peak2d", 8, 3, 0),
    ],
)
def test_parity_with_oracle(problem, n, J, extra):
    ro = solve_heat_equation(
        problem, space_n=n, time_levels=J, extra_time_levels=extra, tol=1e-6,
        compute_error=False,
    )
    rj = solve_heat_equation_device(
        problem, space_n=n, time_levels=J, extra_time_levels=extra, tol=1e-6,
        compute_error=False,
    )
    assert rj.converged
    assert rj.iterations == ro.iterations
    np.testing.assert_allclose(
        rj.residuals, ro.residuals, rtol=1e-10, atol=1e-13 * ro.residuals[0]
    )


def test_tight_tolerance_1e8():
    ro = solve_heat_equation(
        "smooth2d", space_n=16, time_levels=4, tol=1e-8, compute_error=False
    )
    rj = solve_heat_equation_device(
        "smooth2d", space_n=16, time_levels=4, tol=1e-8, compute_error=False
    )
    assert rj.converged and rj.iterations == ro.iterations
    assert rj.residuals[-1] <= 1e-8 * np.linalg.norm(rj.residuals[0])


def test_float32_mode_converges_loosely():
    import jax.numpy as jnp

    r = solve_heat_equation_device(
        "smooth2d", space_n=8, time_levels=3, tol=1e-4, dtype=jnp.float32,
        compute_error=True,
    )
    assert r.converged
    assert r.l2_error < 0.02


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))


def test_mixed_precision_refinement():
    # f32 inner PCG + f64 residual loop reaches 1e-8 in a few rounds and
    # matches the oracle's solution quality (BASELINE.md cfg1b analogue).
    from spacetime.fem import P1System, unit_square_mesh
    from spacetime.fem.timegrid import uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    s = HeatSolver(
        get_problem("smooth2d"),
        P1System.from_mesh(unit_square_mesh(16)),
        uniform_time_grid(4),
    )
    r = s.solve_refined(tol=1e-8, max_rounds=5)
    assert r.converged
    assert len(r.residuals) <= 4  # ~1e-4 contraction per round
    assert r.residuals[-1] <= 1e-8 * r.residuals[0]
    assert abs(r.l2_error - 3.6711e-03) < 1e-5


def test_dia_fallback_matches_stencil():
    # The generic flat-DIA path (unstructured-mesh fallback) must agree with
    # the structured stencil path exactly.
    from spacetime.fem import P1System, unit_square_mesh
    from spacetime.fem.timegrid import uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(8))
    grid = uniform_time_grid(3)
    r_st = HeatSolver(problem, system, grid, spatial_format="stencil").solve(
        tol=1e-6, compute_error=False
    )
    r_dia = HeatSolver(problem, system, grid, spatial_format="dia").solve(
        tol=1e-6, compute_error=False
    )
    assert r_dia.iterations == r_st.iterations
    np.testing.assert_allclose(r_dia.residuals, r_st.residuals, rtol=1e-9)


def test_singular3d_graded_parity():
    # 3D + graded time grid together (new problem family): jitted path
    # matches the oracle; the graded grid handles the t->0 singularity at
    # flat iteration counts.
    import jax.numpy as jnp

    from spacetime.fem import P1System, unit_cube_mesh
    from spacetime.fem.timegrid import graded_time_grid
    from spacetime.models import get_problem
    from spacetime.oracle.solver import OracleSolver
    from spacetime.solver.heateq import HeatSolver

    problem = get_problem("singular3d")
    system = P1System.from_mesh(unit_cube_mesh(6))
    grid = graded_time_grid(2, 3)
    ro = OracleSolver(problem, system, grid).solve(tol=1e-6)
    rj = HeatSolver(problem, system, grid).solve(tol=1e-6)
    assert ro.converged and rj.converged
    assert rj.iterations == ro.iterations <= 20
    np.testing.assert_allclose(rj.residuals, ro.residuals, rtol=1e-9)
    np.testing.assert_allclose(rj.l2_error, ro.l2_error, rtol=1e-10)


@pytest.mark.slow
def test_donate_rhs_and_scalar_x0_placeholder():
    """Capacity levers (single-chip HBM ceiling, BASELINE.md cfg5): cold
    starts pass a scalar x0 placeholder instead of staging a zero field,
    and donate_rhs=True hands the staged load buffers to the executable
    (re-staged per solve). Histories must be identical to the plain path,
    including across repeated and warm-started solves."""
    import jax.numpy as jnp

    from spacetime.fem import P1System, unit_square_mesh
    from spacetime.fem.timegrid import uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    prob = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(12))
    grid = uniform_time_grid(4)
    ref = HeatSolver(prob, system, grid).solve(tol=1e-6, compute_error=False)
    s = HeatSolver(prob, system, grid, donate_rhs=True)
    r1 = s.solve(tol=1e-6, compute_error=False)
    r2 = s.solve(tol=1e-6, compute_error=False)  # re-staged loads
    assert r1.iterations == ref.iterations == r2.iterations
    np.testing.assert_allclose(r1.residuals, ref.residuals, rtol=1e-12)
    np.testing.assert_allclose(r2.residuals, ref.residuals, rtol=1e-12)
    part = s.solve(tol=1e-3, compute_error=False)
    res = s.solve(tol=1e-10, compute_error=False, x0=part.U)
    assert res.converged and res.iterations < ref.iterations + 10
    np.testing.assert_allclose(
        res.U, HeatSolver(prob, system, grid).solve(
            tol=1e-10, compute_error=False
        ).U, atol=1e-9,
    )
