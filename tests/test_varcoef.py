"""Variable-coefficient parabolic operators: ∂t u − ∇·(κ∇u) + c·u = g.

The published method covers any SPD spatial form, not just −Δ (SURVEY.md
Appendix A: the analysis needs A_x SPD only); this family exercises the
weighted-assembly path (fem.assembly.assemble_p1 with κ/c), the autodiff
source with diffusion/reaction terms, and the generic DIA device path that
weighted (non-translation-invariant) operators must take.
"""

import numpy as np
import pytest

from spacetime.fem import P1System, unit_square_mesh, uniform_time_grid
from spacetime.fem.assembly import assemble_p1
from spacetime.models import Problem, get_problem
from spacetime.oracle import solve_heat_equation
from spacetime.solver import solve_heat_equation_device
from spacetime.solver.heateq import HeatSolver


def _brute_force_weighted(mesh, kappa, reaction):
    """Independent per-element Python-loop assembly of ∫κ∇u·∇v + c·uv."""
    import math

    nv = mesh.num_vertices
    d = mesh.dim
    A = np.zeros((nv, nv))
    for el in mesh.elements:
        v = mesh.vertices[el]
        E = (v[1:] - v[0]).T
        det = np.linalg.det(E)
        meas = abs(det) / math.factorial(d)
        G = np.linalg.inv(E)  # row i: grad lambda_{i+1} (x = v0 + E·lam)
        grads = np.vstack([-G.sum(axis=0), G])
        c = v.mean(axis=0)[None]
        kv = float(kappa(c)[0])
        cv = float(reaction(c)[0])
        Mloc = meas * (np.ones((d + 1, d + 1)) + np.eye(d + 1)) / (
            12.0 if d == 2 else 20.0
        )
        Kloc = kv * meas * (grads @ grads.T) + cv * Mloc
        for i in range(d + 1):
            for j in range(d + 1):
                A[el[i], el[j]] += Kloc[i, j]
    return A


def test_weighted_assembly_matches_brute_force():
    mesh = unit_square_mesh(4)
    kappa = lambda X: 1.0 + X[:, 0] + 0.5 * X[:, 1] ** 2
    reaction = lambda X: 2.0 + np.sin(X[:, 0])
    _, A = assemble_p1(mesh, kappa=kappa, reaction=reaction)
    A_ref = _brute_force_weighted(mesh, kappa, reaction)
    np.testing.assert_allclose(A.toarray(), A_ref, rtol=1e-12, atol=1e-14)
    # SPD on the interior block
    idx = mesh.interior
    w = np.linalg.eigvalsh(A_ref[idx][:, idx])
    assert w.min() > 0


def test_weighted_assembly_constant_coeff_reduces_to_scaled():
    mesh = unit_square_mesh(4)
    M0, A0 = assemble_p1(mesh)
    _, A = assemble_p1(
        mesh,
        kappa=lambda X: np.full(X.shape[0], 2.5),
        reaction=lambda X: np.full(X.shape[0], 0.75),
    )
    np.testing.assert_allclose(
        A.toarray(), 2.5 * A0.toarray() + 0.75 * M0.toarray(), rtol=1e-13
    )


def test_coefficient_sign_validation():
    mesh = unit_square_mesh(3)
    with pytest.raises(ValueError, match="positive"):
        assemble_p1(mesh, kappa=lambda X: X[:, 0] - 0.5)
    with pytest.raises(ValueError, match="nonnegative"):
        assemble_p1(mesh, reaction=lambda X: -np.ones(X.shape[0]))


def test_autodiff_source_terms():
    """With constant κ the weighted autodiff source must equal
    ∂t u − κΔu + c·u from the plain-hessian path, exactly."""
    import jax.numpy as jnp

    def u(t, x):
        return jnp.exp(-t) * jnp.sin(jnp.pi * x[0]) * jnp.sin(2 * jnp.pi * x[1])

    plain = Problem(name="_p", dim=2, exact=u)
    weighted = Problem(
        name="_w",
        dim=2,
        exact=u,
        kappa=lambda x: jnp.asarray(2.3),
        reaction=lambda x: 1.0 + x[0],
    )
    X = np.random.default_rng(0).uniform(0.1, 0.9, size=(17, 2))
    t = 0.37
    g_w = weighted.g(t, X)
    u_v = plain.exact_np(t, X)
    du_dt = -u_v  # ∂t e^{-t}(...) = −u
    neg_lap = plain.g(t, X) - du_dt  # plain path: g = ∂t u − Δu ⇒ this is −Δu
    expected = du_dt + 2.3 * neg_lap + (1.0 + X[:, 0]) * u_v
    np.testing.assert_allclose(g_w, expected, rtol=1e-12)


def test_varcoef_oracle_convergence_and_flat_iters():
    errs, iters = [], []
    for n, J in [(8, 3), (16, 4)]:
        r = solve_heat_equation("varcoef2d", space_n=n, time_levels=J, tol=1e-6)
        assert r.converged
        errs.append(r.l2_error)
        iters.append(r.iterations)
    # 2nd-order rate in (h, k) and refinement-robust iteration counts.
    assert 3.4 < errs[0] / errs[1] < 4.6
    assert iters[1] - iters[0] <= 2


def test_varcoef_jax_matches_oracle():
    ro = solve_heat_equation(
        "varcoef2d", space_n=8, time_levels=3, tol=1e-6, compute_error=False
    )
    rj = solve_heat_equation_device(
        "varcoef2d", space_n=8, time_levels=3, tol=1e-6, compute_error=False
    )
    assert rj.converged and rj.iterations == ro.iterations
    np.testing.assert_allclose(
        rj.residuals, ro.residuals, rtol=1e-10, atol=1e-13 * ro.residuals[0]
    )


def test_varcoef_weighted_system_rejects_stencil():
    problem = get_problem("varcoef2d")
    mesh = unit_square_mesh(8)
    system = P1System.from_problem(problem, mesh)
    assert system.weighted
    grid = uniform_time_grid(3)
    with pytest.raises(ValueError, match="stencil"):
        HeatSolver(problem, system, grid, spatial_format="stencil")
    # Auto picks the grid-layout variable-coefficient stencil on structured
    # grids; the flat forms remain explicitly selectable.
    solver = HeatSolver(problem, system, grid)
    assert solver.spatial_format == "vstencil"
    assert HeatSolver(
        problem, system, grid, spatial_format="dia"
    ).spatial_format == "dia"


def test_varcoef_sharded_matches_serial():
    from spacetime.parallel import ShardedHeatSolver, make_time_mesh

    problem = get_problem("varcoef2d")
    system = P1System.from_problem(problem, unit_square_mesh(8))
    grid = uniform_time_grid(3)
    serial = HeatSolver(problem, system, grid).solve(tol=1e-6, compute_error=False)
    sharded = ShardedHeatSolver(
        problem, system, grid, make_time_mesh(8)
    ).solve(tol=1e-6, compute_error=False)
    assert sharded.iterations == serial.iterations
    np.testing.assert_allclose(
        sharded.residuals, serial.residuals, rtol=1e-12
    )


def test_varcoef3d_smoke():
    r = solve_heat_equation("varcoef3d", space_n=4, time_levels=2, tol=1e-6)
    assert r.converged and r.iterations < 20
    assert r.l2_error < 0.1


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
