"""Smoothed-aggregation AMG inner solver (the generic-mesh scale path for
meshes with NO refinement record).

inner='amg' builds an algebraic hierarchy from the assembled (A, M) alone
(ops/multigrid.sa_prolongator + SAMultiShiftMultigrid) — the device-path
replacement for the reference's factorize-once splu on imported meshes where
neither the structured-grid nor the nested-refinement geometric hierarchies
exist, and where the Chebyshev alternative's polynomial degrees grow like
h⁻¹ (SURVEY.md §2 "spatial inner solver"). These tests pin: the aggregation
is a partition, the smoothed prolongator and Galerkin RAP are consistent,
the ELL coarse-level operator is exact, the V-cycle contracts with a
mesh-independent factor, and the full solve matches the exact-inner solution
at discretization accuracy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from spacetime.fem import P1System, l_shape_mesh
from spacetime.fem.timegrid import uniform_time_grid
from spacetime.models import get_problem
from spacetime.ops.multigrid import SAMultiShiftMultigrid, sa_prolongator
from spacetime.solver.heateq import HeatSolver


def test_sa_prolongator_partition_and_rap():
    system = P1System.from_mesh(l_shape_mesh(32))
    A = sp.csr_matrix(system.A)
    P = sa_prolongator(A)
    n, nc = P.shape
    assert nc < n // 2  # real coarsening
    # every fine dof interpolates from at least one aggregate
    counts = np.diff(P.tocsr().indptr)
    assert (counts >= 1).all()
    # Galerkin coarse operator stays SPD
    Ac = (P.T @ A @ P).toarray()
    np.testing.assert_allclose(Ac, Ac.T, atol=1e-12)
    w = np.linalg.eigvalsh(Ac)
    assert w[0] > 0


def test_ell_level_operator_exact():
    # The union-pattern ELL storage of an aggregated coarse level must
    # reproduce the scipy matvec exactly (incl. the zero-padded slots).
    system = P1System.from_mesh(l_shape_mesh(64))
    A = sp.csr_matrix(system.A)
    M = sp.csr_matrix(system.M)
    msmg, _ = SAMultiShiftMultigrid.build(A, M, m_coarse=300)
    ell_levels = [lv for lv in msmg.levels if lv.fmt == "ell"]
    assert ell_levels, "expected at least one aggregated ELL level"
    # rebuild the level's scipy matrices by Galerkin RAP to compare
    Acur, Mcur = A, M
    for lev in msmg.levels:
        if lev.fmt == "ell":
            rng = np.random.default_rng(0)
            x = rng.standard_normal((3, lev.m))
            for omega in (0.0, 7.5):
                lps = msmg.row_params(np.full(3, omega), jnp.float64)
                lp = lps[msmg.levels.index(lev)]
                got = np.asarray(msmg._op(lev, lp, jnp.asarray(x)))
                want = x @ Acur.T + omega * (x @ Mcur.T)
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        # advance to the next level's matrices
        Pl = sp.csr_matrix(
            (lev.Pw.ravel(), (np.repeat(np.arange(lev.m), lev.Pidx.shape[1]),
                              lev.Pidx.ravel())),
            shape=(lev.m, lev.Ridx.shape[0]),
        )
        Acur = (Pl.T @ Acur @ Pl).tocsr()
        Mcur = (Pl.T @ Mcur @ Pl).tocsr()


def test_factored_transfers_match_gather():
    # DIA levels carry the factored transfer form P = (I - wD^-1 A) T
    # (one banded matvec + K=1 / member-sum gathers); it must reproduce
    # the gather-ELL transfers of the SAME prolongator to fp rounding.
    system = P1System.from_mesh(l_shape_mesh(64))
    A = sp.csr_matrix(system.A)
    M = sp.csr_matrix(system.M)
    msmg, _ = SAMultiShiftMultigrid.build(A, M, m_coarse=300)
    lev = msmg.levels[0]
    assert lev.fmt == "dia" and lev.agg is not None
    lps = msmg.row_params(np.zeros(3), jnp.float64)
    lp = lps[0]
    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.standard_normal((3, lev.m)))
    rc_g = np.asarray(msmg._restrict(r, lp))
    rc_f = np.asarray(msmg._restrict_fact(lev, lp, r))
    np.testing.assert_allclose(rc_f, rc_g, rtol=1e-9, atol=1e-10)
    e = jnp.asarray(rng.standard_normal((3, lev.Ridx.shape[0])))
    ef_g = np.asarray(msmg._interp(e, lp))
    ef_f = np.asarray(msmg._interp_fact(lev, lp, e))
    np.testing.assert_allclose(ef_f, ef_g, rtol=1e-9, atol=1e-10)
    # every fine dof has exactly one parent and every aggregate its
    # members: the member mask row-sums reproduce the aggregate sizes
    assert int(lp["mem_w"].sum()) == lev.m


@pytest.mark.parametrize("omega", [0.0, 1000.0])
def test_vcycle_contracts(omega):
    system = P1System.from_mesh(l_shape_mesh(64))
    A, M = sp.csr_matrix(system.A), sp.csr_matrix(system.M)
    msmg, (Ac, Mc) = SAMultiShiftMultigrid.build(A, M, m_coarse=300)
    Op = (A + omega * M).tocsr()
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(A.shape[0])
    lps = msmg.row_params(np.array([omega]), jnp.float64)
    cinv = jnp.asarray(np.linalg.inv(Ac + omega * Mc))
    coarse = lambda bc: bc @ cinv.T
    b = jnp.asarray(Op @ x_true)[None, :]
    x = jnp.zeros_like(b)
    errs = []
    for _ in range(5):
        r = b - msmg._op(msmg.levels[0], lps[0], x)
        x = x + msmg.vcycle(r, lps, coarse)
        errs.append(
            np.linalg.norm(np.asarray(x)[0] - x_true) / np.linalg.norm(x_true)
        )
    # per-cycle contraction (measured ~0.29 for omega=0, ~0.1 shifted)
    assert errs[-1] / errs[0] < 0.4 ** 4
    assert errs[-1] < 1e-3


def test_solve_matches_dense_inner_quick():
    # Quick-tier representative of the AMG dense-inner parity invariant
    # (round-4 advisor: one small unmarked test per invariant class in the
    # default tier; the larger variant below stays slow-marked).
    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(16))
    grid = uniform_time_grid(3)
    r_dense = HeatSolver(problem, system, grid, inner="dense").solve(
        tol=1e-6, compute_error=True
    )
    solver = HeatSolver(problem, system, grid, inner="amg", mg_coarse=64)
    assert solver.mg_flavor == "SAMultiShiftMultigrid"
    r_amg = solver.solve(tol=1e-6, compute_error=True)
    assert r_amg.converged
    assert r_amg.iterations <= r_dense.iterations + 5
    np.testing.assert_allclose(r_amg.l2_error, r_dense.l2_error, rtol=2e-2)


@pytest.mark.slow
def test_solve_matches_dense_inner():
    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(24))
    grid = uniform_time_grid(5)
    r_dense = HeatSolver(problem, system, grid, inner="dense").solve(
        tol=1e-6, compute_error=True
    )
    solver = HeatSolver(problem, system, grid, inner="amg")
    assert solver.mg_flavor == "SAMultiShiftMultigrid"
    r_amg = solver.solve(tol=1e-6, compute_error=True)
    assert r_amg.converged
    # the algebraic hierarchy costs a few outer iterations (measured +2/3
    # at rho~0.29 cycles) but not the computed solution
    assert r_amg.iterations <= r_dense.iterations + 5
    np.testing.assert_allclose(r_amg.l2_error, r_dense.l2_error, rtol=2e-2)


@pytest.mark.slow
def test_solve_f32_and_refined():
    problem = get_problem("lshape2d")
    system = P1System.from_mesh(l_shape_mesh(24))
    grid = uniform_time_grid(4)
    r32 = HeatSolver(
        problem, system, grid, dtype=jnp.float32, inner="amg"
    ).solve(tol=1e-6, compute_error=True)
    assert r32.converged
    rr = HeatSolver(problem, system, grid, inner="amg").solve_refined(
        tol=1e-8
    )
    assert rr.converged and rr.residuals[-1] < 1e-8


def test_amg_requires_flat_layout():
    from spacetime.fem import unit_square_mesh

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(16))
    with pytest.raises(ValueError, match="flat dof layout"):
        HeatSolver(problem, system, uniform_time_grid(3), inner="amg")


@pytest.mark.slow
def test_amg_on_forced_dia_structured():
    # structured mesh forced onto the generic DIA path: amg must work there
    # too (the layout, not the mesh family, is the requirement)
    from spacetime.fem import unit_square_mesh

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(16))
    r = HeatSolver(
        problem, system, uniform_time_grid(4), inner="amg",
        spatial_format="dia",
    ).solve(tol=1e-6, compute_error=True)
    assert r.converged and r.iterations <= 16
    np.testing.assert_allclose(r.l2_error, 3.6711e-03, rtol=2e-2)


@pytest.mark.slow
def test_amg_3d():
    # 3D: tetrahedral P1 graphs have ~15 nnz/row and much faster (~27x)
    # aggregation coarsening than 2D — pin that the hierarchy still
    # contracts and the solve matches the dense-inner solution (the
    # imported-3D-mesh regime, e.g. TetGen files at native resolution).
    from spacetime.fem import unit_cube_mesh

    problem = get_problem("smooth3d")
    system = P1System.from_mesh(unit_cube_mesh(12))
    grid = uniform_time_grid(3)
    r_dense = HeatSolver(
        problem, system, grid, inner="dense", spatial_format="dia"
    ).solve(tol=1e-6, compute_error=True)
    solver = HeatSolver(
        problem, system, grid, inner="amg", spatial_format="dia",
        mg_coarse=256,
    )
    assert solver.mg_flavor == "SAMultiShiftMultigrid"
    r = solver.solve(tol=1e-6, compute_error=True)
    assert r.converged
    assert r.iterations <= r_dense.iterations + 5
    np.testing.assert_allclose(r.l2_error, r_dense.l2_error, rtol=2e-2)


def test_aggressive_aggregation_builder():
    """Two-pass (composed) aggregation: ~ratio² coarsening, same P support.

    Solver-level this is a MEASURED dead end (12 → 86 PCG iterations at the
    2945-dof L-shape — sa_prolongator docstring), kept at the builder level
    for hierarchy experiments; this test pins the structural contract: the
    composed aggregates form a partition and the first coarse level shrinks
    by at least ~2.5x vs standard aggregation."""
    sys_ = P1System.from_problem(get_problem("lshape2d"), l_shape_mesh(48))
    m = sys_.A.shape[0]
    P_std, agg_s, tw_s, _ = sa_prolongator(sys_.A, return_parts=True)
    P_agr, agg_a, tw_a, _ = sa_prolongator(
        sys_.A, return_parts=True, aggressive=True
    )
    assert agg_a.shape == (m,) and (agg_a >= 0).all()
    na_s, na_a = P_std.shape[1], P_agr.shape[1]
    assert np.unique(agg_a).size == na_a  # partition covers every aggregate
    assert na_a * 2.5 <= na_s, (na_s, na_a)
    # tentative weights are 1/sqrt(aggregate size) of the COMPOSED partition
    counts = np.bincount(agg_a, minlength=na_a)
    np.testing.assert_allclose(tw_a, 1.0 / np.sqrt(counts[agg_a]))
    # P rows still have the smoothed one-ring support (degree-1 smoothing)
    assert P_agr.nnz <= P_std.nnz * 1.2
