"""Unstructured nested-refinement multigrid (SURVEY.md §2 "spatial inner
solver" at scale on general domains): fem.refine_hierarchy records the
red-refinement chain, fem.nested_interpolation is the exact nested-P1
embedding, and ops/multigrid.NestedMultiShiftMultigrid runs the multi-shift
V-cycle on it with no structured-grid assumption."""

import numpy as np
import pytest
import jax.numpy as jnp

from spacetime.fem import (
    P1System,
    l_shape_mesh,
    nested_interpolation,
    refine_hierarchy,
    uniform_time_grid,
    unit_cube_mesh,
)
from spacetime.fem.mesh import refine_uniform, sort_vertices_lex
from spacetime.models import get_problem
from spacetime.ops.multigrid import NestedMultiShiftMultigrid
from spacetime.ops.sparse import DiaMatrix
from spacetime.solver.heateq import HeatSolver


def test_interpolation_matches_hat_evaluation():
    # P equals brute-force evaluation of coarse hats at fine vertices.
    from spacetime.fem.evaluate import locate_points

    base = l_shape_mesh(8)
    fine = refine_hierarchy(base, 1)
    P = nested_interpolation(fine).toarray()
    Vf = fine.vertices[fine.interior]
    elem, bary = locate_points(base, Vf)
    c2i = np.full(base.num_vertices, -1)
    c2i[base.interior] = np.arange(base.num_interior)
    Pb = np.zeros_like(P)
    for r in range(Vf.shape[0]):
        for loc in range(base.elements.shape[1]):
            ci = c2i[base.elements[elem[r], loc]]
            if ci >= 0:
                Pb[r, ci] += bary[r, loc]
    np.testing.assert_allclose(P, Pb, atol=1e-12)


@pytest.mark.parametrize("make_base", [lambda: l_shape_mesh(8),
                                       lambda: unit_cube_mesh(3)])
def test_rap_equals_reassembly(make_base):
    # Nested spaces: Galerkin RAP through P equals coarse re-assembly.
    base = make_base()
    fine = refine_hierarchy(base, 1)
    P = nested_interpolation(fine)
    sys_f = P1System.from_mesh(fine)
    sys_c = P1System.from_mesh(base)
    for F, C in ((sys_f.A, sys_c.A), (sys_f.M, sys_c.M)):
        R = (P.T @ F @ P).toarray()
        np.testing.assert_allclose(
            R, C.toarray(), atol=1e-13 * np.abs(R).max()
        )


def test_lex_sort_restores_banded_structure():
    # Raw refinement order scatters neighbors (thousands of DIA diagonals);
    # the lex sort recovers the banded structure the DIA level matvecs need.
    raw = refine_uniform(l_shape_mesh(16))
    srt = sort_vertices_lex(raw)
    nd_raw = len(DiaMatrix.from_csr(P1System.from_mesh(raw).A).offsets)
    nd_srt = len(DiaMatrix.from_csr(P1System.from_mesh(srt).A).offsets)
    assert nd_srt == 11
    assert nd_raw > 10 * nd_srt


def test_vcycle_reduces_residual_and_is_symmetric():
    mesh = refine_hierarchy(l_shape_mesh(8), 2)
    s = P1System.from_mesh(mesh)
    # interior chain is 705 -> 161 -> 33; m_coarse=100 walks both coarsenings
    msmg, (A_c, M_c) = NestedMultiShiftMultigrid.build(
        mesh, s.A, s.M, nu=2, m_coarse=100
    )
    assert len(msmg.levels) >= 2
    T = 6
    rng = np.random.default_rng(0)
    omega = np.abs(rng.standard_normal(T)) * 4
    lps = msmg.row_params(omega, jnp.float64)
    cinvs = jnp.asarray(np.stack([np.linalg.inv(A_c + w * M_c) for w in omega]))

    def coarse(bc):
        return jnp.einsum("tm,tmn->tn", bc, cinvs)

    b = jnp.asarray(rng.standard_normal((T, msmg.levels[0].m)))
    x = msmg.solve(b, lps, coarse, cycles=2)
    r = np.asarray(b - msmg._op(msmg.levels[0], lps[0], x))
    rel = np.linalg.norm(r, axis=1) / np.linalg.norm(np.asarray(b), axis=1)
    assert rel.max() < 0.02  # two V-cycles: ~0.6% measured, allow slack

    # PCG needs a symmetric preconditioner: <K a, b> == <a, K b>.
    a2 = jnp.asarray(rng.standard_normal(b.shape))
    b2 = jnp.asarray(rng.standard_normal(b.shape))
    d1 = float((msmg.solve(a2, lps, coarse, cycles=2) * b2).sum())
    d2 = float((a2 * msmg.solve(b2, lps, coarse, cycles=2)).sum())
    assert abs(d1 - d2) <= 1e-10 * abs(d1)


@pytest.mark.parametrize(
    "problem,base,refines,levels",
    [
        ("lshape2d", lambda: l_shape_mesh(8), 2, 5),
        ("smooth3d", lambda: unit_cube_mesh(4), 2, 3),
    ],
)
@pytest.mark.slow
def test_solver_mg_matches_cheb(problem, base, refines, levels):
    # End-to-end: inner='mg' on the refined unstructured mesh converges with
    # cheb-comparable iteration counts and the same L2 error (the inner
    # solver must not change the computed solution beyond its tolerance).
    prob = get_problem(problem)
    mesh = refine_hierarchy(base(), refines)
    grid = uniform_time_grid(levels)
    sys_ = P1System.from_problem(prob, mesh)
    r_cheb = HeatSolver(prob, sys_, grid, inner="cheb").solve(tol=1e-6)
    s_mg = HeatSolver(prob, sys_, grid, inner="mg")
    assert type(s_mg.msmg).__name__ == "NestedMultiShiftMultigrid"
    r_mg = s_mg.solve(tol=1e-6)
    assert r_mg.converged
    assert abs(r_mg.iterations - r_cheb.iterations) <= 2
    np.testing.assert_allclose(r_mg.l2_error, r_cheb.l2_error, rtol=1e-3)


def test_auto_inner_picks_mg_with_hierarchy():
    # above the m<=4096 dense threshold (12033 interior dofs) auto must use
    # the recorded chain instead of falling back to cheb
    prob = get_problem("lshape2d")
    mesh = refine_hierarchy(l_shape_mesh(8), 4)
    s = HeatSolver(prob, P1System.from_problem(prob, mesh), uniform_time_grid(4))
    assert s.inner == "mg"
    # without the chain, auto falls back to cheb at the same size only when
    # large; small meshes go dense — force the comparison mesh big enough
    s2 = HeatSolver(
        prob, P1System.from_problem(prob, l_shape_mesh(16)), uniform_time_grid(4)
    )
    assert s2.inner in ("dense", "cheb")


@pytest.mark.slow
def test_sharded_parity_nested_mg():
    # 1-device vs 8-device GSPMD histories must match (CLAUDE.md invariant).
    import jax

    from spacetime.parallel import ShardedHeatSolver, make_time_mesh

    prob = get_problem("lshape2d")
    mesh = refine_hierarchy(l_shape_mesh(8), 1)
    sys_ = P1System.from_problem(prob, mesh)
    grid = uniform_time_grid(4)
    r1 = HeatSolver(prob, sys_, grid, inner="mg").solve(
        tol=1e-6, compute_error=False
    )
    rP = ShardedHeatSolver(
        prob, sys_, grid, make_time_mesh(len(jax.devices())), inner="mg"
    ).solve(tol=1e-6, compute_error=False)
    assert rP.iterations == r1.iterations
    np.testing.assert_allclose(rP.residuals, r1.residuals, rtol=1e-9)


def test_mesh_file_roundtrip_refine_hierarchy(tmp_path):
    # User-facing combination: an IMPORTED mesh (no refinement record) gains
    # a nested hierarchy by refining in-framework — run.py --mesh-file
    # --refine K --inner mg.
    from spacetime.fem import load_mesh, save_mesh

    path = str(tmp_path / "lshape.msh")
    save_mesh(l_shape_mesh(8), path)
    loaded = load_mesh(path)
    assert loaded.refined_from is None
    mesh = refine_hierarchy(loaded, 2)
    prob = get_problem("lshape2d")
    s = HeatSolver(
        prob, P1System.from_problem(prob, mesh), uniform_time_grid(5),
        inner="mg",
    )
    assert type(s.msmg).__name__ == "NestedMultiShiftMultigrid"
    r = s.solve(tol=1e-6)
    assert r.converged
    np.testing.assert_allclose(r.l2_error, 3.2796e-03, rtol=1e-3)
