"""Randomized locally-refined time grids (fixed seeds): the wavelet
transform and the full solver must handle ANY admissible dyadic refinement
pattern, not just the uniform/graded shapes the named benchmarks use.

Grid generation uses the timegrid builder's refinement-predicate hook with a
deterministic pseudo-random predicate, so each seed yields one reproducible
irregular grid.
"""

import hashlib

import numpy as np
import pytest

from spacetime.fem import P1System, unit_square_mesh
from spacetime.fem.timegrid import _build
from spacetime.models import get_problem
from spacetime.ops.wavelets import build_wavelet_transform
from spacetime.oracle.solver import OracleSolver
from spacetime.solver.heateq import HeatSolver
from tests.test_wavelets import brute_force_synthesis


def random_grid(seed: int, max_level: int = 5, p_refine: float = 0.6):
    """Deterministic random dyadic refinement: each interval refines with
    probability p_refine (hash-based, so the predicate is a pure function
    of (interval, level, seed)); level-1 refinement is forced so every grid
    has at least 2 intervals."""

    def refine(a, b, lvl):
        if lvl >= max_level:
            return False
        if lvl <= 1:  # force >= 4 intervals so every grid is nontrivial
            return True
        key = f"{seed}:{a:.12f}:{b:.12f}:{lvl}".encode()
        r = int.from_bytes(hashlib.sha256(key).digest()[:4], "big") / 2**32
        return r < p_refine

    return _build(1.0, refine)


SEEDS = [0, 1, 2, 7, 11]


@pytest.mark.parametrize("seed", SEEDS)
def test_wavelet_roundtrip_on_random_grid(seed):
    grid = random_grid(seed)
    wt = build_wavelet_transform(grid)
    n = grid.num_nodes
    W = brute_force_synthesis(grid, wt)
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((n, 3))
    # forward == dense synthesis; adjoint == its transpose; exact inverse
    np.testing.assert_allclose(wt.forward_np(C), W @ C, atol=1e-12)
    np.testing.assert_allclose(wt.adjoint_np(C), W.T @ C, atol=1e-12)
    U = wt.forward_np(C)
    np.testing.assert_allclose(np.linalg.solve(W, U), C, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 7])
def test_solver_on_random_grid_matches_oracle(seed):
    grid = random_grid(seed, max_level=4)
    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(8))
    ro = OracleSolver(problem, system, grid).solve(
        tol=1e-8, compute_error=False
    )
    rj = HeatSolver(problem, system, grid).solve(tol=1e-8, compute_error=False)
    assert ro.converged and rj.converged
    assert rj.iterations == ro.iterations
    np.testing.assert_allclose(rj.residuals, ro.residuals, rtol=1e-9)
    # the paper's flat-iteration property also holds on irregular grids
    assert ro.iterations <= 25


def test_random_grids_are_irregular():
    # sanity: the generator actually produces non-uniform, non-graded grids
    for seed in SEEDS:
        g = random_grid(seed)
        h = g.h
        assert g.num_intervals >= 4
        assert not np.allclose(h, h[0])  # non-uniform
