"""Wavelet transform tests (SURVEY.md §4: invertibility, adjointness,
vanishing moments, norm equivalence, locally refined grids)."""

import numpy as np
import pytest

from spacetime.fem import uniform_time_grid, graded_time_grid, time_matrices
from spacetime.ops.wavelets import build_wavelet_transform


def brute_force_synthesis(grid, wt):
    """Independently build each basis function's fine-grid nodal values by
    piecewise-linear interpolation from its level grid."""
    n = grid.num_nodes
    W = np.zeros((n, n))
    for k in range(n):
        j = grid.level[k]
        present = np.flatnonzero(grid.level <= j)
        t_pres = grid.t[present]
        vals = np.zeros(present.size)
        pos = {int(p): i for i, p in enumerate(present)}
        if j == 0:
            which = np.flatnonzero(wt.root_idx == k)[0]
            vals[pos[k]] = wt.root_s[which]
        else:
            lev = wt.levels[j - 1]
            a = np.flatnonzero(lev.idx == k)[0]
            vals[pos[k]] = lev.s[a]
            vals[pos[int(lev.pl[a])]] = lev.s[a] * lev.wl[a]
            vals[pos[int(lev.pr[a])]] = lev.s[a] * lev.wr[a]
        W[:, k] = np.interp(grid.t, t_pres, vals)
    return W


@pytest.mark.parametrize(
    "grid",
    [
        uniform_time_grid(1),
        uniform_time_grid(3),
        uniform_time_grid(5),
        graded_time_grid(2, 3),
        graded_time_grid(3, 4, t_crit=0.0),
    ],
    ids=["J1", "J3", "J5", "graded23", "graded34"],
)
class TestWaveletTransform:
    def test_matches_brute_force(self, grid):
        wt = build_wavelet_transform(grid)
        W = wt.dense()
        W_ref = brute_force_synthesis(grid, wt)
        assert np.allclose(W, W_ref, atol=1e-12)

    def test_adjoint_is_transpose(self, grid):
        wt = build_wavelet_transform(grid)
        n = grid.num_nodes
        W = wt.dense()
        Wt = wt.adjoint_np(np.eye(n))
        assert np.allclose(Wt, W.T, atol=1e-12)

    def test_invertible_roundtrip(self, grid):
        wt = build_wavelet_transform(grid)
        W = wt.dense()
        c = np.linalg.solve(W, np.sin(3 * grid.t))
        assert np.allclose(wt.forward_np(c), np.sin(3 * grid.t))

    def test_l2_normalized(self, grid):
        wt = build_wavelet_transform(grid)
        G = time_matrices(grid)["G_t"].toarray()
        W = wt.dense()
        norms = np.einsum("ik,ij,jk->k", W, G, W)
        assert np.allclose(norms, 1.0, atol=1e-12)

    def test_vanishing_moments(self, grid):
        wt = build_wavelet_transform(grid)
        G = time_matrices(grid)["G_t"].toarray()
        W = wt.dense()
        moments = np.ones(grid.num_nodes) @ G @ W  # ∫ psi_k dt
        fine = grid.level >= 1
        assert np.allclose(moments[fine], 0.0, atol=1e-12)

    def test_omega_scaling(self, grid):
        # |psi'|/|psi| must scale like 2^level (Bernstein), within constants.
        wt = build_wavelet_transform(grid)
        lev = wt.node_level
        om = wt.node_omega
        for j in range(1, grid.max_level + 1):
            sel = lev == j
            if not sel.any():
                continue
            ratio = om[sel] / 2.0**j
            assert ratio.min() > 0.5 and ratio.max() < 8.0

    def test_jax_matches_numpy(self, grid):
        import jax.numpy as jnp

        wt = build_wavelet_transform(grid)
        rng = np.random.default_rng(5)
        x = rng.standard_normal((grid.num_nodes, 3))
        assert np.allclose(np.asarray(wt.forward(jnp.asarray(x))), wt.forward_np(x))
        assert np.allclose(np.asarray(wt.adjoint(jnp.asarray(x))), wt.adjoint_np(x))

    def test_riesz_basis_conditioning(self, grid):
        # W^T G_t W should be uniformly well conditioned (L2 Riesz basis).
        wt = build_wavelet_transform(grid)
        G = time_matrices(grid)["G_t"].toarray()
        W = wt.dense()
        gram = W.T @ G @ W
        ev = np.linalg.eigvalsh(gram)
        assert ev[0] > 1e-2
        assert ev[-1] / ev[0] < 300.0


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
