"""Unit tests for the P1 FEM substrate (SURVEY.md §4: operator correctness)."""

import numpy as np
import pytest

from spacetime.fem import (
    P1System,
    load_vector,
    time_matrices,
    uniform_time_grid,
    graded_time_grid,
    unit_cube_mesh,
    unit_square_mesh,
)


class TestSquareMesh:
    def test_counts(self):
        mesh = unit_square_mesh(4)
        assert mesh.num_vertices == 25
        assert mesh.elements.shape == (32, 3)
        assert mesh.num_interior == 9

    def test_total_area(self):
        mesh = unit_square_mesh(5)
        M, A = __import__(
            "spacetime.fem.assembly", fromlist=["assemble_p1"]
        ).assemble_p1(mesh)
        # sum of mass matrix = |Omega| = 1
        assert np.isclose(M.sum(), 1.0)
        # stiffness rows sum to zero (constants in kernel)
        assert np.allclose(np.abs(A.sum(axis=1)).max(), 0.0, atol=1e-12)

    def test_laplace_eigenvalue(self):
        # Smallest eigenvalue of (A, M) on the unit square -> 2*pi^2.
        import scipy.sparse.linalg as spla

        sys2 = P1System.from_mesh(unit_square_mesh(32))
        vals = spla.eigsh(sys2.A, k=1, M=sys2.M, sigma=0, which="LM")[0]
        assert abs(vals[0] - 2 * np.pi**2) / (2 * np.pi**2) < 5e-3

    def test_load_vector_constant(self):
        mesh = unit_square_mesh(6)
        f = load_vector(mesh, lambda x: np.ones(x.shape[0]))
        # sum of loads over all vertices = integral of 1 = 1
        assert np.isclose(f.sum(), 1.0)

    def test_stiffness_is_five_point_stencil(self):
        # On the structured SW-NE triangulation, P1 stiffness is the classic
        # 5-point stencil: diagonal 4, off-diagonals -1, diagonal-neighbor 0.
        sys2 = P1System.from_mesh(unit_square_mesh(8))
        A = sys2.A.toarray()
        n = 7
        center = 3 * n + 3
        assert np.isclose(A[center, center], 4.0)
        assert np.isclose(A[center, center + 1], -1.0)
        assert np.isclose(A[center, center + n], -1.0)
        assert np.isclose(A[center, center + n + 1], 0.0)


class TestCubeMesh:
    def test_counts_and_volume(self):
        mesh = unit_cube_mesh(3)
        assert mesh.elements.shape == (6 * 27, 4)
        from spacetime.fem.assembly import assemble_p1

        M, A = assemble_p1(mesh)
        assert np.isclose(M.sum(), 1.0)
        assert np.allclose(np.abs(A.sum(axis=1)).max(), 0.0, atol=1e-12)

    def test_laplace_eigenvalue_3d(self):
        import scipy.sparse.linalg as spla

        # P1 eigenvalue error is O(h^2) (verified: error*n^2 ~ 4.1 for
        # n=4,8,12); at n=12 the relative error is ~2.9%.
        sys3 = P1System.from_mesh(unit_cube_mesh(12))
        vals = spla.eigsh(sys3.A, k=1, M=sys3.M, sigma=0, which="LM")[0]
        assert abs(vals[0] - 3 * np.pi**2) / (3 * np.pi**2) < 3.5e-2


class TestTimeGrid:
    def test_uniform(self):
        g = uniform_time_grid(4)
        assert g.num_intervals == 16
        assert np.allclose(g.t, np.linspace(0, 1, 17))
        assert g.level[0] == 0 and g.level[-1] == 0
        # midpoint of [0,1] has level 1
        assert g.level[8] == 1
        # parents of the global midpoint are the endpoints
        assert g.parent_left[8] == 0 and g.parent_right[8] == 16

    def test_parent_consistency(self):
        g = uniform_time_grid(3)
        for k in range(g.num_nodes):
            if g.level[k] == 0:
                continue
            pl, pr = g.parent_left[k], g.parent_right[k]
            assert np.isclose(g.t[k], 0.5 * (g.t[pl] + g.t[pr]))
            assert g.level[pl] < g.level[k]
            assert g.level[pr] < g.level[k]

    def test_graded(self):
        g = graded_time_grid(2, 3, t_crit=0.0)
        # uniform part: h = 1/4 away from 0; near 0 refined 3 more times.
        assert np.isclose(g.t[1], 2.0**-5)
        assert g.max_level == 5
        assert g.num_intervals == 4 + 3  # 4 uniform, 3 extra bisections at 0

    def test_time_matrices_quadrature(self):
        g = uniform_time_grid(3)
        mats = time_matrices(g)
        N = g.num_intervals
        rng = np.random.default_rng(0)
        u = rng.standard_normal(N + 1)
        # A_t u = jumps of the pw-linear interpolant
        assert np.allclose(mats["A_t"] @ u, u[1:] - u[:-1])
        # M_t u = interval integrals of the pw-linear interpolant
        assert np.allclose(mats["M_t"] @ u, mats["h"] * (u[1:] + u[:-1]) / 2)
        # G_t: ||1||^2 = T
        ones = np.ones(N + 1)
        assert np.isclose(ones @ (mats["G_t"] @ ones), 1.0)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
