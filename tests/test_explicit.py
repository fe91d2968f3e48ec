"""Explicit-collectives (shard_map) path: parity vs the serial solver.

The manual counterpart of tests/test_sharded.py (SURVEY.md §4 serial-vs-MPI
equality): the duplicated-halo-row layout, hand-placed ppermute halo
exchanges, psum dots, and the levelwise sharded wavelet transform must
reproduce the serial residual histories to reduction-order rounding.
"""

import jax
import numpy as np
import pytest

from spacetime.fem import P1System, unit_cube_mesh, unit_square_mesh
from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid
from spacetime.models import get_problem
from spacetime.parallel import ExplicitHeatSolver, make_time_mesh
from spacetime.solver.heateq import HeatSolver

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _pair(problem_name, system, levels, ndev, tol=1e-6, **kw):
    problem = get_problem(problem_name)
    grid = uniform_time_grid(levels)
    r1 = HeatSolver(problem, system, grid, **kw).solve(
        tol=tol, compute_error=False
    )
    ex = ExplicitHeatSolver(problem, system, grid, make_time_mesh(ndev), **kw)
    r2 = ex.solve(tol=tol, compute_error=False)
    return r1, r2


@requires_multidevice
class TestExplicit:
    def test_dense_inner_parity(self):
        system = P1System.from_mesh(unit_square_mesh(8))
        r1, r2 = _pair("smooth2d", system, 4, 8)
        assert r2.converged
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)
        np.testing.assert_allclose(r2.U, r1.U, atol=1e-10)

    def test_one_row_per_device(self):
        # R=1: every trial row is a shard boundary; the wavelet transform is
        # entirely in its gathered coarse phase.
        system = P1System.from_mesh(unit_square_mesh(8))
        r1, r2 = _pair("smooth2d", system, 3, 8)
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)

    def test_smaller_device_count(self):
        system = P1System.from_mesh(unit_square_mesh(8))
        r1, r2 = _pair("smooth2d", system, 4, 4)
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)

    def test_mg_inner_parity(self):
        system = P1System.from_mesh(unit_square_mesh(16))
        r1, r2 = _pair("smooth2d", system, 5, 8, inner="mg", space_n=16)
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)

    def test_3d_parity(self):
        system = P1System.from_mesh(unit_cube_mesh(8))
        r1, r2 = _pair("smooth3d", system, 4, 8)
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)

    @pytest.mark.slow
    def test_wavelet_roundtrip_and_adjoint(self):
        # Sharded W and W' against the serial NumPy transform directly.
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        try:
            shard_map = jax.shard_map
        except AttributeError:
            from jax.experimental.shard_map import shard_map

        system = P1System.from_mesh(unit_square_mesh(4))
        grid = uniform_time_grid(5)  # N=32, R=4
        mesh = make_time_mesh(8)
        ex = ExplicitHeatSolver(get_problem("smooth2d"), system, grid, mesh)
        ep, es = ex.eparams_for(ex.dtype)
        rng = np.random.default_rng(0)
        C = rng.standard_normal((ex.N + 1, ex.m))

        fwd = shard_map(
            lambda c, p: ex._wavelet_forward_local(c, p),
            mesh=mesh, in_specs=(P("time", None), es), out_specs=P("time", None),
        )
        adj = shard_map(
            lambda x, p: ex._wavelet_adjoint_local(x, p),
            mesh=mesh, in_specs=(P("time", None), es), out_specs=P("time", None),
        )
        Cdup = jnp.asarray(ex._dup_rows(C))
        Vdup = fwd(Cdup, ep)
        V = ex._postprocess_U(Vdup)
        np.testing.assert_allclose(V, ex.wt.forward_np(C), rtol=1e-12, atol=1e-12)
        Ydup = adj(Cdup, ep)
        Y = ex._postprocess_U(Ydup)
        np.testing.assert_allclose(Y, ex.wt.adjoint_np(C), rtol=1e-12, atol=1e-12)
        # Twin rows must agree (bitwise-targeted, asserted to fp slack).
        Vd = np.asarray(Vdup).reshape(ex.P, ex.R + 1, ex.m)
        np.testing.assert_array_equal(Vd[:-1, ex.R], Vd[1:, 0])

    # ---- generalized layout (graded grids / odd P / ragged N_t) ----
    # parallel/general_layout.py: graded grids, odd device counts and
    # ragged N_t, which a uniform power-of-two layout cannot serve.

    def _pair_grid(self, problem_name, system, grid, ndev, tol=1e-6, **kw):
        problem = get_problem(problem_name)
        r1 = HeatSolver(problem, system, grid, **kw).solve(
            tol=tol, compute_error=False
        )
        ex = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(ndev), **kw
        )
        assert not ex.aligned, "expected the generalized layout"
        r2 = ex.solve(tol=tol, compute_error=False)
        assert r2.iterations == r1.iterations
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-9)
        np.testing.assert_allclose(r2.U, r1.U, atol=1e-10)
        return ex, r1, r2

    def test_graded_grid_parity(self):
        system = P1System.from_mesh(unit_square_mesh(8))
        self._pair_grid("singular2d", system, graded_time_grid(3, 3), 8)

    def test_odd_device_count(self):
        system = P1System.from_mesh(unit_square_mesh(8))
        self._pair_grid("smooth2d", system, uniform_time_grid(4), 5)

    def test_nondivisible_timesteps(self):
        # N=4 over 8 devices: trailing shards are pure padding.
        system = P1System.from_mesh(unit_square_mesh(8))
        self._pair_grid("smooth2d", system, uniform_time_grid(2), 8)

    @pytest.mark.slow
    def test_graded_odd_devices_mg(self):
        system = P1System.from_mesh(unit_square_mesh(16))
        self._pair_grid(
            "singular2d", system, graded_time_grid(3, 3), 5,
            inner="mg", space_n=16,
        )

    def test_graded_fused_pcg(self):
        system = P1System.from_mesh(unit_square_mesh(8))
        self._pair_grid(
            "singular2d", system, graded_time_grid(3, 3), 6,
            pcg_variant="fused",
        )

    @pytest.mark.slow
    def test_general_wavelet_roundtrip(self):
        # Generalized sharded W / W' against the serial NumPy transform,
        # on a graded grid over an odd device count; twin rows must agree
        # bitwise (the duplicated-row invariant).
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        try:
            shard_map = jax.shard_map
        except AttributeError:
            from jax.experimental.shard_map import shard_map

        system = P1System.from_mesh(unit_square_mesh(4))
        grid = graded_time_grid(3, 4)
        mesh = make_time_mesh(5)
        ex = ExplicitHeatSolver(
            get_problem("singular2d"), system, grid, mesh
        )
        assert not ex.aligned
        ep, es = ex.eparams_for(ex.dtype)
        rng = np.random.default_rng(0)
        C = rng.standard_normal((ex.N + 1, ex.m))

        fwd = shard_map(
            lambda c, p: ex._wavelet_forward_local(c, p),
            mesh=mesh, in_specs=(P("time", None), es),
            out_specs=P("time", None), check_vma=False,
        )
        adj = shard_map(
            lambda x, p: ex._wavelet_adjoint_local(x, p),
            mesh=mesh, in_specs=(P("time", None), es),
            out_specs=P("time", None), check_vma=False,
        )
        Cdup = jnp.asarray(ex._dup_rows(C) * ex.glay.m_trial[:, None])
        Vdup = fwd(Cdup, ep)
        V = ex._postprocess_U(Vdup)
        np.testing.assert_allclose(
            V, ex.wt.forward_np(C), rtol=1e-12, atol=1e-12
        )
        Ydup = adj(Cdup, ep)
        Y = ex._postprocess_U(Ydup)
        np.testing.assert_allclose(
            Y, ex.wt.adjoint_np(C), rtol=1e-12, atol=1e-12
        )
        # Twin copies of every duplicated boundary row: bitwise equal.
        Vd = np.asarray(Vdup).reshape(ex.P, ex.R + 1, ex.m)
        valid = ex.glay.m_trial.reshape(ex.P, ex.R + 1)
        twin = (valid[:-1, ex.R] * valid[1:, 0]).astype(bool)
        np.testing.assert_array_equal(Vd[:-1, ex.R][twin], Vd[1:, 0][twin])

    def test_general_refined(self):
        # Mixed-precision tol=1e-8 refinement over the generalized layout.
        import jax.numpy as jnp

        problem = get_problem("singular2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = graded_time_grid(3, 3)
        s = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(5), dtype=jnp.float32
        )
        r = s.solve_refined(tol=1e-8, compute_error=False)
        r64 = HeatSolver(problem, system, grid).solve(
            tol=1e-10, compute_error=False
        )
        assert r.residuals[-1] < 1e-8
        # atol tracks the tol=1e-8 contract: the adaptive round schedule
        # solves the last correction to what the target needs instead of
        # overshooting it by ~inner_tol (solver/heateq.solve_refined).
        np.testing.assert_allclose(r.U, r64.U, atol=1e-8)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))


def test_explicit_warm_start():
    """x0 warm start on the duplicated-halo layout: resuming from a partial
    solve reaches the tight tolerance in fewer iterations than from scratch
    and lands on the same iterate."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    import jax.numpy as jnp
    import numpy as np

    from spacetime.fem import P1System, unit_square_mesh
    from spacetime.fem.timegrid import uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.parallel import ExplicitHeatSolver, make_time_mesh

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(8))
    grid = uniform_time_grid(4)
    mk = lambda: ExplicitHeatSolver(
        problem, system, grid, make_time_mesh(4), dtype=jnp.float64
    )
    full = mk().solve(tol=1e-10, compute_error=False)
    s = mk()
    part = s.solve(tol=1e-3, compute_error=False)
    resumed = s.solve(tol=1e-10, compute_error=False, x0=part.U)
    assert resumed.converged
    assert resumed.iterations < full.iterations
    np.testing.assert_allclose(resumed.U, full.U, rtol=0, atol=1e-9)
