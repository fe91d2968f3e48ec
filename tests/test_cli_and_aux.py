"""CLI driver, Lanczos estimator, profiling, and determinism tests
(SURVEY.md §5 auxiliary subsystems)."""

import json
import os

import numpy as np
import pytest

from spacetime.run import main as run_main


class TestCLI:
    def test_oracle_backend(self, tmp_path, capsys):
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--backend", "oracle", "--space-n", "8", "--time-levels", "3",
            "--out", str(out),
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        assert rec["converged"] and rec["iterations"] <= 12
        assert "solve" in rec["timings_s"]

    def test_jax_backend_with_condition(self, tmp_path):
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--device", "cpu",
            "--backend", "jax", "--space-n", "8", "--time-levels", "3",
            "--estimate-condition", "--out", str(out),
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        # The paper's headline property: kappa(K_X S) uniformly small.
        assert rec["kappa_estimate"] < 10.0

    def test_refined_flag(self, tmp_path):
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--device", "cpu",
            "--backend", "jax", "--dtype", "f32", "--refined",
            "--refine-inner-tol", "3e-4",
            "--tol", "1e-8", "--space-n", "8", "--time-levels", "3",
            "--out", str(out), "--no-error",
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        assert rec["converged"] and rec["final_rel_residual"] < 1e-8

    def test_refined_requires_jax_backend(self):
        assert run_main(["--backend", "oracle", "--refined"]) == 2

    def test_help_renders(self, capsys):
        # argparse expands help strings with %-formatting: an unescaped
        # literal % in any help text crashes --help (caught live, round 5)
        with pytest.raises(SystemExit) as ei:
            run_main(["--help"])
        assert ei.value.code == 0
        out = capsys.readouterr().out
        assert "--refine-inner-tol" in out and "gpu" in out

    def test_sharded_backend(self, tmp_path):
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--device", "cpu",
            "--backend", "sharded", "--space-n", "8", "--time-levels", "4",
            "--out", str(out), "--no-error",
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        assert rec["converged"]


class TestLanczos:

    def test_donate_rhs_and_nu_post_flags(self, tmp_path):
        """Round-2 flags ride through the CLI: --donate-rhs (capacity
        lever) and --mg-nu-post (experimental V(nu, nu_post) cycles) both
        solve to the same convergence on cfg1-small."""
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--backend", "jax", "--device", "cpu", "--space-n", "8",
            "--time-levels", "3", "--donate-rhs", "--no-error",
            "--out", str(out),
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        assert rec["converged"]
        rc = run_main([
            "--backend", "jax", "--device", "cpu", "--dtype", "f32",
            "--space-n", "16", "--time-levels", "3", "--inner", "mg",
            "--mg-nu-post", "1", "--no-error", "--out", str(out),
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip().splitlines()[-1])
        assert rec["converged"]

    def test_explicit_graded_cli(self, tmp_path):
        """The generalized explicit backend drives graded grids from the
        CLI (round 2; was a ValueError in round 1)."""
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--backend", "explicit", "--device", "cpu8",
            "--problem", "singular2d", "--space-n", "8",
            "--time-levels", "3", "--extra-levels", "2", "--no-error",
            "--out", str(out),
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        assert rec["converged"]

    def test_kappa_flat_under_refinement(self):
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver
        from spacetime.solver.lanczos import lanczos_condition

        problem = get_problem("smooth2d")
        kappas = []
        for n, J in [(8, 3), (16, 4)]:
            s = HeatSolver(problem, P1System.from_mesh(unit_square_mesh(n)),
                           uniform_time_grid(J))
            est = lanczos_condition(s.apply_S, s.apply_KX, (s.N + 1,) + s.gs,
                                    num_iters=25)
            kappas.append(est.condition)
        assert all(k < 10.0 for k in kappas)
        assert abs(kappas[1] - kappas[0]) < 3.0


class TestDeterminism:
    def test_same_inputs_same_history(self):
        # SURVEY.md §5: determinism by construction — two identical solves
        # must produce bit-identical residual histories.
        from spacetime.solver import solve_heat_equation_device

        r1 = solve_heat_equation_device("smooth2d", space_n=8, time_levels=3,
                                     tol=1e-8, compute_error=False)
        r2 = solve_heat_equation_device("smooth2d", space_n=8, time_levels=3,
                                     tol=1e-8, compute_error=False)
        assert r1.iterations == r2.iterations
        np.testing.assert_array_equal(r1.residuals, r2.residuals)


class TestProfiling:
    def test_phase_timer(self):
        from spacetime.utils.profiling import PhaseTimer

        t = PhaseTimer()
        with t("a"):
            pass
        with t("a"):
            pass
        assert t.counts["a"] == 2
        assert t.seconds["a"] >= 0.0
        assert "a" in t.summary()


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))


class TestCheckpoint:
    def test_save_resume(self, tmp_path):
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver
        from spacetime.utils.checkpoint import load_solution

        s = HeatSolver(get_problem("smooth2d"),
                       P1System.from_mesh(unit_square_mesh(8)),
                       uniform_time_grid(3))
        ckpt = str(tmp_path / "state.npz")
        # Phase 1: a few iterations only, checkpoint the iterate.
        r1 = s.solve(tol=1e-12, maxiter=4, compute_error=False,
                     checkpoint_path=ckpt)
        assert not r1.converged
        U, meta = load_solution(ckpt)
        assert int(meta["iterations"]) == 4
        # Phase 2: resume from the checkpoint; must converge in fewer
        # iterations than a cold solve and reach the same answer.
        r2 = s.solve(tol=1e-10, maxiter=50, compute_error=False, x0=U)
        cold = s.solve(tol=1e-10, maxiter=50, compute_error=False)
        assert r2.converged
        assert r2.iterations < cold.iterations
        np.testing.assert_allclose(r2.U, cold.U, atol=1e-8)

    def test_periodic_checkpoint(self, tmp_path):
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver
        from spacetime.utils.checkpoint import load_solution

        s = HeatSolver(get_problem("smooth2d"),
                       P1System.from_mesh(unit_square_mesh(8)),
                       uniform_time_grid(3), chunk=3)
        ckpt = str(tmp_path / "periodic.npz")
        # Converge with periodic saves every ~4 iterations; the final write
        # is the end-of-solve save, earlier ones are in-progress states.
        r = s.solve(tol=1e-10, maxiter=50, compute_error=False,
                    checkpoint_path=ckpt, checkpoint_every=4)
        assert r.converged
        U, meta = load_solution(ckpt)
        assert int(meta["iterations"]) == r.iterations
        assert "in_progress" not in meta  # final save overwrote the periodic
        np.testing.assert_allclose(U, r.U, atol=0)
        # An in-progress save actually happened mid-solve: resume from a
        # truncated run with periodic-only state (kill before completion is
        # simulated by maxiter exhaustion between checkpoints).
        r1 = s.solve(tol=1e-14, maxiter=9, compute_error=False,
                     checkpoint_path=ckpt, checkpoint_every=4)
        U1, meta1 = load_solution(ckpt)
        assert int(meta1["iterations"]) == 9  # end-of-run save
        r2 = s.solve(tol=1e-10, maxiter=50, compute_error=False, x0=U1)
        assert r2.converged and r2.iterations < r.iterations

    def test_exact_state_resume(self, tmp_path):
        """A truncated periodic-checkpoint run leaves a FULL PCG state;
        resuming it continues the exact Krylov sequence — the combined
        residual history matches an uninterrupted solve to rounding
        (SURVEY.md §5: serialize (u, r, p, iteration))."""
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver
        from spacetime.utils.checkpoint import has_pcg_state, load_pcg_state

        s = HeatSolver(get_problem("smooth2d"),
                       P1System.from_mesh(unit_square_mesh(8)),
                       uniform_time_grid(3), chunk=3, loop="chunked")
        cold = s.solve(tol=1e-10, maxiter=50, compute_error=False)
        assert cold.converged

        ckpt = str(tmp_path / "full_state.npz")
        r1 = s.solve(tol=1e-10, maxiter=6, compute_error=False,
                     checkpoint_path=ckpt, checkpoint_every=3)
        assert not r1.converged
        assert has_pcg_state(ckpt)
        state, meta = load_pcg_state(ckpt)
        assert int(meta["iterations"]) == 6 and bool(meta["in_progress"])

        r2 = s.solve(tol=1e-10, maxiter=50, compute_error=False,
                     resume_state=state)
        assert r2.converged
        assert r2.iterations == cold.iterations
        # The stitched history equals the uninterrupted one exactly: the
        # resumed run replays nothing and restarts nothing.
        np.testing.assert_allclose(
            r2.residuals, cold.residuals[: r2.iterations + 1], rtol=1e-12
        )
        np.testing.assert_allclose(r2.U, cold.U, atol=1e-12)

    def test_resume_state_guards(self, tmp_path):
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver
        from spacetime.utils.checkpoint import load_pcg_state, save_solution

        s = HeatSolver(get_problem("smooth2d"),
                       P1System.from_mesh(unit_square_mesh(8)),
                       uniform_time_grid(3))
        path = str(tmp_path / "iterate_only.npz")
        save_solution(path, np.zeros((9, 49)), {"iterations": 0})
        with pytest.raises(KeyError, match="full PCG-state"):
            load_pcg_state(path)
        fake = {k: np.zeros(1) for k in
                ("U", "R", "P", "rz", "res", "pres", "done", "fnorm")}
        fake["it"] = np.int32(60)
        with pytest.raises(ValueError, match="maxiter"):
            s.solve(maxiter=50, resume_state=fake, compute_error=False)

    def test_periodic_checkpoint_guards(self, tmp_path):
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver

        s = HeatSolver(get_problem("smooth2d"),
                       P1System.from_mesh(unit_square_mesh(8)),
                       uniform_time_grid(3))
        with pytest.raises(ValueError):
            s.solve(checkpoint_every=4)  # no path
        s_fused = HeatSolver(get_problem("smooth2d"),
                             P1System.from_mesh(unit_square_mesh(8)),
                             uniform_time_grid(3), pcg_variant="fused")
        with pytest.raises(ValueError):
            s_fused.solve(checkpoint_path=str(tmp_path / "x.npz"),
                          checkpoint_every=4)


class TestReviewRegressions:
    """Fixes from the round-1 review passes."""

    def test_checkpoint_roundtrip_without_extension(self, tmp_path):
        from spacetime.utils.checkpoint import load_solution, save_solution

        path = str(tmp_path / "state")  # same string for save and load
        save_solution(path, np.ones((3, 2)), {"iterations": 5})
        U, meta = load_solution(path)
        assert U.shape == (3, 2) and int(meta["iterations"]) == 5

    def test_explicit_eager_operators_after_solve(self):
        # apply_S/apply_KX with the GLOBAL params (Lanczos diagnostics)
        # after a solve that built the per-shard local-layout params.
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        import jax.numpy as jnp

        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.parallel import ExplicitHeatSolver, make_time_mesh
        from spacetime.solver.lanczos import lanczos_condition

        s = ExplicitHeatSolver(
            get_problem("smooth2d"),
            P1System.from_mesh(unit_square_mesh(16)),
            uniform_time_grid(4), make_time_mesh(4),
            dtype=jnp.float32, inner="mg",
        )
        r = s.solve(tol=1e-4, compute_error=False)
        assert r.converged
        est = lanczos_condition(
            s.apply_S, s.apply_KX, (s.N + 1,) + s.gs, num_iters=8
        )
        assert est.condition < 20

    def test_sharded_chunked_checkpoint(self, tmp_path):
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.parallel import ShardedHeatSolver, make_time_mesh
        from spacetime.solver.heateq import HeatSolver

        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        ref = HeatSolver(problem, system, grid).solve(
            tol=1e-8, compute_error=False
        )
        s = ShardedHeatSolver(problem, system, grid, make_time_mesh(4),
                              chunk=4)
        ckpt = str(tmp_path / "sharded")
        r = s.solve(tol=1e-8, compute_error=False,
                    checkpoint_path=ckpt, checkpoint_every=4)
        assert r.converged
        assert r.iterations == ref.iterations
        np.testing.assert_allclose(r.residuals, ref.residuals, rtol=1e-9)

    def test_refined_honors_changed_inner_params(self):
        import jax.numpy as jnp

        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver

        s = HeatSolver(get_problem("smooth2d"),
                       P1System.from_mesh(unit_square_mesh(8)),
                       uniform_time_grid(3), dtype=jnp.float32)
        # starve the inner solver: 1 iteration per round cannot reach 1e-8
        r1 = s.solve_refined(tol=1e-8, inner_maxiter=1, max_rounds=2,
                             compute_error=False)
        assert not r1.converged
        # same solver object, proper inner budget — must NOT reuse the
        # starved executables (was: closure constants silently cached)
        r2 = s.solve_refined(tol=1e-8, inner_maxiter=60, max_rounds=4,
                             compute_error=False)
        assert r2.converged

    def test_sharded_refined_matches_serial(self):
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        import jax.numpy as jnp

        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.parallel import ShardedHeatSolver, make_time_mesh
        from spacetime.solver.heateq import HeatSolver

        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        r1 = HeatSolver(problem, system, grid, dtype=jnp.float32).solve_refined(
            tol=1e-8, compute_error=False
        )
        r2 = ShardedHeatSolver(
            problem, system, grid, make_time_mesh(4), dtype=jnp.float32
        ).solve_refined(tol=1e-8, compute_error=False)
        assert r1.converged and r2.converged
        assert len(r2.residuals) == len(r1.residuals)
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=1e-6)
        np.testing.assert_allclose(r2.U, r1.U, rtol=0, atol=1e-9)


class TestDeterminism:
    """SURVEY.md §5: same inputs -> bitwise-identical residual histories
    across runs (JAX purity is the rebuild's replacement for the
    reference's by-construction MPI determinism)."""

    def test_repeat_solves_identical(self):
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.solver.heateq import HeatSolver

        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(3)
        a = HeatSolver(problem, system, grid).solve(
            tol=1e-8, compute_error=False
        )
        b = HeatSolver(problem, system, grid).solve(
            tol=1e-8, compute_error=False
        )
        assert a.iterations == b.iterations
        np.testing.assert_array_equal(a.residuals, b.residuals)
        np.testing.assert_array_equal(a.U, b.U)

    def test_repeat_sharded_solves_identical(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.parallel import ExplicitHeatSolver, make_time_mesh

        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        mk = lambda: ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(8)
        ).solve(tol=1e-8, compute_error=False)
        a, b = mk(), mk()
        np.testing.assert_array_equal(a.residuals, b.residuals)
        np.testing.assert_array_equal(a.U, b.U)


class TestProblemRegistry:
    def test_register_and_solve(self):
        """A user-registered manufactured problem flows through get_problem
        and solves with autodiff-derived source/initial data."""
        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import (
            PROBLEMS, Problem, get_problem, register_problem,
        )
        from spacetime.solver.heateq import HeatSolver

        def exact(t, x):
            import jax.numpy as jnp

            return jnp.cos(t) * jnp.prod(jnp.sin(jnp.pi * x))

        name = "_test_custom"
        try:
            register_problem(Problem(name=name, dim=2, exact=exact))
            with pytest.raises(ValueError, match="already registered"):
                register_problem(Problem(name=name, dim=2, exact=exact))
            register_problem(
                Problem(name=name, dim=2, exact=exact), overwrite=True
            )
            problem = get_problem(name)
            res = HeatSolver(
                problem, P1System.from_mesh(unit_square_mesh(12)),
                uniform_time_grid(3),
            ).solve(tol=1e-6)
            assert res.converged and res.l2_error < 0.05
        finally:
            PROBLEMS.pop(name, None)

    def test_register_rejects_dataless(self):
        from spacetime.models import Problem, register_problem

        with pytest.raises(ValueError, match="exact solution"):
            register_problem(Problem(name="_bad", dim=2, exact=None))


class TestExplicitRefined:
    def test_explicit_refined_matches_serial(self):
        """Mixed-precision refinement on the explicit (shard_map) backend:
        same round count and the same computed iterate as the serial path.
        Mid-round residuals differ at the inner-tolerance level (the masked
        local-dot + psum reduction order moves where the f32 inner PCG
        stops), so the histories compare loosely but the f64 iterates must
        agree to refinement accuracy."""
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        import jax.numpy as jnp

        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.parallel import ExplicitHeatSolver, make_time_mesh
        from spacetime.solver.heateq import HeatSolver

        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        r1 = HeatSolver(
            problem, system, grid, dtype=jnp.float32
        ).solve_refined(tol=1e-8, compute_error=False)
        r2 = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(8), dtype=jnp.float32
        ).solve_refined(tol=1e-8, compute_error=False)
        assert r1.converged and r2.converged
        assert len(r2.residuals) == len(r1.residuals)
        np.testing.assert_allclose(r2.residuals, r1.residuals, rtol=0.15)
        np.testing.assert_allclose(r2.U, r1.U, rtol=0, atol=1e-9)

    def test_explicit_refined_fused(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs virtual devices")
        import jax.numpy as jnp

        from spacetime.fem import P1System, unit_square_mesh
        from spacetime.fem.timegrid import uniform_time_grid
        from spacetime.models import get_problem
        from spacetime.parallel import ExplicitHeatSolver, make_time_mesh

        problem = get_problem("smooth2d")
        system = P1System.from_mesh(unit_square_mesh(8))
        grid = uniform_time_grid(4)
        r = ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(8), dtype=jnp.float32,
            pcg_variant="fused",
        ).solve_refined(tol=1e-8, compute_error=False)
        assert r.converged
        assert r.residuals[-1] / r.residuals[0] <= 1e-8


def test_explicit_refined_with_error():
    """compute_error=True on the explicit refined path (the global-layout
    iterate must not be routed through the duplicated-layout flattener)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs virtual devices")
    import jax.numpy as jnp

    from spacetime.fem import P1System, unit_square_mesh
    from spacetime.fem.timegrid import uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.parallel import ExplicitHeatSolver, make_time_mesh
    from spacetime.solver.heateq import HeatSolver

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(8))
    grid = uniform_time_grid(4)
    r1 = HeatSolver(problem, system, grid, dtype=jnp.float32).solve_refined(
        tol=1e-8
    )
    r2 = ExplicitHeatSolver(
        problem, system, grid, make_time_mesh(8), dtype=jnp.float32
    ).solve_refined(tol=1e-8)
    assert r2.l2_error is not None and np.isfinite(r2.l2_error)
    assert np.isclose(r2.l2_error, r1.l2_error, rtol=1e-6)


class TestRound3CLI:
    def test_pcg_flex_flag(self, tmp_path):
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--device", "cpu",
            "--backend", "jax", "--space-n", "8", "--time-levels", "3",
            "--pcg", "flex", "--no-error", "--out", str(out),
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        assert rec["converged"] and rec["pcg"] == "flex"

    def test_explicit2d_backend(self, tmp_path):
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--backend", "explicit2d", "--device", "cpu8",
            "--space-devices", "2", "--space-n", "8", "--time-levels", "3",
            "--no-error", "--out", str(out),
        ])
        assert rc == 0
        rec = json.loads(out.read_text().strip())
        assert rec["converged"]

    def test_explicit2d_bad_space_devices(self):
        assert run_main([
            "--device", "cpu",
            "--backend", "explicit2d", "--space-devices", "0",
            "--space-n", "8", "--time-levels", "3",
        ]) == 2

    def test_explicit2d_condition_skips_gracefully(self, tmp_path, capsys):
        import jax

        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        out = tmp_path / "res.jsonl"
        rc = run_main([
            "--backend", "explicit2d", "--device", "cpu8",
            "--space-devices", "2", "--space-n", "8", "--time-levels", "3",
            "--no-error", "--estimate-condition", "--out", str(out),
        ])
        assert rc == 0  # solve completes; kappa is skipped with a message
        rec = json.loads(out.read_text().strip())
        assert "kappa_estimate" not in rec

    def test_flex_resume_falls_back_to_restart(self, tmp_path):
        ck = str(tmp_path / "ck")
        rc = run_main([
            "--device", "cpu",
            "--backend", "jax", "--space-n", "8", "--time-levels", "3",
            "--tol", "1e-3", "--no-error", "--checkpoint", ck,
            "--checkpoint-every", "3", "--out", "",
        ])
        assert rc == 0
        rc = run_main([
            "--device", "cpu",
            "--backend", "jax", "--space-n", "8", "--time-levels", "3",
            "--pcg", "flex", "--resume-from", ck, "--no-error", "--out", "",
        ])
        assert rc == 0
