"""CLI driver — the analogue of the reference's ``mpi_heateq.py`` entry point.

Examples:
    # serial NumPy oracle (parity reference)
    python -m spacetime.run --backend oracle --problem smooth2d \
        --space-n 64 --time-levels 6 --tol 1e-6

    # jitted path on the default device, mg inner solves, f32
    python -m spacetime.run --backend jax --device gpu --dtype f32 \
        --inner mg --space-n 128 --time-levels 6

    # time-sharded over all local devices
    python -m spacetime.run --backend sharded --device cpu8 --space-n 16

Prints iteration counts / residuals / errors / per-phase timings and appends
one JSON record per run to --out (default results.jsonl).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spacetime.run",
        description="Parallel-in-time minimal-residual heat-equation solver",
    )
    p.add_argument("--problem", default="smooth2d",
                   help="problem name (see --list-problems)")
    p.add_argument("--list-problems", action="store_true",
                   help="print the benchmark problem registry and exit")
    p.add_argument("--space-n", type=int, default=64,
                   help="cells per side of the structured spatial mesh")
    p.add_argument("--mesh-file", default=None, metavar="PATH",
                   help="load the spatial mesh from PATH instead of "
                        "generating one (Gmsh 2.2 ASCII .msh, or Triangle/"
                        "TetGen .node/.ele); the mesh runs the generic "
                        "(non-stencil) spatial path")
    p.add_argument("--refine", type=int, default=0, metavar="K",
                   help="red-refine the spatial mesh K times (generated or "
                        "loaded; the result runs the generic spatial path)")
    p.add_argument("--time-levels", type=int, default=6,
                   help="dyadic time levels (2^J uniform timesteps)")
    p.add_argument("--extra-levels", type=int, default=0,
                   help="extra bisections toward t=0 (graded grid)")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--backend",
                   choices=["oracle", "jax", "sharded", "explicit",
                            "explicit2d"],
                   default="jax",
                   help="oracle = NumPy parity reference; jax = jitted "
                        "single-device; sharded = GSPMD time mesh; explicit "
                        "= shard_map with hand-placed collectives; "
                        "explicit2d = shard_map over a 2-D (time, space) "
                        "mesh with spatial plane-halo exchanges")
    p.add_argument("--space-devices", type=int, default=2, metavar="P",
                   help="space-axis device count of the explicit2d mesh "
                        "(time gets the remaining devices)")
    p.add_argument("--device", choices=["default", "cpu", "cpu8", "gpu"],
                   default="default",
                   help="platform selection: gpu = the CUDA backend (fails "
                        "when no GPU is present); cpu8 = 8 virtual CPU "
                        "devices; default = gpu for device backends, cpu "
                        "for the oracle")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    p.add_argument("--inner", choices=["auto", "dense", "mg", "cheb", "amg"],
                   default="auto",
                   help="inner spatial solver: dense inverses (parity, "
                        "m<=4k), geometric multigrid (structured grids or "
                        "recorded refinement hierarchies), smoothed-"
                        "aggregation AMG (unstructured meshes without a "
                        "hierarchy), or Chebyshev polynomial inverses "
                        "(generic fallback)")
    p.add_argument("--spatial",
                   choices=["auto", "stencil", "vstencil", "dia"],
                   default="auto",
                   help="spatial SpMV format (dia = flat diagonal storage, "
                        "the generic-mesh path)")
    p.add_argument("--mg-cycles", type=int, default=3)
    p.add_argument("--mg-cycles-kx", type=int, default=None,
                   help="V-cycles per shifted solve inside the K_X sandwich "
                        "(default 2). 1 halves the K_X V-cycle work per "
                        "iteration at the cost of a few more PCG iterations")
    p.add_argument("--mg-nu-kx", type=int, default=None,
                   help="Chebyshev smoothing steps per V-cycle inside the "
                        "K_X sandwich only (default: same as K_Y's 2). "
                        "Pair with --mg-cycles-kx 1: one stronger cycle "
                        "costs fewer fine-level stencil passes than two "
                        "default ones (the 3D speed preset)")
    p.add_argument("--cheb-eps", type=float, default=1e-3,
                   help="accuracy of the solution-bearing Chebyshev inverses "
                        "(inner=cheb); lower for tight --tol solves")
    p.add_argument("--rhs", choices=["auto", "host", "device"], default="auto",
                   help="load quadrature: host = NumPy (oracle parity), "
                        "device = jitted on-device (fast at scale); auto = "
                        "device for f32 manufactured problems")
    p.add_argument("--mg-nu-post", type=int, default=None,
                   help="post-smoothing degree override (V(nu, nu_post) "
                        "cycles). EXPERIMENTAL: asymmetric cycles are not "
                        "symmetric preconditioners; V(2,1) at >=2 cycles "
                        "measured iteration-neutral, but combined with "
                        "--mg-cycles-kx 1 it diverged (17 -> 69 iters, "
                        "see ops/multigrid.py nu_post notes)")
    p.add_argument("--donate-rhs", action="store_true",
                   help="donate the staged RHS load buffers to the solve "
                        "executable (single-chip HBM capacity headroom at "
                        "cfg5 scales; each solve then re-stages the loads)")
    p.add_argument("--pcg", choices=["standard", "fused", "flex"],
                   default="standard",
                   help="fused = single-reduction (Chronopoulos-Gear) PCG: "
                        "one global reduction per iteration instead of "
                        "three; flex = Polak-Ribiere flexible CG, tolerant "
                        "of non-symmetric preconditioners (pairs with the "
                        "asymmetric --mg-nu-post cycles)")
    p.add_argument("--refined", action="store_true",
                   help="mixed-precision iterative refinement (f32 inner PCG "
                        "+ f64 residuals; any device backend, pairs with "
                        "--dtype f32 and tight --tol like 1e-8)")
    p.add_argument("--refine-inner-tol", type=float, default=1e-5,
                   metavar="TOL",
                   help="relative tolerance floor for the f32 inner PCG "
                        "rounds of --refined (default 1e-5; looser floors "
                        "trade inner iterations for refinement rounds)")
    p.add_argument("--no-error", action="store_true",
                   help="skip L2 error computation")
    p.add_argument("--estimate-condition", action="store_true",
                   help="Lanczos estimate of kappa(K_X S)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="save the final iterate to PATH.npz; resumable via "
                        "--resume-from")
    p.add_argument("--checkpoint-every", type=int, default=None, metavar="K",
                   help="also save the in-progress iterate every ~K "
                        "iterations (chunked driver; backend=jax/sharded, "
                        "standard PCG)")
    p.add_argument("--resume-from", default=None, metavar="PATH",
                   help="warm-start PCG from a checkpointed iterate")
    p.add_argument("--save-vtk", default=None, metavar="PREFIX",
                   help="write solution snapshots as PREFIX_NNNN.vtk (legacy "
                        "VTK, ParaView-readable) plus a PREFIX.pvd time "
                        "series; pair with --vtk-stride")
    p.add_argument("--vtk-stride", type=int, default=8,
                   help="write every K-th timestep (final time always "
                        "included)")
    p.add_argument("--probe", action="append", default=None, metavar="T,X,Y[,Z]",
                   help="evaluate the solution at a space-time point after "
                        "the solve (repeatable), e.g. --probe 0.5,0.3,0.7")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the solve into DIR "
                        "(view with TensorBoard/XProf)")
    p.add_argument("--out", default="results.jsonl",
                   help="JSONL results file ('' to disable)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_problems:
        from .models import PROBLEMS

        for name, prob in sorted(PROBLEMS.items()):
            kind = "manufactured" if prob.exact is not None else "data-driven"
            extras = []
            if prob.graded_time:
                extras.append("graded time grid")
            if prob.domain != "unit":
                extras.append(f"domain={prob.domain}")
            extra = f" ({', '.join(extras)})" if extras else ""
            print(f"{name:16s} {prob.dim}D {kind}{extra}")
        return 0

    from .utils import use_cpu, use_gpu
    from .utils.platform import device_record
    from .utils.profiling import PhaseTimer, write_jsonl

    if args.refined and args.backend == "oracle":
        print("--refined requires a device backend (jax/sharded/explicit)",
              file=sys.stderr)
        return 2
    x64 = args.dtype == "f64" or args.backend == "oracle" or args.refined
    if args.device == "cpu":
        use_cpu(x64=x64)
    elif args.device == "cpu8":
        use_cpu(num_devices=8, x64=x64)
    elif args.backend == "oracle":
        # The oracle is host NumPy code: it never needs the device.
        use_cpu(x64=True)
    else:
        # "gpu" and "default" on a device backend: no CPU fallback — a run
        # that asked for the device fails loudly when there is none.
        use_gpu(x64=x64)

    import numpy as np

    from .fem import P1System, domain_mesh
    from .fem.timegrid import graded_time_grid, uniform_time_grid
    from .models import get_problem

    timer = PhaseTimer()
    problem = get_problem(args.problem)
    with timer("assembly"):
        if args.mesh_file:
            from .fem import load_mesh

            mesh = load_mesh(args.mesh_file)
            if mesh.dim != problem.dim:
                print(
                    f"mesh {args.mesh_file} is {mesh.dim}D but problem "
                    f"{args.problem} is {problem.dim}D",
                    file=sys.stderr,
                )
                return 2
        else:
            mesh = domain_mesh(problem.domain, problem.dim, args.space_n)
        if args.refine > 0:
            # refine_hierarchy (not a bare refine_uniform loop): records the
            # nested-P1 parent chain so inner='mg' gets a real multigrid
            # hierarchy on unstructured meshes, and lex-sorts each level to
            # keep the assembled matrices DIA-banded.
            from .fem import refine_hierarchy

            mesh = refine_hierarchy(mesh, args.refine)
        system = P1System.from_problem(problem, mesh)
        if args.extra_levels > 0:
            grid = graded_time_grid(args.time_levels, args.extra_levels, T=problem.T)
        else:
            grid = uniform_time_grid(args.time_levels, T=problem.T)

    n_dof = (grid.num_intervals + 1) * system.m
    mesh_desc = args.mesh_file or f"{args.space_n}^{problem.dim}"
    print(
        f"problem={args.problem} mesh={mesh_desc} "
        f"(m={system.m}) timesteps={grid.num_intervals} "
        f"-> {n_dof:,} space-time DoF; backend={args.backend}"
    )

    solver = None
    if args.backend == "oracle":
        from .oracle.solver import OracleSolver

        with timer("setup"):
            solver = OracleSolver(problem, system, grid)
        with timer("solve"):
            res = solver.solve(
                tol=args.tol, maxiter=args.maxiter,
                compute_error=not args.no_error,
            )
    else:
        import jax.numpy as jnp

        dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
        kwargs = dict(dtype=dtype, inner=args.inner, mg_cycles=args.mg_cycles,
                      mg_cycles_kx=args.mg_cycles_kx, mg_nu_kx=args.mg_nu_kx,
                      mg_nu_post=args.mg_nu_post,
                      spatial_format=args.spatial, pcg_variant=args.pcg,
                      rhs=args.rhs, cheb_eps=args.cheb_eps,
                      donate_rhs=args.donate_rhs)
        with timer("setup"):
            if args.backend == "sharded":
                from .parallel import ShardedHeatSolver, make_time_mesh

                solver = ShardedHeatSolver(
                    problem, system, grid, make_time_mesh(), **kwargs
                )
            elif args.backend == "explicit":
                from .parallel import ExplicitHeatSolver, make_time_mesh

                solver = ExplicitHeatSolver(
                    problem, system, grid, make_time_mesh(), **kwargs
                )
            elif args.backend == "explicit2d":
                import jax

                from .parallel import (
                    Explicit2DHeatSolver,
                    make_spacetime_mesh,
                )

                n_space = args.space_devices
                if n_space < 1:
                    print(f"--space-devices must be >= 1 (got {n_space})",
                          file=sys.stderr)
                    return 2
                n_dev = len(jax.devices())
                n_time = n_dev // n_space
                if n_time < 1:
                    print(
                        f"--space-devices {n_space} exceeds the "
                        f"{n_dev} available devices",
                        file=sys.stderr,
                    )
                    return 2
                if n_dev % n_space:
                    # Floor division would silently strand devices (8
                    # devices with --space-devices 3 → a 2x3 mesh on 6
                    # chips); require an exact factorization.
                    print(
                        f"--space-devices {n_space} does not divide the "
                        f"{n_dev} available devices (a {n_time}x{n_space} "
                        f"mesh would strand {n_dev - n_time * n_space})",
                        file=sys.stderr,
                    )
                    return 2
                solver = Explicit2DHeatSolver(
                    problem, system, grid,
                    make_spacetime_mesh(n_time, n_space), **kwargs
                )
            else:
                from .solver.heateq import HeatSolver

                solver = HeatSolver(problem, system, grid, **kwargs)
        import contextlib

        @contextlib.contextmanager
        def _maybe_trace():
            if not args.profile:
                yield
                return
            import jax

            with jax.profiler.trace(args.profile):
                yield
            print(f"profiler trace written to {args.profile}")

        x0 = None
        resume_state = None
        if args.resume_from:
            from .utils.checkpoint import (
                has_pcg_state, load_pcg_state, load_solution,
            )

            if has_pcg_state(args.resume_from) and getattr(
                solver, "supports_chunked", False
            ) and args.pcg == "standard":
                resume_state, ck_meta = load_pcg_state(args.resume_from)
                kind = "exact PCG state"
            else:
                x0, ck_meta = load_solution(args.resume_from)
                kind = "iterate (PCG restart)"
            print(f"resuming {kind} from {args.resume_from} "
                  f"(saved at iteration {int(ck_meta.get('iterations', 0))})")

        with timer("solve (incl. compile)"), _maybe_trace():
            if args.refined:
                res = solver.solve_refined(
                    tol=args.tol, inner_tol=args.refine_inner_tol,
                    compute_error=not args.no_error,
                )
            else:
                res = solver.solve(
                    tol=args.tol, maxiter=args.maxiter,
                    compute_error=not args.no_error, x0=x0,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    resume_state=resume_state,
                )

    if args.save_vtk:
        from .utils import write_vtk_series

        paths = write_vtk_series(
            mesh, np.asarray(res.U).reshape(grid.num_intervals + 1, system.m),
            grid, args.save_vtk, stride=args.vtk_stride,
        )
        print(f"wrote {len(paths)} VTK snapshots + {args.save_vtk}.pvd")

    if args.probe:
        from .fem import evaluate_solution

        U2 = np.asarray(res.U).reshape(grid.num_intervals + 1, system.m)
        for spec in args.probe:
            vals = [float(v) for v in spec.split(",")]
            if len(vals) != problem.dim + 1:
                print(f"--probe {spec!r}: need t,{'x,y,z'[:2 * problem.dim - 1]}",
                      file=sys.stderr)
                return 2
            t_p, x_p = vals[0], np.asarray(vals[1:])
            u_val = float(evaluate_solution(mesh, grid, U2, t_p, x_p))
            line = f"u({t_p}, {x_p.tolist()}) = {u_val:.8e}"
            if problem.exact is not None:
                line += f"  (exact {float(problem.exact_np(t_p, x_p[None])[0]):.8e})"
            print(line)

    rel = res.residuals / res.residuals[0]
    print(
        f"PCG: {res.iterations} iterations, converged={res.converged}, "
        f"final relative residual {rel[-1]:.3e}"
    )
    if res.l2_error is not None:
        print(f"L2(IxOmega) error vs exact solution: {res.l2_error:.6e}")
    print("residual history:", " ".join(f"{x:.2e}" for x in rel))

    record = {
        "problem": args.problem,
        "backend": args.backend,
        # the devices JAX ran on: every timing row names its hardware
        "device": device_record(),
        "space_n": args.space_n,
        "mesh_file": args.mesh_file,
        "refine": args.refine,
        "time_levels": args.time_levels,
        "extra_levels": args.extra_levels,
        "dof": n_dof,
        "dtype": args.dtype if args.backend != "oracle" else "f64",
        "pcg": args.pcg if args.backend != "oracle" else "standard",
        # resolved settings, not the CLI literals — 'auto' is resolved at
        # solver construction and rows are unattributable without them
        "inner": getattr(solver, "inner", "oracle"),
        "spatial": getattr(solver, "spatial_format", "oracle"),
        "tol": args.tol,
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "final_rel_residual": float(rel[-1]),
        "l2_error": res.l2_error,
        "timings_s": timer.summary(),
        # Separated phase costs (SolveResult): device solve time vs one-time
        # RHS quadrature vs result transfer — the driver metric
        # ("time-to-tol residual", BASELINE.md) is solve_seconds on a warm
        # process.
        "solve_seconds": getattr(res, "solve_seconds", None),
        "rhs_seconds": getattr(res, "rhs_seconds", None),
        "transfer_seconds": getattr(res, "transfer_seconds", None),
        "setup_seconds": getattr(res, "setup_seconds", None),
        "timestamp": time.time(),
    }

    if args.estimate_condition and args.backend == "explicit2d":
        # The 2-D explicit solver's operators are local-layout shard_map
        # bodies (space-axis collectives) — not callable as a global-layout
        # pencil. Estimate kappa on the jax/sharded backend at the same
        # config instead (the spectrum is backend-independent).
        print("kappa estimation is not supported on the explicit2d "
              "backend (local-layout operators); use --backend "
              "jax/sharded at the same config", file=sys.stderr)
    elif args.estimate_condition:
        from .solver.lanczos import lanczos_condition

        shape = (grid.num_intervals + 1,) + getattr(
            solver, "gs", (system.m,)
        )
        apply_S, apply_KX = solver.apply_S, solver.apply_KX
        lz_dtype = np.float64
        if args.backend in ("jax", "sharded", "explicit"):
            # At-scale estimation: jit the operator applications — 30
            # eager Lanczos steps at the flagship shapes would dispatch
            # thousands of small ops. Params ride as ARGUMENTS, like the
            # solve's (not closed over as constants).
            import jax as _jax

            p_lz = solver.params
            S_j = _jax.jit(lambda U, p: solver.apply_S(U, p))
            K_j = _jax.jit(lambda R, p: solver.apply_KX(R, p))
            apply_S = lambda U: S_j(U, p_lz)
            apply_KX = lambda R: K_j(R, p_lz)
            lz_dtype = solver.dtype
        with timer("lanczos"):
            est = lanczos_condition(apply_S, apply_KX, shape, dtype=lz_dtype)
        print(
            f"Lanczos: lambda in [{est.lam_min:.3g}, {est.lam_max:.3g}], "
            f"kappa(K_X S) ~= {est.condition:.2f}"
        )
        record["kappa_estimate"] = est.condition

    print("timings:", timer.summary())
    if args.out:
        write_jsonl(args.out, record)
        print(f"appended record to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
