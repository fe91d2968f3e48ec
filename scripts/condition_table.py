"""κ(K_X S) across the refinement ladder — the paper's headline table.

The published method's central claim is a uniformly bounded preconditioned
condition number (⇒ refinement-independent PCG iteration counts); this script
reproduces that table with the built-in Lanczos estimator over the benchmark
ladder (2D/3D, uniform and graded time grids, structured and generic spatial
paths) and prints it as markdown. CPU-runnable in a few minutes.

    python scripts/condition_table.py [--quick]
"""

import argparse
import sys

sys.path.insert(0, ".")

from spacetime.utils import use_cpu  # noqa: E402

use_cpu(x64=True)

import jax.numpy as jnp  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smallest two rows per family only")
    ap.add_argument("--iters", type=int, default=40,
                    help="Lanczos iterations per estimate")
    args = ap.parse_args()

    from spacetime.fem import P1System, domain_mesh
    from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver
    from spacetime.solver.lanczos import lanczos_condition

    ladder = [
        ("smooth2d", 8, 3, 0),
        ("smooth2d", 16, 4, 0),
        ("smooth2d", 32, 5, 0),
        ("smooth2d", 64, 6, 0),
        ("smooth3d", 8, 3, 0),
        ("smooth3d", 16, 4, 0),
        ("singular2d", 16, 4, 3),
        ("singular2d", 32, 5, 4),
        ("lshape2d", 16, 4, 0),
        ("lshape2d", 32, 5, 0),
        ("varcoef2d", 16, 4, 0),
        ("varcoef2d", 32, 5, 0),
    ]
    if args.quick:
        ladder = [
            ("smooth2d", 8, 3, 0), ("smooth2d", 16, 4, 0),
            ("smooth3d", 8, 3, 0), ("singular2d", 16, 4, 3),
            ("lshape2d", 16, 4, 0),
        ]

    print("| problem | mesh | timesteps | λmin | λmax | κ(K_X S) |")
    print("|---|---|---|---|---|---|")
    for name, n, J, extra in ladder:
        problem = get_problem(name)
        mesh = domain_mesh(problem.domain, problem.dim, n)
        system = P1System.from_problem(problem, mesh)
        grid = (graded_time_grid(J, extra, T=problem.T) if extra
                else uniform_time_grid(J, T=problem.T))
        solver = HeatSolver(problem, system, grid, dtype=jnp.float64)
        shape = (grid.num_intervals + 1,) + solver.gs
        est = lanczos_condition(
            solver.apply_S, solver.apply_KX, shape, num_iters=args.iters
        )
        ts = f"{grid.num_intervals}" + (" (graded)" if extra else "")
        print(
            f"| {name} | {n}^{problem.dim} | {ts} "
            f"| {est.lam_min:.3f} | {est.lam_max:.3f} "
            f"| **{est.condition:.2f}** |",
            flush=True,
        )


if __name__ == "__main__":
    main()
