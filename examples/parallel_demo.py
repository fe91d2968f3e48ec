"""Time-parallel solve walkthrough (runs anywhere — 8 virtual CPU devices).

Demonstrates the framework's parallel surface end-to-end:

1. serial jitted solve (the reference point),
2. GSPMD time-sharded solve (sharding annotations, compiler-inserted
   collectives),
3. explicit shard_map solve with hand-placed collectives and the
   single-reduction (Chronopoulos–Gear) PCG variant,

and checks all three produce the same iteration count and residual history —
the serial-vs-parallel equality that the reference validates with
`mpiexec -n P` (SURVEY.md §4).

Run:  python examples/parallel_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from spacetime import (  # noqa: E402
    ExplicitHeatSolver,
    HeatSolver,
    P1System,
    ShardedHeatSolver,
    get_problem,
    make_time_mesh,
)
from spacetime.fem import unit_square_mesh, uniform_time_grid  # noqa: E402


def main():
    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(16))
    grid = uniform_time_grid(5)  # 32 timesteps
    mesh = make_time_mesh(8)
    print(
        f"{problem.name}: {system.m} spatial DoF x {grid.num_intervals} "
        f"timesteps, {len(jax.devices())} devices\n"
    )

    runs = {
        "serial (jit)": HeatSolver(problem, system, grid),
        "GSPMD time-sharded": ShardedHeatSolver(problem, system, grid, mesh),
        "explicit shard_map + fused PCG": ExplicitHeatSolver(
            problem, system, grid, mesh, pcg_variant="fused"
        ),
    }
    results = {}
    for name, solver in runs.items():
        r = solver.solve(tol=1e-8, compute_error=True)
        results[name] = r
        print(
            f"{name:32s} {r.iterations} iterations, "
            f"final rel residual {r.residuals[-1] / r.residuals[0]:.2e}, "
            f"L2 error {r.l2_error:.3e}"
        )

    ref = results["serial (jit)"]
    for name, r in results.items():
        assert r.iterations == ref.iterations, name
        np.testing.assert_allclose(r.residuals, ref.residuals, rtol=1e-9)
    print("\nall backends: identical iteration counts and residual histories")


if __name__ == "__main__":
    main()
