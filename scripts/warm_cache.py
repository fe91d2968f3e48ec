"""Pre-compile the jitted solve for a set of configs into the persistent
XLA compilation cache.

Full-solve graphs at the large configurations take tens of seconds to
compile. The persistent cache (utils.enable_compile_cache: the directory
in $JAX_COMPILATION_CACHE_DIR, else .jax_cache in the checkout) makes a
later process at the same shapes start quickly —
run this once per machine/config set, e.g. overnight:

    python scripts/warm_cache.py 128 256 512   # space_n values, 2D
    python scripts/warm_cache.py --dim 3 64    # 3D

Each config compiles the f32 mg solve at 64/128 timesteps.
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

from spacetime.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402

from spacetime.fem import (  # noqa: E402
    P1System,
    unit_cube_mesh,
    unit_square_mesh,
    uniform_time_grid,
)
from spacetime.models import get_problem  # noqa: E402
from spacetime.solver.heateq import HeatSolver  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("space_n", type=int, nargs="+")
    p.add_argument("--dim", type=int, default=2, choices=[2, 3])
    p.add_argument("--time-levels", type=int, default=None)
    p.add_argument("--tol", type=float, default=1e-6)
    args = p.parse_args()
    for n in args.space_n:
        levels = args.time_levels or (7 if args.dim == 2 and n >= 256 else 6)
        t0 = time.perf_counter()
        mesh = unit_square_mesh(n) if args.dim == 2 else unit_cube_mesh(n)
        problem = get_problem("smooth2d" if args.dim == 2 else "smooth3d")
        solver = HeatSolver(
            problem, P1System.from_mesh(mesh), uniform_time_grid(levels),
            dtype=jnp.float32,
        )
        # Executables are keyed on (tol, maxiter) — warm with the production
        # defaults so the cached binary is the one real solves will load.
        # compute_error=True also seeds the device RHS-quadrature and
        # error-norm graphs the f32 path now uses.
        r = solver.solve(tol=args.tol, compute_error=True)
        print(
            f"n={n} dim={args.dim} levels={levels}: compiled+cached in "
            f"{time.perf_counter() - t0:.0f}s ({r.iterations} iters, "
            f"rel residual {r.residuals[-1] / r.residuals[0]:.1e})",
            flush=True,
        )


if __name__ == "__main__":
    main()
