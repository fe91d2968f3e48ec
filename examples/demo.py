"""Serial demo — the analogue of the reference's demo.py (SURVEY.md §3.2).

Solves the 2D heat-equation benchmark on the CPU-runnable parity config
(65×65 P1 mesh × 64 timesteps, tol 1e-6) with both the NumPy oracle and the
jitted JAX path, and prints the convergence study the paper's tables show:
flat PCG iteration counts and second-order errors under refinement.

Run from the repo root:  python examples/demo.py
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spacetime.utils import use_cpu

use_cpu()

from spacetime.oracle import solve_heat_equation  # noqa: E402
from spacetime.solver import solve_heat_equation_device  # noqa: E402


def main():
    print("== refinement study (smooth2d, tol 1e-6) ==")
    print(f"{'grid':>14} {'PCG iters':>9} {'L2 error':>12} {'rate':>6}")
    prev = None
    for n, J in [(8, 3), (16, 4), (32, 5), (64, 6)]:
        r = solve_heat_equation("smooth2d", space_n=n, time_levels=J, tol=1e-6)
        rate = f"{prev / r.l2_error:.2f}" if prev else "  --"
        print(f"{n+1:>5}^2 x {2**J:>3}ts {r.iterations:>9} {r.l2_error:>12.4e} {rate:>6}")
        prev = r.l2_error

    print("\n== oracle vs jitted JAX path (65x65 x 64ts) ==")
    ro = solve_heat_equation("smooth2d", space_n=64, time_levels=6, tol=1e-6)
    rj = solve_heat_equation_device("smooth2d", space_n=64, time_levels=6, tol=1e-6)
    print(f"oracle: {ro.iterations} iters, err {ro.l2_error:.6e}")
    print(f"jax:    {rj.iterations} iters, err {rj.l2_error:.6e}")
    drift = max(
        abs(a - b) / ro.residuals[0]
        for a, b in zip(ro.residuals, rj.residuals)
    )
    print(f"max relative residual-history difference: {drift:.2e}")


if __name__ == "__main__":
    main()
