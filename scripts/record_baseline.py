"""Regenerate the oracle baseline table in BASELINE.md.

The reference binary is unavailable (SURVEY.md §0); these oracle numbers are
the regression baseline the device path must match (iteration counts ±1,
residual histories to fp tolerance). Run from the repo root:

    python scripts/record_baseline.py
"""

import hashlib
import json
import sys
import time

sys.path.insert(0, ".")

from spacetime.utils import use_cpu  # noqa: E402

use_cpu()

import numpy as np  # noqa: E402

from spacetime.oracle import solve_heat_equation  # noqa: E402

CONFIGS = [
    # (label, problem, space_n, J, extra, tol)
    ("cfg1-2d-65x65x64-tol1e-6", "smooth2d", 64, 6, 0, 1e-6),
    ("cfg1b-2d-65x65x64-tol1e-8", "smooth2d", 64, 6, 0, 1e-8),
    ("2d-ladder-8x8x8", "smooth2d", 8, 3, 0, 1e-6),
    ("2d-ladder-16x16x16", "smooth2d", 16, 4, 0, 1e-6),
    ("2d-ladder-32x32x32", "smooth2d", 32, 5, 0, 1e-6),
    ("cfg3-3d-17x17x17x16", "smooth3d", 16, 4, 0, 1e-6),
    ("cfg4-singular-graded-32-J4+4", "singular2d", 32, 4, 4, 1e-6),
    ("singular3d-graded-8-J2+3", "singular3d", 8, 2, 3, 1e-6),
    ("moving-peak-32x32x32", "moving_peak2d", 32, 5, 0, 1e-6),
    ("lshape-32-J5", "lshape2d", 32, 5, 0, 1e-6),
    ("varcoef-32-J5", "varcoef2d", 32, 5, 0, 1e-6),
    ("varcoef3d-8-J3", "varcoef3d", 8, 3, 0, 1e-6),
]


def main():
    rows = []
    for label, prob, n, J, extra, tol in CONFIGS:
        t0 = time.perf_counter()
        r = solve_heat_equation(
            prob, space_n=n, time_levels=J, extra_time_levels=extra, tol=tol
        )
        wall = time.perf_counter() - t0
        hist = r.residuals / r.residuals[0]
        rh = hashlib.sha256(
            np.round(np.log10(hist + 1e-300), 6).tobytes()
        ).hexdigest()[:12]
        rows.append(
            {
                "config": label,
                "iters": r.iterations,
                "converged": bool(r.converged),
                "final_rel_residual": float(hist[-1]),
                "l2_error": r.l2_error,
                "residual_history_sha": rh,
                "wall_s": round(wall, 2),
                "rel_residuals": [float(f"{x:.6e}") for x in hist],
            }
        )
        print(json.dumps({k: v for k, v in rows[-1].items() if k != "rel_residuals"}))
    with open("baseline_oracle.json", "w") as f:
        json.dump(rows, f, indent=1)
    print("wrote baseline_oracle.json")


if __name__ == "__main__":
    main()
