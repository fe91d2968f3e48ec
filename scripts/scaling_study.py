"""Time-parallel scaling structure study (virtual device mesh).

The reference paper's headline experiment is MPI strong/weak scaling of the
wavelet-PCG solve over timestep blocks. Real multi-chip hardware is not
available in this environment (SURVEY.md §4), so this script validates the
two properties that scaling rests on, on a virtual CPU mesh:

1. **Algorithmic invariance** — iteration counts and residual histories are
   identical (to reduction-order rounding) on 1, 2, 4, 8 devices, for both
   the GSPMD and the explicit shard_map backend, standard and fused PCG.
2. **Communication structure** — a census of collectives in the lowered
   HLO: per-iteration all-reduces (3 standard / 1 fused), nearest-neighbor
   collective-permutes (halos + fine wavelet levels), and the single
   all-gather of the coarse wavelet phase. These counts are what determine
   ICI traffic on real hardware; they are device-count-independent per
   program, which is the scalability argument.

Usage:  python scripts/scaling_study.py [--space-n 16] [--levels 5]
Appends one JSON record per (backend, P, variant) to scaling_study.jsonl.
"""

import argparse
import hashlib
import json
import sys
import time

sys.path.insert(0, ".")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Virtual device count must be set before the backend initializes, i.e.
# before argparse runs — peek at argv (cfg5 names a 16-device time mesh,
# so the study must be able to emulate 16 devices, not just 8).
_nd = 8
if "--num-devices" in sys.argv:
    _nd = int(sys.argv[sys.argv.index("--num-devices") + 1])
jax.config.update("jax_num_cpu_devices", _nd)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from spacetime.fem import P1System, unit_square_mesh  # noqa: E402
from spacetime.fem.timegrid import uniform_time_grid  # noqa: E402
from spacetime.models import get_problem  # noqa: E402
from spacetime.parallel import (  # noqa: E402
    ExplicitHeatSolver,
    ShardedHeatSolver,
    make_time_mesh,
)
from spacetime.solver.heateq import HeatSolver  # noqa: E402


def collective_census(solver) -> dict:
    """Count collectives in the lowered solve program (explicit path)."""
    fn = solver._build_solve(1e-6, 40, warm=False)
    gL, gR, u0 = solver.assemble_rhs_host()
    x0 = solver._prepare_x0(None)
    jitted = fn.__closure__[0].cell_contents
    hlo = jitted.lower(gL, gR, u0, solver._solve_params(), x0).as_text()
    return {
        "all_reduce": hlo.count("stablehlo.all_reduce"),
        "collective_permute": hlo.count("stablehlo.collective_permute"),
        "all_gather": hlo.count("stablehlo.all_gather"),
    }


_DT_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
             "u32": 4, "u8": 1, "pred": 1}


def compiled_collective_stats(solver) -> dict:
    """Census + payload bytes of the collectives GSPMD actually inserted.

    The pre-partitioning StableHLO of the GSPMD path carries only sharding
    annotations; the collectives exist in the COMPILED (SPMD-partitioned)
    module. Each op's result shape is its per-device payload, so summing
    them gives the bytes-on-ICI model: ops inside the PCG while-loop body
    appear once in the text but execute once per iteration — on this
    solver virtually all collective traffic is in-loop, so `bytes` reads
    as per-iteration per-device ICI bytes (halo planes of the space axis,
    halo rows of the time axis, psum scalars)."""
    fn = solver._build_solve(1e-6, 40, warm=False)
    gL, gR, u0 = solver.assemble_rhs_host()
    x0 = solver._prepare_x0(None)
    if not hasattr(fn, "lower"):  # explicit backends wrap the jitted callable
        fn = fn.__closure__[0].cell_contents
    txt = fn.lower(gL, gR, u0, solver._solve_params(), x0).compile().as_text()
    import re

    stats = {}
    for m in re.finditer(
        r"=\s+(\w+)\[([\d,]*)\][^=]*?\s(all-reduce|collective-permute|"
        r"all-gather|all-to-all|reduce-scatter)\(",
        txt,
    ):
        dt, shape, op = m.groups()
        n = 1
        for s in shape.split(","):
            if s:
                n *= int(s)
        d = stats.setdefault(op, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += n * _DT_BYTES.get(dt, 4)
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--space-n", type=int, default=16)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--out", default="scaling_study.jsonl")
    ap.add_argument("--num-devices", type=int, default=8,
                    help="virtual CPU device count (also consumed before "
                    "backend init at module top); device ladder runs "
                    "powers of two up to this")
    args = ap.parse_args()

    problem = get_problem("smooth2d")
    system = P1System.from_mesh(unit_square_mesh(args.space_n))
    grid = uniform_time_grid(args.levels)
    records = []

    ref = {}
    for variant in ("standard", "fused"):
        r = HeatSolver(problem, system, grid, pcg_variant=variant).solve(
            tol=args.tol, compute_error=False
        )
        ref[variant] = r
        print(f"serial/{variant}: {r.iterations} iters")

    # Odd / non-dividing device counts exercise the explicit backend's
    # GENERALIZED layout (parallel/general_layout.py, round 2): per-level
    # padded wavelet index arrays + one small all_gather per
    # boundary-crossing level instead of the aligned path's single coarse
    # gather — the census quantifies that comm-structure difference.
    for backend, cls in (("sharded", ShardedHeatSolver), ("explicit", ExplicitHeatSolver)):
        counts = (2, 3, 4, 5, 8, 16, 32) if backend == "explicit" else (2, 4, 8, 16, 32)
        for P in [p for p in counts if p <= args.num_devices]:
            for variant in ("standard", "fused"):
                solver = cls(
                    problem, system, grid, make_time_mesh(P),
                    pcg_variant=variant,
                )
                t0 = time.perf_counter()
                r = solver.solve(tol=args.tol, compute_error=False)
                dt = time.perf_counter() - t0
                match = (
                    r.iterations == ref[variant].iterations
                    and np.allclose(
                        r.residuals, ref[variant].residuals, rtol=1e-9
                    )
                )
                rec = {
                    "backend": backend,
                    "devices": P,
                    "pcg": variant,
                    "iterations": int(r.iterations),
                    "matches_serial": bool(match),
                    "res_sha": hashlib.sha256(
                        np.asarray(r.residuals).tobytes()
                    ).hexdigest()[:12],
                    "wall_s": round(dt, 3),
                }
                if backend == "explicit":
                    rec["collectives"] = collective_census(solver)
                records.append(rec)
                tag = "OK " if match else "MISMATCH"
                extra = (
                    f" collectives={rec.get('collectives')}"
                    if "collectives" in rec
                    else ""
                )
                print(
                    f"{tag} {backend} P={P} {variant}: {r.iterations} iters"
                    f"{extra}"
                )

    # 2-D (time, space) mesh (cfg5 stretch): 3D problem with an UNEVEN
    # space split (gs[0] = 7 over P_s ∈ {2, 4}), parity vs serial plus the
    # compiled-HLO collective census — the bytes column is the per-device
    # per-iteration ICI traffic model for the layout (see
    # compiled_collective_stats).
    from spacetime.fem import unit_cube_mesh
    from spacetime.parallel import make_spacetime_mesh

    problem3 = get_problem("smooth3d")
    system3 = P1System.from_mesh(unit_cube_mesh(8))
    grid3 = uniform_time_grid(3)
    ref3 = HeatSolver(problem3, system3, grid3).solve(
        tol=args.tol, compute_error=False
    )
    mesh2_records = []
    for pt, ps in ((4, 2), (2, 4), (2, 2)):
        if pt * ps > args.num_devices:
            continue
        solver = ShardedHeatSolver(
            problem3, system3, grid3, make_spacetime_mesh(pt, ps)
        )
        t0 = time.perf_counter()
        r = solver.solve(tol=args.tol, compute_error=False)
        dt = time.perf_counter() - t0
        match = r.iterations == ref3.iterations and np.allclose(
            r.residuals, ref3.residuals, rtol=1e-9
        )
        rec = {
            "backend": "sharded-2d",
            "devices": pt * ps,
            "mesh": [pt, ps],
            "pcg": "standard",
            "iterations": int(r.iterations),
            "matches_serial": bool(match),
            "res_sha": hashlib.sha256(
                np.asarray(r.residuals).tobytes()
            ).hexdigest()[:12],
            "wall_s": round(dt, 3),
            "collectives": compiled_collective_stats(solver),
        }
        mesh2_records.append(rec)
        tag = "OK " if match else "MISMATCH"
        print(f"{tag} sharded-2d mesh={pt}x{ps}: {r.iterations} iters "
              f"collectives={rec['collectives']}")
    records.extend(mesh2_records)

    # Explicit 2-D ('time','space') mesh (round 3): hand-placed plane-halo
    # ppermutes around every stencil op + sharded V-cycle levels + one
    # all_gather at the gather level — the census pins that structure
    # (each spatial stencil application contributes exactly one
    # collective-permute pair; dots psum over both axes). 2D problem so
    # the mg hierarchy actually shards (gs 15 planes over P_s = 2).
    from spacetime.parallel import Explicit2DHeatSolver

    ref2d = HeatSolver(
        problem, system, grid, inner="mg", space_n=args.space_n
    ).solve(tol=args.tol, compute_error=False)
    for pt, ps in ((4, 2), (2, 4), (2, 2)):
        if pt * ps > args.num_devices:
            continue
        solver = Explicit2DHeatSolver(
            problem, system, grid, make_spacetime_mesh(pt, ps),
            inner="mg", space_n=args.space_n,
        )
        t0 = time.perf_counter()
        r = solver.solve(tol=args.tol, compute_error=False)
        dt = time.perf_counter() - t0
        match = r.iterations == ref2d.iterations and np.allclose(
            r.residuals, ref2d.residuals, rtol=1e-9
        )
        rec = {
            "backend": "explicit-2d",
            "devices": pt * ps,
            "mesh": [pt, ps],
            "sp_depth": solver._sp_depth,
            "pcg": "standard",
            "iterations": int(r.iterations),
            "matches_serial": bool(match),
            "res_sha": hashlib.sha256(
                np.asarray(r.residuals).tobytes()
            ).hexdigest()[:12],
            "wall_s": round(dt, 3),
            "collectives": collective_census(solver),
            "compiled": compiled_collective_stats(solver),
        }
        records.append(rec)
        tag = "OK " if match else "MISMATCH"
        print(f"{tag} explicit-2d mesh={pt}x{ps} D={solver._sp_depth}: "
              f"{r.iterations} iters collectives={rec['collectives']}")

    assert all(r["matches_serial"] for r in records), "scaling parity broken"
    with open(args.out, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"{len(records)} records appended to {args.out}")


if __name__ == "__main__":
    main()
