"""Smoke run of the space-time solver on the GPU, in one process.

    python chip_smoke.py            # one card: phases (a)-(e) below
    python chip_smoke.py --four     # four cards: the time-parallel backends
                                    # against the same solve on device 0

Phases (one card):

(a) f64 parity — cfg1 (smooth2d 65x65 x 64 timesteps, tol 1e-6, dense
    inner) on the card against the NumPy ``OracleSolver`` on the host:
    identical iteration count, relative residual histories within 1e-10.
(b) main path at full width — the 135-MDoF flagship (smooth2d 1025^2 x 128
    timesteps, f32, multigrid inner, device RHS, mixed-precision refinement
    to 1e-8), solved twice in-process: set-up, first (compiling) and steady
    solve times, iterations, residual, L2 error against the exact solution
    (8.99e-7 +- 5%, a property of the discretization), the inner solve's
    ``compiled.memory_analysis()`` and the peak device memory.
(c) the paths that had hand-written kernels before, now XLA forms, at
    moderate size: 3-D multigrid, the weighted (variable-coefficient) multigrid, the
    graded time grid, nested unstructured multigrid, smoothed-aggregation
    AMG. Each must converge with iterations in the flat band.
(d) operators against their f64 reference at 1025^2 x 128: f32 B, B^T, the
    K_Y V-cycle and the wavelet GEMM against the same operators in f64 on
    the card (max relative error <= 1e-5 for the single-pass operators: f32
    rounding over a stencil or a GEMM; a TF32 matmul would show ~1e-3.
    <= 1e-4 for the K_Y V-cycles, whose f32 error grows like 1/h: in strict
    IEEE f32 on the CPU it is 2.2e-6, 5.1e-6, 1.0e-5, 3.9e-5 at 129^2,
    257^2, 513^2, 1025^2), and an audit that every f32 matrix product of
    the solve pins its precision.
(e) what XLA makes of the plain forms: the B/B^T pair, one fine-level
    smoother sweep and one V-cycle at 1025^2 x 128 and 129^3 x 64 f32, each
    beside a large device-to-device copy measured in the same process.

Every time is printed beside the card's name and power limit. Any failed
check raises, and then no result line is printed. The last line of
standard output is the JSON device record.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

# Expected L2(IxOmega) error of the flagship at tol 1e-8: a property of the
# discretization (h = 1/1024, 128 uniform timesteps), not of the device. The
# error is h^2-dominated (the f64 NumPy oracle at 65^2 gives 2.301933e-4,
# 2.302087e-4, 2.302117e-4 with 64, 128, 256 steps), and the oracle's
# 33^2 ... 257^2 x 128 ladder (9.200552e-4, 2.302087e-4, 5.755561e-5,
# 1.438071e-5; ratios 3.9966, 3.9998, 4.0023) extrapolates as h^2 to
# 1.438071e-5 / 16 = 8.99e-7.
FLAGSHIP_L2 = 8.99e-7
# PCG iteration band of the wavelet preconditioner at tol 1e-6: kappa(K_X S)
# stays in [4, 7] under refinement (BASELINE.md), so counts stay flat.
FLAT_BAND = (5, 25)
CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rel_err(y, y_ref) -> float:
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())


def _system(problem, space_n: int, refine: int = 0):
    from spacetime.fem import P1System, domain_mesh, refine_hierarchy

    mesh = domain_mesh(problem.domain, problem.dim, space_n)
    if refine:
        mesh = refine_hierarchy(mesh, refine)
    return P1System.from_problem(problem, mesh)


def _grid(problem, time_levels: int, extra_levels: int = 0):
    from spacetime.fem.timegrid import graded_time_grid, uniform_time_grid

    if extra_levels:
        return graded_time_grid(time_levels, extra_levels, T=problem.T)
    return uniform_time_grid(time_levels, T=problem.T)


# ----------------------------------------------------------------- phases


def phase_parity(space_n: int = 64, time_levels: int = 6, tol: float = 1e-6,
                 expect_iters: int | None = 15) -> dict:
    """(a) f64 device solve vs the NumPy oracle, same process."""
    import jax.numpy as jnp

    from spacetime.models import get_problem
    from spacetime.oracle.solver import OracleSolver
    from spacetime.solver.heateq import HeatSolver

    problem = get_problem("smooth2d")
    system = _system(problem, space_n)
    grid = _grid(problem, time_levels)
    ref = OracleSolver(problem, system, grid).solve(tol=tol)
    solver = HeatSolver(problem, system, grid, dtype=jnp.float64,
                        inner="dense")
    res = solver.solve(tol=tol)
    a = res.residuals / res.residuals[0]
    b = ref.residuals / ref.residuals[0]
    dev = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    out = {"iterations": res.iterations, "oracle_iterations": ref.iterations,
           "max_history_diff": dev, "l2_error": res.l2_error,
           "oracle_l2_error": ref.l2_error}
    log(f"(a) parity smooth2d {space_n + 1}^2 x {grid.num_intervals}ts f64: "
        f"{res.iterations} iterations (oracle {ref.iterations}), max "
        f"relative-history difference {dev:.3e} (bound 1e-10), L2 "
        f"{res.l2_error:.6e} (oracle {ref.l2_error:.6e})")
    _check(res.iterations == ref.iterations, "(a) iteration counts differ")
    if expect_iters is not None:
        _check(ref.iterations == expect_iters, "(a) oracle iteration count")
    _check(np.allclose(a, b, rtol=1e-10, atol=0.0),
           "(a) residual histories differ by more than 1e-10")
    return out


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _inner_memory_analysis(solver):
    """compiled.memory_analysis() of the refinement's f32 inner PCG solve —
    the executable that holds the solve's live set."""
    import jax
    import jax.numpy as jnp

    inner = solver._ir_jits[2]
    r32 = jax.ShapeDtypeStruct((solver.N + 1,) + solver.gs, jnp.float32)
    p32 = solver._refined_params(jnp.float32)
    return inner.lower(r32, p32, jnp.float32(1e-5)).compile().memory_analysis()


def phase_flagship(space_n: int = 1024, time_levels: int = 7,
                   tol: float = 1e-8, expect_l2: float | None = FLAGSHIP_L2):
    """(b) the main path at full width: returns (record, solver) — the
    solver is reused by phases (d) and (e)."""
    import jax.numpy as jnp

    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    t0 = time.perf_counter()
    problem = get_problem("smooth2d")
    system = _system(problem, space_n)
    grid = _grid(problem, time_levels)
    solver = HeatSolver(problem, system, grid, dtype=jnp.float32, inner="mg")
    setup = time.perf_counter() - t0
    ndof = (grid.num_intervals + 1) * system.m
    walls, results = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        results.append(solver.solve_refined(tol=tol))
        walls.append(time.perf_counter() - t0)
    res = results[-1]
    rel = float(res.residuals[-1] / res.residuals[0])
    mem = _inner_memory_analysis(solver)
    peak = _peak_bytes()
    rec = {
        "config": f"smooth2d {space_n + 1}^2 x {grid.num_intervals}ts f32 "
                  f"mg refined tol={tol:g}",
        "dof": ndof, "setup_s": setup, "first_solve_wall_s": walls[0],
        "steady_solve_wall_s": walls[1],
        "steady_solve_seconds": res.solve_seconds,
        "rhs_seconds": res.rhs_seconds, "inner_iterations": res.iterations,
        "rounds": len(res.residuals), "final_rel_residual": rel,
        "l2_error": res.l2_error, "peak_bytes_in_use": peak,
        "inner_memory": {
            k: getattr(mem, k, None) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
        },
        "card": CARD,
    }
    log(f"(b) flagship {rec['config']} = {ndof:,} DoF on [{CARD}]: set-up "
        f"{setup:.3f} s, first solve (incl. compile) {walls[0]:.3f} s, "
        f"steady solve {walls[1]:.3f} s wall ({res.solve_seconds:.3f} s "
        f"device loop), {res.iterations} inner iterations in "
        f"{len(res.residuals)} rounds, final relative residual {rel:.3e}, "
        f"L2 error {res.l2_error:.6e}")
    log(f"(b) inner solve memory_analysis: {mem}")
    log(f"(b) peak_bytes_in_use {peak} on [{CARD}]")
    _check(res.converged and rel <= tol, "(b) refinement did not converge")
    if expect_l2 is not None:
        _check(abs(res.l2_error - expect_l2) <= 0.05 * expect_l2,
               f"(b) L2 error {res.l2_error:.4e} not within 5% of "
               f"{expect_l2:.3e}")
    return rec, solver


# (label, problem, space_n, refine, time_levels, extra_levels, inner)
REMOVED_PATHS = (
    ("3-D multigrid (cfg3)", "smooth3d", 64, 0, 5, 0, "mg"),
    ("weighted multigrid", "varcoef2d", 128, 0, 6, 0, "mg"),
    ("graded time grid J6+3", "singular2d", 128, 0, 6, 3, "mg"),
    ("nested unstructured mg (refine 4)", "lshape2d", 16, 4, 6, 0, "mg"),
    ("smoothed-aggregation AMG", "lshape2d", 64, 0, 6, 0, "amg"),
)


def phase_removed_paths(cases=REMOVED_PATHS, tol: float = 1e-6,
                        band=FLAT_BAND) -> list[dict]:
    """(c) every path whose kernel was removed: converge, flat iterations."""
    import jax.numpy as jnp

    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    out = []
    for label, name, space_n, refine, J, extra, inner in cases:
        problem = get_problem(name)
        system = _system(problem, space_n, refine)
        grid = _grid(problem, J, extra)
        t0 = time.perf_counter()
        solver = HeatSolver(problem, system, grid, dtype=jnp.float32,
                            inner=inner)
        setup = time.perf_counter() - t0
        res = solver.solve(tol=tol)
        ndof = (grid.num_intervals + 1) * system.m
        rec = {"case": label, "problem": name, "dof": ndof,
               "inner": getattr(solver, "mg_flavor", solver.inner),
               "iterations": res.iterations, "converged": res.converged,
               "l2_error": res.l2_error, "setup_s": setup,
               "solve_seconds": res.solve_seconds, "card": CARD}
        log(f"(c) {label}: {name} m={system.m} x {grid.num_intervals}ts "
            f"({ndof:,} DoF) f32 {rec['inner']}: {res.iterations} "
            f"iterations, converged={res.converged}, L2 "
            f"{res.l2_error:.6e}, solve {res.solve_seconds:.3f} s incl. "
            f"compile on [{CARD}]")
        _check(res.converged, f"(c) {label} did not converge")
        _check(band[0] <= res.iterations <= band[1],
               f"(c) {label}: {res.iterations} iterations outside {band}")
        out.append(rec)
        del solver
        gc.collect()
    return out


def phase_operators(solver, tol: float = 1e-5, ky_tol: float = 1e-4,
                    seed: int = 0) -> dict:
    """(d) f32 operators against the same operators in f64 on the device,
    and the f32 matmul-precision audit of the solve."""
    import jax
    import jax.numpy as jnp

    from spacetime.utils.jaxpr_audit import unpinned_f32_dots

    p32 = solver.params_for(jnp.float32)
    p64 = solver.params_for(jnp.float64)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    U64 = jax.random.normal(k1, (solver.N + 1,) + solver.gs, jnp.float64)
    V64 = jax.random.normal(k2, (solver.N,) + solver.gs, jnp.float64)
    U32, V32 = U64.astype(jnp.float32), V64.astype(jnp.float32)
    Wd = solver.wt.dense()
    gemm = jax.jit(solver.wt._gemm_axis0)
    ops = {
        "apply_B": (jax.jit(solver.apply_B), U32, U64),
        "apply_BT": (jax.jit(solver.apply_BT), V32, V64),
        "apply_KY": (jax.jit(solver.apply_KY), V32, V64),
    }
    errs = {}
    for name, (fn, x32, x64) in ops.items():
        y64 = fn(x64, p64)
        errs[name] = _rel_err(fn(x32, p32), y64)
        del y64
    errs["wavelet_gemm"] = _rel_err(
        gemm(jnp.asarray(Wd, jnp.float32), U32),
        gemm(jnp.asarray(Wd, jnp.float64), U64),
    )
    r32 = jax.ShapeDtypeStruct((solver.N + 1,) + solver.gs, jnp.float32)
    drv = solver._pcg_driver()
    jaxpr = jax.make_jaxpr(lambda r, p: drv(
        lambda U: solver.apply_S(U, p), lambda R: solver.apply_KX(R, p),
        r, 1e-6, 3,
    ))(r32, p32)
    unpinned = len(unpinned_f32_dots(jaxpr))
    bounds = {name: ky_tol if name == "apply_KY" else tol for name in errs}
    for name, e in errs.items():
        log(f"(d) {name} f32 vs f64 at {solver.N + 1}x{solver.gs}: max "
            f"relative error {e:.3e} (bound {bounds[name]:g})")
    log(f"(d) f32 dot_general without HIGHEST precision in the solve: "
        f"{unpinned}")
    for name, e in errs.items():
        _check(e <= bounds[name], f"(d) {name}: {e:.3e} > {bounds[name]:g}")
    _check(unpinned == 0, "(d) unpinned f32 matmul on the solve path")
    return {"max_rel_err": errs, "unpinned_f32_dots": unpinned}


def _median_time(fn, args, reps: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def copy_bandwidth(nbytes: int = 2 << 30, reps: int = 20) -> float:
    """Bytes/s of a large device-to-device copy (read + write)."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((nbytes // 4,), jnp.float32)
    t = _median_time(jax.jit(lambda a: -a), (x,), reps)
    return 2 * nbytes / t


# Field read+write counts of the ideal XLA schedule, in (rows x m) f32
# fields: the B/B^T pair is two stencil passes (read U, write V; read V,
# write the output); a nu=2 Chebyshev sweep from a nonzero iterate is two
# passes (read x, b, write r, d, x; read r, d, x, write x); a V-cycle level
# is pre-sweep (6) + residual (3) + restrict (1.25) + prolong-correct (2.25)
# + post-sweep (9), summed over the levels by size.
_PAIR_FIELDS = 4.0
_SWEEP_FIELDS = 9.0
_VCYCLE_LEVEL_FIELDS = 21.5


def phase_xla_timings(cases, copy_bw: float, reps: int = 20) -> list[dict]:
    """(e) times of the plain XLA forms. ``cases``: (label, solver)."""
    import jax
    import jax.numpy as jnp

    out = []
    for label, solver in cases:
        p = solver.params_for(jnp.float32)
        ms = solver.msmg
        lev0, lp0 = ms.levels[0], p["ms_ky"][0]
        m = solver.m
        key = jax.random.PRNGKey(1)
        U = jax.random.normal(key, (solver.N + 1,) + solver.gs, jnp.float32)
        V = U[1:]
        coarse = lambda bc, pp: jnp.dot(
            bc.reshape(bc.shape[0], -1), pp["mg_cinv_ky"],
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(bc.shape)
        fns = {
            "B/BT pair": (jax.jit(lambda u, pp: solver.apply_BT(
                solver.apply_B(u, pp), pp)), (U, p)),
            "smoother sweep (fine level, nu=%d)" % ms.nu: (jax.jit(
                lambda x, b, lp: ms._smooth(lev0, lp, x, b)), (V, V, lp0)),
            "V-cycle (K_Y)": (jax.jit(lambda b, pp: ms.vcycle(
                b, pp["ms_ky"], lambda bc: coarse(bc, pp))), (V, p)),
        }
        level_m = [int(np.prod(lv.A_st.grid_shape)) for lv in ms.levels]
        fields = {
            "B/BT pair": _PAIR_FIELDS,
            "smoother sweep (fine level, nu=%d)" % ms.nu: _SWEEP_FIELDS,
            "V-cycle (K_Y)": _VCYCLE_LEVEL_FIELDS * sum(level_m) / m,
        }
        for name, (fn, args) in fns.items():
            t = _median_time(fn, args, reps)
            nbytes = fields[name] * solver.N * m * 4
            bw = nbytes / t
            rec = {"shape": label, "op": name, "ms": t * 1e3,
                   "model_bytes": nbytes, "GB_per_s": bw / 1e9,
                   "share_of_copy": bw / copy_bw, "card": CARD}
            log(f"(e) {label} {name}: {t * 1e3:.4f} ms, "
                f"{bw / 1e9:.1f} GB/s on the {fields[name]:.2f}-field "
                f"model = {bw / copy_bw:.3f} of the copy's "
                f"{copy_bw / 1e9:.1f} GB/s on [{CARD}]")
            out.append(rec)
        del U, V
        gc.collect()
    return out


def phase_four(space_n: int = 512, time_levels: int = 7, tol: float = 1e-6,
               parity_n: int = 64, parity_levels: int = 6,
               n_devices: int = 4) -> dict:
    """(--four) the time-parallel backends on the first ``n_devices``
    devices against the same solve on device 0."""
    import jax
    import jax.numpy as jnp

    from spacetime.models import get_problem
    from spacetime.parallel import (
        Explicit2DHeatSolver,
        ExplicitHeatSolver,
        ShardedHeatSolver,
        make_spacetime_mesh,
        make_time_mesh,
    )
    from spacetime.solver.heateq import HeatSolver

    nd = n_devices
    devs = jax.devices()[:nd]
    _check(len(devs) == nd, f"needs {nd} devices, found {len(devs)}")
    problem = get_problem("smooth2d")
    system = _system(problem, space_n)
    grid = _grid(problem, time_levels)
    kw = dict(dtype=jnp.float32, inner="mg")
    backends = {
        "sharded": lambda: ShardedHeatSolver(
            problem, system, grid, make_time_mesh(nd), **kw),
        "explicit": lambda: ExplicitHeatSolver(
            problem, system, grid, make_time_mesh(nd), **kw),
        "explicit2d": lambda: Explicit2DHeatSolver(
            problem, system, grid, make_spacetime_mesh(nd // 2, 2), **kw),
    }
    rec: dict = {"config": f"smooth2d {space_n + 1}^2 x "
                           f"{grid.num_intervals}ts f32 mg tol={tol:g}"}
    runs = {}
    for name, mk in backends.items():
        t0 = time.perf_counter()
        res = mk().solve(tol=tol, compute_error=False)
        wall = time.perf_counter() - t0
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 for d in devs]
        runs[name] = res
        log(f"(4) {name}: {res.iterations} iterations, converged="
            f"{res.converged}, first solve (incl. compile) {wall:.3f} s, "
            f"peak bytes per device {peaks} on [{CARD}]")
        # Every device holds a share of the work: a path that put all of it
        # on the first device would leave the others' peaks near zero.
        _check(min(peaks) >= 0.2 * max(peaks),
               f"(4) {name}: work not spread over the devices {peaks}")
    t0 = time.perf_counter()
    ref = HeatSolver(problem, system, grid, **kw).solve(
        tol=tol, compute_error=False)
    log(f"(4) one device: {ref.iterations} iterations, first solve "
        f"(incl. compile) {time.perf_counter() - t0:.3f} s on [{CARD}]")
    for name, res in runs.items():
        k = min(res.iterations, ref.iterations) + 1
        a, b = res.residuals[:k], ref.residuals[:k]
        # f32 PCG: rounding differences of the reductions stay near
        # eps32 * ||r_0|| while the residual falls, so entry-wise relative
        # differences grow toward the tolerance; the norm-wise measure is
        # relative to the initial residual.
        normwise = float(np.abs(a - b).max() / b[0])
        entrywise = float(np.abs(a / b - 1).max())
        rec[name] = {"iterations": res.iterations,
                     "history_diff_vs_r0": normwise,
                     "history_diff_entrywise": entrywise}
        log(f"(4) {name} vs one device: iterations {res.iterations} vs "
            f"{ref.iterations}; history difference {normwise:.3e} of "
            f"||r_0|| (bound 1e-4), largest entry-wise relative difference "
            f"{entrywise:.3e}")
        _check(abs(res.iterations - ref.iterations) <= 1,
               f"(4) {name}: iteration counts differ by more than one")
        _check(normwise <= 1e-4, f"(4) {name}: histories differ")
    rec["one_device_iterations"] = ref.iterations
    # cfg1 in f64 under GSPMD against the one-device f64 solve.
    p_sys = _system(problem, parity_n)
    p_grid = _grid(problem, parity_levels)
    r1 = HeatSolver(problem, p_sys, p_grid, dtype=jnp.float64).solve(
        tol=1e-6, compute_error=False)
    r4 = ShardedHeatSolver(problem, p_sys, p_grid, make_time_mesh(nd),
                           dtype=jnp.float64).solve(tol=1e-6,
                                                    compute_error=False)
    diff = float(np.abs(r4.residuals / r1.residuals - 1).max()) \
        if r4.iterations == r1.iterations else float("inf")
    log(f"(4) cfg1 f64 sharded vs one device: {r4.iterations} vs "
        f"{r1.iterations} iterations, max relative history difference "
        f"{diff:.3e} (bound 1e-12)")
    _check(r4.iterations == r1.iterations and diff <= 1e-12,
           "(4) cfg1 f64 sharded history differs")
    rec["cfg1_f64_sharded"] = {"iterations": r4.iterations,
                               "max_rel_history": diff}
    return rec


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card time-parallel comparison")
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json",
                    help="JSON file for the full phase records")
    args = ap.parse_args(argv)

    from spacetime.utils.platform import card_info, device_record, use_gpu

    use_gpu(x64=True)  # raises when JAX finds no GPU
    import jax

    info = card_info()
    for line in info.splitlines():
        log(f"card: {line}")
    CARD = "; ".join(dict.fromkeys(info.splitlines()))
    log(f"jax {jax.__version__}, devices {jax.devices()}")
    t_all = time.perf_counter()
    rec: dict = {"card": CARD, "device": device_record()}
    if args.four:
        nd = len(jax.devices())
        _check(nd == 4, f"--four needs 4 devices, found {nd}")
        rec["four"] = phase_four()
    else:
        rec["parity"] = phase_parity()
        rec["flagship"], flag = phase_flagship()
        rec["operators"] = phase_operators(flag)
        bw = copy_bandwidth()
        log(f"(e) device-to-device copy: {bw / 1e9:.1f} GB/s on [{CARD}]")
        rec["copy_GB_per_s"] = bw / 1e9
        rec["timings"] = phase_xla_timings([("1025^2 x 128", flag)], bw)
        del flag
        gc.collect()
        rec["timings"] += phase_xla_timings([("129^3 x 64", _solver_3d())],
                                            bw)
        rec["removed_paths"] = phase_removed_paths()
    rec["total_s"] = time.perf_counter() - t_all
    log(f"all phases passed in {rec['total_s']:.1f} s on [{CARD}]")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(json.dumps({"ok": True, "device": rec["device"]}), flush=True)
    return 0


def _solver_3d(space_n: int = 128, time_levels: int = 6):
    import jax.numpy as jnp

    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    problem = get_problem("smooth3d")
    return HeatSolver(problem, _system(problem, space_n),
                      _grid(problem, time_levels), dtype=jnp.float32,
                      inner="mg")


if __name__ == "__main__":
    sys.exit(main())
