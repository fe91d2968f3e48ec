"""Per-component timing of one PCG iteration's operators on the device.

Times each linear piece of the iteration — the Kronecker pair, K_Y, K_X,
the wavelet transforms, the multi-shift V-cycle — with the same
chained-fori slope method as bench.py (fixed dispatch and synchronization
costs cancel in the slope between two chain lengths). Each
component is linear, so the chain stays bounded via a static per-link scale
estimated by power iteration; the scalar multiply fuses into the component's
last fusion/GEMM epilogue, so the extra traffic is ~zero.

Usage:
    python scripts/profile_iteration.py --space-n 512 --time-levels 7
    python scripts/profile_iteration.py --space-n 256 --vcycle-stages

Prints one JSON line per component: {"component", "ms_per_apply", ...}.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

from spacetime.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--space-n", type=int, default=512)
    ap.add_argument("--time-levels", type=int, default=7)
    ap.add_argument("--problem", default="smooth2d")
    ap.add_argument("--inner", default="mg")
    ap.add_argument("--refine", type=int, default=0,
                    help="red-refine the mesh K times recording the nested "
                         "hierarchy (unstructured nested-mg profiling)")
    ap.add_argument("--k1", type=int, default=32)
    ap.add_argument("--k2", type=int, default=160)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--components", default="",
                    help="comma list to restrict (default: all)")
    ap.add_argument("--vcycle-stages", action="store_true",
                    help="profile the multi-shift V-cycle's internal stages "
                         "(fine-level smooths/residual, transfer pair, "
                         "coarse remainder) instead of the components")
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu",
                    help="platform (gpu fails when no GPU is present)")
    args = ap.parse_args()

    if args.device == "cpu":
        from spacetime.utils import use_cpu

        use_cpu()
    else:
        from spacetime.utils import use_gpu

        use_gpu()

    from spacetime.fem import (P1System, domain_mesh, refine_hierarchy,
                                   uniform_time_grid)
    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    problem = get_problem(args.problem)
    mesh = domain_mesh(problem.domain, problem.dim, args.space_n)
    if args.refine:
        mesh = refine_hierarchy(mesh, args.refine)
    system = P1System.from_problem(problem, mesh)
    grid = uniform_time_grid(args.time_levels)
    s = HeatSolver(problem, system, grid, dtype=jnp.float32, inner=args.inner)
    p = s.params
    N, gs, m = s.N, s.gs, s.m
    log(f"config: m={m} ({args.space_n}^{problem.dim}) x {N} ts "
        f"-> {(N + 1) * m / 1e6:.1f} MDoF; inner={s.inner}")

    rng = np.random.default_rng(0)
    X_trial = jnp.asarray(rng.standard_normal((N + 1,) + gs), jnp.float32)
    X_test = jnp.asarray(rng.standard_normal((N,) + gs), jnp.float32)

    def spectral_scale(op, X, pp, iters=8):
        """Static 1/rho(op) so a k2-link chain stays bounded in f32."""
        rho = 1.0
        for _ in range(iters):
            Y = op(X, pp)
            rho = float(jnp.max(jnp.abs(Y)))
            X = Y / rho
        return 1.0 / rho

    def slope(op, X, pp=None):
        """Median seconds per op application (chained-fori slope)."""
        pp = p if pp is None else pp
        c = spectral_scale(op, X, pp)

        def chain(k):
            @jax.jit
            def f(V, q):
                V = jax.lax.fori_loop(0, k, lambda i, V: c * op(V, q), V)
                return V[(0,) * V.ndim]

            return f

        def timed(f):
            t0 = time.perf_counter()
            float(f(X, pp))
            log(f"  compile+warm: {time.perf_counter() - t0:.1f}s")
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                float(f(X, pp))
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

        t1, t2 = timed(chain(args.k1)), timed(chain(args.k2))
        return (t2 - t1) / (args.k2 - args.k1)

    def kron_pair(U, pp):
        return s.apply_BT(s.apply_B(U, pp), pp)

    def wavelet_pair(U, pp):
        # Match the solve path's layout: the mg KX keeps the (N+1,)+gs grid
        # layout through W'/W.
        shape = (N + 1,) + gs if s.inner == "mg" else (N + 1, m)
        C = s.wt.adjoint_jax(U.reshape(shape), pp["wavelet"])
        return s.wt.forward_jax(C, pp["wavelet"]).reshape(U.shape)

    components = {
        "S": (s.apply_S, X_trial),
        "kron_pair": (kron_pair, X_trial),
        "KY": (s.apply_KY, X_test),
        "KX": (s.apply_KX, X_trial),
        "wavelet_pair": (wavelet_pair, X_trial),
    }
    if s.inner == "mg":
        components["mg_vcycle_kx"] = (
            lambda U, pp: s._ms_solve_kx(U, pp), X_trial
        )
    if args.vcycle_stages and s.inner == "mg":
        # Decompose the multi-shift V-cycle (the dominant component at the
        # 3D flagship — BASELINE.md split) into its stages. Every op below
        # is linear and shape-preserving so the chained-slope method
        # applies; fixed second operands (b of smooth/residual) are zeros
        # threaded through the params pytree (never closed over, which would
        # bake them into the executable as constants).
        lev0 = s.msmg.levels[0]
        nc = lev0.n // 2
        pz = {**p, "_z": jnp.zeros((N + 1,) + gs, jnp.float32)}

        def vc_full(V, pp):
            return s.msmg.vcycle(
                V, pp["ms_kx"], lambda bc: s._coarse_by_level(bc, pp), 0)

        def vc_transfer_pair(V, pp):
            return s.msmg._interp(s.msmg._restrict(V, nc), nc)

        def vc_coarse_rest(V, pp):
            return s.msmg._interp(
                s.msmg.vcycle(
                    s.msmg._restrict(V, nc), pp["ms_kx"],
                    lambda bc: s._coarse_by_level(bc, pp), 1),
                nc)

        def vc_op(V, pp):
            return s.msmg._op(lev0, pp["ms_kx"][0], V)

        def vc_smooth(V, pp):
            return s.msmg._smooth(lev0, pp["ms_kx"][0], V, pp["_z"])

        stage_components = {
            "vc_full": (vc_full, X_trial, p),
            "vc_transfer_pair": (vc_transfer_pair, X_trial, p),
            "vc_coarse_rest": (vc_coarse_rest, X_trial, p),
            "vc_op": (vc_op, X_trial, p),
            "vc_smooth": (vc_smooth, X_trial, pz),
        }
        for name, (op, X, pp) in stage_components.items():
            log(f"[{name}]")
            sec = slope(op, X, pp=pp)
            print(json.dumps({
                "component": name,
                "ms_per_apply": round(sec * 1e3, 4),
                "gdofs": round(X.size / sec / 1e9, 2),
                "mdof": round((N + 1) * m / 1e6, 2),
                "space_n": args.space_n,
            }), flush=True)
        return

    only = {c for c in args.components.split(",") if c}
    for name, (op, X) in components.items():
        if only and name not in only:
            continue
        log(f"[{name}]")
        sec = slope(op, X)
        dof = X.size
        print(json.dumps({
            "component": name,
            "ms_per_apply": round(sec * 1e3, 4),
            "gdofs": round(dof / sec / 1e9, 2),
            "mdof": round((N + 1) * m / 1e6, 2),
            "space_n": args.space_n,
        }), flush=True)


if __name__ == "__main__":
    main()
