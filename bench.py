"""Headline benchmark: space-time operator throughput and time-to-1e-8 on
one GPU, in one process.

    python bench.py

Prints ONE JSON line on stdout (progress goes to stderr):
  {"metric": "kron_matvec_throughput", "value": N, "unit": "GDoF/s",
   "card": "<name>, <power limit>", ...}

Primary metric: sustained throughput of the space-time operator pair B
then Bᵀ (B = A_t⊗M_x + M_t⊗A_x, the XLA stencil forms of ops/stencil.py)
on the ~10^6-DoF config (BASELINE.md cfg2: 129×129 P1 mesh × 64
timesteps, f32), in giga degrees-of-freedom per second (N_t·m DoF per
operator application).

Secondary fields: ``solve_steady_s``, ``solve_iters``, ``solve_config``
from a mixed-precision tol=1e-8 solve of the same shape (steady = second
in-process solve; the first one compiles).

Method: the pair is chained k times inside one jitted ``fori_loop``
returning a scalar (the chain is kept bounded by a spectral-radius
normalization), and the reported time is the median slope between k1 and
k2 chains, so fixed dispatch and synchronization overheads cancel.

Every number is printed beside the card's name and power limit
(``nvidia-smi``): a card set below its maximum power runs slower under
load.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SPACE_N = 128
TIME_LEVELS = 6  # 64 timesteps
K1, K2, REPS = 512, 4096, 7


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_kron(card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spacetime.fem import P1System, unit_square_mesh, uniform_time_grid
    from spacetime.fem.timegrid import time_matrices
    from spacetime.ops.sparse import DiaMatrix
    from spacetime.ops.stencil import StencilOperator, row_scale

    DTYPE = jnp.float32
    system = P1System.from_mesh(unit_square_mesh(SPACE_N))
    grid = uniform_time_grid(TIME_LEVELS)
    m = system.m
    N = grid.num_intervals
    gs = tuple(system.mesh.grid_shape)
    log(f"config: {SPACE_N+1}x{SPACE_N+1} P1 mesh (m={m}) x {N} timesteps "
        f"-> {(N+1)*m/1e6:.2f} MDoF, dtype={DTYPE.__name__}")

    M_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.M), gs)
    A_st = StencilOperator.from_dia(DiaMatrix.from_csr(system.A), gs)
    h = time_matrices(grid)["h"]
    hh = row_scale(0.5 * h, gs, DTYPE)
    z = jnp.zeros((1,) + gs, DTYPE)

    def pair(V, hs, scale):
        DU, SU = V[1:] - V[:-1], V[1:] + V[:-1]
        W = scale * (M_st.apply(DU) + hs * A_st.apply(SU))
        VM, VA = M_st.apply(W), hs * A_st.apply(W)
        return scale * (
            jnp.concatenate([-VM + VA, z]) + jnp.concatenate([z, VM + VA])
        )

    rng = np.random.default_rng(0)
    U = jnp.asarray(rng.standard_normal((N + 1,) + gs), DTYPE)
    # Spectral normalization: estimate rho(BT∘B) by power iteration so the
    # k2-link chain neither overflows nor vanishes in f32.
    X, rho = U, 1.0
    for _ in range(12):
        Y = pair(X, hh, 1.0)
        rho = float(jnp.max(jnp.abs(Y)))
        X = Y / rho
    scale = float(1.0 / np.sqrt(rho))

    def chain(k):
        @jax.jit
        def f(V, hs):
            V = jax.lax.fori_loop(0, k, lambda i, V: pair(V, hs, scale), V)
            return V[(0,) * V.ndim]

        return f

    def timed(f):
        float(f(U, hh))  # compile + warm
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            float(f(U, hh))  # scalar host read forces completion
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    per_apply = (timed(chain(K2)) - timed(chain(K1))) / (K2 - K1) / 2.0
    gdofs = N * m / per_apply / 1e9
    log(f"B/BT pair: {per_apply*1e3:.4f} ms/apply, {gdofs:.2f} GDoF/s "
        f"on [{card}]")
    return {"metric": "kron_matvec_throughput", "value": gdofs,
            "unit": "GDoF/s", "ms_per_apply": per_apply * 1e3}


def run_solve(card):
    import jax.numpy as jnp

    from spacetime.fem import P1System, unit_square_mesh, uniform_time_grid
    from spacetime.models import get_problem
    from spacetime.solver.heateq import HeatSolver

    solver = HeatSolver(
        get_problem("smooth2d"),
        P1System.from_mesh(unit_square_mesh(SPACE_N)),
        uniform_time_grid(TIME_LEVELS),
        dtype=jnp.float32,
    )
    for i in range(2):
        t0 = time.perf_counter()
        r = solver.solve_refined(tol=1e-8, compute_error=False)
        log(f"solve{i}: wall {time.perf_counter()-t0:.3f} s, solve_seconds "
            f"{r.solve_seconds:.3f}, iters {r.iterations}, rel "
            f"{r.residuals[-1]/r.residuals[0]:.2e} on [{card}]")
    return {
        "solve_steady_s": r.solve_seconds,
        "solve_iters": int(r.iterations),
        "solve_rel_residual": float(r.residuals[-1] / r.residuals[0]),
        "solve_config": (f"smooth2d {SPACE_N+1}x{SPACE_N+1}x"
                         f"{2**TIME_LEVELS}ts f32 mixed-precision tol=1e-8"),
    }


def main():
    from spacetime.utils.platform import card_info, use_gpu

    use_gpu(x64=True)
    card = "; ".join(dict.fromkeys(card_info().splitlines()))
    log(f"card: {card}")
    out = run_kron(card)
    out.update(run_solve(card))
    out["card"] = card
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
