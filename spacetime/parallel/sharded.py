"""Time-sharded heat-equation solver (GSPMD).

Extends the single-device ``HeatSolver`` with sharding annotations: the
space-time coefficient array is sharded over the ``time`` mesh axis on its
leading dimension, the spatial matrices / inner-solve inverses are replicated
(space is replicated per rank in the reference too, SURVEY.md §2), and the
entire PCG while-loop is one jitted SPMD program. GSPMD inserts the
collectives this induces: halo collective-permutes for the banded-in-time
operators (B, B', stabilization), psums for the CG dot products, and the
log-depth pattern of the wavelet levels.

Correctness gate (SURVEY.md §4): a solve on 1 device and on an 8-device mesh
must produce identical residual histories up to reduction-order rounding —
tested on the virtual CPU mesh in tests/test_sharded.py.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solver.heateq import HeatSolver
from ..solver.pcg import pcg, pcg_fused  # noqa: F401 (re-export compat)


class ShardedHeatSolver(HeatSolver):
    """HeatSolver whose solve is jitted over a 1-D ``time`` mesh."""

    def __init__(self, problem, system, grid, mesh: Mesh, **kwargs):
        super().__init__(problem, system, grid, **kwargs)
        if tuple(mesh.axis_names) not in [("time",), ("time", "space")]:
            raise ValueError(
                "expected mesh axes ('time',) or ('time', 'space')"
            )
        self.mesh = mesh
        self.has_space_axis = "space" in mesh.axis_names

    def _shardings(self):
        ndim_g = len(self.gs)
        if self.has_space_axis and ndim_g >= 2:
            # 2-D parallelism (cfg5 stretch, SURVEY.md §2): timesteps over
            # 'time', the leading spatial grid axis over 'space'; GSPMD
            # inserts the spatial halo exchanges for the stencils too.
            spec = P("time", "space", *([None] * (ndim_g - 1)))
        else:
            spec = P("time", *([None] * ndim_g))
        time_rows = NamedSharding(self.mesh, spec)
        repl = NamedSharding(self.mesh, P())
        return time_rows, repl

    def _build_solve(self, tol: float, maxiter: int, warm: bool = False):
        time_rows, repl = self._shardings()
        params_sh = jax.tree.map(lambda _: repl, self.params)

        # 'fused' merges the three per-iteration dot reductions into one;
        # under GSPMD the local partial-sums are inferred, and the three
        # scalars reduce in a single all-reduce.
        drv = self._pcg_driver()

        def run(gL, gR, u0_vec, p, x0):
            f = self.rhs_device(gL, gR, u0_vec, p)
            f = jax.lax.with_sharding_constraint(f, time_rows)
            return drv(
                lambda U: self.apply_S(U, p),
                lambda R: self.apply_KX(R, p),
                f,
                tol,
                maxiter,
                x0=x0 if warm else None,
            )

        # RHS inputs are setup-time data used once; pjit requires divisible
        # input shardings, so shard them only when the row count divides the
        # mesh and replicate otherwise (the with_sharding_constraint on f
        # re-shards the iteration state either way — uneven intermediate
        # shardings are fine for GSPMD).
        P_t = self.mesh.shape["time"]
        P_s = self.mesh.shape.get("space", 1)
        even_space = not self.has_space_axis or (
            len(self.gs) >= 2 and self.gs[0] % P_s == 0
        )
        g_sh = time_rows if (self.N % P_t == 0 and even_space) else repl
        x_sh = time_rows if ((self.N + 1) % P_t == 0 and even_space) else repl
        if not warm:
            x_sh = repl  # cold starts pass a scalar placeholder (heateq)
        donate = (0, 1) if self.donate_rhs else ()
        return jax.jit(
            run,
            in_shardings=(g_sh, g_sh, repl, params_sh, x_sh),
            out_shardings=None,
            donate_argnums=donate,
        )

    def _build_refined_jits(self, mode: str, inner_tol: float,
                            inner_maxiter: int):
        """Mixed-precision refinement with mesh shardings: the f64
        residual loop's arrays and the f32 inner PCG state stay
        time-sharded (inputs committed by in_shardings; everything
        downstream propagates)."""
        from ..solver.pcg import pcg, pcg_fused  # noqa: F401 (re-export compat)

        time_rows, repl = self._shardings()
        # prefix sharding: one entry replicates the whole params subtree
        # (its pytree structure differs between the f64 and f32 calls)
        params_sh = repl
        P_t = self.mesh.shape["time"]
        P_s = self.mesh.shape.get("space", 1)
        even_space = not self.has_space_axis or (
            len(self.gs) >= 2 and self.gs[0] % P_s == 0
        )
        g_sh = time_rows if (self.N % P_t == 0 and even_space) else repl
        x_sh = time_rows if ((self.N + 1) % P_t == 0 and even_space) else repl

        def rhs(a, b, c, p):
            f = self.rhs_device(a, b, c, p)
            return jax.lax.with_sharding_constraint(f, time_rows)

        rhs64 = jax.jit(rhs, in_shardings=(g_sh, g_sh, repl, params_sh))
        resid64 = jax.jit(
            lambda f, u, p: f - self.apply_S(u, p),
            in_shardings=(x_sh, x_sh, params_sh),
        )
        drv = self._pcg_driver()
        inner = jax.jit(
            lambda r32, p, tol32: drv(
                lambda U: self.apply_S(U, p),
                lambda R: self.apply_KX(R, p),
                r32,
                tol32,
                inner_maxiter,
            ),
            in_shardings=(x_sh, params_sh, repl),
        )
        return rhs64, resid64, inner

    def _build_chunked(self, tol: float, maxiter: int, warm: bool = False):
        """Chunked driver with mesh shardings (periodic checkpointing).

        Only ``prep`` needs explicit input shardings + a constraint on the
        iteration state; ``step`` inherits placement from its committed
        inputs (prep's outputs), so GSPMD keeps every chunk time-sharded.
        """
        from ..solver.pcg import pcg_chunk, pcg_init

        time_rows, repl = self._shardings()
        params_sh = jax.tree.map(lambda _: repl, self.params)

        def prep(gL, gR, u0_vec, p, x0):
            f = self.rhs_device(gL, gR, u0_vec, p)
            f = jax.lax.with_sharding_constraint(f, time_rows)
            return pcg_init(
                lambda U: self.apply_S(U, p), lambda R: self.apply_KX(R, p),
                f, maxiter, x0=x0 if warm else None,
            )

        def step(state, p, k):
            return pcg_chunk(
                lambda U: self.apply_S(U, p), lambda R: self.apply_KX(R, p),
                state, tol, k,
            )

        P_t = self.mesh.shape["time"]
        P_s = self.mesh.shape.get("space", 1)
        even_space = not self.has_space_axis or (
            len(self.gs) >= 2 and self.gs[0] % P_s == 0
        )
        g_sh = time_rows if (self.N % P_t == 0 and even_space) else repl
        x_sh = time_rows if ((self.N + 1) % P_t == 0 and even_space) else repl
        return (
            jax.jit(prep, in_shardings=(g_sh, g_sh, repl, params_sh, x_sh)),
            jax.jit(step, static_argnums=2),
        )


def replicate_result_check(res_a, res_b, rtol=1e-10) -> bool:
    """Utility: are two SolveResults numerically the same solve?"""
    return (
        res_a.iterations == res_b.iterations
        and np.allclose(res_a.residuals, res_b.residuals, rtol=rtol)
    )
