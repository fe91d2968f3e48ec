"""Preconditioned conjugate gradients as one fused XLA loop.

The whole CG iteration — Kronecker matvec, per-timestep solves, wavelet
preconditioner, dot products — lives inside a single ``lax.while_loop`` under
``jit`` (BASELINE.json: "one fused XLA loop"), so a solve is one device
dispatch with no host round-trips. The operation order matches the NumPy
oracle exactly so float64 residual histories agree to rounding.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


def vdot(a, b):
    """Inner product at full precision: an f32 dot without a pinned
    precision may run in TF32 on GPU tensor cores (~3 decimal digits)."""
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


class PCGResult(NamedTuple):
    U: jax.Array
    iterations: jax.Array  # int32
    residuals: jax.Array  # (maxiter+1,) 2-norm history, NaN beyond last
    precond_residuals: jax.Array  # sqrt(r·z) history
    converged: jax.Array  # bool


def pcg(
    apply_S: Callable,
    apply_KX: Callable,
    f: jax.Array,
    tol: float,
    maxiter: int,
    x0: jax.Array | None = None,
    dot: Callable | None = None,
) -> PCGResult:
    """Solve S u = f with preconditioner K_X; stops at ||r|| <= tol*||f||.

    Trace-compatible: ``maxiter`` bounds the history buffer; the while_loop
    exits early on convergence. ``x0`` warm-starts the iteration (restart
    semantics — used by checkpoint/resume for long runs).

    ``dot``: inner-product override for manually-partitioned (shard_map)
    callers — must return the GLOBAL <a, b> (e.g. masked local vdot +
    lax.psum); norms are then derived as sqrt(dot(x, x)). The default keeps
    vdot / jnp.linalg.norm so single-device residual histories stay
    bitwise stable against the recorded oracle baselines.
    """
    dtype = f.dtype
    nan = jnp.array(jnp.nan, dtype)
    if dot is None:
        dot = vdot
        norm = jnp.linalg.norm
    else:
        norm = lambda x: jnp.sqrt(dot(x, x))

    U0 = jnp.zeros_like(f) if x0 is None else x0
    R0 = f - apply_S(U0)
    Z0 = apply_KX(R0)
    P0 = Z0
    rz0 = dot(R0, Z0)
    fnorm = norm(f)
    rnorm0 = norm(R0)
    res0 = jnp.full((maxiter + 1,), nan).at[0].set(rnorm0)
    pres0 = jnp.full((maxiter + 1,), nan).at[0].set(
        jnp.sqrt(jnp.maximum(rz0, 0.0))
    )
    # Already-converged entry (f = 0, or a warm start that solves exactly):
    # without this the first trip computes alpha = 0/0 and poisons U with
    # NaN. Normal solves enter with rnorm0 > tol*fnorm, so histories are
    # unchanged.
    done0 = rnorm0 <= tol * fnorm

    def cond(state):
        it, U, R, P, rz, res, pres, done = state
        return jnp.logical_and(it < maxiter, jnp.logical_not(done))

    def body(state):
        it, U, R, P, rz, res, pres, done = state
        SP = apply_S(P)
        alpha = rz / dot(P, SP)
        U = U + alpha * P
        R = R - alpha * SP
        rnorm = norm(R)
        res = res.at[it + 1].set(rnorm)
        Z = apply_KX(R)
        rz_new = dot(R, Z)
        pres = pres.at[it + 1].set(jnp.sqrt(jnp.maximum(rz_new, 0.0)))
        done = rnorm <= tol * fnorm
        P = Z + (rz_new / rz) * P
        return (it + 1, U, R, P, rz_new, res, pres, done)

    it, U, R, P, rz, res, pres, done = jax.lax.while_loop(
        cond, body, (jnp.int32(0), U0, R0, P0, rz0, res0, pres0, done0)
    )
    return PCGResult(
        U=U, iterations=it, residuals=res, precond_residuals=pres, converged=done
    )


def pcg_flex(
    apply_S: Callable,
    apply_KX: Callable,
    f: jax.Array,
    tol: float,
    maxiter: int,
    x0: jax.Array | None = None,
    dot: Callable | None = None,
) -> PCGResult:
    """Flexible PCG (Polak–Ribière beta): solve S u = f with a possibly
    NON-symmetric / iteration-varying preconditioner.

    Standard PCG's Fletcher–Reeves beta = (r⁺·z⁺)/(r·z) assumes K_X is a
    fixed SPD operator; an asymmetric multigrid cycle (V(nu, nu_post) with
    nu_post ≠ nu — a measured 17→69-iteration blowup at the 3-D
    flagship) breaks that. The flexible variant replaces
    it with beta = z⁺·(r⁺ − r)/(r·z) — for a fixed SPD preconditioner
    z⁺·r = 0 in exact arithmetic, so histories match pcg() to rounding
    (tested), while for varying/nonsymmetric preconditioners it restores
    local conjugacy (Notay's flexible CG). Cost: one extra dot product and
    one extra live field per iteration.

    ``dot``: global-inner-product override for shard_map callers (see pcg).
    """
    dtype = f.dtype
    nan = jnp.array(jnp.nan, dtype)
    if dot is None:
        dot = vdot
        norm = jnp.linalg.norm
    else:
        norm = lambda x: jnp.sqrt(dot(x, x))

    U0 = jnp.zeros_like(f) if x0 is None else x0
    R0 = f - apply_S(U0)
    Z0 = apply_KX(R0)
    P0 = Z0
    rz0 = dot(R0, Z0)
    fnorm = norm(f)
    rnorm0 = norm(R0)
    res0 = jnp.full((maxiter + 1,), nan).at[0].set(rnorm0)
    pres0 = jnp.full((maxiter + 1,), nan).at[0].set(
        jnp.sqrt(jnp.maximum(rz0, 0.0))
    )
    done0 = rnorm0 <= tol * fnorm

    def cond(state):
        it, U, R, P, rz, res, pres, done = state
        return jnp.logical_and(it < maxiter, jnp.logical_not(done))

    def body(state):
        it, U, R, P, rz, res, pres, done = state
        SP = apply_S(P)
        alpha = rz / dot(P, SP)
        U = U + alpha * P
        R_new = R - alpha * SP
        rnorm = norm(R_new)
        res = res.at[it + 1].set(rnorm)
        Z = apply_KX(R_new)
        rz_new = dot(R_new, Z)
        # Polak–Ribière: subtract the stale-residual overlap z⁺·r.
        beta = (rz_new - dot(R, Z)) / rz
        pres = pres.at[it + 1].set(jnp.sqrt(jnp.maximum(rz_new, 0.0)))
        done = rnorm <= tol * fnorm
        P = Z + beta * P
        return (it + 1, U, R_new, P, rz_new, res, pres, done)

    it, U, R, P, rz, res, pres, done = jax.lax.while_loop(
        cond, body, (jnp.int32(0), U0, R0, P0, rz0, res0, pres0, done0)
    )
    return PCGResult(
        U=U, iterations=it, residuals=res, precond_residuals=pres,
        converged=done,
    )


# ------------------------------------------------- single-reduction PCG
#
# Chronopoulos–Gear recombined PCG: per iteration the three inner products
# (r·z), (z·Sz), (r·r) are evaluated on the SAME vectors and merged into ONE
# global reduction, with alpha obtained from the recurrence
#   (p·Sp) = (z·Sz) − beta·(r·z)/alpha_prev
# instead of a second reduction after p is updated. Standard PCG costs 3
# global syncs per iteration (alpha-dot, residual norm, beta-dot); this
# variant costs 1 — the classical Allreduce-latency optimization for
# distributed CG (the reference's MPI scaling is bounded by exactly these
# Allreduces, SURVEY.md §3.1 "2 dot products → MPI_Allreduce [global sync
# point ×2/iter]"). On the explicit shard_map path the three partial dots
# ride a single 3-vector lax.psum over the time axis.
#
# In exact arithmetic the iterates are identical to pcg(); in floating point
# the alpha recurrence drifts by O(eps·kappa) per iteration — harmless at
# this problem's kappa ≈ 5 (tested: identical iteration counts, residual
# histories matching to ~1e-12 relative in f64).


def pcg_fused(
    apply_S: Callable,
    apply_KX: Callable,
    f: jax.Array,
    tol: float,
    maxiter: int,
    x0: jax.Array | None = None,
    dot3: Callable | None = None,
) -> PCGResult:
    """Single-reduction PCG: solve S u = f with preconditioner K_X.

    ``dot3(r, z, t)`` must return the GLOBAL ``((r·z), (z·t), (r·r))``
    triple — shard_map callers fuse the three masked local dots into one
    3-vector psum. The default evaluates three vdots (a single device
    dispatch fuses them anyway).
    """
    dtype = f.dtype
    nan = jnp.array(jnp.nan, dtype)
    if dot3 is None:
        def dot3(r, z, t):
            return vdot(r, z), vdot(z, t), vdot(r, r)

    U0 = jnp.zeros_like(f) if x0 is None else x0
    R0 = f - apply_S(U0)
    fnorm = jnp.sqrt(dot3(f, f, f)[2])
    res0 = jnp.full((maxiter + 1,), nan)
    pres0 = jnp.full((maxiter + 1,), nan)
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)

    # state: r_it is live but not yet recorded at trip entry; P/Q carry the
    # direction and S·direction recurrences (zero before the first trip).
    def cond(state):
        it, U, R, P, Q, g_prev, a_prev, res, pres, done = state
        return jnp.logical_and(it < maxiter, jnp.logical_not(done))

    def body(state):
        it, U, R, P, Q, g_prev, a_prev, res, pres, done = state
        Z = apply_KX(R)
        T = apply_S(Z)
        gamma, delta, rho = dot3(R, Z, T)
        rnorm = jnp.sqrt(rho)
        res = res.at[it].set(rnorm)
        pres = pres.at[it].set(jnp.sqrt(jnp.maximum(gamma, 0.0)))
        conv = rnorm <= tol * fnorm
        first = it == 0
        beta = jnp.where(first, zero, gamma / g_prev)
        pSp = jnp.where(first, delta, delta - beta * gamma / a_prev)
        alpha = gamma / pSp
        step = jnp.where(conv, zero, alpha)
        P = Z + beta * P
        Q = T + beta * Q
        U = U + step * P
        R = R - step * Q
        it = it + jnp.int32(jnp.logical_not(conv))
        return (it, U, R, P, Q, gamma, alpha, res, pres, conv)

    state = (
        jnp.int32(0), U0, R0, jnp.zeros_like(f), jnp.zeros_like(f),
        one, one, res0, pres0, jnp.bool_(False),
    )
    it, U, R, P, Q, g_prev, a_prev, res, pres, done = jax.lax.while_loop(
        cond, body, state
    )
    # Entry `it` holds the final residual: on convergence the closing trip
    # recorded it and froze R (step = 0); on maxiter exhaustion the last
    # update was never measured — one more reduced norm covers both (the
    # recomputation is the identical (r·r) contraction, so the converged
    # case just rewrites its own value).
    res = res.at[it].set(jnp.sqrt(dot3(R, R, R)[2]))
    # Same for the preconditioned history: the exhaustion exit needs one
    # more K_X application to measure the final sqrt(r·z); the cond skips
    # it on the (usual) converged exit where the closing trip recorded it.
    def _final_pres(pres):
        Z = apply_KX(R)
        g = dot3(R, Z, Z)[0]
        return pres.at[it].set(jnp.sqrt(jnp.maximum(g, 0.0)))

    pres = jax.lax.cond(done, lambda p: p, _final_pres, pres)
    # Exhaustion exit whose LAST update did reach tol: the loop only detects
    # convergence at the next trip's entry, which cond (it < maxiter) never
    # runs — measure the final residual so `converged` agrees with pcg()'s
    # for the identical history.
    done = jnp.logical_or(done, res[it] <= tol * fnorm)
    return PCGResult(
        U=U, iterations=it, residuals=res, precond_residuals=pres,
        converged=done,
    )


# --------------------------------------------------------------- chunked PCG
#
# Alternative driver: fixed-trip fori_loop chunks (masked updates after
# convergence, so extra trips are exact no-ops) with host convergence checks
# between chunks. Identical arithmetic per live iteration -> identical
# residual histories. The single-dispatch while-loop form above is the
# default (no host round-trip inside the solve); chunked exists for
# mid-solve host control (checkpointing, adaptive policies), at one host
# sync per chunk.


class PCGState(NamedTuple):
    it: jax.Array
    U: jax.Array
    R: jax.Array
    P: jax.Array
    rz: jax.Array
    res: jax.Array
    pres: jax.Array
    done: jax.Array
    fnorm: jax.Array


def pcg_init(apply_S, apply_KX, f, maxiter: int, x0=None) -> PCGState:
    dtype = f.dtype
    nan = jnp.array(jnp.nan, dtype)
    U0 = jnp.zeros_like(f) if x0 is None else x0
    R0 = f - apply_S(U0)
    Z0 = apply_KX(R0)
    rz0 = vdot(R0, Z0)
    res0 = jnp.full((maxiter + 1,), nan).at[0].set(jnp.linalg.norm(R0))
    pres0 = jnp.full((maxiter + 1,), nan).at[0].set(
        jnp.sqrt(jnp.maximum(rz0, 0.0))
    )
    return PCGState(
        it=jnp.int32(0), U=U0, R=R0, P=Z0, rz=rz0, res=res0, pres=pres0,
        done=jnp.bool_(False), fnorm=jnp.linalg.norm(f),
    )


def pcg_chunk(apply_S, apply_KX, state: PCGState, tol: float, k: int) -> PCGState:
    """Advance k masked PCG iterations (a single device dispatch).

    Trips past convergence, past the history buffer's iteration budget
    (``maxiter`` = res.shape[0]-1 — a chunk size need not divide it), or
    after an exactly-zero residual (alpha would be 0/0) are exact no-ops.
    """
    nmax = state.res.shape[0] - 1

    def body(_, s: PCGState) -> PCGState:
        degenerate = s.rz <= 0  # R == 0 entry (or SPD breakdown): finish
        halt = jnp.logical_or(
            s.done, jnp.logical_or(degenerate, s.it >= nmax)
        )
        SP = apply_S(s.P)
        alpha = jnp.where(halt, 0.0, s.rz / vdot(s.P, SP)).astype(s.rz.dtype)
        U = s.U + alpha * s.P
        R = s.R - alpha * SP
        rnorm = jnp.linalg.norm(R)
        idx = jnp.where(halt, 0, s.it + 1)
        res = s.res.at[idx].set(jnp.where(halt, s.res[0], rnorm))
        Z = apply_KX(R)
        rz_new = vdot(R, Z)
        pres = s.pres.at[idx].set(
            jnp.where(halt, s.pres[0], jnp.sqrt(jnp.maximum(rz_new, 0.0)))
        )
        new_done = jnp.where(
            halt,
            jnp.logical_or(s.done, degenerate),
            rnorm <= tol * s.fnorm,
        )
        beta = jnp.where(halt, 0.0, rz_new / s.rz).astype(s.rz.dtype)
        # alpha/beta are masked to 0 on halted trips, so U and R freeze by
        # construction; only P needs an explicit select (beta=0 gives Z).
        P = jnp.where(halt, s.P, Z + beta * s.P)
        return PCGState(
            it=s.it + jnp.int32(jnp.logical_not(halt)),
            U=U,
            R=R,
            P=P,
            rz=jnp.where(halt, s.rz, rz_new),
            res=res,
            pres=pres,
            done=new_done,
            fnorm=s.fnorm,
        )

    return jax.lax.fori_loop(0, k, body, state)
