"""Lanczos estimation of the preconditioned spectrum (SURVEY.md §3.4).

Estimates the extreme eigenvalues / condition number of K_X·S — the numbers
behind the paper's "uniformly bounded condition" tables — via the
preconditioned Lanczos recurrence (the same three-term recurrence PCG
implicitly builds), with the tridiagonal eigenproblem solved on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SpectrumEstimate:
    lam_min: float
    lam_max: float
    ritz_values: np.ndarray

    @property
    def condition(self) -> float:
        return self.lam_max / self.lam_min


def lanczos_condition(
    apply_S,
    apply_KX,
    shape: tuple[int, ...],
    num_iters: int = 30,
    seed: int = 0,
    dtype=np.float64,
) -> SpectrumEstimate:
    """Preconditioned Lanczos for the pencil (S, K_X⁻¹).

    Runs the coupled recurrence in the K_X-inner product: eigenvalues of the
    resulting tridiagonal matrix are Ritz values of K_X·S. Host-driven loop
    (not performance-critical; each step is one S and one K_X application).
    """
    import jax.numpy as jnp

    from .pcg import vdot

    rng = np.random.default_rng(seed)
    r = jnp.asarray(rng.standard_normal(shape), dtype)
    z = apply_KX(r)
    gamma = float(vdot(r, z)) ** 0.5
    v = r / gamma  # K_X-orthonormal: <z, r> = 1
    zv = z / gamma

    alphas, betas = [], []
    v_prev = None
    beta = 0.0
    for _ in range(num_iters):
        w = apply_S(zv)  # S K_X applied to v (in r-coordinates)
        alpha = float(vdot(w, zv))
        w = w - alpha * v
        if v_prev is not None:
            w = w - beta * v_prev
        zw = apply_KX(w)
        beta2 = float(vdot(w, zw))
        alphas.append(alpha)
        if beta2 <= 1e-300:
            break
        beta = beta2**0.5
        betas.append(beta)
        v_prev = v
        v = w / beta
        zv = zw / beta

    k = len(alphas)
    T = np.diag(np.asarray(alphas))
    if k > 1:
        off = np.asarray(betas[: k - 1])
        T += np.diag(off, 1) + np.diag(off, -1)
    ritz = np.linalg.eigvalsh(T)
    return SpectrumEstimate(float(ritz[0]), float(ritz[-1]), ritz)
