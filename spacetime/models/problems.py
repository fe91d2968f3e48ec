"""Parabolic benchmark problems.

Each problem prescribes a linear parabolic equation
∂u/∂t − ∇·(κ(x)∇u) + c(x)u = g on Ω×(0,T], u = 0 on ∂Ω, u(0) = u0, with Ω
the unit square/cube (SURVEY.md Appendix A; κ ≡ 1, c ≡ 0 is the heat
equation — every benchmark family of the reference). Manufactured problems
are defined by their exact solution alone: the source g is derived by JAX
autodiff (exact to machine precision), so adding a benchmark — including the
singular and moving-peak ones — is a three-line closed-form formula.

Benchmark families (BASELINE.md config ladder):
  smooth2d / smooth3d — smooth separable solutions; iteration counts must be
    flat under refinement.
  singular2d/3d — u ~ t^alpha near t=0 (incompatible data): optimal rates only
    on a time grid graded toward t=0.
  moving_peak2d — a Gaussian peak travelling across the domain.
  varcoef2d — variable diffusion κ(x) + reaction c(x): the general linear
    parabolic operator of the method (the published analysis covers any
    SPD spatial form, not just −Δ); exercises the weighted-assembly path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Problem:
    """A parabolic benchmark problem on the unit square/cube.

    Attributes:
      name: registry key.
      dim: spatial dimension (2 or 3).
      T: final time.
      exact: scalar exact solution u(t, x) with x shape (dim,), written in
        jax.numpy (autodiff-able), or None for non-manufactured problems.
      g_override / u0_override: data for non-manufactured problems.
      graded_time: whether the benchmark calls for a time grid graded
        toward t=0 (the singular family).
      domain: spatial domain tag for fem.mesh.domain_mesh ('unit' square/
        cube, 'lshape' — the generic non-tensor-product mesh path).
      kappa: scalar diffusion coefficient κ(x) > 0 written in jax.numpy
        (x shape (dim,)), or None for κ ≡ 1. Enters the bilinear form
        a(u,v) = ∫ κ∇u·∇v + c·uv and the autodiff source.
      reaction: scalar reaction coefficient c(x) ≥ 0, or None for c ≡ 0.
    """

    name: str
    dim: int
    exact: Callable | None
    T: float = 1.0
    g_override: Callable | None = None
    u0_override: Callable | None = None
    graded_time: bool = False
    domain: str = "unit"
    kappa: Callable | None = None
    reaction: Callable | None = None

    # ---------------------------------------------------------------- data

    def u0(self, X: np.ndarray) -> np.ndarray:
        """Initial datum at points X (n, dim) -> (n,)."""
        if self.exact is None:
            return np.asarray(self.u0_override(X))
        return self.exact_np(0.0, X)

    def g(self, t: float, X: np.ndarray) -> np.ndarray:
        """Source g(t, ·) at points X (n, dim) -> (n,)."""
        if self.exact is None:
            return np.asarray(self.g_override(t, X))
        with _host_device():
            return np.asarray(self._g_fn()(float(t), X))

    def g_many(self, ts: np.ndarray, X: np.ndarray) -> np.ndarray:
        """Source at many times: (nt,), (n, dim) -> (nt, n). One fused jit
        call — the per-time loop in ``g`` dominates load assembly at scale."""
        if self.exact is None:
            return np.stack([np.asarray(self.g_override(t, X)) for t in ts])
        import jax

        if not hasattr(self, "_g_many_cache"):
            fn = self._g_fn()
            object.__setattr__(
                self, "_g_many_cache", jax.jit(jax.vmap(fn, in_axes=(0, None)))
            )
        with _host_device():
            import jax.numpy as jnp

            return np.asarray(self._g_many_cache(jnp.asarray(ts), jnp.asarray(X)))

    def exact_np(self, t: float, X: np.ndarray) -> np.ndarray:
        import jax.numpy as jnp

        with _host_device():
            return np.asarray(
                _vmap_space(self.exact)(jnp.asarray(float(t)), jnp.asarray(X))
            )

    def kappa_np(self, X: np.ndarray) -> np.ndarray:
        """Diffusion coefficient at points X (n, dim) -> (n,), on the host
        (assembly-time evaluation; κ ≡ 1 when unset)."""
        if self.kappa is None:
            return np.ones(X.shape[0])
        with _host_device():
            import jax.numpy as jnp

            return np.asarray(_vmap_x(self.kappa)(jnp.asarray(X)))

    def reaction_np(self, X: np.ndarray) -> np.ndarray:
        """Reaction coefficient at points X (n, dim) -> (n,), on the host
        (c ≡ 0 when unset)."""
        if self.reaction is None:
            return np.zeros(X.shape[0])
        with _host_device():
            import jax.numpy as jnp

            return np.asarray(_vmap_x(self.reaction)(jnp.asarray(X)))

    def _g_fn(self):
        if not hasattr(self, "_g_cache"):
            import jax

            u = self.exact

            if self.kappa is None and self.reaction is None:
                # Heat-equation path, byte-identical arithmetic to the
                # recorded baselines (residual-history parity).
                def g_scalar(t, x):
                    du_dt = jax.grad(u, argnums=0)(t, x)
                    lap = jnp_trace_hessian(u, t, x)
                    return du_dt - lap

            else:
                kap, rea = self.kappa, self.reaction

                def g_scalar(t, x):
                    du_dt = jax.grad(u, argnums=0)(t, x)
                    if kap is None:
                        diff = jnp_trace_hessian(u, t, x)
                    else:
                        # ∇·(κ∇u) = tr ∂x [κ(x) ∇u(t,x)]
                        flux = lambda y: kap(y) * jax.grad(u, argnums=1)(t, y)
                        diff = jax.jacfwd(flux)(x).trace()
                    out = du_dt - diff
                    if rea is not None:
                        out = out + rea(x) * u(t, x)
                    return out

            object.__setattr__(self, "_g_cache", jax.jit(_vmap_space(g_scalar)))
        return self._g_cache


def _host_device():
    """Context pinning problem-data evaluation (quadrature loads, exact
    solutions) to the host CPU backend: these are many tiny per-call batches
    of host-side data, each of which would otherwise pay a device launch and
    a host-device copy. Requires the CPU platform to be registered
    (utils.use_gpu sets jax_platforms='cuda,cpu'); falls back to the default
    device otherwise."""
    import contextlib

    import jax

    try:
        return jax.default_device(jax.devices("cpu")[0])
    except RuntimeError:
        return contextlib.nullcontext()


def jnp_trace_hessian(u, t, x):
    import jax

    H = jax.hessian(u, argnums=1)(t, x)
    return H.trace()


def _vmap_space(fn):
    import jax

    return jax.vmap(fn, in_axes=(None, 0))


def _vmap_x(fn):
    import jax

    return jax.jit(jax.vmap(fn))


# ------------------------------------------------------------------ registry


def _bubble(x):
    import jax.numpy as jnp

    return jnp.prod(x * (1.0 - x))


def _smooth(dim):
    def u(t, x):
        import jax.numpy as jnp

        return jnp.exp(-t) * jnp.prod(jnp.sin(jnp.pi * x))

    return Problem(name=f"smooth{dim}d", dim=dim, exact=u)


def _singular(dim, alpha=0.75):
    def u(t, x):
        import jax.numpy as jnp

        # u ~ (t + eps)^alpha-like singularity: u_t blows up as t -> 0, so
        # uniform time grids lose the optimal rate; graded grids restore it.
        return t**alpha * jnp.prod(jnp.sin(jnp.pi * x))

    return Problem(name=f"singular{dim}d", dim=dim, exact=u, graded_time=True)


def _moving_peak2d():
    def u(t, x):
        import jax.numpy as jnp

        cx = 0.25 + 0.5 * t
        cy = 0.5
        r2 = (x[0] - cx) ** 2 + (x[1] - cy) ** 2
        return 16.0 * _bubble(x) * jnp.exp(-50.0 * r2)

    return Problem(name="moving_peak2d", dim=2, exact=u)


def _varcoef(dim):
    """General linear parabolic operator: smooth positive diffusion κ(x)
    and nonnegative reaction c(x). The exact solution is the smooth-family
    bubble, so convergence rates are directly comparable; the operator is
    what changes (weighted assembly, generic DIA/cheb device paths)."""

    def kappa(x):
        import jax.numpy as jnp

        return 1.0 + 0.5 * jnp.prod(jnp.sin(jnp.pi * x))

    def reaction(x):
        return 1.0 + x[0]

    def u(t, x):
        import jax.numpy as jnp

        return jnp.exp(-t) * jnp.prod(jnp.sin(jnp.pi * x))

    return Problem(
        name=f"varcoef{dim}d", dim=dim, exact=u, kappa=kappa, reaction=reaction
    )


def _lshape2d():
    def u(t, x):
        import jax.numpy as jnp

        # sin(2πx)·sin(2πy) vanishes on x,y ∈ {0, ½, 1} — i.e. on the whole
        # boundary of the L-shaped domain including the reentrant edges — so
        # this is a valid manufactured solution there.
        return jnp.exp(-t) * jnp.prod(jnp.sin(2.0 * jnp.pi * x))

    return Problem(name="lshape2d", dim=2, exact=u, domain="lshape")


PROBLEMS = {
    p.name: p
    for p in [
        _smooth(2),
        _smooth(3),
        _singular(2),
        _singular(3),
        _moving_peak2d(),
        _lshape2d(),
        _varcoef(2),
        _varcoef(3),
    ]
}


def get_problem(name: str) -> Problem:
    try:
        return PROBLEMS[name]
    except KeyError:
        raise KeyError(f"unknown problem {name!r}; available: {sorted(PROBLEMS)}")


def register_problem(problem: Problem, overwrite: bool = False) -> Problem:
    """Add a user-defined :class:`Problem` to the registry (and thus to the
    CLI's ``--problem`` and ``get_problem``). Manufactured problems need only
    an ``exact`` formula in jax.numpy — the source g = ∂t u − Δu is derived by
    autodiff; data-driven problems pass ``g_override``/``u0_override``
    (NumPy callables) instead. See examples/custom_problem.py."""
    if problem.exact is None and (
        problem.g_override is None or problem.u0_override is None
    ):
        raise ValueError(
            "a Problem needs either an exact solution (manufactured) or "
            "both g_override and u0_override (data-driven)"
        )
    if problem.name in PROBLEMS and not overwrite:
        raise ValueError(
            f"problem {problem.name!r} already registered "
            "(pass overwrite=True to replace)"
        )
    PROBLEMS[problem.name] = problem
    return problem
