"""The XLA multi-shift V-cycle stages against a dense NumPy reference.

The reference is built from the assembled CSR matrices and the exact
nested-P1 interpolation (``p1_interpolation_matrix``): per-row shifted
operators A + ω_r M, the Chebyshev–Jacobi recurrence with Gershgorin
bounds, restriction Pᵀ, prolongation P, and exact coarse solves. Covered:
constant-stencil hierarchies in 2-D and 3-D at ν = 2 and 3 (uniform and
ragged row counts), the coefficient-weighted Galerkin hierarchy, and
asymmetric V(ν, ν_post) cycles."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spacetime.fem import P1System, unit_cube_mesh, unit_square_mesh
from spacetime.models import get_problem
from spacetime.ops.multigrid import (
    GalerkinMultiShiftMultigrid,
    MultiShiftMultigrid,
    _transfer_fast,
    p1_interpolation_matrix,
)

SIGMA = 5.0 / 3.0
RTOL = 1e-10


# ------------------------------------------------------------ reference


@dataclasses.dataclass
class RefLevel:
    A: np.ndarray  # dense (m, m)
    M: np.ndarray
    P: np.ndarray | None  # (m, m_coarse) interpolation to this level


def ref_op(lv, omega, X):
    return X @ lv.A + omega[:, None] * (X @ lv.M)


def ref_scalars(lv, omega, node_diag: bool):
    dA, dM = np.diag(lv.A), np.diag(lv.M)
    rsA, rsM = np.abs(lv.A).sum(1), np.abs(lv.M).sum(1)
    D = dA[None] + omega[:, None] * dM[None]  # (T, m)
    lam = 1.1 * ((rsA[None] + omega[:, None] * rsM[None]) / D).max(1)
    if not node_diag:  # constant stencils: the interior diagonal
        D = np.broadcast_to(D.max(1, keepdims=True), D.shape)
    return 1.0 / D, 1.0 / (0.625 * lam), 1.0 / (0.375 * lam)


def ref_smooth(lv, omega, x, b, nu, node_diag):
    invd, it, idl = ref_scalars(lv, omega, node_diag)
    r = invd * (b - ref_op(lv, omega, x))
    d = r * it[:, None]
    x = x + d
    rho = 1.0 / SIGMA
    for _ in range(nu - 1):
        rho_new = 1.0 / (2.0 * SIGMA - rho)
        r = r - invd * ref_op(lv, omega, d)
        d = rho_new * rho * d + (2.0 * rho_new) * idl[:, None] * r
        x = x + d
        rho = rho_new
    return x


def ref_coarse(Ac, Mc, omega, b):
    return np.stack([np.linalg.solve(Ac + w * Mc, bi)
                     for w, bi in zip(omega, b)])


def ref_vcycle(levels, coarse, omega, b, nu, nu_post, node_diag, l=0):
    if l == len(levels):
        return ref_coarse(coarse[0], coarse[1], omega, b)
    lv = levels[l]
    x = ref_smooth(lv, omega, np.zeros_like(b), b, nu, node_diag)
    r = b - ref_op(lv, omega, x)
    Pn = levels[l + 1].P if l + 1 < len(levels) else coarse[2]
    ec = ref_vcycle(levels, coarse, omega, r @ Pn, nu, nu_post, node_diag,
                    l + 1)
    x = x + ec @ Pn.T
    return ref_smooth(lv, omega, x, b, nu_post, node_diag)


# ------------------------------------------------------------ hierarchies


@functools.lru_cache(maxsize=None)
def structured(dim, n):
    """(msmg, reference levels, (A_c, M_c, P_c)) for the constant-stencil
    hierarchy, reference matrices re-assembled per level."""
    msmg, (A_c, M_c) = MultiShiftMultigrid.build(dim, n, nu=2, n_coarse=4)
    mk = unit_square_mesh if dim == 2 else unit_cube_mesh
    levels = []
    for i, lev in enumerate(msmg.levels):
        sys_l = P1System.from_mesh(mk(lev.n))
        P = None if i == 0 else p1_interpolation_matrix(dim, lev.n).toarray()
        levels.append(RefLevel(sys_l.A.toarray(), sys_l.M.toarray(), P))
    Pc = p1_interpolation_matrix(dim, msmg.n_coarse).toarray()
    return msmg, levels, (A_c, M_c, Pc)


@functools.lru_cache(maxsize=None)
def weighted(dim, n):
    """(gmsmg, reference levels, coarse) for the coefficient-weighted
    hierarchy: reference coarse operators by RAP with the exact P."""
    problem = get_problem("varcoef2d" if dim == 2 else "varcoef3d")
    mk = unit_square_mesh if dim == 2 else unit_cube_mesh
    system = P1System.from_problem(problem, mk(n))
    gm, (A_c, M_c) = GalerkinMultiShiftMultigrid.build(
        dim, n, system.A, system.M, nu=2, n_coarse=4)
    A, M = system.A.toarray(), system.M.toarray()
    levels = [RefLevel(A, M, None)]
    for lev in gm.levels[1:]:
        P = p1_interpolation_matrix(dim, lev.n).toarray()
        A, M = P.T @ A @ P, P.T @ M @ P
        levels.append(RefLevel(A, M, P))
    Pc = p1_interpolation_matrix(dim, gm.n_coarse).toarray()
    return gm, levels, (A_c, M_c, Pc)


def _omega(T, seed):
    rng = np.random.default_rng(seed)
    om = rng.uniform(0.0, 4000.0, T)
    om[0] = 0.0
    return om


def _coarse_fn(Ac, Mc, omega):
    inv = np.stack([np.linalg.inv(Ac + w * Mc) for w in omega])
    invj = jnp.asarray(inv)

    def solve(bc):
        flat = bc.reshape(bc.shape[0], -1)
        out = jnp.einsum("tj,tjk->tk", flat, invj,
                         precision=jax.lax.Precision.HIGHEST)
        return out.reshape(bc.shape)

    return solve


def _close(got, want):
    got = np.asarray(got).reshape(want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= RTOL, err


# (dim, n, T, nu): 2-D at ν=2/3, 3-D, a ragged row count, 3-D at ν=3
CASES = [(2, 16, 8, 2), (2, 16, 8, 3), (3, 8, 4, 2), (2, 16, 7, 2),
         (3, 8, 3, 3)]
STAGES = ["op", "smooth_zero", "smooth", "residual", "restrict", "prolong",
          "vcycle"]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("dim,n,T,nu", CASES)
def test_structured_stage(dim, n, T, nu, stage):
    msmg, levels, coarse = structured(dim, n)
    msmg = dataclasses.replace(msmg, nu=nu)
    omega = _omega(T, n + T + nu)
    lps = msmg.row_params(omega, jnp.float64)
    lev, lv = msmg.levels[0], levels[0]
    gs = lev.A_st.grid_shape
    rng = np.random.default_rng(7 * T + nu)
    x = rng.standard_normal((T, lv.A.shape[0]))
    b = rng.standard_normal((T, lv.A.shape[0]))
    g = lambda a: jnp.asarray(a.reshape((T,) + gs))
    P1 = levels[1].P if len(levels) > 1 else coarse[2]
    if stage == "op":
        _close(msmg._op(lev, lps[0], g(x)), ref_op(lv, omega, x))
    elif stage == "smooth_zero":
        _close(msmg._smooth(lev, lps[0], g(x) * 0.0, g(b)),
               ref_smooth(lv, omega, 0 * x, b, nu, False))
    elif stage == "smooth":
        _close(msmg._smooth(lev, lps[0], g(x), g(b)),
               ref_smooth(lv, omega, x, b, nu, False))
    elif stage == "residual":
        _close(g(b) - msmg._op(lev, lps[0], g(x)),
               b - ref_op(lv, omega, x))
    elif stage == "restrict":
        _close(msmg._restrict(g(x), lev.n // 2), x @ P1)
    elif stage == "prolong":
        nc = lev.n // 2
        xc = rng.standard_normal((T, P1.shape[1]))
        _close(msmg._interp(jnp.asarray(xc.reshape((T,) + (nc - 1,) * dim)),
                            nc), xc @ P1.T)
    else:
        got = msmg.vcycle(g(b), lps, _coarse_fn(coarse[0], coarse[1], omega))
        _close(got, ref_vcycle(levels, coarse, omega, b, nu, nu, False))


WEIGHTED = [(2, 16, 8, 2), (2, 16, 8, 3), (3, 8, 4, 2)]


@pytest.mark.parametrize("stage", ["op", "smooth", "vcycle"])
@pytest.mark.parametrize("dim,n,T,nu", WEIGHTED)
def test_weighted_stage(dim, n, T, nu, stage):
    gm, levels, coarse = weighted(dim, n)
    gm = dataclasses.replace(gm, nu=nu)
    omega = _omega(T, 3 * n + T + nu)
    lps = gm.row_params(omega, jnp.float64)
    lev, lv = gm.levels[0], levels[0]
    rng = np.random.default_rng(11 * T + nu)
    x = rng.standard_normal((T, lv.A.shape[0]))
    b = rng.standard_normal((T, lv.A.shape[0]))
    g = lambda a: jnp.asarray(a.reshape((T,) + lev.gs))
    if stage == "op":
        _close(gm._op(lev, lps[0], g(x)), ref_op(lv, omega, x))
    elif stage == "smooth":
        _close(gm._smooth(lev, lps[0], g(x), g(b)),
               ref_smooth(lv, omega, x, b, nu, True))
    else:
        got = gm.solve(jnp.asarray(b), lps,
                       _coarse_fn(coarse[0], coarse[1], omega), cycles=1)
        _close(got, ref_vcycle(levels, coarse, omega, b, nu, nu, True))


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 8)])
def test_asymmetric_nu_post_vcycle(dim, n):
    msmg, levels, coarse = structured(dim, n)
    msmg = dataclasses.replace(msmg, nu=3, nu_post=1)
    T = 4
    omega = _omega(T, 5 * n)
    lps = msmg.row_params(omega, jnp.float64)
    gs = msmg.levels[0].A_st.grid_shape
    b = np.random.default_rng(n).standard_normal((T, levels[0].A.shape[0]))
    got = msmg.vcycle(jnp.asarray(b.reshape((T,) + gs)), lps,
                      _coarse_fn(coarse[0], coarse[1], omega))
    _close(got, ref_vcycle(levels, coarse, omega, b, 3, 1, False))


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 16)])
def test_galerkin_coarse_operator_is_reassembly(dim, n):
    """The exact interpolation the references use: Pᵀ A_f P equals the
    re-assembled coarse operator (nested P1 spaces), and the separated
    transfer form applies exactly P and Pᵀ."""
    _, levels, _ = structured(dim, n)
    fine, crs = levels[0], levels[1]
    P = crs.P
    np.testing.assert_allclose(P.T @ fine.A @ P, crs.A, atol=1e-12)
    nc = n // 2
    xc = np.random.default_rng(dim).standard_normal((2, P.shape[1]))
    got = _transfer_fast(jnp.asarray(xc.reshape((2,) + (nc - 1,) * dim)),
                         dim, restrict=False)
    _close(got, xc @ P.T)
