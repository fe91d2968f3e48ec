"""The flat-dof multigrid levels (nested-refinement and smoothed-aggregation
hierarchies) against scipy.sparse: the Chebyshev–Jacobi smoother, the
residual, the shifted level operator, the stiffness DIA matvec and the
gather (and factored) transfers, level by level, plus one full V-cycle
against a NumPy V-cycle built from the same scipy matrices.

The references rebuild every level independently: the nested levels
through the recorded red-refinement embedding (``nested_interpolation``),
the SA levels through ``sa_prolongator``, each coarse pair as the Galerkin
product Pᵀ·A·P in scipy.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from spacetime.fem import P1System, l_shape_mesh, refine_hierarchy
from spacetime.fem.mesh import nested_interpolation
from spacetime.ops.multigrid import (
    NestedMultiShiftMultigrid,
    SAMultiShiftMultigrid,
    sa_prolongator,
)

T = 8
OMEGA = np.concatenate([[0.0], np.geomspace(0.5, 500.0, T - 1)])
SIGMA = 5.0 / 3.0


@functools.lru_cache(maxsize=None)
def _hierarchy(kind):
    """(multigrid, [(A_l, M_l, P_l) scipy per level])."""
    if kind == "nested":
        mesh = refine_hierarchy(l_shape_mesh(8), 2)
        system = P1System.from_mesh(mesh)
        ms, _ = NestedMultiShiftMultigrid.build(
            mesh, system.A, system.M, nu=2, m_coarse=64
        )
        A, M = sp.csr_matrix(system.A), sp.csr_matrix(system.M)
        ref = []
        for _ in ms.levels:
            P = sp.csr_matrix(nested_interpolation(mesh))
            ref.append((A, M, P))
            A, M = (P.T @ A @ P).tocsr(), (P.T @ M @ P).tocsr()
            mesh = mesh.refined_from[0]
    else:
        system = P1System.from_mesh(l_shape_mesh(64))
        A, M = sp.csr_matrix(system.A), sp.csr_matrix(system.M)
        ms, _ = SAMultiShiftMultigrid.build(A, M, m_coarse=300)
        ref = []
        for _ in ms.levels:
            P = sp.csr_matrix(sa_prolongator(A, 0.08))
            ref.append((A, M, P))
            A, M = (P.T @ A @ P).tocsr(), (P.T @ M @ P).tocsr()
    assert len(ms.levels) == 2
    return ms, ref


def _shifted(A, M, w):
    return (A + w * M).tocsr()


def _ref_op(A, M, x):
    return np.stack([_shifted(A, M, w) @ x[t] for t, w in enumerate(OMEGA)])


def _ref_smooth(A, M, x, b, nu, zero_init):
    """Chebyshev–Jacobi smoothing, row t with shift OMEGA[t]: Gershgorin
    bound lam = 1.1·max_i (|A|_i + w|M|_i) / (a_ii + w m_ii), interval
    [lam/4, lam] (theta = 0.625 lam, delta = 0.375 lam)."""
    rsA = np.asarray(abs(A).sum(axis=1)).ravel()
    rsM = np.asarray(abs(M).sum(axis=1)).ravel()
    out = np.empty_like(b)
    for t, w in enumerate(OMEGA):
        K = _shifted(A, M, w)
        dK = A.diagonal() + w * M.diagonal()
        lam = 1.1 * ((rsA + w * rsM) / dK).max()
        theta, delta = 0.625 * lam, 0.375 * lam
        xt = np.zeros_like(b[t]) if zero_init else x[t].copy()
        r = (b[t] - K @ xt) / dK
        d = r / theta
        xt = xt + d
        rho = 1.0 / SIGMA
        for _ in range(nu - 1):
            rho_new = 1.0 / (2.0 * SIGMA - rho)
            r = r - (K @ d) / dK
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            xt = xt + d
            rho = rho_new
        out[t] = xt
    return out


def _vectors(m, mc, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, m)), rng.standard_normal((T, m)),
            rng.standard_normal((T, mc)))


def _close(got, want, dtype):
    got = np.asarray(got, np.float64)
    rtol = 1e-12 if dtype == jnp.float64 else 2e-5
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max(),
                               rtol=0)


STAGES = ["presmooth", "postsmooth", "residual", "op", "restrict", "interp"]


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["nested", "sa"])
def test_level_stage(kind, level, stage, dtype):
    ms, ref = _hierarchy(kind)
    A, M, P = ref[level]
    lev = ms.levels[level]
    lp = ms.row_params(OMEGA, dtype)[level]
    x, b, e = _vectors(A.shape[0], P.shape[1], seed=10 * level + len(stage))
    dev = lambda v: jnp.asarray(v, dtype)
    if stage == "presmooth":
        got = ms._smooth(lev, lp, None, dev(b), zero_init=True)
        want = _ref_smooth(A, M, None, b, ms.nu, zero_init=True)
    elif stage == "postsmooth":
        got = ms._smooth(lev, lp, dev(x), dev(b))
        want = _ref_smooth(A, M, x, b, ms.nu, zero_init=False)
    elif stage == "residual":
        got = dev(b) - ms._op(lev, lp, dev(x))
        want = b - _ref_op(A, M, x)
    elif stage == "op":
        got = ms._op(lev, lp, dev(x))
        want = _ref_op(A, M, x)
    elif stage == "restrict":
        got = ms._restrict(dev(x), lp)
        want = x @ P.toarray()
    else:
        got = ms._interp(dev(e), lp)
        want = e @ P.toarray().T
    _close(got, want, dtype)


@pytest.mark.parametrize("kind,level", [("nested", 0), ("nested", 1),
                                        ("sa", 0)])
def test_dia_stiffness_matvec(kind, level):
    from spacetime.ops.sparse import dia_matvec

    ms, ref = _hierarchy(kind)
    A, _, _ = ref[level]
    lev = ms.levels[level]
    lp = ms.row_params(OMEGA, jnp.float64)[level]
    x, _, _ = _vectors(A.shape[0], 1, seed=3)
    got = dia_matvec(lp["Av"], lev.offA, jnp.asarray(x))
    _close(got, x @ A.toarray().T, jnp.float64)


@pytest.mark.parametrize("direction", ["restrict", "interp"])
def test_sa_factored_transfers(direction):
    ms, ref = _hierarchy("sa")
    assert ms.factored_transfers
    lev = ms.levels[0]
    assert lev.fmt == "dia" and lev.agg is not None
    assert ms.levels[1].fmt == "ell"
    A, _, P = ref[0]
    lp = ms.row_params(OMEGA, jnp.float64)[0]
    x, _, e = _vectors(A.shape[0], P.shape[1], seed=4)
    if direction == "restrict":
        got = ms._restrict_fact(lev, lp, jnp.asarray(x))
        want = x @ P.toarray()
    else:
        got = ms._interp_fact(lev, lp, jnp.asarray(e))
        want = e @ P.toarray().T
    _close(got, want, jnp.float64)


def _ref_vcycle(ref, b, nu, lvl=0):
    if lvl == len(ref):
        A, M = ref[-1][0], ref[-1][1]
        P = ref[-1][2]
        Ac, Mc = P.T @ A @ P, P.T @ M @ P
        return np.stack([
            np.linalg.solve((Ac + w * Mc).toarray(), b[t])
            for t, w in enumerate(OMEGA)
        ])
    A, M, P = ref[lvl]
    x = _ref_smooth(A, M, None, b, nu, zero_init=True)
    r = b - _ref_op(A, M, x)
    x = x + _ref_vcycle(ref, r @ P.toarray(), nu, lvl + 1) @ P.toarray().T
    return _ref_smooth(A, M, x, b, nu, zero_init=False)


@pytest.mark.parametrize("kind", ["nested", "sa"])
def test_vcycle_matches_scipy(kind):
    ms, ref = _hierarchy(kind)
    lps = ms.row_params(OMEGA, jnp.float64)
    A, M, P = ref[-1]
    Ac, Mc = (P.T @ A @ P).toarray(), (P.T @ M @ P).toarray()
    cinv = jnp.asarray(np.stack([np.linalg.inv(Ac + w * Mc) for w in OMEGA]))
    coarse = lambda bc: jnp.einsum("tij,tj->ti", cinv, bc)
    _, b, _ = _vectors(ref[0][0].shape[0], 1, seed=5)
    got = ms.vcycle(jnp.asarray(b), lps, coarse)
    _close(got, _ref_vcycle(ref, b, ms.nu), jnp.float64)
