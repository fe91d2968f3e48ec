"""Space-time error norms (host-side analysis, shared by oracle and device paths)."""

from __future__ import annotations

import numpy as np

from .assembly import _quad_rule, _tet_geometry, _tri_geometry
from .mesh import Mesh
from .timegrid import TimeGrid


def l2_error_spacetime(problem, mesh: Mesh, grid: TimeGrid, U: np.ndarray) -> float:
    """L2(I×Ω) error of the discrete solution vs ``problem.exact``.

    ``U`` holds interior-vertex coefficients, shape (N_t+1, m). Quadrature:
    2-point Gauss per time interval × degree-2 rule per element.
    """
    bary, w = _quad_rule(mesh.dim)
    measure = _tri_geometry(mesh)[0] if mesh.dim == 2 else _tet_geometry(mesh)[0]
    v = mesh.vertices[mesh.elements]
    pts = np.einsum("qi,eid->eqd", bary, v)
    flat = pts.reshape(-1, mesh.dim)

    N = grid.num_intervals
    Ufull = np.zeros((N + 1, mesh.num_vertices))
    Ufull[:, mesh.interior] = U

    def uq_row(j):
        # one row at a time: materializing (N+1, ne, nq) for all rows costs
        # gigabytes at the large configs on a first-touch-slow host
        return np.einsum("ei,qi->eq", Ufull[j][mesh.elements], bary)

    t = grid.t
    h = grid.h
    gq = 0.5 / np.sqrt(3.0)
    total = 0.0
    uq_j = uq_row(0)
    for j in range(N):
        uq_j1 = uq_row(j + 1)
        mid = 0.5 * (t[j] + t[j + 1])
        for tq in (mid - gq * h[j], mid + gq * h[j]):
            lam = (tq - t[j]) / h[j]
            uh = (1 - lam) * uq_j + lam * uq_j1
            ue = problem.exact_np(tq, flat).reshape(uh.shape)
            total += 0.5 * h[j] * np.einsum("eq,q,e->", (uh - ue) ** 2, w, measure)
        uq_j = uq_j1
    return float(np.sqrt(total))


def device_l2_error_spacetime(
    problem, mesh: Mesh, grid: TimeGrid, U, dtype=None, chunk: int = 16
) -> float:
    """L2(I×Ω) error evaluated as jitted device code (the scale path).

    Same quadrature as ``l2_error_spacetime`` (which stays the host parity
    reference): 2-point Gauss per time interval, with the interpolation
    weights constant in time (λ = ½ ∓ g for every interval). ``U`` may be a
    device array (preferred — at large configs shipping the iterate through
    the host costs more than the whole error computation) or a host array,
    shape (N_t+1, m). ``chunk`` = time intervals per dispatch.
    """
    import jax
    import jax.numpy as jnp

    if problem.exact is None:
        raise ValueError("device error needs a manufactured problem (exact)")
    bary, w = _quad_rule(mesh.dim)
    measure = _tri_geometry(mesh)[0] if mesh.dim == 2 else _tet_geometry(mesh)[0]
    N = grid.num_intervals
    t, h = grid.t, grid.h
    gq = 0.5 / np.sqrt(3.0)
    U = jnp.asarray(U)
    dtype = U.dtype if dtype is None else dtype
    hp = jax.lax.Precision.HIGHEST

    nq = bary.shape[0]

    # Element blocking (as in assembly's device loads): scan over element
    # blocks so the per-element (C+1, EB, nq) interpolated-values buffer
    # stays bounded at any mesh size, big element axis minor.
    from .assembly import _POINT_BLOCK

    ne = mesh.elements.shape[0]
    EB = ne if ne * nq <= _POINT_BLOCK else max(1, _POINT_BLOCK // nq)
    nblk = -(-ne // EB)
    pad_e = nblk * EB - ne
    elems_np = mesh.elements
    meas_np = measure
    if pad_e:
        # Padded elements point at vertex 0 with measure 0: zero contribution.
        elems_np = np.concatenate(
            [elems_np, np.zeros((pad_e, elems_np.shape[1]), elems_np.dtype)]
        )
        meas_np = np.concatenate([meas_np, np.zeros(pad_e, meas_np.dtype)])

    verts = jnp.asarray(mesh.vertices, dtype)
    # (nblk, nloc, EB): element axis minor.
    elems_d = jnp.asarray(
        np.swapaxes(elems_np.reshape(nblk, EB, -1), 1, 2), jnp.int32
    )
    bary_d = jnp.asarray(bary, dtype)
    wm = jnp.asarray(w, dtype)
    meas_d = jnp.asarray(meas_np.reshape(nblk, EB), dtype)
    interior = jnp.asarray(mesh.interior, jnp.int32)
    Ufull = (
        jnp.zeros((N + 1, mesh.num_vertices), dtype)
        .at[:, interior]
        .set(U.astype(dtype))
    )
    exact_pts = jax.vmap(problem.exact, in_axes=(None, 0))

    C = int(min(chunk, N))
    mid = 0.5 * (t[:-1] + t[1:])
    tq = np.stack([mid - gq * h, mid + gq * h], axis=1)  # (N, 2)
    lam = (0.5 - gq, 0.5 + gq)

    # mesh arrays as jit ARGUMENTS, not closed-over constants (CLAUDE.md)
    geo = (verts, elems_d, bary_d, wm, meas_d)

    @jax.jit
    def chunk_err(Uc, tqc, hc, verts, elems_d, bary_d, wm, meas_d):
        """Uc (C+1, nv) coefficient rows, tqc (C, 2), hc (C,) -> partial sum."""

        def step(tot, blk):
            elems_blk, meas_blk = blk  # (nloc, EB), (EB,)
            # (nq, EB, d) points, flattened q-major (point index q*EB+e)
            pts = jnp.einsum(
                "qi,ied->qed", bary_d, verts[elems_blk], precision=hp
            )
            flat = pts.reshape(-1, mesh.dim)
            # interpolated values in (time, quad, element) layout — the big
            # element axis stays minor throughout
            uq = jnp.einsum(
                "qi,tie->tqe", bary_d, Uc[:, elems_blk], precision=hp
            )
            for g in range(2):
                uh = (1 - lam[g]) * uq[:-1] + lam[g] * uq[1:]
                ue = jax.vmap(lambda tt: exact_pts(tt, flat))(tqc[:, g])
                d2 = (uh - ue.reshape(uh.shape[0], nq, -1)) ** 2
                # exact() formulas may promote (x64 consts); the scan carry
                # type is fixed, so pin the partial sum to the accumulator
                tot = tot + jnp.einsum(
                    "tqe,q,e,t->", d2, wm, meas_blk, 0.5 * hc, precision=hp
                ).astype(tot.dtype)
            return tot, None

        total, _ = jax.lax.scan(step, jnp.zeros((), dtype), (elems_d, meas_d))
        return total

    total = 0.0
    for lo in range(0, N, C):
        hi = min(lo + C, N)
        k = hi - lo
        Uc = Ufull[lo : lo + C + 1]
        tqc = tq[lo:hi]
        hc = h[lo:hi]
        if k < C:  # pad the tail chunk; h=0 rows contribute nothing
            Uc = jnp.concatenate(
                [Uc, jnp.zeros((C + 1 - Uc.shape[0], Ufull.shape[1]), dtype)]
            )
            tqc = np.concatenate([tqc, np.zeros((C - k, 2))])
            hc = np.concatenate([hc, np.zeros(C - k)])
        total += float(
            chunk_err(Uc, jnp.asarray(tqc, dtype), jnp.asarray(hc, dtype), *geo)
        )
    return float(np.sqrt(total))
