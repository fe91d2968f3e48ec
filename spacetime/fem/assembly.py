"""Vectorized P1 finite-element assembly (host-side, runs once per solve).

Replacement for the reference's NGSolve assembly (SURVEY.md §2):
pure NumPy element loops vectorized over all simplices, emitting scipy CSR for
the oracle and DIA diagonals for the device path. Assembly cost is amortized —
it runs once; the per-iteration hot path never touches these routines.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .mesh import Mesh


def _check_nondegenerate(det: np.ndarray, what: str) -> None:
    """Zero-measure elements make the barycentric gradients inf/NaN and the
    assembled operators silently poisoned — fail with the element ids
    instead (imported meshes are only index-validated by the loader)."""
    bad = np.flatnonzero(det == 0.0)
    if bad.size:
        raise ValueError(
            f"{bad.size} degenerate (zero-{what}) element(s), e.g. ids "
            f"{bad[:5].tolist()}"
        )


def _tri_geometry(mesh: Mesh):
    v = mesh.vertices[mesh.elements]  # (ne, 3, 2)
    d1 = v[:, 1] - v[:, 0]
    d2 = v[:, 2] - v[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    _check_nondegenerate(det, "area")
    area = np.abs(det) / 2.0
    # Gradients of the barycentric basis functions.
    g1 = np.stack([d2[:, 1], -d2[:, 0]], axis=1) / det[:, None]
    g2 = np.stack([-d1[:, 1], d1[:, 0]], axis=1) / det[:, None]
    g0 = -g1 - g2
    grads = np.stack([g0, g1, g2], axis=1)  # (ne, 3, 2)
    return area, grads


def _tet_geometry(mesh: Mesh):
    v = mesh.vertices[mesh.elements]  # (ne, 4, 3)
    D = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], axis=1)
    det = np.linalg.det(D)
    _check_nondegenerate(det, "volume")
    vol = np.abs(det) / 6.0
    Dinv = np.linalg.inv(D)  # rows of Dinv^T are gradients of bary 1..3
    g = np.transpose(Dinv, (0, 2, 1))  # (ne, 3, 3): g[:, i] = grad lambda_{i+1}
    g0 = -g.sum(axis=1)
    grads = np.concatenate([g0[:, None, :], g], axis=1)  # (ne, 4, 3)
    return vol, grads


def assemble_p1(
    mesh: Mesh, engine: str = "auto", kappa=None, reaction=None
) -> tuple[sp.csr_matrix, sp.csr_matrix]:
    """Assemble full (all-vertex) P1 mass and spatial-form matrices.

    Returns (M, A) as CSR over all vertices; restrict with
    ``P1System.from_mesh`` for the Dirichlet-interior block. With the
    optional coefficients, A is the general SPD parabolic spatial form
    ``a(u,v) = ∫ κ(x) ∇u·∇v + c(x) u v`` (κ, c are callables
    ``(n, d) -> (n,)`` evaluated at element centroids — exact for
    elementwise-constant coefficients and an O(h²) variational crime
    otherwise, preserving the method's 2nd-order rates); M is always the
    plain mass matrix (it carries the ∂t pairing and the trace term).

    ``engine``: 'numpy' (vectorized host assembly, the parity reference),
    'native' (the C++ core in spacetime/native — the NGSolve-equivalent
    engine, ~2x faster and O(1) temporaries), or 'auto' (native for large
    meshes when the compiler is available, or when SPACETIME_NATIVE=1).
    Both engines assemble the weighted form (centroid coefficient values
    are evaluated host-side once and handed to the C++ core per element).
    """
    import os

    d = mesh.dim
    nloc = d + 1
    weighted = kappa is not None or reaction is not None
    kv = cv = None
    if weighted:
        centroids = mesh.vertices[mesh.elements].mean(axis=1)
        if kappa is not None:
            kv = np.asarray(kappa(centroids), np.float64)
            if kv.min() <= 0.0:
                raise ValueError("diffusion coefficient must be positive")
        if reaction is not None:
            cv = np.asarray(reaction(centroids), np.float64)
            if cv.min() < 0.0:
                raise ValueError("reaction coefficient must be nonnegative")
    if engine == "auto":
        big = mesh.elements.shape[0] >= 500_000
        want = big or os.environ.get("SPACETIME_NATIVE") == "1"
        if want:
            from .. import native

            engine = "native" if native.available() else "numpy"
        else:
            engine = "numpy"
    if engine == "native":
        from ..native import assemble_p1_native

        rows, cols, mass, stiff = assemble_p1_native(
            mesh.vertices, mesh.elements, kv, cv
        )
        nv = mesh.num_vertices
        # coo -> csr conversion already sums duplicate entries
        A = sp.coo_matrix((stiff, (rows, cols)), shape=(nv, nv)).tocsr()
        M = sp.coo_matrix((mass, (rows, cols)), shape=(nv, nv)).tocsr()
        return M, A
    if d == 2:
        measure, grads = _tri_geometry(mesh)
        mass_scale = 1.0 / 12.0  # int lam_i lam_j = area/12 * (1 + delta_ij)
    elif d == 3:
        measure, grads = _tet_geometry(mesh)
        mass_scale = 1.0 / 20.0
    else:
        raise ValueError(f"unsupported dim {d}")

    # Local matrices, vectorized over elements.
    K = measure[:, None, None] * np.einsum("eid,ejd->eij", grads, grads)
    Mloc = (np.ones((nloc, nloc)) + np.eye(nloc)) * mass_scale
    Mel = measure[:, None, None] * Mloc[None]
    if kv is not None:
        K = kv[:, None, None] * K
    if cv is not None:
        K = K + cv[:, None, None] * Mel

    rows = np.repeat(mesh.elements, nloc, axis=1).ravel()
    cols = np.tile(mesh.elements, (1, nloc)).ravel()
    nv = mesh.num_vertices
    # coo -> csr conversion already sums duplicate entries
    A = sp.coo_matrix((K.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    M = sp.coo_matrix((Mel.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    return M, A


def _quad_rule(dim: int):
    """Degree-2-exact quadrature in barycentric coordinates: (bary, weights)."""
    if dim == 2:
        # Edge-midpoint rule, exact for quadratics.
        bary = np.array(
            [[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]], dtype=np.float64
        )
        w = np.full(3, 1.0 / 3.0)
    elif dim == 3:
        a = (5.0 - np.sqrt(5.0)) / 20.0
        b = 1.0 - 3.0 * a
        bary = np.full((4, 4), a)
        np.fill_diagonal(bary, b)
        w = np.full(4, 0.25)
    else:
        raise ValueError(f"unsupported dim {dim}")
    return bary, w


def load_vector(mesh: Mesh, f) -> np.ndarray:
    """Assemble the load vector f_k = ∫_Ω f φ_k dx over all vertices.

    ``f`` is called with an (nq, d) array of points and must return (nq,)
    values. Uses a degree-2-exact rule, enough to preserve the method's
    second-order convergence.
    """
    bary, w = _quad_rule(mesh.dim)
    v = mesh.vertices[mesh.elements]  # (ne, nloc, d)
    if mesh.dim == 2:
        measure, _ = _tri_geometry(mesh)
    else:
        measure, _ = _tet_geometry(mesh)
    pts = np.einsum("qi,eid->eqd", bary, v)  # (ne, nq, d)
    fvals = np.asarray(f(pts.reshape(-1, mesh.dim))).reshape(pts.shape[:2])
    # phi_k at quad point q equals bary[q, local_index(k)].
    contrib = np.einsum("eq,q,qi->ei", fvals, w, bary) * measure[:, None]
    out = np.zeros(mesh.num_vertices)
    np.add.at(out, mesh.elements.ravel(), contrib.ravel())
    return out


def spacetime_loads(problem, mesh: Mesh, grid) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Half-interval space-time loads for the stabilized formulation.

    Returns (gL, gR, u0_vec): gL/gR (N, m_interior) with
    gL[j,k] = ∫_{left half of interval j} ∫_Ω g φ_k (2-point Gauss per half),
    and u0_vec[k] = ∫_Ω u0 φ_k, all restricted to interior vertices.
    Shared by the NumPy oracle and the JAX device path so their right-hand
    sides agree bit-for-bit.
    """
    idx = mesh.interior
    t = grid.t
    h = grid.h
    N = grid.num_intervals
    gq = 0.5 / np.sqrt(3.0)

    # Quadrature times: per interval, 2-point Gauss on each half.
    hh = 0.5 * h
    mids = np.stack([t[:-1] + 0.5 * hh, t[:-1] + 1.5 * hh], axis=1)  # (N, 2)
    tq = np.stack(
        [mids - gq * hh[:, None], mids + gq * hh[:, None]], axis=2
    ).reshape(N, 2, 2)  # (interval, half, gauss point)

    # Spatial quadrature structures, built once.
    bary, w = _quad_rule(mesh.dim)
    measure = _tri_geometry(mesh)[0] if mesh.dim == 2 else _tet_geometry(mesh)[0]
    v = mesh.vertices[mesh.elements]
    pts = np.einsum("qi,eid->eqd", bary, v).reshape(-1, mesh.dim)
    nq = bary.shape[0]
    nloc = mesh.elements.shape[1]
    ne = mesh.elements.shape[0]
    inv = -np.ones(mesh.num_vertices, dtype=np.int64)
    inv[idx] = np.arange(idx.size)
    # ONE sparse matrix (m_interior, ne·nq) folds quadrature weights, basis
    # values, AND element measures: loads = S2 · g(points). The earlier
    # two-stage form (tensordot with WB, then a scatter product) built a
    # (t, ne, nloc)-sized intermediate — on a first-touch-slow host that
    # allocation dominated everything (measured 231 s per 4.8 GB chunk at
    # 513²; this form never materializes it).
    row_q = (np.arange(ne)[:, None] * nq + np.arange(nq)[None, :])  # (ne, nq)
    WB = w[:, None] * bary  # (nq, nloc)
    rows, cols, data = [], [], []
    for l in range(nloc):
        c = inv[mesh.elements[:, l]]  # (ne,)
        keep = c >= 0
        rows.append(np.repeat(c[keep], nq))
        cols.append(row_q[keep].ravel())
        data.append((measure[keep, None] * WB[None, :, l]).ravel())
    S2 = sp.csr_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=(idx.size, ne * nq),
    )

    def half_loads(times_flat: np.ndarray) -> np.ndarray:
        """(k,) times -> (k, m) interior loads, one fused g evaluation per
        chunk (the per-time python loop dominated assembly at scale);
        chunk size bounds the g-values buffer to ~1 GB."""
        out = np.empty((times_flat.size, idx.size))
        chunk = max(1, int(1.2e8 // max(pts.shape[0], 1)))
        for lo in range(0, times_flat.size, chunk):
            ts = times_flat[lo : lo + chunk]
            fvals = problem.g_many(ts, pts)  # (k, ne*nq)
            out[lo : lo + ts.size] = S2.dot(fvals.T).T
        return out

    loads = half_loads(tq.reshape(-1)).reshape(N, 2, 2, idx.size)
    weights = 0.5 * hh  # per Gauss point on each half
    gL = weights[:, None] * loads[:, 0].sum(axis=1)
    gR = weights[:, None] * loads[:, 1].sum(axis=1)

    u0_vec = load_vector(mesh, problem.u0)[idx]
    return gL, gR, u0_vec


# Quadrature-point block bound for device_spacetime_loads (module-level so
# tests can force multi-block execution on small meshes).
_POINT_BLOCK = 500_000


def device_spacetime_loads(problem, mesh: Mesh, grid, dtype, chunk: int = 128):
    """Device-resident half-interval load quadrature (the scale path).

    Same mathematics as ``spacetime_loads`` — 2-point Gauss per half
    interval in time, degree-2 rule in space, scatter to interior vertices —
    but evaluated as jitted device code in the solve dtype, so at large
    configs the RHS never crosses the host boundary. Measured on the host
    path at 513²×128ts: 437 s of NumPy quadrature vs ~1 s of device solve —
    the host path remains the f64 parity oracle; this serves the f32/mg
    configs. Requires a manufactured problem (``problem.exact`` — source and
    initial data are then jax-traceable); ``chunk`` bounds the number of
    quadrature times evaluated per dispatch (fixed shape → one compile).

    Returns device arrays (gL (N, m), gR (N, m), u0_vec (m,)).
    """
    import jax
    import jax.numpy as jnp

    if problem.exact is None:
        raise ValueError("device loads need a manufactured problem (exact)")
    idx = mesh.interior
    m = idx.size
    t, h, N = grid.t, grid.h, grid.num_intervals
    gq = 0.5 / np.sqrt(3.0)
    hh = 0.5 * h
    mids = np.stack([t[:-1] + 0.5 * hh, t[:-1] + 1.5 * hh], axis=1)
    tq = np.stack(
        [mids - gq * hh[:, None], mids + gq * hh[:, None]], axis=2
    )  # (N, half, gauss)

    bary, w = _quad_rule(mesh.dim)
    measure = (_tri_geometry(mesh) if mesh.dim == 2 else _tet_geometry(mesh))[0]
    nq = bary.shape[0]
    inv = -np.ones(mesh.num_vertices, dtype=np.int64)
    inv[idx] = np.arange(m)
    ids = inv[mesh.elements.ravel()]
    ids = np.where(ids >= 0, ids, m)  # boundary vertices -> dummy slot m

    gfn = problem._g_fn()  # jitted (t, (n, d)) -> (n,), inlines under jit

    # HIGHEST matmul precision: a reduced-precision default (bf16 or TF32
    # passes) costs ~1e-3 relative error on the assembled loads; full-f32
    # contraction keeps it at ~1e-7. These run once — speed is irrelevant.
    hp = jax.lax.Precision.HIGHEST

    # Element blocking: every materialized per-element buffer is bounded by
    # the block size (≤5e5 quadrature points per block), so the working set
    # of the quadrature stays small at any mesh size.
    ne = mesh.elements.shape[0]
    npts = ne * nq
    EB = ne if npts <= _POINT_BLOCK else max(1, _POINT_BLOCK // nq)
    nblk = -(-ne // EB)
    pad_e = nblk * EB - ne

    def _padded(a, fill):
        if not pad_e:
            return a
        tail = np.full((pad_e,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, tail])

    # Padded elements point at vertex 0 with measure 0 — their quadrature
    # contributions are exact zeros scattered to real slots.
    elems_b = _padded(mesh.elements, 0).reshape(nblk, EB, -1)
    meas_b = _padded(measure, 0.0).reshape(nblk, EB)
    ids_b = _padded(ids.reshape(ne, -1), m).reshape(nblk, -1)

    verts = jnp.asarray(mesh.vertices, dtype)
    # (nblk, nverts, EB): the big element axis is the minor dimension.
    elems_d = jnp.asarray(np.swapaxes(elems_b, 1, 2), jnp.int32)
    meas_d = jnp.asarray(meas_b, dtype)
    WB_d = jnp.asarray(w[:, None] * bary, dtype)
    bary_d = jnp.asarray(bary, dtype)
    ids_d = jnp.asarray(ids_b, jnp.int32)

    # The mesh arrays travel as jit ARGUMENTS (the `geo` tuple), never as
    # closed-over constants — the CLAUDE.md rule: baked-in device constants
    # (50+ MB of vertex/element/index data at 1025²) risk the measured
    # minutes-long compiles on this backend.
    geo = (verts, elems_d, bary_d, WB_d, meas_d, ids_d)

    def _pts_blk(verts, elems_blk, bary_d):
        """One block's quadrature points, (EB*nq, d), point index e*nq+q."""
        return jnp.einsum(
            "qi,ied->eqd", bary_d, verts[elems_blk], precision=hp
        ).reshape(-1, mesh.dim)

    def _scatter_blk(fv, k, WB_d, meas_blk, ids_blk, out):
        """(k, EB*nq) point values accumulated into the (k, m+1) loads."""
        contrib = jnp.matmul(fv.reshape(k, -1, nq), WB_d, precision=hp)
        contrib = contrib * meas_blk[None, :, None]
        return out.at[:, ids_blk].add(contrib.reshape(k, -1))

    def _eval_scatter(tfun, k, verts, elems_d, bary_d, WB_d, meas_d, ids_d):
        """Scan over element blocks: scatter tfun(points) -> (k, m)."""

        def step(out, blk):
            elems_blk, meas_blk, ids_blk = blk
            fv = tfun(_pts_blk(verts, elems_blk, bary_d))
            return _scatter_blk(fv, k, WB_d, meas_blk, ids_blk, out), None

        out0 = jnp.zeros((k, m + 1), dtype)
        out, _ = jax.lax.scan(step, out0, (elems_d, meas_d, ids_d))
        return out[:, :m]

    # Chunk bound: the vmapped hessian-of-exact evaluation materializes a
    # handful of (C, block-points) intermediates; cap their product at
    # ~1.5e8 so the largest configs stay ~2-3 GB of HBM temp (128 times
    # over all 1025² points builds 22 GB and OOMs a 16 GB chip — measured).
    C = int(min(chunk, 4 * N, max(1, int(1.5e8 // max(min(npts, EB * nq), 1)))))

    @jax.jit
    def loads_all(ts_chunks, verts, elems_d, bary_d, WB_d, meas_d, ids_d):
        """(nc, C) times -> (nc, C, m); lax.map over time chunks × scan
        over element blocks bounds the working set while keeping the whole
        quadrature a SINGLE dispatch."""

        def one(ts):
            tfun = lambda pts: jax.vmap(lambda tt: gfn(tt, pts))(ts)
            return _eval_scatter(tfun, C, verts, elems_d, bary_d, WB_d, meas_d, ids_d)

        return jax.lax.map(one, ts_chunks)

    @jax.jit
    def u0_load(verts, elems_d, bary_d, WB_d, meas_d, ids_d):
        zero = jnp.zeros((), dtype)
        tfun = lambda pts: jax.vmap(lambda x: problem.exact(zero, x))(pts)[None]
        return _eval_scatter(tfun, 1, verts, elems_d, bary_d, WB_d, meas_d, ids_d)[0]

    times = tq.reshape(-1)
    pad = (-times.size) % C
    tpad = np.concatenate([times, np.full(pad, t[0])]) if pad else times
    chunks = jnp.asarray(tpad.reshape(-1, C), dtype)
    loads = loads_all(chunks, *geo).reshape(-1, m)[: times.size]
    loads = loads.reshape(N, 2, 2, m)
    wts = jnp.asarray(0.5 * hh, dtype)[:, None]
    gL = wts * loads[:, 0].sum(axis=1)
    gR = wts * loads[:, 1].sum(axis=1)
    return gL, gR, u0_load(*geo)


@dataclasses.dataclass(frozen=True)
class P1System:
    """Interior-block spatial operators for a Dirichlet problem.

    Attributes:
      mesh: the underlying mesh.
      M: interior mass matrix (m×m CSR).
      A: interior spatial-form matrix (m×m CSR): the stiffness matrix, or
        the weighted form ∫κ∇u·∇v + c·uv for variable-coefficient problems.
      weighted: True when A carries non-constant coefficients — such
        operators are not translation invariant, so the constant-stencil
        device path must not be used (solvers fall back to DIA/blocked-ELL).
    """

    mesh: Mesh
    M: sp.csr_matrix
    A: sp.csr_matrix
    weighted: bool = False

    @classmethod
    def from_mesh(cls, mesh: Mesh, kappa=None, reaction=None) -> "P1System":
        """``kappa``/``reaction``: optional coefficient callables
        ``(n, d) -> (n,)`` (see :func:`assemble_p1`)."""
        Mfull, Afull = assemble_p1(mesh, kappa=kappa, reaction=reaction)
        idx = mesh.interior
        return cls(
            mesh,
            Mfull[idx][:, idx].tocsr(),
            Afull[idx][:, idx].tocsr(),
            weighted=kappa is not None or reaction is not None,
        )

    @classmethod
    def from_problem(cls, problem, mesh: Mesh) -> "P1System":
        """Assemble the spatial form a given Problem prescribes (plain heat
        operator, or the κ/c-weighted general parabolic form)."""
        kap = problem.kappa_np if problem.kappa is not None else None
        rea = problem.reaction_np if problem.reaction is not None else None
        return cls.from_mesh(mesh, kappa=kap, reaction=rea)

    @property
    def m(self) -> int:
        return self.mesh.num_interior

    def interior_load(self, f) -> np.ndarray:
        """Load vector restricted to interior vertices."""
        return load_vector(self.mesh, f)[self.mesh.interior]
