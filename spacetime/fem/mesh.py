"""Simplicial meshes: structured unit square / unit cube, plus generic
(unstructured-path) domains and uniform red refinement.

The reference delegated meshing to NGSolve (SURVEY.md §2, L0); here meshes are
generated directly. Structured triangulations of the unit square/cube carry a
``grid_shape`` so the spatial operators become constant stencils / a handful
of diagonals (the fast path); meshes without ``grid_shape`` (the L-shaped
domain, refined general meshes) run through the generic DIA SpMV path. Uniform refinement of a structured mesh is regeneration at twice
the resolution; ``refine_uniform`` red-refines arbitrary simplicial meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A simplicial mesh with Dirichlet boundary bookkeeping.

    Attributes:
      vertices: (nv, d) float64 vertex coordinates.
      elements: (ne, d+1) int32 vertex indices per simplex.
      boundary: (nv,) bool mask of Dirichlet-boundary vertices.
      interior: (m,) int32 indices of interior (free) vertices.
      grid_shape: per-axis interior node counts for structured meshes
        (used to derive DIA diagonal offsets), or None for unstructured.
      refined_from: for meshes produced by ``refine_uniform``: the tuple
        (coarse_mesh, parent_edges) where parent_edges[i] = (a, b) are the
        COARSE vertex indices whose midpoint is fine vertex i (a == b for
        inherited vertices). This is the exact nested-P1 embedding record
        that the unstructured Galerkin multigrid hierarchy is built from
        (ops/multigrid.NestedMultiShiftMultigrid).
    """

    vertices: np.ndarray
    elements: np.ndarray
    boundary: np.ndarray
    interior: np.ndarray
    grid_shape: tuple[int, ...] | None = None
    refined_from: tuple | None = None

    @property
    def dim(self) -> int:
        return self.vertices.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_interior(self) -> int:
        return self.interior.shape[0]


def unit_square_mesh(n: int) -> Mesh:
    """Structured triangulation of (0,1)^2 with n×n cells, SW–NE diagonals.

    Vertices are ordered lexicographically (y-major, x-fastest); interior
    vertices form an (n-1)×(n-1) grid, so the P1 stiffness/mass matrices have
    nonzeros only on diagonals {0, ±1, ±(n-1), ±n} of the interior block.
    """
    if n < 2:
        raise ValueError("need n >= 2 for a nonempty interior")
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")  # X[iy, ix]
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    ix, iy = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    v00 = (iy * (n + 1) + ix).ravel()
    v10 = v00 + 1
    v01 = v00 + (n + 1)
    v11 = v01 + 1
    # Split every cell along the SW–NE diagonal (v00–v11).
    tris = np.concatenate(
        [
            np.stack([v00, v10, v11], axis=1),
            np.stack([v00, v11, v01], axis=1),
        ],
        axis=0,
    ).astype(np.int32)

    on_bdry = (
        np.isclose(vertices[:, 0], 0.0)
        | np.isclose(vertices[:, 0], 1.0)
        | np.isclose(vertices[:, 1], 0.0)
        | np.isclose(vertices[:, 1], 1.0)
    )
    interior = np.flatnonzero(~on_bdry).astype(np.int32)
    return Mesh(vertices, tris, on_bdry, interior, grid_shape=(n - 1, n - 1))


_KUHN_PERMS = [
    (0, 1, 2),
    (0, 2, 1),
    (1, 0, 2),
    (1, 2, 0),
    (2, 0, 1),
    (2, 1, 0),
]


def unit_cube_mesh(n: int) -> Mesh:
    """Kuhn triangulation of (0,1)^3: each of the n^3 cells splits into 6 tets.

    Every tet walks from the cell's origin corner to the opposite corner along
    one of the 6 axis orderings, giving a conforming simplicial mesh whose
    interior P1 operators live on ≤15 diagonals.
    """
    if n < 2:
        raise ValueError("need n >= 2 for a nonempty interior")
    xs = np.linspace(0.0, 1.0, n + 1)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):  # x-index i, y-index j, z-index k
        return (k * (n + 1) + j) * (n + 1) + i

    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    strides = np.array([1, n + 1, (n + 1) ** 2], dtype=np.int64)
    base = vid(i, j, k)
    tets = []
    for perm in _KUHN_PERMS:
        p0 = base
        p1 = p0 + strides[perm[0]]
        p2 = p1 + strides[perm[1]]
        p3 = p2 + strides[perm[2]]
        tets.append(np.stack([p0, p1, p2, p3], axis=1))
    tets = np.concatenate(tets, axis=0).astype(np.int32)

    on_bdry = np.zeros(vertices.shape[0], dtype=bool)
    for d in range(3):
        on_bdry |= np.isclose(vertices[:, d], 0.0) | np.isclose(vertices[:, d], 1.0)
    interior = np.flatnonzero(~on_bdry).astype(np.int32)
    return Mesh(vertices, tets, on_bdry, interior, grid_shape=(n - 1, n - 1, n - 1))


# ------------------------------------------------- generic (unstructured path)


def _boundary_vertex_mask(num_vertices: int, elements: np.ndarray) -> np.ndarray:
    """Topological boundary detection: a facet (edge in 2D, face in 3D) is on
    the boundary iff it belongs to exactly one element; boundary vertices are
    the vertices of boundary facets. Assumes the whole boundary is Dirichlet
    (the framework's convention, SURVEY.md Appendix A)."""
    import itertools

    k = elements.shape[1]  # d+1 vertices per simplex
    d = k - 1
    facets = np.concatenate(
        [elements[:, list(c)] for c in itertools.combinations(range(k), d)],
        axis=0,
    )
    F = np.sort(facets.astype(np.int64), axis=1)
    order = np.lexsort(F.T[::-1])
    Fs = F[order]
    new = np.ones(len(Fs), dtype=bool)
    new[1:] = (Fs[1:] != Fs[:-1]).any(axis=1)
    grp = np.cumsum(new) - 1
    counts = np.bincount(grp)
    bdry = Fs[new][counts == 1]
    mask = np.zeros(num_vertices, dtype=bool)
    mask[bdry.ravel()] = True
    return mask


def l_shape_mesh(n: int) -> Mesh:
    """L-shaped domain (0,1)² minus the closed quadrant [½,1]², n×n base cells
    (n even). The classic non-tensor-product domain: exercises the generic
    (non-stencil) spatial path the reference reached through NGSolve meshes."""
    if n < 4 or n % 2:
        raise ValueError("need even n >= 4")
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    vertices_full = np.stack([X.ravel(), Y.ravel()], axis=1)

    ix, iy = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    keep = ~((ix >= n // 2) & (iy >= n // 2))
    ix, iy = ix[keep].ravel(), iy[keep].ravel()
    v00 = iy * (n + 1) + ix
    v10 = v00 + 1
    v01 = v00 + (n + 1)
    v11 = v01 + 1
    tris = np.concatenate(
        [np.stack([v00, v10, v11], axis=1), np.stack([v00, v11, v01], axis=1)],
        axis=0,
    )
    used = np.unique(tris)
    remap = np.full(vertices_full.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    vertices = vertices_full[used]
    tris = remap[tris].astype(np.int32)

    on_bdry = _boundary_vertex_mask(vertices.shape[0], tris)
    interior = np.flatnonzero(~on_bdry).astype(np.int32)
    return Mesh(vertices, tris, on_bdry, interior, grid_shape=None)


_TET_CHILDREN_CORNERS = [(0, 4, 5, 6), (4, 1, 7, 8), (5, 7, 2, 9), (6, 8, 9, 3)]
# Bey's red refinement of the inner octahedron along the m02–m13 diagonal
# (local ids: 4=m01, 5=m02, 6=m03, 7=m12, 8=m13, 9=m23).
_TET_CHILDREN_OCTA = [(4, 5, 6, 8), (4, 5, 7, 8), (5, 6, 8, 9), (5, 7, 8, 9)]


def refine_uniform(mesh: Mesh) -> Mesh:
    """Red uniform refinement of an arbitrary simplicial mesh: every edge is
    bisected; each triangle splits into 4 similar children, each tetrahedron
    into 4 corner tets + 4 octahedron tets (Bey's rule). The result carries no
    ``grid_shape`` (structured meshes should regenerate at 2× resolution to
    keep the stencil fast path)."""
    V, E = mesh.vertices, mesh.elements.astype(np.int64)
    k = E.shape[1]
    import itertools

    pair_ids = list(itertools.combinations(range(k), 2))
    edges = np.sort(
        np.concatenate([E[:, list(c)] for c in pair_ids], axis=0), axis=1
    )
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mid_ids = V.shape[0] + inv.reshape(len(pair_ids), -1)  # (npairs, ne)
    midpoints = 0.5 * (V[uniq[:, 0]] + V[uniq[:, 1]])
    vertices = np.concatenate([V, midpoints], axis=0)

    if k == 3:  # triangles: local ids 3=m01, 4=m02, 5=m12
        loc = np.stack([E[:, 0], E[:, 1], E[:, 2], *mid_ids], axis=1)
        children = [(0, 3, 4), (1, 5, 3), (2, 4, 5), (3, 5, 4)]
    elif k == 4:  # tets: pair order (01,02,03,12,13,23) -> local ids 4..9
        loc = np.stack([E[:, 0], E[:, 1], E[:, 2], E[:, 3], *mid_ids], axis=1)
        children = _TET_CHILDREN_CORNERS + _TET_CHILDREN_OCTA
    else:
        raise ValueError(f"unsupported element arity {k}")
    elements = np.concatenate([loc[:, list(c)] for c in children], axis=0)
    elements = elements.astype(np.int32)

    on_bdry = _boundary_vertex_mask(vertices.shape[0], elements)
    interior = np.flatnonzero(~on_bdry).astype(np.int32)
    # Nested-P1 parent record: inherited vertices are their own parents,
    # new vertices are midpoints of the unique coarse edges.
    nv = V.shape[0]
    own = np.stack([np.arange(nv), np.arange(nv)], axis=1)
    parent_edges = np.concatenate([own, uniq], axis=0).astype(np.int32)
    return Mesh(vertices, elements, on_bdry, interior, grid_shape=None,
                refined_from=(mesh, parent_edges))


def sort_vertices_lex(mesh: Mesh) -> Mesh:
    """Reorder vertices lexicographically (last coordinate major, first
    fastest). ``refine_uniform`` appends midpoints after the inherited
    vertices, which scatters grid neighbors across the index space — the
    assembled matrix then has thousands of DIA diagonals (measured 12365 at
    the refined L-shape n=64 vs 11 lex-sorted). Grid-like meshes recover
    their banded structure exactly under this sort; parent links
    (``refined_from``) are row-permuted along."""
    key = tuple(mesh.vertices[:, d] for d in range(mesh.dim))
    order = np.lexsort(key)  # last key = major -> here first coord fastest
    inv = np.empty(order.size, dtype=np.int64)
    inv[order] = np.arange(order.size)
    boundary = mesh.boundary[order]
    refined_from = mesh.refined_from
    if refined_from is not None:
        coarse, pe = refined_from
        refined_from = (coarse, pe[order])
    return Mesh(
        mesh.vertices[order],
        inv[mesh.elements.astype(np.int64)].astype(np.int32),
        boundary,
        np.flatnonzero(~boundary).astype(np.int32),
        grid_shape=None,
        refined_from=refined_from,
    )


def refine_hierarchy(base: Mesh, refines: int, sort: bool = True) -> Mesh:
    """Red-refine ``refines`` times, recording the nested-P1 parent chain
    (``Mesh.refined_from``) that the unstructured Galerkin multigrid walks;
    each level is lex-sorted (``sort_vertices_lex``) to keep the assembled
    matrices DIA-banded. This is the multigrid-ready counterpart of calling
    ``refine_uniform`` in a loop."""
    mesh = base
    for _ in range(refines):
        mesh = refine_uniform(mesh)
        if sort:
            mesh = sort_vertices_lex(mesh)
    return mesh


def nested_interpolation(fine: Mesh):
    """The exact nested-P1 embedding P (interior-fine × interior-coarse,
    scipy CSR) for a mesh produced by ``refine_uniform``: a fine interior
    vertex reads its inherited coarse value (weight 1) or the mean of its
    parent edge's endpoints (weights ½, ½); coarse Dirichlet parents
    contribute their boundary value 0 and are dropped. Restriction is Pᵀ;
    Galerkin RAP through this P equals re-assembly on the coarse mesh in
    exact arithmetic (nested spaces)."""
    import scipy.sparse as sp

    if fine.refined_from is None:
        raise ValueError("mesh carries no refinement record (refined_from)")
    coarse, pe = fine.refined_from
    c2i = np.full(coarse.num_vertices, -1, dtype=np.int64)
    c2i[coarse.interior] = np.arange(coarse.num_interior)
    fi = fine.interior.astype(np.int64)
    rows, cols, vals = [], [], []
    for side in (0, 1):
        parent = pe[fi, side].astype(np.int64)
        # ½ per edge endpoint; an inherited vertex lists itself twice,
        # so the duplicate sum below restores its weight 1.
        w = np.full(fi.size, 0.5)
        ci = c2i[parent]
        keep = ci >= 0
        rows.append(np.arange(fi.size)[keep])
        cols.append(ci[keep])
        vals.append(w[keep])
    P = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(fine.num_interior, coarse.num_interior),
    )
    P.sum_duplicates()
    return P


def domain_mesh(domain: str, dim: int, n: int) -> Mesh:
    """Mesh factory keyed by a problem's domain tag."""
    if domain == "unit":
        return unit_square_mesh(n) if dim == 2 else unit_cube_mesh(n)
    if domain == "lshape":
        if dim != 2:
            raise ValueError("lshape domain is 2D")
        return l_shape_mesh(n)
    raise ValueError(f"unknown domain {domain!r}")
