"""Native C++ assembly core vs NumPy reference (exactness + availability)."""

import numpy as np
import pytest

from spacetime import native
from spacetime.fem import unit_cube_mesh, unit_square_mesh
from spacetime.fem.assembly import assemble_p1


requires_native = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


@requires_native
@pytest.mark.parametrize("mesh", [unit_square_mesh(16), unit_cube_mesh(6)],
                         ids=["2d", "3d"])
def test_native_matches_numpy(mesh):
    M0, A0 = assemble_p1(mesh, engine="numpy")
    M1, A1 = assemble_p1(mesh, engine="native")
    assert abs(M1 - M0).max() < 1e-16
    assert abs(A1 - A0).max() < 1e-13


@requires_native
@pytest.mark.parametrize("mesh", [unit_square_mesh(16), unit_cube_mesh(6)],
                         ids=["2d", "3d"])
def test_native_weighted_matches_numpy(mesh):
    kap = lambda X: 1.0 + X[:, 0] + 0.5 * np.sin(np.pi * X[:, 1])
    rea = lambda X: 2.0 + X[:, -1]
    M0, A0 = assemble_p1(mesh, engine="numpy", kappa=kap, reaction=rea)
    M1, A1 = assemble_p1(mesh, engine="native", kappa=kap, reaction=rea)
    assert abs(M1 - M0).max() < 1e-16
    assert abs(A1 - A0).max() < 1e-13
    # The weighted form differs from the plain one (sanity of the wiring).
    _, Aplain = assemble_p1(mesh, engine="native")
    assert abs(A1 - Aplain).max() > 1e-3


@requires_native
def test_native_sa_aggregation_bit_exact():
    """The C++ greedy aggregation (native.sa_aggregate_native) must
    reproduce the Python reference passes of ops/multigrid.sa_prolongator
    bit-exactly — same visit order, same tie-breaks — so the AMG hierarchy
    (and every downstream residual history) is independent of which engine
    ran the setup."""
    import scipy.sparse as sp

    from spacetime.fem import P1System, l_shape_mesh
    from spacetime.native import sa_aggregate_native

    sys_ = P1System.from_mesh(l_shape_mesh(32))
    A = sp.csr_matrix(sys_.A)
    n = A.shape[0]
    d = np.asarray(A.diagonal())
    C = A.tocoo()
    off = C.row != C.col
    strong = off & (np.abs(C.data) >= 0.08 * np.sqrt(d[C.row] * d[C.col]))
    S = sp.csr_matrix(
        (np.ones(int(strong.sum()), np.int8), (C.row[strong], C.col[strong])),
        shape=A.shape,
    )
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    na = 0
    for i in range(n):
        nbrs = indices[indptr[i]: indptr[i + 1]]
        if agg[i] == -1 and (agg[nbrs] == -1).all():
            agg[i] = na
            agg[nbrs] = na
            na += 1
    p1 = agg.copy()
    for i in range(n):
        if p1[i] != -1:
            continue
        hit = p1[indices[indptr[i]: indptr[i + 1]]]
        hit = hit[hit != -1]
        if hit.size:
            agg[i] = hit[0]
    for i in range(n):
        if agg[i] != -1:
            continue
        agg[i] = na
        for j in indices[indptr[i]: indptr[i + 1]]:
            if agg[j] == -1:
                agg[j] = na
        na += 1
    agg2 = np.full(n, -1, np.int64)
    na2 = sa_aggregate_native(indptr, indices, agg2)
    assert na2 == na
    np.testing.assert_array_equal(agg2, agg)
