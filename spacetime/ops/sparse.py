"""Device-friendly sparse spatial operator formats.

The P1 operators on structured meshes live on a handful of diagonals
(7 in 2D, 15 in 3D): DIA format turns the batched SpMV
``Y[t] = A @ U[t]`` into `ndiag` shifted multiply-adds over the dense
(T, m) coefficient array — elementwise work that XLA fuses into one
bandwidth-bound pass (SURVEY.md §2: the generic-mesh SpMV slot; the
structured-grid fast path is ops/stencil.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """A square sparse matrix stored by diagonals.

    vals[i, d] = A[i, i + offsets[d]]  (zero where out of range).
    """

    offsets: tuple[int, ...]
    vals: np.ndarray  # (m, ndiag) float64
    shape: tuple[int, int]

    @classmethod
    def from_csr(cls, A: sp.spmatrix) -> "DiaMatrix":
        coo = A.tocoo()
        coo.sum_duplicates()
        m = A.shape[0]
        d = coo.col - coo.row
        offs = np.unique(d)
        vals = np.zeros((m, offs.size))
        # sum_duplicates guarantees unique (row, col) pairs, so plain fancy
        # assignment suffices — np.add.at on the same index set cost 7.2 s
        # of the 9.8 s AMG setup at 1.05M dofs (round-3 profile).
        vals[coo.row, np.searchsorted(offs, d)] = coo.data
        return cls(tuple(int(x) for x in offs), vals, (m, m))

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    def to_dense(self) -> np.ndarray:
        m = self.shape[0]
        A = np.zeros((m, m))
        for k, d in enumerate(self.offsets):
            lo = max(0, -d)
            hi = min(m, m - d)
            rows = np.arange(lo, hi)
            A[rows, rows + d] = self.vals[rows, k]
        return A

    def matvec_np(self, U: np.ndarray) -> np.ndarray:
        """NumPy batched DIA SpMV along the last axis: (..., m) -> (..., m)."""
        m = self.shape[0]
        mo = max(max(self.offsets), -min(self.offsets))
        pad = [(0, 0)] * (U.ndim - 1) + [(mo, mo)]
        Up = np.pad(U, pad)
        Y = np.zeros_like(U)
        for k, d in enumerate(self.offsets):
            Y += self.vals[..., :, k] * Up[..., mo + d : mo + d + m]
        return Y


def dia_matvec(vals, offsets: tuple[int, ...], U):
    """JAX batched DIA SpMV along the last axis of ``U``.

    ``vals`` is the (m, ndiag) device array, ``offsets`` the static tuple;
    Y[..., i] = sum_d vals[i, d] * U[..., i + d]. All slices are static, so
    XLA fuses the whole thing into one elementwise pass over U.
    """
    import jax.numpy as jnp

    m = vals.shape[0]
    mo = max(max(offsets), -min(offsets))
    pad = [(0, 0)] * (U.ndim - 1) + [(mo, mo)]
    Up = jnp.pad(U, pad)
    Y = jnp.zeros_like(U)
    for k, d in enumerate(offsets):
        Y = Y + vals[:, k] * Up[..., mo + d : mo + d + m]
    return Y
