"""Constant-stencil spatial operators on structured grids.

On the structured triangulations this framework assembles (unit square SW–NE,
unit cube Kuhn), the interior P1 mass/stiffness matrices are translation
invariant: a 7-point (2D) / 15-point (3D) stencil with constant weights, and
zero padding reproduces the Dirichlet-eliminated boundary rows exactly. The
batched matvec over the (T, *grid_shape) coefficient array then becomes a
handful of shifted multiply-adds — one fused, bandwidth-bound XLA pass (the
generic flat-DIA form needs large ±n_x offsets and per-row weight loads).

Weights are extracted from the assembled DiaMatrix and verified constant over
interior rows, so assembly stays the single source of truth.

Per-time-row scales are passed pre-broadcast with shape
``(T, *grid_shape[:-1], 1)`` (``row_scale`` below).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .sparse import DiaMatrix


def _offset_candidates(grid_shape: tuple[int, ...]) -> dict:
    """flat DIA offset -> list of ±1-neighborhood grid displacements."""
    dim = len(grid_shape)
    strides = tuple(
        int(np.prod(grid_shape[i + 1 :], dtype=int)) for i in range(dim)
    )
    cand: dict[int, list] = {}
    for disp in itertools.product((-1, 0, 1), repeat=dim):
        off = sum(d * s for d, s in zip(disp, strides))
        cand.setdefault(off, []).append(disp)
    return cand


def weight_groups(disps, weights):
    """Drop zero taps and group displacements by weight: the stencil form
    that sums taps first and multiplies once per distinct weight."""
    groups: dict[float, list] = {}
    for d, w in zip(disps, weights):
        if w != 0.0:
            groups.setdefault(float(w), []).append(tuple(d))
    return tuple((w, tuple(ds)) for w, ds in groups.items())


def pair_groups(groups_A, groups_M):
    """Regroup two same-support stencils by their (wA, wM) weight PAIR.

    A and M are P1 forms on the same mesh — identical tap displacements —
    so applying them as two separate grouped stencils loads every tap
    twice. Grouping by the weight pair shares the tap sums: each pair
    group costs its tap adds once plus one per-row combined weight
    (wA + ω·wM) multiply (ops/multigrid.MultiShiftMultigrid._op)."""
    wA = {d: w for w, ds in groups_A for d in ds}
    wM = {d: w for w, ds in groups_M for d in ds}
    pairs: dict[tuple[float, float], list] = {}
    for d in {**wA, **wM}:
        key = (wA.get(d, 0.0), wM.get(d, 0.0))
        if key != (0.0, 0.0):
            pairs.setdefault(key, []).append(d)
    return tuple((k, tuple(ds)) for k, ds in pairs.items())


def _shifted_tap(U, disp, grid_shape, batch, Up_cache):
    """Zero-padded slice of U translated by ``disp`` over the grid axes."""
    import jax.numpy as jnp

    center = (0,) * len(grid_shape)
    if disp == center:
        return U
    if Up_cache[0] is None:
        pad = [(0, 0)] * batch + [(1, 1)] * len(grid_shape)
        Up_cache[0] = jnp.pad(U, pad)
    idx = tuple([slice(None)] * batch) + tuple(
        slice(1 + d, 1 + d + n) for d, n in zip(disp, grid_shape)
    )
    return Up_cache[0][idx]


@dataclasses.dataclass(frozen=True)
class VarStencilOperator:
    """A variable-coefficient stencil on a structured grid.

    The weighted spatial forms (∫κ∇u·∇v + c·uv, fem/assembly.py) keep the
    ±1-neighborhood sparsity of the P1 operators but are not translation
    invariant, so weights are per-node ARRAYS, not scalars:
    out[y, x] = Σ_disp W_disp[y, x] · U[y+dy, x+dx]. In grid layout every
    tap is a small-axis shift instead of the flat-DIA form's ±n_x offsets.
    Weight arrays are device params (threaded through jit, never closed
    over); the static structure here carries only displacements + shapes.
    """

    disps: tuple[tuple[int, ...], ...]
    grid_shape: tuple[int, ...]

    @classmethod
    def from_dia(
        cls, dia: DiaMatrix, grid_shape: tuple[int, ...]
    ) -> tuple["VarStencilOperator", np.ndarray]:
        """Returns (static operator, weights (ntaps, *grid_shape) float64 —
        goes in the params pytree)."""
        cand = _offset_candidates(grid_shape)
        disps = []
        for off in dia.offsets:
            matches = cand.get(off)
            if matches is None:
                raise ValueError(f"offset {off} is not a +/-1 neighborhood move")
            if len(matches) > 1:
                raise ValueError(
                    f"ambiguous offset {off} for grid {grid_shape}; "
                    "grid extents too small"
                )
            disps.append(matches[0])
        W = np.ascontiguousarray(
            dia.vals.T.reshape((len(disps),) + tuple(grid_shape))
        )
        return cls(tuple(disps), tuple(grid_shape)), W

    def apply(self, U, W):
        """U (..., *grid_shape), W (ntaps, *grid_shape) -> U.shape."""
        batch = U.ndim - len(self.grid_shape)
        Up_cache = [None]
        out = None
        for k, disp in enumerate(self.disps):
            term = W[k] * _shifted_tap(U, disp, self.grid_shape, batch, Up_cache)
            out = term if out is None else out + term
        return out

    def apply_np(self, U: np.ndarray, W: np.ndarray) -> np.ndarray:
        batch = U.ndim - len(self.grid_shape)
        pad = [(0, 0)] * batch + [(1, 1)] * len(self.grid_shape)
        Up = np.pad(U, pad)
        out = np.zeros_like(U)
        for k, disp in enumerate(self.disps):
            idx = tuple([slice(None)] * batch) + tuple(
                slice(1 + d, 1 + d + n)
                for d, n in zip(disp, self.grid_shape)
            )
            out += np.asarray(W[k]) * Up[idx]
        return out


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """A constant-coefficient stencil on a structured grid.

    disps: tuple of displacement tuples (dy, dx) / (dz, dy, dx).
    weights: matching coefficients.
    grid_shape: interior grid extents.
    """

    disps: tuple[tuple[int, ...], ...]
    weights: tuple[float, ...]
    grid_shape: tuple[int, ...]

    @classmethod
    def from_dia(cls, dia: DiaMatrix, grid_shape: tuple[int, ...]) -> "StencilOperator":
        """Decode DIA offsets into grid displacements and verify the weights
        are constant over interior rows."""
        dim = len(grid_shape)
        cand = _offset_candidates(grid_shape)

        # Interior-of-interior rows: all grid coords in [1, n-2].
        coords = np.unravel_index(np.arange(dia.shape[0]), grid_shape)
        interior = np.ones(dia.shape[0], dtype=bool)
        for c, n in zip(coords, grid_shape):
            interior &= (c >= 1) & (c <= n - 2)
        if not interior.any():
            raise ValueError("grid too small for stencil extraction")

        disps, weights = [], []
        # Assembly cancellation noise: taps that cancel exactly in exact
        # arithmetic carry ~1e-17 row-dependent fp residue; compare and snap
        # relative to the matrix scale.
        scale = float(np.abs(dia.vals).max())
        for k, off in enumerate(dia.offsets):
            if off not in cand:
                raise ValueError(f"offset {off} is not a +/-1 neighborhood move")
            col = np.where(np.abs(dia.vals[:, k]) < 1e-12 * scale, 0.0, dia.vals[:, k])
            w = col[interior]
            if w.size and not np.allclose(w, w[0], rtol=1e-10, atol=1e-12 * scale):
                raise ValueError(f"non-constant stencil weight at offset {off}")
            matches = cand[off]
            if len(matches) > 1:
                raise ValueError(
                    f"ambiguous offset {off} for grid {grid_shape}; "
                    "grid extents too small"
                )
            disps.append(matches[0])
            weights.append(float(w[0]))
        return cls(tuple(disps), tuple(weights), tuple(grid_shape))

    # ------------------------------------------------------------------ jax

    def apply(self, U):
        """Batched stencil matvec: U (..., *grid_shape) -> same shape.

        The center tap reads the unpadded input, exact-zero weights are
        dropped, and taps sharing a weight are summed FIRST and multiplied
        once (fewer multiplies; the f64 parity histories depend on this
        accumulation order).
        """
        import jax.numpy as jnp

        dim = len(self.grid_shape)
        batch = U.ndim - dim
        center = (0,) * dim
        Up = None
        groups: dict[float, list] = {}
        for disp, w in zip(self.disps, self.weights):
            if w == 0.0:
                continue
            if disp == center:
                tap = U
            else:
                if Up is None:
                    pad = [(0, 0)] * batch + [(1, 1)] * dim
                    Up = jnp.pad(U, pad)
                idx = tuple([slice(None)] * batch) + tuple(
                    slice(1 + d, 1 + d + n) for d, n in zip(disp, self.grid_shape)
                )
                tap = Up[idx]
            groups.setdefault(w, []).append(tap)
        out = None
        for w, taps in groups.items():
            acc = taps[0]
            for t in taps[1:]:
                acc = acc + t
            term = w * acc
            out = term if out is None else out + term
        return out

    # ---------------------------------------------------------------- numpy

    def apply_np(self, U: np.ndarray) -> np.ndarray:
        dim = len(self.grid_shape)
        batch = U.ndim - dim
        pad = [(0, 0)] * batch + [(1, 1)] * dim
        Up = np.pad(U, pad)
        out = np.zeros_like(U)
        for disp, w in zip(self.disps, self.weights):
            idx = tuple([slice(None)] * batch) + tuple(
                slice(1 + d, 1 + d + n) for d, n in zip(disp, self.grid_shape)
            )
            out += w * Up[idx]
        return out


def row_scale(h: np.ndarray, grid_shape: tuple[int, ...], dtype):
    """Pre-broadcast a per-time-row scale vector to (T, *grid_shape[:-1], 1).

    Every per-row scale in the params pytree has this one layout, which the
    explicit shard_map paths shard over their leading axes.
    """

    import jax.numpy as jnp

    shape = (h.shape[0],) + tuple(grid_shape[:-1]) + (1,)
    return jnp.broadcast_to(
        jnp.asarray(h, dtype).reshape((h.shape[0],) + (1,) * len(grid_shape)), shape
    ).copy()
