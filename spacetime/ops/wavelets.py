"""Three-point piecewise-linear wavelet transform in time (Stevenson style).

Implements the wavelet-in-time synthesis ``W`` and its transpose ``W'`` of the
minimal-residual solver (SURVEY.md Appendix A): level-0 basis = the two hats
on the coarsest grid {0, T}; a node created at level j by bisecting the
interval (pl, pr) carries the wavelet

    psi_{j,k} = s_k * ( wl_k * sigma_pl + sigma_k + wr_k * sigma_pr )

in level-j hats, where the weights satisfy one vanishing moment via the
symmetric split  wl = -I_k / (2 I_pl),  wr = -I_k / (2 I_pr)  (I_* = hat
integrals on the level-j grid). On uniform interior nodes this reduces to the
classical (-1/2, 1, -1/2) stencil and at the boundary to the adapted
(-1, 1, -1/2) stencil automatically — including on locally refined dyadic
grids. Every basis function is exactly L2(0,T)-normalized (scale s_k).

The transform is applied levelwise in O(N_t) as a composition of elementary
maps E_j acting on nodal values: interpolate the level-(j-1) field to the
level-j grid, then add the level-j details. Both the NumPy (oracle) and JAX
(device) applications share the same host-precomputed index/weight arrays;
the JAX version is a short unrolled loop of static gathers/scatter-adds over
axis 0 (J ≈ log2 N_t stages), jit-friendly and shardable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fem.timegrid import TimeGrid


@dataclasses.dataclass(frozen=True)
class _Level:
    idx: np.ndarray  # nodes created at this level
    pl: np.ndarray  # creation parents (left)
    pr: np.ndarray  # creation parents (right)
    wl: np.ndarray  # wavelet weight on sigma_pl
    wr: np.ndarray  # wavelet weight on sigma_pr
    s: np.ndarray  # L2 normalization scale


@dataclasses.dataclass(frozen=True)
class WaveletTransform:
    """Host-precomputed structure of the wavelet transform on a TimeGrid."""

    grid: TimeGrid
    levels: tuple[_Level, ...]  # levels 1..J
    root_idx: np.ndarray  # the two level-0 nodes
    root_s: np.ndarray  # their L2 normalization
    node_level: np.ndarray  # (N+1,) level of each node
    node_omega: np.ndarray  # (N+1,) |psi'|_L2 of the normalized basis function
    level_shift: np.ndarray  # (J+1,) representative omega per level
    perm_by_level: np.ndarray  # stable permutation sorting nodes by level
    level_counts: np.ndarray  # (J+1,) nodes per level

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    # ------------------------------------------------------------------ numpy

    def forward_np(self, c: np.ndarray) -> np.ndarray:
        """Synthesis W: wavelet coefficients -> nodal (hat) values, axis 0."""
        v = np.zeros_like(c)
        v[self.root_idx] = _bcast(self.root_s, c.ndim) * c[self.root_idx]
        for lev in self.levels:
            interp = 0.5 * (v[lev.pl] + v[lev.pr])
            t = _bcast(lev.s, c.ndim) * c[lev.idx]
            np.add.at(v, lev.pl, _bcast(lev.wl, c.ndim) * t)
            np.add.at(v, lev.pr, _bcast(lev.wr, c.ndim) * t)
            v[lev.idx] = t + interp
        return v

    def adjoint_np(self, v: np.ndarray) -> np.ndarray:
        """Transpose W': nodal-value layout -> wavelet-coefficient layout."""
        y = np.array(v, copy=True)
        for lev in reversed(self.levels):
            t = y[lev.idx].copy()
            pv_l = y[lev.pl].copy()
            pv_r = y[lev.pr].copy()
            np.add.at(y, lev.pl, 0.5 * t)
            np.add.at(y, lev.pr, 0.5 * t)
            y[lev.idx] = _bcast(lev.s, v.ndim) * (
                t + _bcast(lev.wl, v.ndim) * pv_l + _bcast(lev.wr, v.ndim) * pv_r
            )
        y[self.root_idx] = _bcast(self.root_s, v.ndim) * y[self.root_idx]
        return y

    def dense(self) -> np.ndarray:
        """Dense (N+1)x(N+1) synthesis matrix (tests / small problems only)."""
        n = self.grid.num_nodes
        return self.forward_np(np.eye(n))

    # -------------------------------------------------------------------- jax
    #
    # Two device paths:
    #  * forward/adjoint — index arrays baked in as literals (large
    #    constants inside the jitted loop's HLO).  Use only in tests.
    #  * forward_jax/adjoint_jax(x, wp) — the solver path.  ``wp`` is the
    #    pytree from ``jax_params``: all float weights are runtime arguments,
    #    and on uniform dyadic grids every level op is a static STRIDED SLICE
    #    (no gathers at all); graded grids use gathers whose index arrays are
    #    also passed as runtime arguments.

    @property
    def is_uniform(self) -> bool:
        """True iff the grid is the full uniform dyadic grid (N = 2^J)."""
        N = self.grid.num_intervals
        J = self.num_levels
        if N != (1 << J):
            return False
        for j, lev in enumerate(self.levels, start=1):
            s = N >> j
            if not (
                np.array_equal(lev.idx, np.arange(s, N, 2 * s))
                and np.array_equal(lev.pl, lev.idx - s)
                and np.array_equal(lev.pr, lev.idx + s)
            ):
                return False
        return True

    # Above this many time nodes the dense-W GEMM's O(N² m) FLOPs overtake
    # the O(N m log N) lifting's ~40 memory passes (crossover on the GPU
    # not measured).
    _DENSE_MAX_NODES = 1025

    def _use_dense(self, dtype) -> bool:
        import jax.numpy as jnp

        return (
            jnp.dtype(dtype) != jnp.dtype(jnp.float64)
            and self.grid.num_nodes <= self._DENSE_MAX_NODES
        )

    def jax_params(self, dtype):
        """Device pytree of transform arrays, to be passed through jit.

        For f32 and moderate N the whole transform is shipped as the dense
        (N+1)² synthesis matrix: W and W' then apply as single GEMMs (~2
        memory passes) instead of J levels of strided full-array updates
        (~40 passes). The f64
        parity path keeps the lifting form, whose rounding matches the
        NumPy oracle's operation order.
        """
        import jax.numpy as jnp

        if self._use_dense(dtype):
            Wd = self.dense()
            return {"Wd": jnp.asarray(Wd, dtype), "WdT": jnp.asarray(Wd.T, dtype)}
        return self._lifting_params(dtype, gather=not self.is_uniform)

    def _lifting_params(self, dtype, gather: bool):
        """Lifting-form wp: per-level weight columns, plus gather index
        arrays and the root scaling column when ``gather`` (every array a
        runtime argument — no closed-over device constants, CLAUDE.md)."""
        import jax.numpy as jnp

        levels = []
        for lev in self.levels:
            d = {
                "wl": jnp.asarray(lev.wl[:, None], dtype),
                "wr": jnp.asarray(lev.wr[:, None], dtype),
                "s": jnp.asarray(lev.s[:, None], dtype),
            }
            if gather:
                d["idx"] = jnp.asarray(lev.idx)
                d["pl"] = jnp.asarray(lev.pl)
                d["pr"] = jnp.asarray(lev.pr)
            levels.append(d)
        out = {"levels": levels}
        if gather:
            out["root_idx"] = jnp.asarray(self.root_idx)
            out["root_s"] = jnp.asarray(self.root_s[:, None], dtype)
        return out

    def _stride_slices(self, j: int):
        N = self.grid.num_intervals
        s = N >> j
        mid = slice(s, N, 2 * s)
        left = slice(0, N - 2 * s + 1, 2 * s)
        right = slice(2 * s, N + 1, 2 * s)
        return mid, left, right

    @staticmethod
    def _gemm_axis0(Wmat, x):
        """W @ x along axis 0 of (N+1, …) at full f32 accuracy (reduced-
        precision bf16/TF32 passes would perturb the preconditioner by
        ~1e-3).

        dot_general on the ORIGINAL layout, never a flattening reshape,
        so no relayout copy of the grid axes is ever forced."""
        import jax

        return jax.lax.dot_general(
            Wmat, x, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )

    def forward_jax(self, c, wp):
        """Synthesis W along axis 0; solver path (see class jax notes)."""
        import jax.numpy as jnp

        if "Wd" in wp:
            return self._gemm_axis0(wp["Wd"], c)
        r = lambda a: a.reshape(a.shape[:1] + (1,) * (c.ndim - 1))
        v = jnp.zeros_like(c)
        if "root_idx" not in wp:  # uniform grid: static strided slices
            N = self.grid.num_intervals
            v = v.at[0].set(float(self.root_s[0]) * c[0])
            v = v.at[N].set(float(self.root_s[1]) * c[N])
            for j, lw in enumerate(wp["levels"], start=1):
                mid, left, right = self._stride_slices(j)
                t = r(lw["s"]) * c[mid]
                interp = 0.5 * (v[left] + v[right])
                v = v.at[left].add(r(lw["wl"]) * t)
                v = v.at[right].add(r(lw["wr"]) * t)
                v = v.at[mid].set(t + interp)
            return v
        ridx = wp["root_idx"]
        v = v.at[ridx].set(r(wp["root_s"]) * c[ridx])
        for lw in wp["levels"]:
            t = r(lw["s"]) * c[lw["idx"]]
            interp = 0.5 * (v[lw["pl"]] + v[lw["pr"]])
            v = v.at[lw["pl"]].add(r(lw["wl"]) * t)
            v = v.at[lw["pr"]].add(r(lw["wr"]) * t)
            v = v.at[lw["idx"]].set(t + interp)
        return v

    def adjoint_jax(self, x, wp):
        """Transpose W' along axis 0; solver path (see class jax notes)."""
        import jax.numpy as jnp

        if "WdT" in wp:
            return self._gemm_axis0(wp["WdT"], x)
        r = lambda a: a.reshape(a.shape[:1] + (1,) * (x.ndim - 1))
        y = jnp.asarray(x)
        if "root_idx" not in wp:  # uniform grid: static strided slices
            N = self.grid.num_intervals
            for j in range(self.num_levels, 0, -1):
                lw = wp["levels"][j - 1]
                mid, left, right = self._stride_slices(j)
                t = y[mid]
                a = y[left]
                b = y[right]
                y = y.at[left].add(0.5 * t)
                y = y.at[right].add(0.5 * t)
                y = y.at[mid].set(r(lw["s"]) * (t + r(lw["wl"]) * a + r(lw["wr"]) * b))
            y = y.at[0].multiply(float(self.root_s[0]))
            y = y.at[N].multiply(float(self.root_s[1]))
            return y
        for lw in reversed(wp["levels"]):
            t = y[lw["idx"]]
            a = y[lw["pl"]]
            b = y[lw["pr"]]
            y = y.at[lw["pl"]].add(0.5 * t)
            y = y.at[lw["pr"]].add(0.5 * t)
            y = y.at[lw["idx"]].set(r(lw["s"]) * (t + r(lw["wl"]) * a + r(lw["wr"]) * b))
        ridx = wp["root_idx"]
        y = y.at[ridx].multiply(r(wp["root_s"]))
        return y

    def forward(self, c):
        """JAX synthesis W along axis 0 of ``c`` ((N+1,) or (N+1, m)) —
        the gather form of forward_jax with a literal wp (tests only; see
        the class jax notes)."""
        return self.forward_jax(c, self._lifting_params(c.dtype, gather=True))

    def adjoint(self, x):
        """JAX transpose W' along axis 0 (literal-wp gather form of
        adjoint_jax; tests only)."""
        return self.adjoint_jax(x, self._lifting_params(x.dtype, gather=True))


def _bcast(a: np.ndarray, ndim: int):
    return a.reshape(a.shape + (1,) * (ndim - 1))


def _hat_integrals(t_sorted: np.ndarray) -> np.ndarray:
    """∫ sigma_i for hats on the sorted grid: (d_left + d_right) / 2."""
    d = np.diff(t_sorted)
    out = np.zeros_like(t_sorted)
    out[:-1] += d / 2.0
    out[1:] += d / 2.0
    return out


def _pw_linear_norms(t_loc: np.ndarray, v_loc: np.ndarray) -> tuple[float, float]:
    """(L2 norm^2, H1 seminorm^2) of the pw-linear function with nodal values
    ``v_loc`` at sorted nodes ``t_loc`` (zero outside)."""
    d = np.diff(t_loc)
    a, b = v_loc[:-1], v_loc[1:]
    l2 = np.sum(d / 3.0 * (a * a + a * b + b * b))
    h1 = np.sum((b - a) ** 2 / d)
    return float(l2), float(h1)


def build_wavelet_transform(grid: TimeGrid) -> WaveletTransform:
    """Precompute the transform structure for a (possibly locally refined)
    dyadic time grid."""
    t = grid.t
    nlev = grid.max_level
    N1 = grid.num_nodes
    node_omega = np.zeros(N1)

    # Level 0: the two hats on the coarsest grid {0, T}.
    root_idx = np.flatnonzero(grid.level == 0).astype(np.int32)
    assert root_idx.size == 2
    T = t[-1] - t[0]
    l2_root = T / 3.0
    root_s = np.full(2, 1.0 / np.sqrt(l2_root))
    node_omega[root_idx] = root_s * np.sqrt(1.0 / T)

    levels = []
    for j in range(1, nlev + 1):
        present = np.flatnonzero(grid.level <= j)  # already time-sorted
        pos = {int(k): i for i, k in enumerate(present)}
        idx = np.flatnonzero(grid.level == j).astype(np.int32)
        pl = grid.parent_left[idx].astype(np.int32)
        pr = grid.parent_right[idx].astype(np.int32)
        t_present = t[present]
        integ = _hat_integrals(t_present)

        wl = np.empty(idx.size)
        wr = np.empty(idx.size)
        s = np.empty(idx.size)
        for a, (k, l, r) in enumerate(zip(idx, pl, pr)):
            p_k, p_l, p_r = pos[int(k)], pos[int(l)], pos[int(r)]
            assert p_l == p_k - 1 and p_r == p_k + 1, "parents must be grid neighbors"
            wl[a] = -integ[p_k] / (2.0 * integ[p_l])
            wr[a] = -integ[p_k] / (2.0 * integ[p_r])
            # Local support of psi on the level-j grid: [pl-1, pl, k, pr, pr+1].
            lo = max(p_l - 1, 0)
            hi = min(p_r + 1, present.size - 1)
            t_loc = t_present[lo : hi + 1]
            v_loc = np.zeros(t_loc.size)
            v_loc[p_l - lo] = wl[a]
            v_loc[p_k - lo] = 1.0
            v_loc[p_r - lo] = wr[a]
            l2, h1 = _pw_linear_norms(t_loc, v_loc)
            s[a] = 1.0 / np.sqrt(l2)
            node_omega[k] = np.sqrt(h1 / l2)
        levels.append(_Level(idx, pl, pr, wl, wr, s))

    level_shift = np.zeros(nlev + 1)
    for j in range(nlev + 1):
        omj = node_omega[grid.level == j]
        level_shift[j] = float(np.median(omj)) if omj.size else 0.0

    perm = np.argsort(grid.level, kind="stable").astype(np.int32)
    counts = np.bincount(grid.level, minlength=nlev + 1).astype(np.int32)
    return WaveletTransform(
        grid=grid,
        levels=tuple(levels),
        root_idx=root_idx,
        root_s=root_s,
        node_level=grid.level.copy(),
        node_omega=node_omega,
        level_shift=level_shift,
        perm_by_level=perm,
        level_counts=counts,
    )
