"""Geometric multigrid for the shifted spatial operators (A_x + ω M_x).

The scale-phase inner solver (SURVEY.md §7.1): dense precomputed inverses are
exact but O(m²) memory — fine for parity configs (m ≤ ~4k), impossible at
cfg2+ (m ≥ 16k). On the structured meshes this framework assembles, geometric
multigrid is the natural replacement:

- hierarchy: unit_square/cube meshes at n, n/2, ..., n_coarse; P1 spaces are
  nested, so per-level re-assembly equals the Galerkin coarse operator
  exactly (A_c = Pᵀ A_f P) — assembly stays the single source of truth;
- transfers: linear interpolation on the structured triangulation =
  static strided-slice scatter/gather (edge midpoints average their two
  edge endpoints, including the SW–NE diagonal edges) — no gathers, no
  scatters; restriction is the exact transpose;
- smoother: Chebyshev–Jacobi on the Gershgorin-bounded upper spectrum of
  D⁻¹(A+ωM) (no eigenvalue estimation needed);
- coarse solve: dense inverse at the coarsest level (tiny), passed through
  the params pytree like every other float array.

Everything is batched over an arbitrary leading (time) axis and jit-safe.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .sparse import DiaMatrix
from .stencil import StencilOperator, row_scale


def _repeat2_pad(X, axis: int):
    """G with G[f] = X[floor(f/2)] along ``axis`` (size n -> 2n+1, the last
    row reading the zero Dirichlet ghost): repeat + zero-pad, no gathers."""
    import jax.numpy as jnp

    G = jnp.repeat(X, 2, axis=axis)
    pad = [(0, 0)] * X.ndim
    pad[axis] = (0, 1)
    return jnp.pad(G, pad)


def _shift1_zero(X, axes, sign: int = 1):
    """X translated by ``sign`` (+1 or -1) along each of ``axes``, zero fill:
    out[f] = X[f - sign]."""
    import jax.numpy as jnp

    pad = [(0, 0)] * X.ndim
    sl = [slice(None)] * X.ndim
    for a in axes:
        pad[a] = (1, 0) if sign > 0 else (0, 1)
        sl[a] = slice(0, X.shape[a]) if sign > 0 else slice(1, X.shape[a] + 1)
    return jnp.pad(X, pad)[tuple(sl)]


def _pairsum(X, axis: int):
    """C[c] = X[2c] + X[2c+1] along ``axis`` (size 2n-1 -> n-1; the final
    odd row belongs to the Dirichlet ghost and is dropped)."""
    sl = [slice(None)] * X.ndim
    sl[axis] = slice(0, X.shape[axis] - 1)
    Xe = X[tuple(sl)]
    shape = list(Xe.shape)
    shape[axis] = shape[axis] // 2
    shape.insert(axis + 1, 2)
    return Xe.reshape(shape).sum(axis=axis + 1)


def _transfer_fast(X, dim: int, *, restrict: bool):
    """Separated form of the P1 transfer: the 3^dim kernel factors exactly as
    K = ½(u^⊗dim + w^⊗dim) with u = [1,1,0], w = [0,1,1] (the two families of
    Kuhn-path corners), and the w-term equals the u-term translated by one
    fine step per axis. So prolongation is an axis-wise repeat (+ one shifted
    add) and restriction an axis-wise pair-sum — pure elementwise/reshape
    passes that XLA fuses into few loops (the C=1 conv form does not)."""
    axes = tuple(range(X.ndim - dim, X.ndim))
    if restrict:
        H = X + _shift1_zero(X, axes, sign=-1)
        for a in axes:
            H = _pairsum(H, a)
        return 0.5 * H
    G = X
    for a in axes:
        G = _repeat2_pad(G, a)
    return 0.5 * (G + _shift1_zero(G, axes))


def _interp2d(C, nc: int):
    """Prolong coarse (…, nc-1, nc-1) -> fine (…, 2nc-1, 2nc-1)."""
    return _transfer_fast(C, 2, restrict=False)


def _interp2d_scatter(C, nc: int):
    """Reference scatter form of _interp2d (tests)."""
    import jax.numpy as jnp

    n = 2 * nc
    batch = C.shape[:-2]
    F = jnp.zeros(batch + (n - 1, n - 1), C.dtype)
    pad = [(0, 0)] * len(batch) + [(1, 1), (1, 1)]
    Cp = jnp.pad(C, pad)
    F = F.at[..., 1::2, 1::2].set(C)
    F = F.at[..., 0::2, 1::2].set(0.5 * (Cp[..., :-1, 1:-1] + Cp[..., 1:, 1:-1]))
    F = F.at[..., 1::2, 0::2].set(0.5 * (Cp[..., 1:-1, :-1] + Cp[..., 1:-1, 1:]))
    F = F.at[..., 0::2, 0::2].set(0.5 * (Cp[..., :-1, :-1] + Cp[..., 1:, 1:]))
    return F


def _restrict2d(F, nc: int):
    """Restriction = interpolation transpose: (…, 2nc-1, 2nc-1) -> (…, nc-1, nc-1)."""
    return _transfer_fast(F, 2, restrict=True)


def _restrict2d_slices(F, nc: int):
    """Reference strided-slice form of _restrict2d (tests)."""
    C = F[..., 1::2, 1::2]
    up = F[..., 0::2, 1::2]
    C = C + 0.5 * (up[..., :-1, :] + up[..., 1:, :])
    lr = F[..., 1::2, 0::2]
    C = C + 0.5 * (lr[..., :, :-1] + lr[..., :, 1:])
    dg = F[..., 0::2, 0::2]
    C = C + 0.5 * (dg[..., :-1, :-1] + dg[..., 1:, 1:])
    return C


def _interp3d(C, nc: int):
    """Prolong coarse (…, (nc-1,)*3) -> fine (…, (2nc-1,)*3) on the Kuhn mesh.

    Fine nodes sit at coarse nodes, edge midpoints of axis edges, face
    diagonals (x+y, y+z, x+z with positive orientation), and the cube
    diagonal (x+y+z) — each averages its two coarse edge endpoints.
    """
    return _transfer_fast(C, 3, restrict=False)


def _interp3d_scatter(C, nc: int):
    """Reference scatter form of _interp3d (tests; scatters are slow)."""
    import jax.numpy as jnp

    n = 2 * nc
    batch = C.shape[:-3]
    F = jnp.zeros(batch + (n - 1,) * 3, C.dtype)
    pad = [(0, 0)] * len(batch) + [(1, 1)] * 3
    Cp = jnp.pad(C, pad)
    o = slice(1, None, 2)  # odd fine index = coarse node position
    e = slice(0, None, 2)  # even fine index = midpoint layer
    lo = slice(None, -1)
    hi = slice(1, None)
    mid = slice(1, -1)
    F = F.at[..., o, o, o].set(C)
    # axis-edge midpoints
    F = F.at[..., e, o, o].set(0.5 * (Cp[..., lo, mid, mid] + Cp[..., hi, mid, mid]))
    F = F.at[..., o, e, o].set(0.5 * (Cp[..., mid, lo, mid] + Cp[..., mid, hi, mid]))
    F = F.at[..., o, o, e].set(0.5 * (Cp[..., mid, mid, lo] + Cp[..., mid, mid, hi]))
    # face-diagonal midpoints (positive orientation pairs)
    F = F.at[..., e, e, o].set(0.5 * (Cp[..., lo, lo, mid] + Cp[..., hi, hi, mid]))
    F = F.at[..., o, e, e].set(0.5 * (Cp[..., mid, lo, lo] + Cp[..., mid, hi, hi]))
    F = F.at[..., e, o, e].set(0.5 * (Cp[..., lo, mid, lo] + Cp[..., hi, mid, hi]))
    # cube-diagonal midpoints
    F = F.at[..., e, e, e].set(0.5 * (Cp[..., lo, lo, lo] + Cp[..., hi, hi, hi]))
    return F


def _restrict3d(F, nc: int):
    """Restriction = interpolation transpose (conv form)."""
    return _transfer_fast(F, 3, restrict=True)


def _restrict3d_slices(F, nc: int):
    o = slice(1, None, 2)
    e = slice(0, None, 2)
    lo = slice(None, -1)
    hi = slice(1, None)
    C = F[..., o, o, o]
    t = F[..., e, o, o]
    C = C + 0.5 * (t[..., lo, :, :] + t[..., hi, :, :])
    t = F[..., o, e, o]
    C = C + 0.5 * (t[..., :, lo, :] + t[..., :, hi, :])
    t = F[..., o, o, e]
    C = C + 0.5 * (t[..., :, :, lo] + t[..., :, :, hi])
    t = F[..., e, e, o]
    C = C + 0.5 * (t[..., lo, lo, :] + t[..., hi, hi, :])
    t = F[..., o, e, e]
    C = C + 0.5 * (t[..., :, lo, lo] + t[..., :, hi, hi])
    t = F[..., e, o, e]
    C = C + 0.5 * (t[..., lo, :, lo] + t[..., hi, :, hi])
    t = F[..., e, e, e]
    C = C + 0.5 * (t[..., lo, lo, lo] + t[..., hi, hi, hi])
    return C


@dataclasses.dataclass(frozen=True)
class _MGLevel:
    stencil: StencilOperator
    inv_diag: float  # Jacobi scale (center weight is constant on-grid)
    lam_max: float  # Gershgorin bound on lambda_max(D^-1 Op)
    n: int  # cells per side at this level


@dataclasses.dataclass(frozen=True)
class ShiftedMultigrid:
    """V-cycle solver for one shifted operator A + ω M on a mesh family."""

    dim: int
    omega: float
    levels: tuple[_MGLevel, ...]  # fine -> coarse (coarsest excluded)
    nu: int  # pre/post smoothing degree
    n_coarse: int

    @classmethod
    def build(
        cls,
        dim: int,
        n_fine: int,
        omega: float,
        nu: int = 2,
        n_coarse: int = 8,
        _system_cache: dict | None = None,
    ) -> tuple["ShiftedMultigrid", np.ndarray]:
        """Returns (static structure, coarse dense inverse — goes in params)."""
        from ..fem import P1System, unit_cube_mesh, unit_square_mesh

        make = unit_square_mesh if dim == 2 else unit_cube_mesh
        levels = []
        n = n_fine
        while n > n_coarse:
            sys_l = None if _system_cache is None else _system_cache.get(n)
            if sys_l is None:
                sys_l = P1System.from_mesh(make(n))
                if _system_cache is not None:
                    _system_cache[n] = sys_l
            Op = (sys_l.A + omega * sys_l.M).tocsr()
            st = StencilOperator.from_dia(DiaMatrix.from_csr(Op), sys_l.mesh.grid_shape)
            center = dict(zip(st.disps, st.weights))[(0,) * dim]
            gersh = sum(abs(w) for w in st.weights) / center
            levels.append(_MGLevel(st, 1.0 / center, gersh, n))
            n //= 2
        sys_c = None if _system_cache is None else _system_cache.get(n)
        if sys_c is None:
            sys_c = P1System.from_mesh(make(n))
            if _system_cache is not None:
                _system_cache[n] = sys_c
        coarse_inv = np.linalg.inv((sys_c.A + omega * sys_c.M).toarray())
        return cls(dim, omega, tuple(levels), nu, n), coarse_inv

    # ----------------------------------------------------------------- jax

    def _smooth(self, lev: _MGLevel, x, b):
        """Chebyshev–Jacobi smoothing of degree self.nu on the upper spectrum
        [lam_max/4, lam_max] of D⁻¹Op (fourth-kind-free classical recurrence).
        """
        lmax = 1.1 * lev.lam_max
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        # r in D^-1-preconditioned form
        r = lev.inv_diag * (b - self.levels_apply(lev, x))
        d = r / theta
        x = x + d
        for _ in range(self.nu - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - lev.inv_diag * self.levels_apply(lev, d)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x

    @staticmethod
    def levels_apply(lev: _MGLevel, x):
        return lev.stencil.apply(x)

    def _interp(self, C, nc):
        return _interp2d(C, nc) if self.dim == 2 else _interp3d(C, nc)

    def _restrict(self, F, nc):
        return _restrict2d(F, nc) if self.dim == 2 else _restrict3d(F, nc)

    def vcycle(self, b, coarse_inv, lvl: int = 0):
        """One V(nu,nu)-cycle for Op x = b, zero initial guess.

        ``b`` has shape (..., *grid_shape(lvl)); coarse_inv comes from the
        params pytree.
        """
        if lvl == len(self.levels):
            import jax

            sh = b.shape
            m = coarse_inv.shape[0]
            flat = b.reshape(-1, m)
            # HIGHEST: reduced-precision (bf16/TF32) passes would perturb the
            # coarse solve by ~1e-3 and poison the V-cycle (heateq._dot).
            out = jax.numpy.dot(flat, coarse_inv,
                                precision=jax.lax.Precision.HIGHEST)
            return out.reshape(sh)
        lev = self.levels[lvl]
        x = self._smooth(lev, b * 0.0, b)
        r = b - self.levels_apply(lev, x)
        nc = lev.n // 2
        rc = self._restrict(r, nc)
        ec = self.vcycle(rc, coarse_inv, lvl + 1)
        x = x + self._interp(ec, nc)
        x = self._smooth(lev, x, b)
        return x

    def solve(self, b, coarse_inv, cycles: int = 2):
        """``cycles`` V-cycles (fixed count — trace-static, parity-stable)."""
        x = self.vcycle(b, coarse_inv)
        for _ in range(cycles - 1):
            r = b - self.levels_apply(self.levels[0], x)
            x = x + self.vcycle(r, coarse_inv)
        return x


@dataclasses.dataclass(frozen=True)
class _MSLevel:
    A_st: StencilOperator
    M_st: StencilOperator
    cA: float  # center weights (constant on-grid)
    cM: float
    gA: float  # Gershgorin row sums  sum|w|
    gM: float
    n: int


@dataclasses.dataclass(frozen=True)
class MultiShiftMultigrid:
    """One V-cycle structure for ALL shifted operators A + ω_r M at once.

    The wavelet preconditioner needs solves with a different shift ω per
    time row (one per wavelet level). Rather than unrolling one hierarchy
    per shift (9 hierarchies in a typical config — huge compiled graphs,
    poor utilization on thin row subsets), the shift enters as a per-row
    scale: Op(x) = A(x) + ω ⊙ M(x), and the Chebyshev–Jacobi smoother's
    per-row coefficients (Jacobi diagonal, 1/θ, 1/δ from per-row Gershgorin
    bounds) are precomputed host-side as (T, ny_l, 1)-broadcast arrays. One
    V-cycle then smooths every row with its own operator in a single fused
    pass; only the tiny coarsest-level solve distinguishes shifts (per-level
    dense inverses applied on strided row slices).

    With lmin = lmax/4 smoothing range, σ = θ/δ = 5/3 is row-independent,
    so the recurrence scalars stay Python floats.
    """

    dim: int
    levels: tuple[_MSLevel, ...]
    nu: int
    n_coarse: int
    # Post-smoothing degree override (None = nu). CAUTION — asymmetric
    # V(nu, nu_post) cycles make the cycle operator NON-symmetric (the
    # symmetric-V identity needs post = adjoint(pre)), so the PCG
    # preconditioner is no longer SPD. Measured: V(2,1) at >= 2 cycles is
    # benign (3D ladder iteration counts identical, 2D +1), but ONE strongly
    # asymmetric cycle inside K_X (cycles_kx=1, nu=3, nu_post=1) blew the
    # outer solve up 17 -> 69 iterations. Keep symmetric defaults for
    # production; treat this as an experiment knob.
    nu_post: int | None = None

    _SIGMA = 5.0 / 3.0

    @classmethod
    def build(
        cls,
        dim: int,
        n_fine: int,
        nu: int = 2,
        n_coarse: int = 8,
        _system_cache: dict | None = None,
    ) -> tuple["MultiShiftMultigrid", tuple[np.ndarray, np.ndarray]]:
        """Returns (static structure, (A_coarse, M_coarse) dense)."""
        from ..fem import P1System, unit_cube_mesh, unit_square_mesh

        make = unit_square_mesh if dim == 2 else unit_cube_mesh
        levels = []
        n = n_fine
        while n > n_coarse:
            sys_l = None if _system_cache is None else _system_cache.get(n)
            if sys_l is None:
                sys_l = P1System.from_mesh(make(n))
                if _system_cache is not None:
                    _system_cache[n] = sys_l
            gs = sys_l.mesh.grid_shape
            A_st = StencilOperator.from_dia(DiaMatrix.from_csr(sys_l.A), gs)
            M_st = StencilOperator.from_dia(DiaMatrix.from_csr(sys_l.M), gs)
            center = (0,) * dim
            cA = dict(zip(A_st.disps, A_st.weights))[center]
            cM = dict(zip(M_st.disps, M_st.weights))[center]
            gA = sum(abs(w) for w in A_st.weights)
            gM = sum(abs(w) for w in M_st.weights)
            levels.append(_MSLevel(A_st, M_st, cA, cM, gA, gM, n))
            n //= 2
        sys_c = None if _system_cache is None else _system_cache.get(n)
        if sys_c is None:
            sys_c = P1System.from_mesh(make(n))
            if _system_cache is not None:
                _system_cache[n] = sys_c
        return (
            cls(dim, tuple(levels), nu, n),
            (sys_c.A.toarray(), sys_c.M.toarray()),
        )

    # ------------------------------------------------------------- params

    def row_params(self, omega_rows: np.ndarray, dtype) -> list[dict]:
        """Per-level device arrays for a given per-row shift vector
        (host precompute; thread through jit like all float arrays)."""
        out = []
        for lev in self.levels:
            gs_l = (lev.n - 1,) * self.dim
            inv_diag = 1.0 / (lev.cA + omega_rows * lev.cM)
            lam_max = 1.1 * (lev.gA + omega_rows * lev.gM) * inv_diag
            theta = 0.625 * lam_max
            delta = 0.375 * lam_max
            out.append(
                {
                    "omega": row_scale(omega_rows, gs_l, dtype),
                    "inv_diag": row_scale(inv_diag, gs_l, dtype),
                    "inv_theta": row_scale(1.0 / theta, gs_l, dtype),
                    "inv_delta": row_scale(1.0 / delta, gs_l, dtype),
                }
            )
        return out

    # ---------------------------------------------------------------- jax

    def _op(self, lev: _MSLevel, lp, x):
        """A(x) + ω⊙M(x) with the tap loads shared between the two stencils
        and the weights folded into ONE per-row combined weight per pair
        group, (wa + ω·wm)·Σtaps (ops/stencil.pair_groups). Same stencil
        rules as ops/stencil.py: group sums first, one multiply per group,
        center tap unpadded, ω pre-broadcast to (T, *gs[:-1], 1)."""
        import jax.numpy as jnp

        from .stencil import pair_groups, weight_groups

        gs = lev.A_st.grid_shape
        dim = len(gs)
        batch = x.ndim - dim
        center = (0,) * dim
        omega = lp["omega"]
        Up = None
        out = None
        for (wa, wm), ds in pair_groups(
            weight_groups(lev.A_st.disps, lev.A_st.weights),
            weight_groups(lev.M_st.disps, lev.M_st.weights),
        ):
            acc = None
            for disp in ds:
                if disp == center:
                    tap = x
                else:
                    if Up is None:
                        Up = jnp.pad(x, [(0, 0)] * batch + [(1, 1)] * dim)
                    idx = tuple([slice(None)] * batch) + tuple(
                        slice(1 + d, 1 + d + n) for d, n in zip(disp, gs)
                    )
                    tap = Up[idx]
                acc = tap if acc is None else acc + tap
            if wm == 0.0:
                w = wa
            elif wa == 0.0:
                w = omega * wm
            else:
                w = wa + omega * wm
            out = w * acc if out is None else out + w * acc
        return out

    def _smooth(self, lev: _MSLevel, lp, x, b, nu: int | None = None):
        nu = self.nu if nu is None else nu
        sigma = self._SIGMA
        r = lp["inv_diag"] * (b - self._op(lev, lp, x))
        d = r * lp["inv_theta"]
        x = x + d
        rho = 1.0 / sigma
        for _ in range(nu - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - lp["inv_diag"] * self._op(lev, lp, d)
            d = rho_new * rho * d + (2.0 * rho_new) * lp["inv_delta"] * r
            x = x + d
            rho = rho_new
        return x

    def _interp(self, C, nc):
        return _interp2d(C, nc) if self.dim == 2 else _interp3d(C, nc)

    def _restrict(self, F, nc):
        return _restrict2d(F, nc) if self.dim == 2 else _restrict3d(F, nc)

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0):
        if lvl == len(self.levels):
            return coarse_solve(b)
        lev = self.levels[lvl]
        lp = lps[lvl]
        x = self._smooth(lev, lp, b * 0.0, b)
        r = b - self._op(lev, lp, x)
        nc = lev.n // 2
        ec = self.vcycle(self._restrict(r, nc), lps, coarse_solve, lvl + 1)
        x = x + self._interp(ec, nc)
        return self._smooth(lev, lp, x, b, nu=self.nu_post)

    def solve(self, b, lps, coarse_solve, cycles: int = 2):
        x = self.vcycle(b, lps, coarse_solve)
        for _ in range(cycles - 1):
            r = b - self._op(self.levels[0], lps[0], x)
            x = x + self.vcycle(r, lps, coarse_solve)
        return x


def p1_interpolation_matrix(dim: int, nc: int):
    """The nested-P1 interpolation as a sparse matrix over INTERIOR nodes:
    coarse (nc-1)^dim -> fine (2nc-1)^dim on the structured Kuhn meshes.

    Exactly the operator _transfer_fast applies on-device (its transpose is
    the restriction): the 3^dim kernel factors as ½(u^⊗dim + w^⊗dim) with
    1-D factors U[f, f//2] = 1 and W[f, (f-1)//2] = 1 (zero Dirichlet
    ghosts dropped). Used host-side to form Galerkin coarse operators
    A_c = Pᵀ A_f P for coefficient-weighted (non-constant-stencil) forms,
    where per-level re-assembly and RAP coincide only in exact arithmetic
    for resolved coefficients — RAP works from the assembled fine matrix
    alone, no coefficient callables needed."""
    import scipy.sparse as sp

    nf = 2 * nc - 1
    f = np.arange(nf)
    U = sp.csr_matrix(
        (np.ones(nf - 1), (f[f // 2 <= nc - 2], (f // 2)[f // 2 <= nc - 2])),
        shape=(nf, nc - 1),
    )
    g = (f - 1) // 2
    keep = (f >= 1) & (g <= nc - 2)
    W = sp.csr_matrix(
        (np.ones(keep.sum()), (f[keep], g[keep])), shape=(nf, nc - 1)
    )
    Ud, Wd = U, W
    for _ in range(dim - 1):
        Ud = sp.kron(Ud, U, format="csr")
        Wd = sp.kron(Wd, W, format="csr")
    return (0.5 * (Ud + Wd)).tocsr()


def galerkin_coarsen(A, dim: int, nc: int):
    """One Galerkin RAP step A -> Pᵀ A P, symmetrized and pruned of the
    fp-noise entries outside the P1 neighbor pattern (anti-diagonal
    couplings are exactly zero in exact arithmetic for any coefficient —
    hats at anti-diagonal nodes share zero-measure support)."""
    import scipy.sparse as sp

    P = p1_interpolation_matrix(dim, nc)
    Ac = (P.T @ A @ P).tocsr()
    Ac = 0.5 * (Ac + Ac.T)
    Ac.data[np.abs(Ac.data) < 1e-13 * np.abs(Ac.data).max()] = 0.0
    Ac.eliminate_zeros()
    return Ac.tocsr()


@dataclasses.dataclass(frozen=True)
class _GMSLevel:
    A_vs: "VarStencilOperator"  # weighted spatial form: grid-layout taps
    Aw: np.ndarray  # its (ntaps, *gs) weight arrays (host; cast into params)
    kc: int  # index of the center tap in A_vs.disps (Jacobi diagonal)
    M_st: StencilOperator  # plain mass — constant stencil at every level
    cM: float  # its center weight
    dA: np.ndarray  # operator diagonals (m_l,) for Chebyshev bounds
    dM: np.ndarray
    rsA: np.ndarray  # |row| sums (Gershgorin numerators)
    rsM: np.ndarray
    n: int  # cells per side
    gs: tuple[int, ...]  # interior grid shape (n-1,)*dim


@dataclasses.dataclass(frozen=True)
class GalerkinMultiShiftMultigrid:
    """Multi-shift V-cycle for coefficient-weighted spatial forms.

    Same algorithm as :class:`MultiShiftMultigrid` (per-row shifts ω enter
    as scales, one fused smoothing pass for all rows), but the operators are
    NOT translation invariant (variable diffusion/reaction), so:

    - per-level weighted operators are grid-layout variable-coefficient
      stencils (ops/stencil.VarStencilOperator: per-tap WEIGHT ARRAYS in
      the params pytree) — every tap a small-axis shift instead of the
      flat-DIA form's ±n_x offsets.
      The mass matrix stays a constant stencil at every level (Galerkin
      coarsening of the plain mass equals re-assembly exactly);
    - coarse levels come from Galerkin RAP of the assembled fine matrix
      (exact for nested P1), not re-assembly;
    - the Jacobi diagonal is node-dependent: 1/(Aw_center + ω·cM) is formed
      on the fly in the smoother (one elementwise pass, nothing
      materialized per row at setup);
    - per-row Chebyshev bounds use the exact per-ω Gershgorin maximum,
      computed host-side at the few distinct ω values only.

    ``solve`` accepts (..., m_l) flat or (..., *gs) grid layouts (grid
    internally).
    """

    dim: int
    levels: tuple[_GMSLevel, ...]
    nu: int
    n_coarse: int
    nu_post: int | None = None  # see MultiShiftMultigrid.nu_post

    _SIGMA = 5.0 / 3.0

    @classmethod
    def build(
        cls,
        dim: int,
        n_fine: int,
        A_fine,
        M_fine,
        nu: int = 2,
        n_coarse: int = 8,
    ) -> tuple["GalerkinMultiShiftMultigrid", tuple[np.ndarray, np.ndarray]]:
        """``A_fine``/``M_fine``: interior CSR at the finest level (the
        solver's assembled system — single source of truth). Returns
        (static structure, (A_coarse, M_coarse) dense)."""
        import scipy.sparse as sp

        from .stencil import VarStencilOperator

        A = sp.csr_matrix(A_fine)
        M = sp.csr_matrix(M_fine)
        levels = []
        n = n_fine
        while n > n_coarse:
            if n % 2:
                raise ValueError(f"level size {n} not even (n_fine={n_fine})")
            gs = (n - 1,) * dim
            A_vs, Aw = VarStencilOperator.from_dia(DiaMatrix.from_csr(A), gs)
            kc = A_vs.disps.index((0,) * dim)
            M_st = StencilOperator.from_dia(DiaMatrix.from_csr(M), gs)
            cM = dict(zip(M_st.disps, M_st.weights))[(0,) * dim]
            dA = np.asarray(A.diagonal())
            dM = np.asarray(M.diagonal())
            rsA = np.asarray(np.abs(A).sum(axis=1)).ravel()
            rsM = np.asarray(np.abs(M).sum(axis=1)).ravel()
            levels.append(
                _GMSLevel(A_vs, Aw, kc, M_st, cM, dA, dM, rsA, rsM, n, gs)
            )
            A = galerkin_coarsen(A, dim, n // 2)
            M = galerkin_coarsen(M, dim, n // 2)
            n //= 2
        return cls(dim, tuple(levels), nu, n), (A.toarray(), M.toarray())

    # ------------------------------------------------------------- params

    def row_params(self, omega_rows: np.ndarray, dtype) -> list[dict]:
        """Per-level device params for a per-row shift vector: DIA values,
        node diagonal vectors, and per-row Chebyshev scalars (θ, δ from the
        exact Gershgorin bound of D(ω)⁻¹(A+ωM), evaluated at the distinct
        shift values)."""
        import jax.numpy as jnp

        omega_rows = np.asarray(omega_rows, np.float64)
        uniq, inv = np.unique(omega_rows, return_inverse=True)
        out = []
        for lev in self.levels:
            lam_u = np.empty(uniq.size)
            for k, w in enumerate(uniq):
                lam_u[k] = ((lev.rsA + w * lev.rsM) / (lev.dA + w * lev.dM)).max()
            lam = 1.1 * lam_u[inv]
            out.append(
                {
                    "omega": row_scale(omega_rows, lev.gs, dtype),
                    "inv_theta": row_scale(1.0 / (0.625 * lam), lev.gs, dtype),
                    "inv_delta": row_scale(1.0 / (0.375 * lam), lev.gs, dtype),
                    "Aw": jnp.asarray(lev.Aw, dtype),
                }
            )
        return out

    # ---------------------------------------------------------------- jax

    def _op(self, lev: _GMSLevel, lp, x):
        return lev.A_vs.apply(x, lp["Aw"]) + lp["omega"] * lev.M_st.apply(x)

    def _smooth(self, lev: _GMSLevel, lp, x, b, zero_init: bool = False,
                nu: int | None = None):
        nu = self.nu if nu is None else nu
        sigma = self._SIGMA
        invd = 1.0 / (lp["Aw"][lev.kc] + lev.cM * lp["omega"])
        r = invd * (b if zero_init else b - self._op(lev, lp, x))
        d = r * lp["inv_theta"]
        x = d if zero_init else x + d
        rho = 1.0 / sigma
        for _ in range(nu - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - invd * self._op(lev, lp, d)
            d = rho_new * rho * d + (2.0 * rho_new) * lp["inv_delta"] * r
            x = x + d
            rho = rho_new
        return x

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0):
        if lvl == len(self.levels):
            return coarse_solve(b)
        lev = self.levels[lvl]
        lp = lps[lvl]
        x = self._smooth(lev, lp, None, b, zero_init=True)
        r = b - self._op(lev, lp, x)
        rc = _transfer_fast(r, self.dim, restrict=True)
        ec = self.vcycle(rc, lps, coarse_solve, lvl + 1)
        x = x + _transfer_fast(ec, self.dim, restrict=False)
        return self._smooth(lev, lp, x, b, nu=self.nu_post)

    def solve(self, b, lps, coarse_solve, cycles: int = 2):
        """``b``: (..., m) flat or (..., *gs) grid layout; grid internally
        (small-axis shifts — see class docstring), output in b's layout."""
        gs = self.levels[0].gs
        flat_in = b.shape[-len(gs):] != gs
        if flat_in:
            lead = b.shape[:-1]
            b = b.reshape(lead + gs)
        x = self.vcycle(b, lps, coarse_solve)
        for _ in range(cycles - 1):
            r = b - self._op(self.levels[0], lps[0], x)
            x = x + self.vcycle(r, lps, coarse_solve)
        if flat_in:
            x = x.reshape(lead + (-1,))
        return x


def _rap(A, P):
    """Galerkin RAP Pᵀ A P, symmetrized and pruned of fp noise (for nested
    P1 this equals re-assembly on the coarse mesh — verified exactly in
    tests/test_nested_mg.py)."""
    import scipy.sparse as sp  # noqa: F401  (A @ P needs scipy loaded)

    Ac = (P.T @ A @ P).tocsr()
    Ac = 0.5 * (Ac + Ac.T)
    Ac.data[np.abs(Ac.data) < 1e-13 * np.abs(Ac.data).max()] = 0.0
    Ac.eliminate_zeros()
    return Ac


def _ell_rows(P, pad_width: int | None = None):
    """CSR rows → fixed-width (idx, w) gather arrays, zero-weight padded
    (pad index 0 is harmless under weight 0). Vectorized scatter — the
    per-row Python loop cost ~0.3 s of the AMG setup at 195k dofs on the
    1-core host (round-3 profile)."""
    P = P.tocsr()
    n = P.shape[0]
    counts = np.diff(P.indptr)
    K = int(counts.max()) if counts.size else 0
    if pad_width is not None:
        K = pad_width
    K = max(K, 1)
    idx = np.zeros((n, K), np.int32)
    w = np.zeros((n, K), np.float64)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(P.nnz) - np.repeat(P.indptr[:-1], counts)
    idx[rows, pos] = P.indices
    w[rows, pos] = P.data
    return idx, w


@dataclasses.dataclass(frozen=True)
class _NestedLevel:
    offA: tuple[int, ...]
    offM: tuple[int, ...]
    Av: np.ndarray  # (m, ndiagA) host f64 DIA values
    Mv: np.ndarray
    dA: np.ndarray  # (m,) diagonals / |row| sums for Chebyshev bounds
    dM: np.ndarray
    rsA: np.ndarray
    rsM: np.ndarray
    m: int
    Pidx: np.ndarray  # (m, ≤2) prolongation gather (coarse dof ids)
    Pw: np.ndarray
    Ridx: np.ndarray  # (m_c, K) restriction gather (fine dof ids)
    Rw: np.ndarray


@dataclasses.dataclass(frozen=True)
class NestedMultiShiftMultigrid:
    """Multi-shift V-cycle on UNSTRUCTURED nested-refinement hierarchies.

    The scale-phase inner solver for general domains the reference reached
    through NGSolve meshes + splu (SURVEY.md §2 "spatial inner solver"):
    where the mesh records a red-refinement chain (``Mesh.refined_from``,
    built by ``fem.refine_hierarchy``), the P1 spaces are exactly nested, so
    Galerkin RAP through the recorded embedding (``fem.nested_interpolation``)
    equals coarse re-assembly and geometric multigrid applies with NO
    structured-grid assumption. This replaces the Chebyshev polynomial
    inverses (`inner="cheb"`) whose degrees grow like h⁻¹ — measured degree
    935 for the K_Y solve at the L-shape h=1/512 — with a mesh-independent
    V-cycle cost.

    Same algorithm as :class:`MultiShiftMultigrid` (per-row shifts ω enter
    as (T, 1) scales; Chebyshev–Jacobi smoothing with exact per-ω Gershgorin
    bounds), but everything stays in the flat (..., m_l) dof layout:

    - level operators are DIA matvecs (lex-sorted refined meshes keep the
      P1 matrices banded — 11 diagonals at the L-shape, vs 12365 in raw
      refinement order: ``fem.sort_vertices_lex``);
    - transfers are fixed-width gather rows of P (≤2 parents per fine dof)
      and Pᵀ, zero-weight padded;
    - the Jacobi diagonal 1/(dA + ω·dM) is formed on the fly per row.
    """

    levels: tuple[_NestedLevel, ...]
    nu: int
    nu_post: int | None = None  # see MultiShiftMultigrid.nu_post

    _SIGMA = 5.0 / 3.0

    @classmethod
    def build(
        cls,
        fine_mesh,
        A_fine,
        M_fine,
        nu: int = 2,
        m_coarse: int = 1024,
        max_levels: int | None = None,
    ) -> tuple["NestedMultiShiftMultigrid", tuple[np.ndarray, np.ndarray]]:
        """Walk the mesh's ``refined_from`` chain, Galerkin-coarsening the
        assembled fine matrices, until the chain ends or the level is at
        most ``m_coarse`` dofs. Returns (structure, (A_c, M_c) dense for
        the coarsest solve)."""
        import scipy.sparse as sp

        from ..fem.mesh import nested_interpolation

        A = sp.csr_matrix(A_fine)
        M = sp.csr_matrix(M_fine)
        mesh = fine_mesh
        levels = []
        while (
            mesh.refined_from is not None
            and A.shape[0] > m_coarse
            and (max_levels is None or len(levels) < max_levels)
        ):
            P = nested_interpolation(mesh)
            dia_A = DiaMatrix.from_csr(A)
            dia_M = DiaMatrix.from_csr(M)
            Pidx, Pw = _ell_rows(P)
            Ridx, Rw = _ell_rows(P.T.tocsr())
            levels.append(
                _NestedLevel(
                    dia_A.offsets, dia_M.offsets, dia_A.vals, dia_M.vals,
                    np.asarray(A.diagonal()), np.asarray(M.diagonal()),
                    np.asarray(np.abs(A).sum(axis=1)).ravel(),
                    np.asarray(np.abs(M).sum(axis=1)).ravel(),
                    A.shape[0], Pidx, Pw, Ridx, Rw,
                )
            )
            A = _rap(A, P)
            M = _rap(M, P)
            mesh = mesh.refined_from[0]
        if not levels:
            raise ValueError(
                "mesh carries no refinement chain above m_coarse — build it "
                "with fem.refine_hierarchy(base, refines)"
            )
        if A.shape[0] > 8192:
            raise ValueError(
                f"coarsest level still has {A.shape[0]} dofs (> 8192): the "
                "dense coarse inverses would not fit — start from a coarser "
                "base mesh or refine more"
            )
        return cls(tuple(levels), nu), (A.toarray(), M.toarray())

    # ------------------------------------------------------------- params

    def row_params(self, omega_rows: np.ndarray, dtype) -> list[dict]:
        """Per-level device params for a per-row shift vector (exact
        Gershgorin Chebyshev bounds at the distinct shift values)."""
        import jax.numpy as jnp

        omega_rows = np.asarray(omega_rows, np.float64)
        uniq, inv = np.unique(omega_rows, return_inverse=True)
        out = []
        for lev in self.levels:
            lam_u = np.empty(uniq.size)
            for k, w in enumerate(uniq):
                lam_u[k] = ((lev.rsA + w * lev.rsM) / (lev.dA + w * lev.dM)).max()
            lam = 1.1 * lam_u[inv]
            col = lambda v: jnp.asarray(v, dtype)[:, None]
            out.append(
                {
                    "omega": col(omega_rows),
                    "inv_theta": col(1.0 / (0.625 * lam)),
                    "inv_delta": col(1.0 / (0.375 * lam)),
                    "Av": jnp.asarray(lev.Av, dtype),
                    "Mv": jnp.asarray(lev.Mv, dtype),
                    "dA": jnp.asarray(lev.dA, dtype),
                    "dM": jnp.asarray(lev.dM, dtype),
                    "Pidx": jnp.asarray(lev.Pidx),
                    "Pw": jnp.asarray(lev.Pw, dtype),
                    "Ridx": jnp.asarray(lev.Ridx),
                    "Rw": jnp.asarray(lev.Rw, dtype),
                }
            )
        return out

    # ---------------------------------------------------------------- jax

    def _op(self, lev: _NestedLevel, lp, x):
        from .sparse import dia_matvec

        return dia_matvec(lp["Av"], lev.offA, x) + lp["omega"] * dia_matvec(
            lp["Mv"], lev.offM, x
        )

    def _smooth(self, lev: _NestedLevel, lp, x, b, zero_init: bool = False,
                nu: int | None = None):
        nu = self.nu if nu is None else nu
        sigma = self._SIGMA
        invd = 1.0 / (lp["dA"] + lp["omega"] * lp["dM"])
        r = invd * (b if zero_init else b - self._op(lev, lp, x))
        d = r * lp["inv_theta"]
        x = d if zero_init else x + d
        rho = 1.0 / sigma
        for _ in range(nu - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - invd * self._op(lev, lp, d)
            d = rho_new * rho * d + (2.0 * rho_new) * lp["inv_delta"] * r
            x = x + d
            rho = rho_new
        return x

    @staticmethod
    def _gather_apply(w, idx, v):
        """(..., n_src) -> (..., n_dst): Σ_k w[r, k] · v[..., idx[r, k]].

        Unrolled over the (static, small) K columns: K full-width gathers
        that fuse into K passes, instead of the one-shot ``take(v, idx)``
        form's materialized (..., n_dst, K) intermediate."""
        import jax.numpy as jnp

        out = None
        for k in range(idx.shape[-1]):
            term = w[..., k] * jnp.take(v, idx[..., k], axis=-1)
            out = term if out is None else out + term
        return out

    def _restrict(self, r, lp):
        return self._gather_apply(lp["Rw"], lp["Ridx"], r)

    def _interp(self, e, lp):
        return self._gather_apply(lp["Pw"], lp["Pidx"], e)

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0):
        if lvl == len(self.levels):
            return coarse_solve(b)
        lev = self.levels[lvl]
        lp = lps[lvl]
        x = self._smooth(lev, lp, None, b, zero_init=True)
        r = b - self._op(lev, lp, x)
        ec = self.vcycle(self._restrict(r, lp), lps, coarse_solve, lvl + 1)
        x = x + self._interp(ec, lp)
        return self._smooth(lev, lp, x, b, nu=self.nu_post)

    def solve(self, b, lps, coarse_solve, cycles: int = 2):
        """``b``: (..., m) flat dof layout."""
        x = self.vcycle(b, lps, coarse_solve)
        for _ in range(cycles - 1):
            r = b - self._op(self.levels[0], lps[0], x)
            x = x + self.vcycle(r, lps, coarse_solve)
        return x


def _sa_aggregate(A, theta: float):
    """Strength graph + greedy 3-pass aggregation of ``A`` (the aggregation
    core of :func:`sa_prolongator`): returns (agg, n_agg)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    d = np.asarray(A.diagonal())
    C = A.tocoo()
    off = C.row != C.col
    strong = off & (np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col]))
    S = sp.csr_matrix(
        (np.ones(int(strong.sum()), np.int8),
         (C.row[strong], C.col[strong])),
        shape=A.shape,
    )
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    from ..native import sa_aggregate_native

    na = sa_aggregate_native(indptr, indices, agg)
    if na is None:  # no compiler: Python reference (bit-identical output)
        na = 0
        for i in range(n):  # pass 1: roots, fully unaggregated neighborhoods
            nbrs = indices[indptr[i] : indptr[i + 1]]
            if agg[i] == -1 and (agg[nbrs] == -1).all():
                agg[i] = na
                agg[nbrs] = na
                na += 1
        pass1 = agg.copy()
        for i in range(n):  # pass 2: attach stragglers to a pass-1 aggregate
            if pass1[i] != -1:
                continue
            hit = pass1[indices[indptr[i] : indptr[i + 1]]]
            hit = hit[hit != -1]
            if hit.size:
                agg[i] = hit[0]
        for i in range(n):  # pass 3: leftovers form their own aggregates
            if agg[i] != -1:
                continue
            agg[i] = na
            for j in indices[indptr[i] : indptr[i + 1]]:
                if agg[j] == -1:
                    agg[j] = na
            na += 1
    return agg, na


def sa_prolongator(A, theta: float = 0.08, return_parts: bool = False,
                   aggressive: bool = False):
    """Smoothed-aggregation prolongator (Vaněk–Mandel–Brezina) for one
    coarsening step of an SPD operator — the hierarchy builder for meshes
    with NO refinement record (imported files at native resolution), where
    neither the structured-grid nor the nested-refinement geometric
    hierarchies exist (SURVEY.md §2 "spatial inner solver", general-domain
    regime).

    Standard scalar SA: strength graph |a_ij| ≥ θ·√(a_ii·a_jj); greedy
    3-pass aggregation (roots with untouched strong neighborhoods, attach
    stragglers, sweep leftovers); tentative prolongator = the constant
    near-nullspace vector chopped per aggregate (unit columns); one damped-
    Jacobi smoothing step P = (I − ω D⁻¹A)·T with ω = 4/(3·λmax(D⁻¹A)),
    λmax bounded by the Gershgorin row sum (under-relaxing is safe).
    Returns the (n × n_agg) CSR prolongator.

    ``aggressive``: TWO-pass aggregation (aggregate the tentative-contracted
    operator T₁ᵀAT₁ again and compose) — ~coarsening-ratio² per level
    (~36x in 2D vs ~9x standard), one smoothing step on the original A as
    usual. MEASURED DEAD END for the solver (round 4): the coarse space is
    too weak for the multi-shift V-cycles — 12 → 86 PCG iterations at the
    2945-dof L-shape (degree-2 prolongator smoothing recovers only 86 →
    79), far past any cycle-cost saving from the ~4x smaller ELL level it
    was meant to buy (r4_profile_amg1m: coarse ELL gathers are ~75%% of
    the 1.05M-dof AMG V-cycle). Retained at the hierarchy-builder level
    for experiments; deliberately NOT exposed on HeatSolver/CLI.
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    d = np.asarray(A.diagonal())
    agg, na = _sa_aggregate(A, theta)
    if aggressive:
        counts1 = np.bincount(agg, minlength=na).astype(np.float64)
        T1 = sp.csr_matrix(
            (1.0 / np.sqrt(counts1[agg]), (np.arange(n), agg)),
            shape=(n, na),
        )
        A1 = (T1.T @ A @ T1).tocsr()
        agg2, na = _sa_aggregate(A1, theta)
        agg = agg2[agg]
    counts = np.bincount(agg, minlength=na).astype(np.float64)
    T = sp.csr_matrix(
        (1.0 / np.sqrt(counts[agg]), (np.arange(n), agg)), shape=(n, na)
    )
    # λmax(D⁻¹A) by fixed-seed power iteration (measured: the Gershgorin
    # bound over-estimates by ~30% on P1 stiffness graphs, under-damping
    # the prolongator smoother — V-cycle ρ 0.33 → 0.29 with this). The
    # 1.05 margin only shrinks ω slightly if the iteration undershoots.
    DinvA = A.multiply((1.0 / d)[:, None]).tocsr()
    v = np.random.default_rng(1).standard_normal(n)
    for _ in range(25):
        v = DinvA @ v
        v /= np.linalg.norm(v)
    lmax = 1.05 * float(v @ (DinvA @ v))
    P = (T - (4.0 / (3.0 * lmax)) * (DinvA @ T)).tocsr()
    P.data[np.abs(P.data) < 1e-13] = 0.0
    P.eliminate_zeros()
    if return_parts:
        # Factored-transfer ingredients (see _SALevel): P = (I − ωD⁻¹A)·T
        # with T[i, agg[i]] = 1/√count — P·e and Pᵀ·r can then ride ONE
        # banded operator matvec plus K=1 / aggregate-member gathers
        # instead of K-wide unrolled gather passes.
        tw = 1.0 / np.sqrt(counts[agg])
        wd = (4.0 / (3.0 * lmax)) / d
        return P, agg, tw, wd
    return P


@dataclasses.dataclass(frozen=True)
class _SALevel:
    m: int
    fmt: str  # 'dia' | 'ell' level-operator storage
    offA: tuple[int, ...] | None
    offM: tuple[int, ...] | None
    Av: np.ndarray | None  # (m, ndiag) host f64 DIA values
    Mv: np.ndarray | None
    eidx: np.ndarray | None  # (m, K) union-pattern ELL column ids
    ewA: np.ndarray | None  # (m, K) ELL values aligned to eidx
    ewM: np.ndarray | None
    dA: np.ndarray  # (m,) diagonals / |row| sums for Chebyshev bounds
    dM: np.ndarray
    rsA: np.ndarray
    rsM: np.ndarray
    Pidx: np.ndarray  # (m, Kp) prolongation gather (coarse dof ids)
    Pw: np.ndarray
    Ridx: np.ndarray  # (m_c, Kr) restriction gather (fine dof ids)
    Rw: np.ndarray
    # Factored-transfer arrays (P = (I − ωD⁻¹A)·T, see sa_prolongator):
    # present on DIA-format levels, where P·e / Pᵀ·r evaluate as one
    # BANDED A matvec plus a K=1 parent gather / a ≤Kmax member-sum —
    # replacing the Kp/Kr-wide unrolled gather passes (Kr=31 at the
    # 1.05M-dof L-shape fine level).
    agg: np.ndarray | None = None  # (m,) parent aggregate id
    tw: np.ndarray | None = None  # (m,) tentative weight 1/√count
    wd: np.ndarray | None = None  # (m,) ω/diag(A)
    mem_idx: np.ndarray | None = None  # (m_c, Kmax) member fine ids
    mem_w: np.ndarray | None = None  # (m_c, Kmax) 0/1 validity


# Default for SAMultiShiftMultigrid's factored-transfer form (P=(I−ωD⁻¹A)T
# riding the banded matvec vs the K-wide gather form). Same operator to fp
# rounding (tests/test_amg.py). Read ONCE at build() and baked into the
# instance as the ``factored_transfers`` field — flipping the global after
# construction has no effect on existing solvers (each instance carries an
# explicit, inspectable value; A/B runs may also pass
# ``factored_transfers=`` to build() directly).
SA_FACTORED_TRANSFERS = True


@dataclasses.dataclass(frozen=True)
class SAMultiShiftMultigrid(NestedMultiShiftMultigrid):
    """Multi-shift V-cycle on a smoothed-aggregation (algebraic) hierarchy.

    The inner solver for unstructured meshes with NO refinement record —
    imported mesh files at their native resolution — where the Chebyshev
    polynomial inverses are the only alternative and their degrees grow
    like h⁻¹ (measured degree 935 for the K_Y solve at the L-shape
    h=1/512, BASELINE.md). SA needs only the assembled (A, M): coarse
    spaces come from :func:`sa_prolongator` aggregation of A's graph, and
    both operators Galerkin-coarsen through the same P, so the shifted
    operators A_c + ω·M_c are the exact RAP of the fine shifts.

    Same smoother/cycle algorithm as :class:`NestedMultiShiftMultigrid`
    (inherited); only the level construction and the level operator differ:

    - level 0 keeps the lex-sorted fine matrices' DIA form (banded);
    - aggregated coarse operators are NOT banded (aggregate numbering
      scrambles offsets), so coarse levels store the A/M union pattern as
      fixed-width ELL gather rows, sharing one gather of x between the A
      and M applications;
    - transfers are fixed-width gather rows of P and Pᵀ (as in nested mg).
    """

    # Factored-transfer form on DIA levels (baked at build() from the
    # module default SA_FACTORED_TRANSFERS or an explicit build argument;
    # never read from the global inside the jitted cycle).
    factored_transfers: bool = True

    # ~9x (2D) coarsening per level; storage rule below picks DIA only when
    # the diagonal count stays within 4x the nnz footprint.
    _DIA_MAX_WASTE = 4.0

    @classmethod
    def build(
        cls,
        A_fine,
        M_fine,
        nu: int = 2,
        m_coarse: int = 1024,
        theta: float = 0.08,
        max_levels: int | None = None,
        aggressive: int = 0,
        reorder_coarse: bool = False,
        factored_transfers: bool | None = None,
    ) -> tuple["SAMultiShiftMultigrid", tuple[np.ndarray, np.ndarray]]:
        """Aggregate-coarsen (A, M) until ≤ ``m_coarse`` dofs (or until
        aggregation stops making progress). Returns (structure, (A_c, M_c)
        dense for the coarsest solve).

        ``aggressive``: the first N levels use two-pass (composed)
        aggregation — ~4x smaller first coarse level at some iteration
        cost (see sa_prolongator).

        ``reorder_coarse``: renumber each aggregated coarse level by
        reverse Cuthill–McKee of its Galerkin operator's graph (a pure dof
        permutation — operator unchanged up to fp rounding and the
        order-dependent aggregation below). MEASURED NEUTRAL-TO-NEGATIVE
        (round 4, 1.05M-dof L-shape L1, m=175231): the greedy aggregation
        already inherits the fine lex banding — natural order ndiag=1187 /
        bw=790 vs RCM ndiag=1483 / bw=741 — so RCM neither qualifies the
        level for DIA (needs ndiag <= ~36 under the 4x waste rule) nor
        meaningfully improves gather locality. Default OFF; kept for
        ordering experiments."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A_fine)
        M = sp.csr_matrix(M_fine)
        levels = []
        while A.shape[0] > m_coarse and (
            max_levels is None or len(levels) < max_levels
        ):
            P, agg, tw, wd = sa_prolongator(
                A, theta, return_parts=True,
                aggressive=len(levels) < aggressive,
            )
            if P.shape[1] >= A.shape[0]:
                break  # no coarsening progress (pathological graph)
            Ac = _rap(A, P)
            Mc = _rap(M, P)
            if reorder_coarse:
                from scipy.sparse.csgraph import reverse_cuthill_mckee

                perm = np.asarray(
                    reverse_cuthill_mckee(Ac, symmetric_mode=True)
                )
                iperm = np.empty_like(perm)
                iperm[perm] = np.arange(perm.size)
                P = P[:, perm].tocsr()
                agg = iperm[agg]
                Ac = Ac[perm][:, perm].tocsr()
                Mc = Mc[perm][:, perm].tocsr()
            levels.append(
                cls._make_level(A, M, P, first=not levels,
                                parts=(agg, tw, wd))
            )
            A = Ac
            M = Mc
        if not levels:
            raise ValueError(
                f"smoothed aggregation built no levels above m_coarse="
                f"{m_coarse} (m={A.shape[0]})"
            )
        if A.shape[0] > 8192:
            raise ValueError(
                f"coarsest level still has {A.shape[0]} dofs (> 8192): "
                "aggregation stalled — lower theta or raise max_levels"
            )
        ft = (
            SA_FACTORED_TRANSFERS
            if factored_transfers is None else bool(factored_transfers)
        )
        return (
            cls(tuple(levels), nu, factored_transfers=ft),
            (A.toarray(), M.toarray()),
        )

    @classmethod
    def _make_level(cls, A, M, P, first: bool, parts=None) -> _SALevel:
        import scipy.sparse as sp

        m = A.shape[0]
        dia_A = DiaMatrix.from_csr(A)
        dia_M = DiaMatrix.from_csr(M)
        ndiag = max(len(dia_A.offsets), len(dia_M.offsets))
        use_dia = ndiag * m <= cls._DIA_MAX_WASTE * max(A.nnz, M.nnz)
        if use_dia:
            op = dict(offA=dia_A.offsets, offM=dia_M.offsets,
                      Av=dia_A.vals, Mv=dia_M.vals,
                      eidx=None, ewA=None, ewM=None)
        else:
            # Union sparsity pattern so one gather of x serves A and M.
            # _ell_rows of the all-ones pattern returns the validity mask,
            # which zeroes the padded slots (pad id 0 would otherwise pick
            # up the row's column-0 entry).
            patt = ((A != 0) + (M != 0)).tocsr()
            eidx, valid = _ell_rows(
                sp.csr_matrix(
                    (np.ones(patt.nnz), patt.indices, patt.indptr),
                    shape=patt.shape,
                )
            )
            rows = np.arange(m)[:, None]
            dense = lambda W: (
                np.asarray(W.todense()) if sp.issparse(W) else np.asarray(W)
            )
            ewA = dense(A[rows, eidx]) * valid
            ewM = dense(M[rows, eidx]) * valid
            op = dict(offA=None, offM=None, Av=None, Mv=None,
                      eidx=eidx, ewA=ewA, ewM=ewM)
        Pidx, Pw = _ell_rows(P)
        Ridx, Rw = _ell_rows(P.T.tocsr())
        fact: dict = {}
        if parts is not None and use_dia:
            # Factored-transfer arrays (DIA levels only — where the banded
            # A matvec is fast; ELL levels keep the gather transfers).
            agg, tw, wd = parts
            mc = P.shape[1]
            counts = np.bincount(agg, minlength=mc)
            Kmax = max(int(counts.max()), 1)
            order = np.argsort(agg, kind="stable")
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(m) - np.repeat(starts, counts)
            mem_idx = np.zeros((mc, Kmax), np.int32)
            mem_w = np.zeros((mc, Kmax), np.float64)
            mem_idx[agg[order], pos] = order
            mem_w[agg[order], pos] = 1.0
            fact = dict(
                agg=agg.astype(np.int32), tw=tw, wd=wd,
                mem_idx=mem_idx, mem_w=mem_w,
            )
        return _SALevel(
            m=m, fmt="dia" if use_dia else "ell",
            dA=np.asarray(A.diagonal()), dM=np.asarray(M.diagonal()),
            rsA=np.asarray(np.abs(A).sum(axis=1)).ravel(),
            rsM=np.asarray(np.abs(M).sum(axis=1)).ravel(),
            Pidx=Pidx, Pw=Pw, Ridx=Ridx, Rw=Rw, **op, **fact,
        )

    # ------------------------------------------------------------- params

    def row_params(self, omega_rows: np.ndarray, dtype) -> list[dict]:
        """Per-level device params (same Chebyshev-bound derivation as the
        nested hierarchy; operator arrays by level storage format)."""
        import jax.numpy as jnp

        omega_rows = np.asarray(omega_rows, np.float64)
        uniq, inv = np.unique(omega_rows, return_inverse=True)
        out = []
        for lev in self.levels:
            lam_u = np.empty(uniq.size)
            for k, w in enumerate(uniq):
                lam_u[k] = ((lev.rsA + w * lev.rsM) / (lev.dA + w * lev.dM)).max()
            lam = 1.1 * lam_u[inv]
            col = lambda v: jnp.asarray(v, dtype)[:, None]
            lp = {
                "omega": col(omega_rows),
                "inv_theta": col(1.0 / (0.625 * lam)),
                "inv_delta": col(1.0 / (0.375 * lam)),
                "dA": jnp.asarray(lev.dA, dtype),
                "dM": jnp.asarray(lev.dM, dtype),
                "Pidx": jnp.asarray(lev.Pidx),
                "Pw": jnp.asarray(lev.Pw, dtype),
                "Ridx": jnp.asarray(lev.Ridx),
                "Rw": jnp.asarray(lev.Rw, dtype),
            }
            if lev.fmt == "dia":
                lp["Av"] = jnp.asarray(lev.Av, dtype)
                lp["Mv"] = jnp.asarray(lev.Mv, dtype)
                if lev.agg is not None:
                    lp["agg"] = jnp.asarray(lev.agg)
                    lp["tw"] = jnp.asarray(lev.tw, dtype)
                    lp["wd"] = jnp.asarray(lev.wd, dtype)
                    lp["mem_idx"] = jnp.asarray(lev.mem_idx)
                    lp["mem_w"] = jnp.asarray(lev.mem_w, dtype)
            else:
                lp["eidx"] = jnp.asarray(lev.eidx)
                lp["ewA"] = jnp.asarray(lev.ewA, dtype)
                lp["ewM"] = jnp.asarray(lev.ewM, dtype)
            out.append(lp)
        return out

    # ---------------------------------------------------------------- jax

    def _op(self, lev: _SALevel, lp, x):
        if lev.fmt == "dia":
            return NestedMultiShiftMultigrid._op(self, lev, lp, x)
        import jax.numpy as jnp

        # Unrolled over the static ELL width: each take is a full-width
        # gather that serves both A and M (see _gather_apply).
        outA = outM = None
        for k in range(lp["eidx"].shape[-1]):
            g = jnp.take(x, lp["eidx"][..., k], axis=-1)
            tA = lp["ewA"][..., k] * g
            tM = lp["ewM"][..., k] * g
            outA = tA if outA is None else outA + tA
            outM = tM if outM is None else outM + tM
        return outA + lp["omega"] * outM

    # -------------------------------------------- factored transfers (DIA)

    @staticmethod
    def _apply_A_fact(lev: _SALevel, lp, v):
        """Plain stiffness DIA matvec for the factored transfers."""
        from .sparse import dia_matvec

        return dia_matvec(lp["Av"], lev.offA, v)

    def _restrict_fact(self, lev: _SALevel, lp, r):
        """Pᵀ·r = Tᵀ(I − ωAD⁻¹)·r: one banded A matvec + a ≤Kmax
        aggregate-member sum — vs the Kr-wide gather form (Kr=31 at the
        1.05M-dof L-shape fine level)."""
        import jax.numpy as jnp

        u = r - self._apply_A_fact(lev, lp, lp["wd"] * r)
        u = lp["tw"] * u
        out = None
        for k in range(lp["mem_idx"].shape[-1]):
            term = lp["mem_w"][..., k] * jnp.take(
                u, lp["mem_idx"][..., k], axis=-1
            )
            out = term if out is None else out + term
        return out

    def _interp_fact(self, lev: _SALevel, lp, e):
        """P·e = (I − ωD⁻¹A)·T·e: one K=1 parent gather + one banded A
        matvec."""
        import jax.numpy as jnp

        g = lp["tw"] * jnp.take(e, lp["agg"], axis=-1)
        return g - lp["wd"] * self._apply_A_fact(lev, lp, g)

    def vcycle(self, b, lps, coarse_solve, lvl: int = 0):
        if lvl == len(self.levels):
            return coarse_solve(b)
        lev = self.levels[lvl]
        lp = lps[lvl]
        fact = self.factored_transfers and lev.fmt == "dia" and "agg" in lp
        x = self._smooth(lev, lp, None, b, zero_init=True)
        r = b - self._op(lev, lp, x)
        if fact:
            rc = self._restrict_fact(lev, lp, r)
        else:
            rc = self._restrict(r, lp)
        ec = self.vcycle(rc, lps, coarse_solve, lvl + 1)
        if fact:
            x = x + self._interp_fact(lev, lp, ec)
        else:
            x = x + self._interp(ec, lp)
        return self._smooth(lev, lp, x, b, nu=self.nu_post)



def chebyshev_inverse(stencil: StencilOperator, inv_diag: float, lmin: float,
                      lmax: float, degree: int):
    """Return fn(b) ≈ Op⁻¹ b by degree-``degree`` Chebyshev–Jacobi iteration.

    Used for the well-conditioned mass solves (K_H ≈ M_x⁻¹): the spectrum of
    D⁻¹M is h-independent on a structured mesh family, so the bounds are
    calibrated once on a tiny instance. Error factor ≈ 2((√κ-1)/(√κ+1))^d.
    Low degree only (the mass solve uses ~30): see ``chebyshev_generic``'s
    note on large degrees.
    """
    return chebyshev_generic(stencil.apply, inv_diag, lmin, lmax, degree)


def generic_spectral_bounds(
    Op, safety: float = 0.9, known_lmin: float | None = None
) -> tuple[float, float]:
    """(lmin, lmax) of D⁻¹·Op for an arbitrary SPD sparse matrix — the
    calibration step of the generic Chebyshev inner solver (unstructured
    meshes, where no nested grid hierarchy exists for multigrid).

    lmax: Gershgorin row-sum bound (safe upper, cheap) of the symmetrically
    normalized D^-1/2 Op D^-1/2 — callers that already hold |Op| row sums may
    use their own (equally safe) D^-1-scaled bound instead, as the solver's
    shifted-operator derivation does. lmin: smallest eigenvalue of the
    Jacobi-normalized operator via a one-time sparse eigensolve at setup
    (shift-invert Lanczos; LOBPCG fallback), shrunk by ``safety`` so the
    Chebyshev interval certainly covers the spectrum.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    d = np.asarray(Op.diagonal())
    if known_lmin is not None:
        # Caller supplies a certified analytic lower bound — skip the
        # eigensolve (and its splu factorization) entirely. Used for P1
        # mass matrices, where λmin(D⁻¹M) ≥ 1/2 on ANY simplicial mesh in
        # any dimension: M = Σ_e M_e with M_e = c_e(I + 1·1ᵀ) (pencil eigs
        # vs its own diagonal 2c_e·I are {(d+2)/2, 1/2, …, 1/2}), so
        # xᵀMx ≥ ½·xᵀDx elementwise; Dirichlet restriction preserves it
        # (zero-extension argument). Measured λmin at the L-shape n=256:
        # 0.50016 — the bound is tight.
        # The upper bound here is the D⁻¹-scaled Gershgorin row-sum bound
        # (spec(D⁻¹Op) = spec(D^-1/2 Op D^-1/2), and Gershgorin on D⁻¹Op
        # gives max_i rs_i/d_i) — equally safe as B's own row sums but
        # skips building B entirely: on the 1-core/120-MB/s host this
        # branch must not pay two O(nnz) sparse multiplies for a value
        # the production callers discard anyway.
        rs = np.asarray(np.abs(sp.csr_matrix(Op)).sum(axis=1)).ravel()
        return safety * known_lmin, float((rs / d).max())
    s = 1.0 / np.sqrt(d)
    B = sp.csr_matrix(Op).multiply(s[:, None]).multiply(s[None, :]).tocsc()
    gersh = float(np.abs(B).sum(axis=1).max())
    try:
        # Loose ARPACK tolerance: the default (tol=0, machine precision) is
        # pathological on clustered spectra — measured 2881 shift-invert
        # solves (134 s) for the P1 mass matrix at the L-shape n=256, where
        # λmin is not separated from the cluster above it; tol=1e-2 converges
        # in ~2 s. Accuracy is recovered safely below: for symmetric B an
        # eigenvalue lies within ‖Bv−λv‖/‖v‖ of the Ritz value, so backing
        # the estimate off by the residual gives a certified lower bound
        # (underestimating λmin only costs Chebyshev degree).
        # Deterministic start vector: at loose tolerance the Ritz value
        # retains an O(tol) dependence on the start, and ARPACK's default
        # random v0 differs between calls — two solver instances (serial vs
        # sharded) would get different Chebyshev coefficients and residual
        # histories (measured: equality tests fail at rtol 1e-5).
        v0 = np.random.default_rng(0).standard_normal(B.shape[0])
        lam, V = spla.eigsh(B, k=1, sigma=0.0, which="LM", tol=1e-2, v0=v0)
        v = V[:, 0]
        lam = float(lam[0])
        resid = float(
            np.linalg.norm(B @ v - lam * v) / max(np.linalg.norm(v), 1e-300)
        )
        if resid >= 0.5 * lam:
            # The residual back-off only certifies a useful bound when the
            # Ritz pair is reasonably converged; here it is not (loose-tol
            # run on a clustered spectrum). Re-run tighter — tol=1e-4 is
            # still orders cheaper than ARPACK's tol=0 default — warm-
            # started from the loose eigenvector.
            lam, V = spla.eigsh(
                B, k=1, sigma=0.0, which="LM", tol=1e-4, v0=v
            )
            v = V[:, 0]
            lam = float(lam[0])
            resid = float(
                np.linalg.norm(B @ v - lam * v)
                / max(np.linalg.norm(v), 1e-300)
            )
        # lam - resid is a certified lower bound (symmetric eigenvalue
        # perturbation); if even the tight run leaves resid >= lam/2, fall
        # back to the same HEURISTIC floor the LOBPCG path uses — an
        # underestimate costs only Chebyshev degree, and 0.1·lam is far
        # enough below any plausibly-converged Ritz value.
        lmin = lam - resid if resid < 0.5 * lam else 0.1 * lam
    except Exception:
        rng = np.random.default_rng(0)
        X = rng.standard_normal((B.shape[0], 1))
        w, V = spla.lobpcg(B.tocsr(), X, largest=False, maxiter=200, tol=1e-4)
        lam = float(w[0])
        # LOBPCG with a single random block vector may stop unconverged and
        # (approaching from above) OVERestimate lambda_min — which would
        # silently exclude the lowest modes from the Chebyshev interval
        # (|p| > 1 there amplifies instead of inverting). Underestimating
        # only costs polynomial degree, so back the estimate off by the
        # achieved residual norm (an eigenvalue lies within it of lam).
        v = V[:, 0]
        resid = float(
            np.linalg.norm(B @ v - lam * v) / max(np.linalg.norm(v), 1e-300)
        )
        lmin = max(lam - resid, 0.1 * lam)
    if not np.isfinite(lmin) or lmin <= 0.0:
        raise ValueError(
            f"spectral lower-bound estimation failed (lmin={lmin}); the "
            "operator may not be SPD"
        )
    return safety * lmin, gersh


def chebyshev_generic(spmv, inv_diag, lmin: float, lmax: float, degree: int):
    """fn(b) ≈ Op⁻¹ b by Chebyshev–Jacobi iteration for a generic SPD
    operator: ``spmv(x)`` applies Op on (..., m) arrays, ``inv_diag`` is the
    (m,) Jacobi vector (broadcasts over leading axes). Same recurrence as
    ``chebyshev_inverse``; this is a fixed POLYNOMIAL in Op — a linear,
    symmetric approximation of Op⁻¹, which is what keeps the outer normal
    equations SPD (an inner Krylov solve would not be linear).

    The recurrence here is an unrolled Python loop — fine eagerly and for
    the low-degree structured-mesh uses, but NOT for jitting at the large
    degrees the generic scale path reaches (HLO size ∝ degree; see
    CLAUDE.md). The jitted production form is HeatSolver._cheb_run: a
    ``lax.scan`` over ``chebyshev_coefficients`` rows threaded through
    params. Keep the two numerically identical."""

    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def solve(b):
        r = inv_diag * b
        d = r / theta
        x = d
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - inv_diag * spmv(d)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x

    return solve


def chebyshev_coefficients(lmin: float, lmax: float, degree: int) -> np.ndarray:
    """Precompute the data-independent scalar sequence of the Chebyshev
    recurrence: row k = (α_k, β_k) with d ← α_k·d + β_k·r. Shape
    (degree-1, 2). Large-degree polynomials (generic meshes, κ ~ h⁻²) must
    run as a ``lax.scan`` over these rows — unrolling the recurrence in
    Python inflates the HLO by the degree and compiles for minutes."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    out = np.empty((max(degree - 1, 0), 2))
    for k in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        out[k, 0] = rho_new * rho
        out[k, 1] = 2.0 * rho_new / delta
        rho = rho_new
    return out


def chebyshev_degree(lmin: float, lmax: float, eps: float) -> int:
    """Smallest degree with error factor 2·((√κ−1)/(√κ+1))^d ≤ eps."""
    kappa = lmax / lmin
    q = (np.sqrt(kappa) - 1.0) / (np.sqrt(kappa) + 1.0)
    if q <= 0:
        return 1
    return max(1, int(np.ceil(np.log(eps / 2.0) / np.log(q))))


def mass_spectral_bounds(dim: int) -> tuple[float, float]:
    """(lmin, lmax) of D⁻¹M for the structured P1 mass matrix family —
    h-independent, computed exactly on a small instance with safety margin."""
    import scipy.linalg as sla

    from ..fem import P1System, unit_cube_mesh, unit_square_mesh

    sys_s = P1System.from_mesh(
        unit_square_mesh(8) if dim == 2 else unit_cube_mesh(6)
    )
    M = sys_s.M.toarray()
    D = np.diag(M).copy()
    w = sla.eigvalsh(M / np.sqrt(D)[:, None] / np.sqrt(D)[None, :])
    # Upper bound: Gershgorin over interior rows (exact for the family since
    # interior rows repeat); lower: small-instance minimum with margin.
    gersh = float((np.abs(M).sum(axis=1) / D).max())
    return float(0.8 * w[0]), gersh
