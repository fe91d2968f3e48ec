"""Explicit-collectives 2-D ``('time', 'space')`` mesh solver.

Extends the explicit shard_map backend (parallel/explicit.py) with spatial
domain decomposition: the LEADING spatial grid axis is block-sharded over a
second ``space`` mesh axis, with hand-placed one-plane ``ppermute`` halo
exchanges around every stencil application. This is the path past the time
mesh's single-axis capacity (beyond one device's memory per time block,
space must shard); the GSPMD 2-D mesh (parallel/sharded.py) is the
compiler-placed counterpart.

Spatial layout — padded slabs, zero-scale padding discipline
------------------------------------------------------------
With P_s space devices, the fine grid axis gs[0] = n0 is zero-padded to
P_s·Rs, Rs a multiple of 2^D so the first D multigrid levels stay
shard-aligned (level l keeps Rs>>l planes per device, even, so coarse planes
2c+1 never straddle a shard boundary). Padding planes sit past the physical
Dirichlet boundary, so *zeros there emulate the boundary exactly*; the
discipline that keeps them zero:

- every stencil application halo-extends its input by the needed number of
  planes (``ppermute`` neighbours; zero fill at the mesh ends = Dirichlet),
  applies the unmodified local stencil, and crops — so interior planes are
  bitwise what the serial operator computes;
- the Chebyshev–Jacobi smoother's per-plane scale arrays (inv_diag,
  inv_theta, inv_delta) are ZERO on padding planes, which pins every
  smoother update there to exactly 0.0 — V-cycle outputs therefore carry
  zero padding with no masking, so prolongation inputs and PCG dot products
  are automatically exact;
- the few outputs assembled outside a smoother (apply_S, the RHS) get one
  final 0/1 plane mask.

Multigrid: levels 0..D-1 run sharded (halo-exchanged smoother ops and
transfer stages); at level D the slabs are ``all_gather``-ed once per
V-cycle and the remaining coarse levels + coarse solve run replicated per
space shard (the same small-tail redundancy the wavelet transform's coarse
levels accept over the time axis). Time-axis machinery — duplicated halo
rows, wavelet tree, graded/general layouts — is inherited unchanged; dots
psum over BOTH mesh axes.

Supported configs: structured constant-stencil grids (``spatial_format
'stencil'``), inner 'mg' or 'dense', any time layout the 1-D explicit path
serves. No reference file:line cites are possible (the mount is empty —
SURVEY.md §0); the reference has no spatial decomposition at all (space is
replicated per MPI rank, SURVEY.md §2) — this is a stretch extension.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.multigrid import _transfer_fast, mass_spectral_bounds
from ..ops.stencil import row_scale
from ..solver.heateq import _dot
from ..solver.pcg import PCGResult, vdot
from .explicit import ExplicitHeatSolver, shard_map


class Explicit2DHeatSolver(ExplicitHeatSolver):
    """Explicit shard_map solver over a 2-D ``('time', 'space')`` mesh."""

    _mesh_axes = ("time", "space")

    def __init__(self, problem, system, grid, mesh: Mesh, **kwargs):
        super().__init__(problem, system, grid, mesh, **kwargs)
        if self.spatial_format != "stencil":
            raise ValueError(
                "the 2-D explicit mesh serves constant-stencil structured "
                f"grids (got spatial_format={self.spatial_format!r}); "
                "weighted/unstructured systems use the GSPMD 2-D mesh"
            )
        if self.inner not in ("dense", "mg"):
            raise ValueError(
                f"inner={self.inner!r} not supported on the 2-D explicit "
                "mesh (use 'dense' or 'mg')"
            )
        self._dim = len(self.gs)
        if self._dim < 2:
            raise ValueError("spatial sharding needs a >= 2-D grid")
        self.Ps = mesh.shape["space"]
        self._sp_fwd = [(d, d + 1) for d in range(self.Ps - 1)]
        self._sp_bwd = [(d + 1, d) for d in range(self.Ps - 1)]
        n0 = self.gs[0]
        # Sharded multigrid depth: keep a level sharded while it still has
        # >= 4 planes per device globally; below, gather (small-tail
        # redundancy). Rs then divides by 2^D so every sharded level keeps
        # an even plane count per device (coarse alignment).
        if self.inner == "mg":
            Dmax = len(self.msmg.levels)
            D = 0
            while D < Dmax and (self.msmg.levels[D].n - 1) >= 4 * self.Ps:
                D += 1
            self._coarse_ext = self.msmg.levels[-1].n // 2 - 1
        else:
            D = 0
            self._coarse_ext = None
        self._sp_depth = D
        blk = 1 << D
        self.Rs = blk * int(-(-n0 // (self.Ps * blk)))
        self._eparams2_cache: dict = {}
        # The base __init__ binds _spmv_M/_spmv_A as instance attributes
        # (whole-grid closures) — rebind to the halo-exchanged forms.
        self._spmv_M = lambda U, p=None: self._st_apply_sh(
            self._st_ops[0], U
        )
        self._spmv_A = lambda U, p=None: self._st_apply_sh(
            self._st_ops[1], U
        )
        # Structured-mg mass Chebyshev (K_H): the parent's closure applies
        # the global stencil; the sharded twin needs the raw scalars.
        if self.inner == "mg":
            M_st, _ = self._st_ops
            self._minv_center = dict(
                zip(M_st.disps, M_st.weights)
            )[(0,) * self._dim]
            self._minv_bounds = mass_spectral_bounds(self._dim)

    # -------------------------------------------------- spatial collectives

    def _sp_ax(self, X):
        """Index of the sharded (leading spatial) axis in a local array."""
        return X.ndim - self._dim

    def _sp_halo(self, X, k: int = 1):
        """Halo-extend the sharded axis by ``k`` planes per side.
        ``ppermute`` zero-fills the mesh ends — exactly the Dirichlet ghost
        the serial stencils' zero padding provides."""
        ax = self._sp_ax(X)
        n = X.shape[ax]
        left = lax.ppermute(
            lax.slice_in_dim(X, n - k, n, axis=ax), "space", self._sp_fwd
        )
        right = lax.ppermute(
            lax.slice_in_dim(X, 0, k, axis=ax), "space", self._sp_bwd
        )
        return jnp.concatenate([left, X, right], axis=ax)

    def _sp_crop(self, X, k: int = 1):
        ax = self._sp_ax(X)
        return lax.slice_in_dim(X, k, X.shape[ax] - k, axis=ax)

    def _sp_gather(self, X, e: int | None = None):
        """Local slabs -> replicated real planes (axis sliced to ``e``)."""
        ax = self._sp_ax(X)
        G = lax.all_gather(X, "space", axis=ax, tiled=True)
        e = self.gs[0] if e is None else e
        return lax.slice_in_dim(G, 0, e, axis=ax)

    def _sp_scatter(self, Y, Rs: int | None = None):
        """Replicated real planes -> local slabs (padding zero-filled)."""
        ax = self._sp_ax(Y)
        Rs = self.Rs if Rs is None else Rs
        pad = [(0, 0)] * Y.ndim
        pad[ax] = (0, self.Ps * Rs - Y.shape[ax])
        Yp = jnp.pad(Y, pad)
        s = lax.axis_index("space")
        return lax.dynamic_slice_in_dim(Yp, s * Rs, Rs, axis=ax)

    # ----------------------------------------------------- sharded stencils

    def _st_apply_sh(self, st, U):
        """Halo-extended constant-stencil apply: bitwise the serial
        ``StencilOperator.apply`` on every owned plane (same weight-group
        accumulation order on the same tap values)."""
        dim = self._dim
        ax = self._sp_ax(U)
        Ue = self._sp_halo(U, 1)
        gse = tuple(Ue.shape[ax:])
        center = (0,) * dim
        Up = None
        groups: dict[float, list] = {}
        for disp, w in zip(st.disps, st.weights):
            if w == 0.0:
                continue
            if disp == center:
                tap = Ue
            else:
                if Up is None:
                    Up = jnp.pad(Ue, [(0, 0)] * ax + [(1, 1)] * dim)
                idx = tuple([slice(None)] * ax) + tuple(
                    slice(1 + d, 1 + d + n) for d, n in zip(disp, gse)
                )
                tap = Up[idx]
            groups.setdefault(w, []).append(tap)
        out = None
        for w, taps in groups.items():
            acc = taps[0]
            for t in taps[1:]:
                acc = acc + t
            term = w * self._sp_crop(acc, 1)
            out = term if out is None else out + term
        return out

    def _pair_op_sh(self, A_st, M_st, omega, x):
        """A(x) + ω⊙M(x), halo-extended — the sharded twin of
        ``MultiShiftMultigrid._op`` (same pair-group order and arithmetic,
        so histories match the serial solver to reduction rounding)."""
        from ..ops.stencil import pair_groups, weight_groups

        dim = self._dim
        ax = self._sp_ax(x)
        xe = self._sp_halo(x, 1)
        gse = tuple(xe.shape[ax:])
        center = (0,) * dim
        Up = None
        out = None
        for (wa, wm), ds in pair_groups(
            weight_groups(A_st.disps, A_st.weights),
            weight_groups(M_st.disps, M_st.weights),
        ):
            acc = None
            for disp in ds:
                if disp == center:
                    tap = xe
                else:
                    if Up is None:
                        Up = jnp.pad(xe, [(0, 0)] * ax + [(1, 1)] * dim)
                    idx = tuple([slice(None)] * ax) + tuple(
                        slice(1 + d, 1 + d + n) for d, n in zip(disp, gse)
                    )
                    tap = Up[idx]
                acc = tap if acc is None else acc + tap
            acc = self._sp_crop(acc, 1)
            if wm == 0.0:
                w = wa
            elif wa == 0.0:
                w = omega * wm
            else:
                w = wa + omega * wm
            out = w * acc if out is None else out + w * acc
        return out

    # ------------------------------------------------- sharded multigrid

    def _ms_op_sh(self, lvl: int, lp, x):
        lev = self.msmg.levels[lvl]
        return self._pair_op_sh(lev.A_st, lev.M_st, lp["omega"], x)

    def _ms_smooth_sh(self, ms, lvl: int, lp, x, b, nu: int | None = None):
        """Chebyshev–Jacobi smoothing, sharded level: identical recurrence
        to ``MultiShiftMultigrid._smooth``; the per-plane scale arrays are
        zero on padding planes, which keeps every update there exactly 0."""
        nu = ms.nu if nu is None else nu
        sigma = ms._SIGMA
        r = lp["inv_diag"] * (b - self._ms_op_sh(lvl, lp, x))
        d = r * lp["inv_theta"]
        x = x + d
        rho = 1.0 / sigma
        for _ in range(nu - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - lp["inv_diag"] * self._ms_op_sh(lvl, lp, d)
            d = rho_new * rho * d + (2.0 * rho_new) * lp["inv_delta"] * r
            x = x + d
            rho = rho_new
        return x

    def _restrict_sh(self, F):
        """P1 restriction across the sharded axis: one right halo plane,
        then the exact serial transfer on the extended slab (shard offsets
        are even at every sharded level, so local parity == global)."""
        ax = self._sp_ax(F)
        right = lax.ppermute(
            lax.slice_in_dim(F, 0, 1, axis=ax), "space", self._sp_bwd
        )
        Fe = jnp.concatenate([F, right], axis=ax)
        return _transfer_fast(Fe, self._dim, restrict=True)

    def _interp_sh(self, C):
        """P1 prolongation: one left coarse halo plane, serial transfer on
        the extended slab, crop to the owned fine planes."""
        ax = self._sp_ax(C)
        n = C.shape[ax]
        left = lax.ppermute(
            lax.slice_in_dim(C, n - 1, n, axis=ax), "space", self._sp_fwd
        )
        Ce = jnp.concatenate([left, C], axis=ax)
        G = _transfer_fast(Ce, self._dim, restrict=False)
        return lax.slice_in_dim(G, 2, 2 + 2 * n, axis=ax)

    def _ms_vcycle_sh(self, ms, b, lps, coarse_solve, lvl: int):
        if lvl == self._sp_depth:
            if lvl == len(ms.levels):
                bg = self._sp_gather(b, self._coarse_ext)
                out = coarse_solve(bg)
            else:
                bg = self._sp_gather(b, ms.levels[lvl].n - 1)
                out = ms.vcycle(bg, lps, coarse_solve, lvl)
            return self._sp_scatter(out, self.Rs >> lvl)
        lp = lps[lvl]
        x = self._ms_smooth_sh(ms, lvl, lp, b * 0.0, b)
        r = b - self._ms_op_sh(lvl, lp, x)
        ec = self._ms_vcycle_sh(ms, self._restrict_sh(r), lps, coarse_solve,
                                lvl + 1)
        x = x + self._interp_sh(ec)
        return self._ms_smooth_sh(ms, lvl, lp, x, b, nu=ms.nu_post)

    def _ms_solve_sh(self, ms, b, lps, coarse_solve, cycles: int):
        if self._sp_depth == 0:
            # Grid too small to shard the hierarchy: one gather, the whole
            # replicated solve, scatter back (tests / tiny tails).
            bg = self._sp_gather(b)
            return self._sp_scatter(ms.solve(bg, lps, coarse_solve, cycles))
        x = self._ms_vcycle_sh(ms, b, lps, coarse_solve, 0)
        for _ in range(cycles - 1):
            r = b - self._ms_op_sh(0, lps[0], x)
            x = x + self._ms_vcycle_sh(ms, r, lps, coarse_solve, 0)
        return x

    # ------------------------------------------------------------- params

    def _sp_mask_np(self, G: int, e: int) -> np.ndarray:
        m = np.zeros(G)
        m[:e] = 1.0
        return m

    def _sp_ms_params(self, ms, omega_rows: np.ndarray, dtype):
        """Per-level smoother params: sharded levels carry padded
        ``(rows, P_s·Rs_l, 1…)`` arrays ZEROED on padding planes (the
        discipline that keeps V-cycle outputs clean); gathered levels keep
        the serial ``row_scale`` layout, replicated over space."""
        omega_rows = np.asarray(omega_rows, np.float64)
        nrows = omega_rows.shape[0]
        t_only = lambda a: P(*(("time",) + (None,) * (a.ndim - 1)))
        lps, specs = [], []
        for l, lev in enumerate(ms.levels):
            inv_diag = 1.0 / (lev.cA + omega_rows * lev.cM)
            lam = 1.1 * (lev.gA + omega_rows * lev.gM) * inv_diag
            vals = {
                "omega": omega_rows,
                "inv_diag": inv_diag,
                "inv_theta": 1.0 / (0.625 * lam),
                "inv_delta": 1.0 / (0.375 * lam),
            }
            gs_l = (lev.n - 1,) * self._dim
            if l < self._sp_depth:
                Gl = self.Ps * (self.Rs >> l)
                mask = self._sp_mask_np(Gl, lev.n - 1)
                shape = (nrows, Gl) + (1,) * (self._dim - 1)
                mk = lambda v: jnp.asarray(
                    (v[:, None] * mask[None]).reshape(shape), dtype
                )
                lp = {k: mk(v) for k, v in vals.items()}
                sp = {
                    k: P("time", "space", *([None] * (self._dim - 1)))
                    for k in lp
                }
            else:
                lp = {k: row_scale(v, gs_l, dtype) for k, v in vals.items()}
                sp = {k: t_only(v) for k, v in lp.items()}
            lps.append(lp)
            specs.append(sp)
        return lps, specs

    def eparams_for(self, dtype):
        key = jnp.dtype(dtype).name
        if key in self._eparams2_cache:
            return self._eparams2_cache[key]
        ep, es = super().eparams_for(dtype)
        ep, es = dict(ep), dict(es)
        dim = self._dim
        cast = lambda x: jnp.asarray(x, dtype)
        Gs = self.Ps * self.Rs
        gs_pad = (Gs,) + self.gs[1:]
        sp_spec = P("time", "space", *([None] * (dim - 1)))
        mask = self._sp_mask_np(Gs, self.gs[0])
        mcol = mask.reshape((Gs,) + (1,) * (dim - 1))
        ep["sp_mask"] = cast(mcol)
        es["sp_mask"] = P("space", *([None] * (dim - 1)))
        # Per-time-row h scales: padded along the sharded axis (zeroed on
        # padding so B/stab garbage there never grows).
        h = self._host["h"] if self.aligned else self.glay.h_pad
        for name, v in (
            ("h_half", 0.5 * h), ("h_stab", h / 16.0), ("inv_h", 1.0 / h)
        ):
            ep[name] = row_scale(v, gs_pad, dtype) * ep["sp_mask"]
            es[name] = sp_spec
        # Aligned wavelet level weights: (k, 1) -> (k, 1, …) so they
        # broadcast over the grid-layout payload (Rs, gs[1:]).
        wcol = lambda a: a.reshape(a.shape[:1] + (1,) * dim)
        if "w_fine" in ep:
            ep["w_fine"] = [
                {k: wcol(v) for k, v in d.items()} for d in ep["w_fine"]
            ]
            es["w_fine"] = [
                {k: P("time", *([None] * dim)) for k in d}
                for d in ep["w_fine"]
            ]
            ep["w_coarse"] = [
                {k: wcol(v) for k, v in d.items()} for d in ep["w_coarse"]
            ]
            # w_coarse stays replicated: P() matches any rank.
        if self.inner == "mg":
            om_ky = np.zeros(self.Np)
            om_ky[: self.N] = self._host["omega_ky"]
            ep["ms_ky"], es["ms_ky"] = self._sp_ms_params(
                self.msmg, om_ky, dtype
            )
            ep["ms_kx"], es["ms_kx"] = self._sp_ms_params(
                self.msmg, self._dup_rows(self._host["omega_kx"]), dtype
            )
        self._eparams2_cache[key] = (ep, es)
        return ep, es

    # ----------------------------------------------------- local operators

    def _zrow(self, dtype=None):
        # Local-slab zero test row (the base emits the global grid shape).
        return jnp.zeros((1, self.Rs) + self.gs[1:], dtype or self.dtype)

    def _apply_Minv(self, X, p):
        """K_H ≈ M⁻¹ on local slabs: dense inner gathers for the GEMM;
        structured mg runs the same degree-30 Chebyshev as the serial
        closure, with the Jacobi scale zeroed on padding planes."""
        if self.inner == "dense":
            lead = X.shape[: self._sp_ax(X)]
            Xg = self._sp_gather(X)
            flat = Xg.reshape((-1, self.m))
            Y = _dot(flat, p["Minv"]).reshape(lead + self.gs)
            return self._sp_scatter(Y)
        lmin, lmax = self._minv_bounds
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        invd = (1.0 / self._minv_center) * p["sp_mask"]
        r = invd * X
        d = r / theta
        x = d
        rho = 1.0 / sigma
        for _ in range(29):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = r - invd * self._spmv_M(d, p)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x

    def apply_KY(self, V, p=None):
        p = self.params if p is None else p
        if self.inner == "dense":
            lead = V.shape[: self._sp_ax(V)]
            Vg = self._sp_gather(V)
            sol = _dot(Vg.reshape(-1, self.m), p["Kx_inv"])
            sol = self._sp_scatter(sol.reshape(lead + self.gs))
        else:
            def coarse(bc):
                lead = bc.shape[0]
                return _dot(
                    bc.reshape(lead, -1), p["mg_cinv_ky"]
                ).reshape(bc.shape)

            sol = self._ms_solve_sh(
                self.msmg, V, p["ms_ky"], coarse, self.mg_cycles
            )
        return sol * p["inv_h"]

    def _apply_S_local(self, U, ep):
        return super()._apply_S_local(U, ep) * ep["sp_mask"]

    def _apply_KX_local(self, Rr, ep):
        gsl = (self.Rs,) + self.gs[1:]
        C = self._wavelet_adjoint_local(
            Rr.reshape((self.R + 1,) + gsl), ep
        )
        if self.inner == "mg":
            msolve = lambda Z: self._ms_solve_sh(
                self.msmg_kx, Z, ep["ms_kx"],
                lambda bc: self._coarse_by_level_local(bc, ep),
                self.mg_cycles_kx,
            )
            X = msolve(C)
            X = self._spmv_A(X, ep)
            C = msolve(X)

        else:
            Cg = self._sp_gather(C)
            Cf = self._sandwich_local(Cg.reshape(self.R + 1, self.m), ep)
            C = self._sp_scatter(Cf.reshape((self.R + 1,) + self.gs))
        return self._wavelet_forward_local(C, ep).reshape(Rr.shape)

    def _rhs_local(self, gL, gR, u0_vec, ep):
        KYg = self.apply_KY(gL + gR, ep)
        part = self.apply_BT(KYg, ep)
        corr = 0.25 * (gL - gR)
        z = self._zrow(gL.dtype)
        part = part - jnp.concatenate([z, corr]) + jnp.concatenate([corr, z])
        f = self._exchange_boundary(part)
        u0l = self._sp_scatter(u0_vec.reshape((1,) + self.gs))
        f0 = self._spmv_M(self._apply_Minv(u0l, ep), ep)
        mask0 = (lax.axis_index("time") == 0).astype(f.dtype)
        f = f.at[0].add(mask0 * f0[0])
        return f * ep["sp_mask"]

    # -------------------------------------------------------------- dots

    def _dot_local(self, a, b, ep=None):
        if not self.aligned:
            s = vdot(ep["w_dot"] * a, b)
            return lax.psum(s, ("time", "space"))
        s = vdot(a[: self.R], b[: self.R])
        last = (lax.axis_index("time") == self.P - 1).astype(a.dtype)
        return lax.psum(
            s + last * vdot(a[self.R], b[self.R]), ("time", "space")
        )

    def _dot3_local(self, r, z, t, ep=None):
        if not self.aligned:
            w = ep["w_dot"]
            loc = lambda a, b: vdot(w * a, b)
        else:
            last = (lax.axis_index("time") == self.P - 1).astype(r.dtype)
            loc = lambda a, b: (
                vdot(a[: self.R], b[: self.R])
                + last * vdot(a[self.R], b[self.R])
            )
        v = lax.psum(
            jnp.stack([loc(r, z), loc(z, t), loc(r, r)]), ("time", "space")
        )
        return v[0], v[1], v[2]

    # ------------------------------------------------------------- layout

    def _pad_all(self, X):
        """Global (N, *gs) test-row array -> (Np, P_s·Rs, gs[1:]) padded."""
        X = self._pad_tests(X)
        pad = [(0, 0)] * X.ndim
        pad[1] = (0, self.Ps * self.Rs - self.gs[0])
        return jnp.pad(X, pad)

    def _prepare_x0(self, x0):
        gsl = (self.Ps * self.Rs,) + self.gs[1:]
        if x0 is None:
            return jnp.zeros((self.P * (self.R + 1),) + gsl, self.dtype)
        full = np.asarray(x0, self.dtype).reshape(self.N + 1, self.m)
        dup = self._dup_rows(full)
        if not self.aligned:
            dup = dup * self.glay.m_trial[:, None]
        dup = dup.reshape((self.P * (self.R + 1),) + self.gs)
        pad = [(0, 0)] * dup.ndim
        pad[1] = (0, self.Ps * self.Rs - self.gs[0])
        return jnp.asarray(np.pad(dup, pad))

    def _device_iterate_flat(self, U_dev):
        gsl = (self.Ps * self.Rs,) + self.gs[1:]
        U = U_dev.reshape((self.P, self.R + 1) + gsl)
        flat = jnp.concatenate(
            [U[:, : self.R].reshape((-1,) + gsl), U[-1, self.R:]], axis=0
        )
        flat = flat[: self.N + 1, : self.gs[0]]
        return flat.reshape(self.N + 1, self.m)

    # -------------------------------------------------------------- solve

    def _build_solve(self, tol: float, maxiter: int, warm: bool = False):
        ep, es = self.eparams_for(self.dtype)
        gspec = P("time", "space", *([None] * (len(self.gs) - 1)))

        drv = self._pcg_driver()

        def local_run(gL, gR, u0_vec, p, x0):
            f = self._rhs_local(gL, gR, u0_vec, p)
            out = drv(
                lambda U: self._apply_S_local(U, p),
                lambda Rr: self._apply_KX_local(Rr, p),
                f,
                tol,
                maxiter,
                x0=x0 if warm else None,
                **self._dot_kwargs(p),
            )
            tile = lambda x: x[None]
            return (
                out.U,
                tile(out.iterations),
                tile(out.residuals),
                tile(out.precond_residuals),
                tile(out.converged),
            )

        mapped = shard_map(
            local_run,
            mesh=self.mesh,
            in_specs=(gspec, gspec, P(), es, gspec),
            out_specs=(gspec, P("time"), P("time", None), P("time", None),
                       P("time")),
            check_vma=False,
        )
        jitted = jax.jit(
            lambda gL, gR, u0, p, x0: mapped(
                self._pad_all(gL), self._pad_all(gR), u0, p, x0
            ),
            donate_argnums=(0, 1) if self.donate_rhs else (),
        )

        def run(gL, gR, u0_vec, p, x0):
            U, it, res, pres, done = jitted(gL, gR, u0_vec, p, x0)
            return PCGResult(
                U=U, iterations=it[0], residuals=res[0],
                precond_residuals=pres[0], converged=done[0],
            )

        return run

    # -------------------------------------------------- mixed precision

    def _build_refined_jits(self, mode: str, inner_tol: float,
                            inner_maxiter: int):
        """Refinement over the 2-D mesh: same structure as the 1-D path
        (f64 residual legs + f32 inner PCG as shard_map programs; global
        (N+1, m) <-> padded slab conversions at the jit boundary)."""
        _, es64 = self.eparams_for(jnp.float64)
        _, es32 = self.eparams_for(jnp.float32)
        gspec = P("time", "space", *([None] * (len(self.gs) - 1)))
        N, R, nP, gs = self.N, self.R, self.P, self.gs
        gsl = (self.Ps * self.Rs,) + gs[1:]
        dup_idx = self._dup_index
        m_trial = (
            None if self.aligned
            else jnp.asarray(self.glay.m_trial)[:, None]
        )

        def dup(Ug):
            D = Ug.reshape(N + 1, -1)[dup_idx]
            if m_trial is not None:
                D = D * m_trial.astype(D.dtype)
            D = D.reshape((nP * (R + 1),) + gs)
            pad = [(0, 0)] * D.ndim
            pad[1] = (0, gsl[0] - gs[0])
            return jnp.pad(D, pad)

        def flat(Ud):
            return self._device_iterate_flat(Ud).reshape((N + 1,) + gs)

        rhs_local = shard_map(
            lambda gL, gR, u0, p: self._rhs_local(gL, gR, u0, p),
            mesh=self.mesh, in_specs=(gspec, gspec, P(), es64),
            out_specs=gspec, check_vma=False,
        )
        S_local = shard_map(
            lambda U, p: self._apply_S_local(U, p),
            mesh=self.mesh, in_specs=(gspec, es64), out_specs=gspec,
            check_vma=False,
        )
        rhs64 = jax.jit(
            lambda a, b, c, p: flat(
                rhs_local(self._pad_all(a), self._pad_all(b), c, p)
            )
        )
        resid64 = jax.jit(lambda f, u, p: f - flat(S_local(dup(u), p)))

        drv = self._pcg_driver()

        def local_inner(fd, p, tol32):
            out = drv(
                lambda U: self._apply_S_local(U, p),
                lambda Rr: self._apply_KX_local(Rr, p),
                fd, tol32, inner_maxiter, **self._dot_kwargs(p),
            )
            tile = lambda x: x[None]
            return (out.U, tile(out.iterations), tile(out.residuals),
                    tile(out.precond_residuals), tile(out.converged))

        mapped = shard_map(
            local_inner, mesh=self.mesh, in_specs=(gspec, es32, P()),
            out_specs=(gspec, P("time"), P("time", None), P("time", None),
                       P("time")),
            check_vma=False,
        )
        inner_j = jax.jit(
            lambda r32, p, tol32: tuple(
                flat(o) if i == 0 else o
                for i, o in enumerate(mapped(dup(r32), p, tol32))
            )
        )

        def inner(r32, p, tol32):
            U, it, res, pres, done = inner_j(r32, p, tol32)
            return PCGResult(
                U=U, iterations=it[0], residuals=res[0],
                precond_residuals=pres[0], converged=done[0],
            )

        return rhs64, resid64, inner
