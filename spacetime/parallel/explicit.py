"""Explicit-collectives time-sharded solver (shard_map + ppermute/psum).

The GSPMD path (parallel/sharded.py) lets the compiler infer the collectives
from sharding annotations. This module is the manual counterpart — the
JAX analogue of the reference's hand-written MPI communication layer
(SURVEY.md §2: `mpi_vector.py` halo exchange, `mpi_wavelets.py` levelwise
tree comms, Allreduce dots): every transfer is an explicit `lax.ppermute` /
`lax.psum` / `lax.all_gather` placed exactly where the algorithm needs it,
and the per-device program is written against local shards. The
communication schedule is explicit and minimal: per CG iteration, one
boundary-row exchange for Bᵀ+stab (B needs none), two wavelet transforms
(one single-row ppermute pair per fine level + one small all_gather for the
coarse levels), and three psum'd dot products — nearest-neighbour traffic
only; nothing re-shards.

Layout — duplicated halo rows
-----------------------------
With P devices and N = P·R timesteps, device d stores trial-space rows
[dR, dR+R] — R+1 rows, the last duplicating device d+1's first row (the
analogue of an MPI ghost row that is kept permanently valid). Then:

- `B` (trial→test) is fully local: rows dR..dR+R-1 of the output need
  exactly U[dR..dR+R], all on-device.
- `Bᵀ` (test→trial) computed on local test rows yields PARTIAL trial rows:
  slot 0 is missing the contribution of V[dR-1] (on device d-1) and slot R
  is missing V[dR+R] (on device d+1). One bidirectional single-row
  ppermute completes both copies — and both devices add the two
  contributions in the same (left, right) order, so twin rows stay
  bitwise identical. The stabilization jump term and the RHS correction
  have the same structure and ride the same exchange.
- Dot products mask the duplicated slot (counted on the last device only)
  and psum.

Wavelet transform — levelwise with tree communication
-----------------------------------------------------
On the uniform dyadic grid (N = 2^J, P = 2^p), wavelet level j has stride
s = N >> j. For fine levels (s < R) all created nodes are strictly interior
to their shard, parents are at worst the shard-boundary rows, and the level
update is a device-uniform static strided-slice operation plus the same
single-row boundary-increment exchange as Bᵀ. For coarse levels (s ≥ R)
every participating row is a shard-boundary row (a multiple of R): the P+1
boundary rows are all_gather'd once per transform and the coarse levels are
applied redundantly on every device (O(P) rows of work — the log-depth
tail the reference also accepts, SURVEY.md §3.3). Graded time grids are
served by the GSPMD path; this one requires the uniform grid.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..solver.heateq import HeatSolver, _dot
from ..solver.pcg import PCGResult, vdot

shard_map = jax.shard_map


class ExplicitHeatSolver(HeatSolver):
    """HeatSolver over a 1-D ``time`` mesh with hand-placed collectives."""

    supports_chunked = False  # single fused shard_map program only
    _x0_needs_layout = True  # shard_map in_specs need the full dup layout
    _mesh_axes = ("time",)  # the 2-D subclass adds 'space'

    def __init__(self, problem, system, grid, mesh: Mesh, **kwargs):
        if tuple(mesh.axis_names) != self._mesh_axes:
            raise ValueError(
                f"explicit path expects a {self._mesh_axes} mesh, got "
                f"{tuple(mesh.axis_names)}"
            )
        nP = mesh.shape["time"]
        N = grid.num_intervals
        super().__init__(problem, system, grid, **kwargs)
        self.mesh = mesh
        self.P = nP
        # Aligned fast path: uniform dyadic grid, power-of-two device count
        # dividing N_t — every level op is a static strided slice and the
        # coarse wavelet levels ride ONE all_gather (original design).
        # Otherwise the generalized layout (parallel/general_layout.py)
        # serves graded grids, odd device counts, and ragged N_t with
        # per-level padded index arrays + one small all_gather per
        # boundary-crossing level.
        self.aligned = (
            self.wt.is_uniform and nP & (nP - 1) == 0 and N % nP == 0
        )
        if self.aligned:
            self.R = N // nP
            self.p_log = nP.bit_length() - 1
            self.glay = None
        else:
            from .general_layout import build_general_layout

            self.glay = build_general_layout(self.wt, nP)
            self.R = self.glay.R
            self.p_log = None
        self.Np = nP * self.R  # padded test-row count (== N when aligned)
        self.J = self.wt.num_levels
        self._fwd = [(d, d + 1) for d in range(nP - 1)]
        self._bwd = [(d + 1, d) for d in range(nP - 1)]
        self._eparams_cache: dict = {}

    # ------------------------------------------------------------- params

    @property
    def _dup_index(self) -> np.ndarray:
        """Global-row gather index defining the duplicated layout:
        device d owns trial rows [dR, dR+R]. On ragged layouts the
        padding slots are clipped to row N — harmless garbage that every
        consumer masks (general_layout.m_trial) or ignores."""
        idx = (
            np.arange(self.P)[:, None] * self.R + np.arange(self.R + 1)[None]
        ).reshape(-1)
        return np.minimum(idx, self.N)

    def _dup_rows(self, a: np.ndarray) -> np.ndarray:
        """(N+1, ...) per-trial-row data -> duplicated layout (P*(R+1), ...)."""
        return np.asarray(a)[self._dup_index]

    def eparams_for(self, dtype):
        """(global param pytree, matching PartitionSpec pytree). Sharded
        leaves carry their per-device block on axis 0; replicated leaves are
        whole. Cached per dtype like HeatSolver.params_for."""
        key = jnp.dtype(dtype).name
        if key in self._eparams_cache:
            return self._eparams_cache[key]
        from ..ops.stencil import row_scale

        cast = lambda x: jnp.asarray(x, dtype)
        # Padded time steps: identity when aligned; padding entries are 1.0
        # so 1/h stays finite — the test-row mask keeps padding inert.
        h = self._host["h"] if self.aligned else self.glay.h_pad
        t_spec = P(*(("time",) + (None,) * len(self.gs)))
        repl = P()
        ep = {
            "h_half": row_scale(0.5 * h, self.gs, dtype),
            "h_stab": row_scale(h / 16.0, self.gs, dtype),
            "inv_h": row_scale(1.0 / h, self.gs, dtype),
        }
        es = {"h_half": t_spec, "h_stab": t_spec, "inv_h": t_spec}
        if not self.aligned:
            ep["mask_test"] = jnp.asarray(
                self.glay.mask_test, dtype
            ).reshape((self.Np,) + (1,) * len(self.gs))
            es["mask_test"] = t_spec
            ep["w_dot"] = cast(self.glay.w_dot).reshape(
                (self.P * (self.R + 1),) + (1,) * len(self.gs)
            )
            es["w_dot"] = t_spec
        if self.spatial_format == "dia":
            ep["dia_Mv"] = cast(self._dia_host["Mv"])
            ep["dia_Av"] = cast(self._dia_host["Av"])
            es["dia_Mv"] = repl
            es["dia_Av"] = repl

        if self.aligned:
            # Level one-hots for the two boundary slots (their wavelet
            # level is device-dependent, so level selection there is
            # data-driven; interior slots use device-uniform static
            # slices).
            lvl = self.wt.node_level
            n_lvl = self.J + 1
            bnd_lvl = np.stack(
                [lvl[np.arange(self.P) * self.R],
                 lvl[np.arange(self.P) * self.R + self.R]],
                axis=1,
            ).reshape(-1)  # (2P,) levels of slots [0, R] per device
            onehot2 = np.zeros((2 * self.P, n_lvl))
            # Dyadic-grid invariant (relied on by _levelwise_local's
            # coarse-only boundary blend): shard-boundary nodes d*R are odd
            # multiples of N >> j only for j <= log2 P.
            assert bnd_lvl.max() <= self.p_log
            onehot2[np.arange(2 * self.P), bnd_lvl] = 1.0
            ep["onehot2"] = cast(onehot2)
            es["onehot2"] = P("time", None)
        else:
            # Generalized K_X level selection: per-level padded slot
            # arrays covering every valid slot (twin copies included).
            ep["kxl"] = [jnp.asarray(a) for a in self.glay.kx_lvl]
            es["kxl"] = [P("time", None) for _ in self.glay.kx_lvl]

        if self.inner == "dense":
            ep["Kx_inv"] = cast(self._host["Kx_inv"])
            ep["Minv"] = cast(self._host["Minv"])
            ep["sandwich"] = [cast(S) for S in self._host["sandwich"]]
            es["Kx_inv"] = repl
            es["Minv"] = repl
            es["sandwich"] = [repl for _ in ep["sandwich"]]
        elif self.inner == "cheb":
            # Chebyshev polynomial inverses are per-row local (batched SpMV
            # scans) — the coefficient rows and Jacobi vectors replicate.
            pbase = self.params_for(dtype)
            for k in ("cheb_invA", "cheb_invM", "cheb_invS",
                      "cheb_coefA", "cheb_coefM", "cheb_coefS"):
                ep[k] = pbase[k]
                es[k] = jax.tree.map(lambda _: repl, pbase[k])
        else:
            ep["mg_cinv_ky"] = cast(self._host["mg_cinv_ky"])
            ep["mg_cinv"] = [cast(S) for S in self._host["mg_cinv"]]
            es["mg_cinv_ky"] = repl
            es["mg_cinv"] = [repl for _ in ep["mg_cinv"]]
            # Test-row shift vector, padded to the sharded row count
            # (padding shift 0 — those rows are masked zeros anyway).
            om_ky = np.zeros(self.Np)
            om_ky[: self.N] = self._host["omega_ky"]
            ep["ms_ky"] = self.msmg.row_params(om_ky, dtype)
            ep["ms_kx"] = self.msmg.row_params(
                self._dup_rows(self._host["omega_kx"]), dtype
            )
            lvl_spec = lambda d: {k: P(*(("time",) + (None,) * (v.ndim - 1)))
                                  for k, v in d.items()}
            es["ms_ky"] = [lvl_spec(d) for d in ep["ms_ky"]]
            es["ms_kx"] = [lvl_spec(d) for d in ep["ms_kx"]]

        if self.aligned:
            # Wavelet level arrays: fine levels sharded (their node count
            # is a multiple of P), coarse levels replicated (≤ P/2 nodes).
            fine, coarse = [], []
            fine_s, coarse_s = [], []
            for j, lev in enumerate(self.levels_of_wt(), start=1):
                d = {
                    "wl": cast(lev.wl[:, None]),
                    "wr": cast(lev.wr[:, None]),
                    "s": cast(lev.s[:, None]),
                }
                if j > self.p_log:
                    fine.append(d)
                    fine_s.append({k: P("time", None) for k in d})
                else:
                    coarse.append(d)
                    coarse_s.append({k: repl for k in d})
            ep["w_fine"], ep["w_coarse"] = fine, coarse
            es["w_fine"], es["w_coarse"] = fine_s, coarse_s
        else:
            # Generalized wavelet structure (parallel/general_layout.py):
            # per-device padded index/weight arrays sharded over 'time',
            # gathered-node lists replicated.
            shard2 = P("time", None)
            lev_p, lev_s = [], []
            for gl in self.glay.levels:
                d, s = {}, {}
                for k in ("lmid", "lpl", "lpr", "lpl_tgt", "lpr_tgt",
                          "send_v", "send_c", "set_slot", "set_src",
                          "add_slot", "add_src"):
                    d[k] = jnp.asarray(getattr(gl, k))
                    s[k] = shard2
                for k in ("lwl", "lwr", "ls", "lpl_i0", "lpl_iR",
                          "lpr_i0", "lpr_iR"):
                    d[k] = cast(getattr(gl, k))
                    s[k] = shard2
                for k in ("g_mid", "g_pl", "g_pr", "g_c"):
                    d[k] = jnp.asarray(getattr(gl, k))
                    s[k] = repl
                for k in ("g_wl", "g_wr", "g_s"):
                    d[k] = cast(getattr(gl, k))
                    s[k] = repl
                lev_p.append(d)
                lev_s.append(s)
            ep["gw"] = {
                "levels": lev_p,
                "root_slot": jnp.asarray(self.glay.root_slot),
                "root_scale": cast(self.glay.root_scale),
            }
            es["gw"] = {
                "levels": lev_s,
                "root_slot": shard2,
                "root_scale": shard2,
            }
        self._eparams_cache[key] = (ep, es)
        return ep, es

    def levels_of_wt(self):
        return self.wt.levels

    # -------------------------------------------------- local collectives

    def _mask_t(self, X, ep):
        """Zero the padding test rows of the ragged layout (no-op when
        aligned): garbage on those rows would otherwise flow into valid
        trial rows through Bᵀ."""
        m = ep.get("mask_test")
        return X if m is None else X * m

    def _exchange_boundary(self, part):
        """Complete partial trial-row arrays: global row dR = (device d-1's
        slot-R partial) + (device d's slot-0 partial), accumulated in that
        order on both owners so twin rows stay bitwise identical."""
        from_left = lax.ppermute(part[self.R], "time", self._fwd)
        from_right = lax.ppermute(part[0], "time", self._bwd)
        part = part.at[0].set(from_left + part[0])
        return part.at[self.R].set(part[self.R] + from_right)

    def _dot_local(self, a, b, ep=None):
        """Global inner product: every valid row counted exactly once
        (aligned: rows 0..R-1 everywhere + the duplicated slot R on the
        last device; general: the 0/1 weight vector of
        general_layout.w_dot, which also zeroes ragged padding), psum'd
        over the time axis."""
        if not self.aligned:
            s = vdot(ep["w_dot"] * a, b)
            return lax.psum(s, "time")
        s = vdot(a[: self.R], b[: self.R])
        last = (lax.axis_index("time") == self.P - 1).astype(a.dtype)
        return lax.psum(s + last * vdot(a[self.R], b[self.R]), "time")

    def _dot3_local(self, r, z, t, ep=None):
        """The pcg_fused reduction: ((r·z), (z·t), (r·r)) as ONE 3-vector
        psum over the time axis (vs three separate psums for the standard
        driver's dots) — the Allreduce-latency half of the single-reduction
        CG variant; the algebraic half lives in solver/pcg.pcg_fused."""
        if not self.aligned:
            w = ep["w_dot"]
            loc = lambda a, b: vdot(w * a, b)
        else:
            last = (lax.axis_index("time") == self.P - 1).astype(r.dtype)
            loc = lambda a, b: (
                vdot(a[: self.R], b[: self.R])
                + last * vdot(a[self.R], b[self.R])
            )
        v = lax.psum(jnp.stack([loc(r, z), loc(z, t), loc(r, r)]), "time")
        return v[0], v[1], v[2]

    # --------------------------------------------------- wavelet (sharded)

    def _gather_boundary(self, y):
        """(R+1, m) local -> (P+1, m) gathered shard-boundary rows."""
        both = lax.all_gather(y[jnp.array([0, self.R])], "time")  # (P, 2, m)
        return jnp.concatenate([both[:, 0], both[-1:, 1]], axis=0)

    def _scatter_boundary(self, y, G):
        d = lax.axis_index("time")
        y = y.at[0].set(lax.dynamic_index_in_dim(G, d, keepdims=False))
        return y.at[self.R].set(
            lax.dynamic_index_in_dim(G, d + 1, keepdims=False)
        )

    def _fine_slices(self, j: int):
        """Local slot slices of fine level j (device-uniform: dR ≡ 0 mod 2s)."""
        s = self.N >> j
        mid = slice(s, self.R, 2 * s)
        left = slice(0, self.R - 2 * s + 1, 2 * s)
        right = slice(2 * s, self.R + 1, 2 * s)
        left_int = slice(2 * s, self.R - 2 * s + 1, 2 * s)
        right_int = slice(2 * s, self.R, 2 * s)
        return mid, left, right, left_int, right_int

    # ---- generalized transform (graded / odd P / ragged N_t) ----
    # See parallel/general_layout.py for the structure and the twin-row
    # consistency argument. Each level: local phase (padded index arrays,
    # scatter mode='drop', boundary-increment ppermute) + gathered phase
    # (one small all_gather, redundant compute, per-device scatter-back).

    @staticmethod
    def _wcol(a, ndim):
        """(k,) weight row -> (k, 1, ...) broadcastable over grid axes."""
        return a.reshape(a.shape + (1,) * (ndim - 1))

    def _g_exchange_incs(self, v, inc0, incR):
        """Add boundary-slot contributions on both twin copies in the
        same (left, right) order — bitwise twin consistency, mirroring
        the aligned `_exchange_boundary` ordering."""
        recvL = lax.ppermute(incR, "time", self._fwd)
        recvR = lax.ppermute(inc0, "time", self._bwd)
        v = v.at[0].add(recvL + inc0)
        return v.at[self.R].add(incR + recvR)

    def _g_gather(self, rows_list):
        """all_gather the stacked per-device send rows -> flat buffer."""
        stacked = jnp.concatenate(rows_list, axis=0)
        buf = lax.all_gather(stacked, "time")  # (P, k, *tail)
        return buf

    def _wavelet_forward_general(self, C, ep):
        gw = ep["gw"]
        R = self.R
        r = lambda a: self._wcol(a, C.ndim)
        v = jnp.zeros_like(C)
        rs = gw["root_slot"][0]
        v = v.at[rs].set(
            r(gw["root_scale"][0]) * C[jnp.clip(rs, 0, R)], mode="drop"
        )
        for lw, gl in zip(gw["levels"], self.glay.levels):
            nl, ng = gl.n_local, gl.n_gathered
            ns, nc = gl.send_v.shape[1], gl.send_c.shape[1]
            if nl:
                lmid = lw["lmid"][0]
                t = r(lw["ls"][0]) * C[jnp.clip(lmid, 0, R)]
                interp = 0.5 * (v[lw["lpl"][0]] + v[lw["lpr"][0]])
            if ng:
                # Send BEFORE any local update: gathered reads must see the
                # pre-level state, like the serial transform's.
                buf = self._g_gather([v[lw["send_v"][0]], C[lw["send_c"][0]]])
                Gv = buf[:, :ns].reshape((self.P * ns,) + C.shape[1:])
                Gc = buf[:, ns:].reshape((self.P * nc,) + C.shape[1:])
                tg = r(lw["g_s"]) * Gc[lw["g_c"]]
                new_mid = tg + 0.5 * (Gv[lw["g_pl"]] + Gv[lw["g_pr"]])
                adds = jnp.concatenate(
                    [r(lw["g_wl"]) * tg, r(lw["g_wr"]) * tg], axis=0
                )
            if nl:
                cl = r(lw["lwl"][0]) * t
                cr = r(lw["lwr"][0]) * t
                v = v.at[lw["lpl_tgt"][0]].add(cl, mode="drop")
                v = v.at[lw["lpr_tgt"][0]].add(cr, mode="drop")
                inc0 = (r(lw["lpl_i0"][0]) * cl + r(lw["lpr_i0"][0]) * cr).sum(0)
                incR = (r(lw["lpl_iR"][0]) * cl + r(lw["lpr_iR"][0]) * cr).sum(0)
                v = self._g_exchange_incs(v, inc0, incR)
                v = v.at[lmid].set(t + interp, mode="drop")
            if ng:
                v = v.at[lw["set_slot"][0]].set(
                    new_mid[lw["set_src"][0]], mode="drop"
                )
                v = v.at[lw["add_slot"][0]].add(
                    adds[lw["add_src"][0]], mode="drop"
                )
        return v

    def _wavelet_adjoint_general(self, X, ep):
        gw = ep["gw"]
        R = self.R
        r = lambda a: self._wcol(a, X.ndim)
        y = jnp.asarray(X)
        for lw, gl in zip(reversed(gw["levels"]), reversed(self.glay.levels)):
            nl, ng = gl.n_local, gl.n_gathered
            ns = gl.send_v.shape[1]
            if nl:
                lmid = lw["lmid"][0]
                t = y[jnp.clip(lmid, 0, R)]
                a = y[lw["lpl"][0]]
                b = y[lw["lpr"][0]]
            if ng:
                buf = self._g_gather([y[lw["send_v"][0]]])
                Gv = buf.reshape((self.P * ns,) + X.shape[1:])
                tg = Gv[lw["g_mid"]]
                new_mid = r(lw["g_s"]) * (
                    tg
                    + r(lw["g_wl"]) * Gv[lw["g_pl"]]
                    + r(lw["g_wr"]) * Gv[lw["g_pr"]]
                )
                htg = 0.5 * tg
                adds = jnp.concatenate([htg, htg], axis=0)
            if nl:
                ht = 0.5 * t
                y = y.at[lw["lpl_tgt"][0]].add(ht, mode="drop")
                y = y.at[lw["lpr_tgt"][0]].add(ht, mode="drop")
                inc0 = (r(lw["lpl_i0"][0] + lw["lpr_i0"][0]) * ht).sum(0)
                incR = (r(lw["lpl_iR"][0] + lw["lpr_iR"][0]) * ht).sum(0)
                y = self._g_exchange_incs(y, inc0, incR)
                y = y.at[lmid].set(
                    r(lw["ls"][0]) * (t + r(lw["lwl"][0]) * a + r(lw["lwr"][0]) * b),
                    mode="drop",
                )
            if ng:
                y = y.at[lw["set_slot"][0]].set(
                    new_mid[lw["set_src"][0]], mode="drop"
                )
                y = y.at[lw["add_slot"][0]].add(
                    adds[lw["add_src"][0]], mode="drop"
                )
        rs = gw["root_slot"][0]
        return y.at[rs].set(
            r(gw["root_scale"][0]) * y[jnp.clip(rs, 0, R)], mode="drop"
        )

    def _wavelet_forward_local(self, C, ep):
        """Synthesis W on the duplicated local layout ((R+1, m) -> same).
        Mirrors ops/wavelets.forward_jax levelwise; see module docstring for
        the coarse/fine communication split."""
        if not self.aligned:
            return self._wavelet_forward_general(C, ep)
        rs0, rs1 = float(self.wt.root_s[0]), float(self.wt.root_s[1])
        # Coarse phase on the gathered boundary rows (redundant per device).
        G = self._gather_boundary(C)
        Gv = jnp.zeros_like(G)
        Gv = Gv.at[0].set(rs0 * G[0])
        Gv = Gv.at[-1].set(rs1 * G[-1])
        for j in range(1, self.p_log + 1):
            sk = self.P >> j
            mid = slice(sk, self.P, 2 * sk)
            left = slice(0, self.P - 2 * sk + 1, 2 * sk)
            right = slice(2 * sk, self.P + 1, 2 * sk)
            lw = ep["w_coarse"][j - 1]
            t = lw["s"] * G[mid]
            interp = 0.5 * (Gv[left] + Gv[right])
            Gv = Gv.at[left].add(lw["wl"] * t)
            Gv = Gv.at[right].add(lw["wr"] * t)
            Gv = Gv.at[mid].set(t + interp)
        v = jnp.zeros_like(C)
        v = self._scatter_boundary(v, Gv)
        # Fine phase: local strided updates + boundary-increment exchange.
        for j in range(self.p_log + 1, self.J + 1):
            mid, left, right, left_int, right_int = self._fine_slices(j)
            lw = ep["w_fine"][j - self.p_log - 1]
            t = lw["s"] * C[mid]
            interp = 0.5 * (v[left] + v[right])
            incL = lw["wl"] * t
            incR = lw["wr"] * t
            v = v.at[left_int].add(incL[1:])
            v = v.at[right_int].add(incR[:-1])
            recvL = lax.ppermute(incR[-1], "time", self._fwd)
            recvR = lax.ppermute(incL[0], "time", self._bwd)
            v = v.at[0].add(recvL + incL[0])
            v = v.at[self.R].add(incR[-1] + recvR)
            v = v.at[mid].set(t + interp)
        return v

    def _wavelet_adjoint_local(self, X, ep):
        """Transpose W' on the duplicated local layout ((R+1, m) -> same)."""
        if not self.aligned:
            return self._wavelet_adjoint_general(X, ep)
        y = jnp.asarray(X)
        for j in range(self.J, self.p_log, -1):
            mid, left, right, left_int, right_int = self._fine_slices(j)
            lw = ep["w_fine"][j - self.p_log - 1]
            t = y[mid]
            a = y[left]
            b = y[right]
            ht = 0.5 * t
            y = y.at[left_int].add(ht[1:])
            y = y.at[right_int].add(ht[:-1])
            recvL = lax.ppermute(ht[-1], "time", self._fwd)
            recvR = lax.ppermute(ht[0], "time", self._bwd)
            y = y.at[0].add(recvL + ht[0])
            y = y.at[self.R].add(ht[-1] + recvR)
            y = y.at[mid].set(lw["s"] * (t + lw["wl"] * a + lw["wr"] * b))
        G = self._gather_boundary(y)
        for j in range(self.p_log, 0, -1):
            sk = self.P >> j
            mid = slice(sk, self.P, 2 * sk)
            left = slice(0, self.P - 2 * sk + 1, 2 * sk)
            right = slice(2 * sk, self.P + 1, 2 * sk)
            lw = ep["w_coarse"][j - 1]
            t = G[mid]
            a = G[left]
            b = G[right]
            G = G.at[left].add(0.5 * t)
            G = G.at[right].add(0.5 * t)
            G = G.at[mid].set(lw["s"] * (t + lw["wl"] * a + lw["wr"] * b))
        G = G.at[0].multiply(float(self.wt.root_s[0]))
        G = G.at[-1].multiply(float(self.wt.root_s[1]))
        return self._scatter_boundary(y, G)

    # ------------------------------------------------------ operators

    def apply_KY(self, V, p=None):
        p = self.params if p is None else p
        if self.inner != "mg":
            return super().apply_KY(V, p)

        def coarse(bc):
            lead = bc.shape[0]
            return _dot(bc.reshape(lead, -1), p["mg_cinv_ky"]).reshape(bc.shape)

        sol = self.msmg.solve(V, p["ms_ky"], coarse, self.mg_cycles)
        return sol * p["inv_h"]

    def apply_stab(self, U, p=None):
        p = self.params if p is None else p
        if self.aligned:
            return super().apply_stab(U, p)
        D = U[1:] - U[:-1]
        W = self._mask_t(p["h_stab"] * self._spmv_A(D, p), p)
        z = self._zrow(U.dtype)
        return jnp.concatenate([z, W]) - jnp.concatenate([W, z])

    def _apply_S_local(self, U, ep):
        Vt = self.apply_KY(self._mask_t(self.apply_B(U, ep), ep), ep)
        part = self.apply_BT(Vt, ep) + self.apply_stab(U, ep)
        out = self._exchange_boundary(part)
        mask0 = (lax.axis_index("time") == 0).astype(U.dtype)
        return out.at[0].add(mask0 * self._trace_row(U, ep)[0])

    def _levelwise_local(self, flat, ep, apply_rows):
        """Apply a per-wavelet-level row operation ``apply_rows(rows, j)``
        on the duplicated (R+1, k) local layout.

        Aligned: interior slots are device-uniform static strided slices
        carrying exactly the fine levels: global row dR+i (0<i<R) has
        level J - tz(i) > log2 P. The two boundary slots have
        device-dependent COARSE levels (node dR has level
        p_log - tz(d) <= p_log, asserted at setup), so their one-hot
        blend loops coarse levels only.

        General: per-level padded slot arrays (general_layout.kx_lvl)
        cover every valid slot once — twin copies on both devices, so no
        exchange is needed; padding entries scatter with mode='drop'."""
        if not self.aligned:
            out = flat
            for j, idx2 in enumerate(ep["kxl"]):
                idx = idx2[0]
                if idx.shape[0] == 0:
                    continue
                rows = flat[jnp.clip(idx, 0, self.R)]
                out = out.at[idx].set(apply_rows(rows, j), mode="drop")
            return out
        out = flat
        for j in range(self.p_log + 1, self.J + 1):
            s = self.N >> j
            sl = slice(s, self.R, 2 * s)
            out = out.at[sl].set(apply_rows(flat[sl], j))
        b2 = jnp.array([0, self.R])
        rows2 = flat[b2]
        acc = jnp.zeros_like(rows2)
        for j in range(self.p_log + 1):
            acc = acc + ep["onehot2"][:, j : j + 1] * apply_rows(rows2, j)
        return out.at[b2].set(acc)

    def _coarse_by_level_local(self, bc, ep):
        """Multi-shift coarse solve, duplicated layout."""
        flat = bc.reshape(self.R + 1, -1)
        out = self._levelwise_local(
            flat, ep, lambda rows, j: _dot(rows, ep["mg_cinv"][j])
        )
        return out.reshape(bc.shape)

    def _sandwich_local(self, C, ep):
        """K_X middle block, duplicated layout: per-level dense sandwich
        GEMMs (inner 'dense') or Chebyshev shifted-solve scans ('cheb')."""
        if self.inner == "cheb":
            return self._levelwise_local(
                C, ep, lambda rows, j: self._sandwich_rows(rows, j, ep)
            )
        return self._levelwise_local(
            C, ep, lambda rows, j: _dot(rows, ep["sandwich"][j])
        )

    def _apply_KX_local(self, Rr, ep):
        C = self._wavelet_adjoint_local(Rr.reshape(self.R + 1, self.m), ep)
        if self.inner == "mg":
            X = C.reshape((self.R + 1,) + self.gs)
            msolve = lambda Z: self.msmg_kx.solve(
                Z, ep["ms_kx"], lambda bc: self._coarse_by_level_local(bc, ep),
                self.mg_cycles_kx,
            )
            X = msolve(X)
            X = self._spmv_A(X, ep)
            X = msolve(X)
            C = X.reshape(self.R + 1, self.m)
        else:
            C = self._sandwich_local(C, ep)
        return self._wavelet_forward_local(C, ep).reshape(Rr.shape)

    def _rhs_local(self, gL, gR, u0_vec, ep):
        KYg = self.apply_KY(gL + gR, ep)
        part = self.apply_BT(KYg, ep)
        corr = 0.25 * (gL - gR)
        z = self._zrow(gL.dtype)
        part = part - jnp.concatenate([z, corr]) + jnp.concatenate([corr, z])
        f = self._exchange_boundary(part)
        u0g = u0_vec.reshape((1,) + self.gs)
        f0 = self._spmv_M(self._apply_Minv(u0g, ep), ep)
        mask0 = (lax.axis_index("time") == 0).astype(f.dtype)
        return f.at[0].add(mask0 * f0[0])

    # ---------------------------------------------------------- solve

    def _loop_mode(self) -> str:
        if self.loop not in ("auto", "while"):
            raise ValueError("explicit path supports the while-loop driver only")
        return "while"

    def _pad_tests(self, X):
        """Zero-pad a global (N, ...) test-row array to the sharded row
        count (no-op on aligned layouts)."""
        if self.Np == self.N:
            return X
        pad = jnp.zeros((self.Np - self.N,) + X.shape[1:], X.dtype)
        return jnp.concatenate([X, pad])

    def _dot_kwargs(self, p):
        """pcg dot callbacks bound to the LOCAL params (the general dots
        read the per-device weight rows from them)."""
        if self.pcg_variant == "fused":
            return {"dot3": lambda r, z, t: self._dot3_local(r, z, t, p)}
        return {"dot": lambda a, b: self._dot_local(a, b, p)}

    def _build_solve(self, tol: float, maxiter: int, warm: bool = False):
        ep, es = self.eparams_for(self.dtype)
        gspec = P(*(("time",) + (None,) * len(self.gs)))

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
            # Scalar/history outputs are returned tiled (leading device axis)
            # so no replication annotation is needed; host takes row 0.
            tile = lambda x: x[None]
            return (
                out.U,
                tile(out.iterations),
                tile(out.residuals),
                tile(out.precond_residuals),
                tile(out.converged),
            )

        # check_vma=False: every output here is explicitly tiled over
        # 'time', so the replication checker has nothing to prove.

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
                self._pad_tests(gL), self._pad_tests(gR), u0, p, x0
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

    def _solve_params(self):
        return self.eparams_for(self.dtype)[0]

    # ------------------------------------------------- mixed precision

    def _refined_params(self, dtype):
        return self.eparams_for(dtype)[0]

    def _build_refined_jits(self, mode: str, inner_tol: float,
                            inner_maxiter: int):
        """Refinement executables over the explicit mesh: the f64 residual
        pieces and the f32 inner PCG run as shard_map programs on the
        duplicated-halo-row layout; the refinement driver itself sees the
        global (N+1)-row layout, converted at the jit boundary (a static
        gather in, the halo-slot drop out — per refinement round, not per
        iteration, so the conversions are off the hot path)."""
        _, es64 = self.eparams_for(jnp.float64)
        _, es32 = self.eparams_for(jnp.float32)
        gspec = P(*(("time",) + (None,) * len(self.gs)))
        N, R, nP, gs = self.N, self.R, self.P, self.gs
        dup_idx = self._dup_index

        m_trial = (
            None if self.aligned
            else jnp.asarray(self.glay.m_trial)[:, None]
        )

        def dup(Ug):
            """(N+1, *gs) global -> (P*(R+1), *gs) duplicated rows (ragged
            padding slots zeroed — the clipped index copies row N)."""
            D = Ug.reshape(N + 1, -1)[dup_idx]
            if m_trial is not None:
                D = D * m_trial.astype(D.dtype)
            return D.reshape((nP * (R + 1),) + gs)

        def flat(Ud):
            """Duplicated rows -> (N+1, *gs) global."""
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
                rhs_local(self._pad_tests(a), self._pad_tests(b), c, p)
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

    def _prepare_x0(self, x0):
        if x0 is None:
            # zeros are already in duplicated layout — building and
            # duplicating a host array only to discard it (warm=False
            # traces ignore x0) costs GB-scale host allocation + transfer
            # at the large configs
            return jnp.zeros((self.P * (self.R + 1),) + self.gs, self.dtype)
        full = np.asarray(x0, self.dtype).reshape(self.N + 1, self.m)
        dup = self._dup_rows(full)
        if not self.aligned:
            # Padding slots must start exactly zero (the clipped dup index
            # copies row N into them) so they stay zero through the solve.
            dup = dup * self.glay.m_trial[:, None]
        return jnp.asarray(dup.reshape((self.P * (self.R + 1),) + self.gs))

    def _device_iterate_flat(self, U_dev):
        """Drop the duplicated halo slots: (P·(R+1), gs) -> (N+1, m).
        Shared by host postprocessing (via the base _postprocess_U) and
        on-device analysis. The [: N+1] slice drops ragged padding (a
        no-op on aligned layouts, where P·R == N)."""
        U = U_dev.reshape(self.P, self.R + 1, self.m)
        flat = jnp.concatenate(
            [U[:, : self.R].reshape(-1, self.m), U[-1, self.R :]], axis=0
        )
        return flat[: self.N + 1]
