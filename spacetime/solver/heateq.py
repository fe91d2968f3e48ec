"""End-to-end jitted heat-equation solver (single device).

The device counterpart of ``oracle.solver.OracleSolver``: identical
mathematics (stabilized minimal-residual formulation, see the oracle module
docstring), but every per-iteration operation is a device op:

- spatial SpMV: constant 7/15-point stencils on the structured grid
  (ops/stencil.py), applied to the (N_t+1, *grid_shape) coefficient array as
  one fused bandwidth-bound XLA pass (generic flat-DIA fallback for
  unstructured meshes);
- per-timestep / per-level inner solves: multigrid V-cycles, or exact
  inverses precomputed on the host once (parity phase; m ≤ a few thousand)
  and applied as batched GEMMs;
- wavelet transform: unrolled levelwise gathers/scatter-adds (J ≈ log2 N_t
  stages);
- PCG: one ``lax.while_loop`` under jit (solver.pcg).

Per-time-row scales (h_j factors) are pre-broadcast to (T, ny, 1)-style
shapes, and ALL float device arrays are passed into the jitted solve as a
params pytree rather than closed over, so one executable serves every
dtype-matched params set and large constants never enter the HLO.

The operation order mirrors the oracle exactly, so float64 runs match the
recorded BASELINE.md residual histories to rounding and iteration counts
exactly.
"""

from __future__ import annotations

import dataclasses
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from ..fem import (
    P1System,
    TimeGrid,
    domain_mesh,
    spacetime_loads,
    time_matrices,
)
from ..fem.errors import device_l2_error_spacetime, l2_error_spacetime
from ..fem.timegrid import graded_time_grid, uniform_time_grid
from ..models import Problem, get_problem
from ..ops.multigrid import (
    GalerkinMultiShiftMultigrid,
    MultiShiftMultigrid,
    chebyshev_inverse,
    mass_spectral_bounds,
)
from ..ops.sparse import DiaMatrix, dia_matvec
from ..ops.stencil import StencilOperator, row_scale
from ..ops.wavelets import build_wavelet_transform
from .pcg import PCGResult, pcg, pcg_chunk, pcg_flex, pcg_fused, pcg_init


def _dot(a, b):
    """Matmul at full f32 precision: reduced-precision passes (bf16, or TF32
    on GPU tensor cores — ~3 decimal digits) perturb the operator by ~1e-3,
    which stalls PCG and mixed-precision refinement; HIGHEST is required for
    correctness."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def _nu_variant(msmg, nu):
    """The same multigrid hierarchy with a different smoothing strength
    (the K_X-only nu knob — levels and coarse solves are shared)."""
    return msmg if nu == msmg.nu else dataclasses.replace(msmg, nu=nu)


@dataclasses.dataclass
class SolveResult:
    U: np.ndarray  # (N_t+1, m) flat interior coefficients
    iterations: int
    residuals: np.ndarray
    precond_residuals: np.ndarray
    converged: bool
    l2_error: float | None = None
    solve_seconds: float = 0.0  # dispatch -> completion (small-array sync)
    transfer_seconds: float = 0.0  # shipping U device->host
    setup_seconds: float = 0.0
    rhs_seconds: float = 0.0  # host load quadrature (once per solver)


class HeatSolver:
    """Jitted single-device solver. Setup (assembly, factorizations, wavelet
    structure) runs once on the host; ``solve`` dispatches one fused device
    computation."""

    supports_chunked = True  # the explicit shard_map subclass opts out
    # True where the solve signature needs x0 in full device layout even on
    # cold starts (the explicit shard_map path's in_specs) — disables the
    # scalar-placeholder capacity optimization in solve().
    _x0_needs_layout = False

    def __init__(
        self,
        problem: Problem,
        system: P1System,
        grid: TimeGrid,
        dtype=jnp.float64,
        spatial_format: str = "auto",
        inner: str = "auto",
        mg_cycles: int = 3,
        mg_cycles_kx: int | None = None,
        mg_nu: int = 2,
        mg_nu_kx: int | None = None,
        mg_nu_post: int | None = None,
        mg_coarse: int | None = None,
        space_n: int | None = None,
        loop: str = "auto",
        chunk: int = 10,
        pcg_variant: str = "standard",
        rhs: str = "auto",
        cheb_eps: float = 1e-3,
        donate_rhs: bool = False,
    ):
        """``inner``: inner spatial solver — 'dense' (exact precomputed
        inverses, parity phase, m ≤ a few thousand) or 'mg' (geometric
        multigrid + Chebyshev mass inverse, scale phase); 'auto' picks by m.
        ``space_n``: cells per side of the structured mesh (required for
        'mg'; inferred from grid_shape when square/cubic).
        ``cheb_eps``: relative accuracy of the solution-bearing (K_Y/K_H)
        Chebyshev polynomial inverses on the generic-mesh path (inner
        'cheb'); the preconditioner-only wavelet sandwich runs at 30x this.
        The polynomials are FIXED at setup — for solve tolerances far below
        the default 1e-3 operator accuracy, lower this (degrees grow like
        log(1/eps))."""
        t0 = _time.perf_counter()
        self.problem = problem
        self.system = system
        self.grid = grid
        self.dtype = dtype
        self.N = grid.num_intervals
        self.m = system.m
        self.wt = build_wavelet_transform(grid)

        # --- spatial operator representation ------------------------------
        M_dia = DiaMatrix.from_csr(system.M)
        A_dia = DiaMatrix.from_csr(system.A)
        gs = system.mesh.grid_shape
        if spatial_format not in ("auto", "stencil", "vstencil", "dia"):
            raise ValueError(f"unknown spatial_format {spatial_format!r}")
        weighted = getattr(system, "weighted", False)
        if spatial_format == "stencil" and weighted:
            raise ValueError(
                "spatial_format='stencil' needs a translation-invariant "
                "operator; coefficient-weighted systems use 'dia'"
            )
        use_stencil = (
            spatial_format == "stencil"
            or (
                spatial_format == "auto"
                and gs is not None
                and min(gs) >= 3
                # Weighted forms are not constant stencils — generic paths.
                and not weighted
            )
        )
        use_vst = (
            not use_stencil
            and gs is not None
            and min(gs) >= 3
            and (
                spatial_format == "vstencil"
                or (spatial_format == "auto" and weighted)
            )
        )
        if spatial_format == "vstencil" and not use_vst:
            raise ValueError(
                "spatial_format='vstencil' needs a structured grid "
                "(mesh.grid_shape)"
            )
        if use_stencil:
            self.gs = tuple(gs)
            M_st = StencilOperator.from_dia(M_dia, self.gs)
            A_st = StencilOperator.from_dia(A_dia, self.gs)
            self._st_ops = (M_st, A_st)
            # Stencil weights are static Python floats — safe to close over.
            self._spmv_M = lambda U, p=None: M_st.apply(U)
            self._spmv_A = lambda U, p=None: A_st.apply(U)
        elif use_vst:
            # Weighted forms on structured grids: grid layout with per-node
            # tap weights for A (ops/stencil.VarStencilOperator — every tap
            # a small-axis shift instead of the flat DIA form's ±n_x
            # offsets); M is the plain mass — a constant stencil.
            from ..ops.stencil import VarStencilOperator

            self.gs = tuple(gs)
            M_st = StencilOperator.from_dia(M_dia, self.gs)
            vA, Aw = VarStencilOperator.from_dia(A_dia, self.gs)
            self._vst_A = vA
            self._vst_host = {"Aw": Aw}
            self._spmv_M = lambda U, p=None: M_st.apply(U)
            self._spmv_A = lambda U, p=None: vA.apply(
                U, (p or self.params)["Aw"]
            )
        else:
            # Generic-mesh path. DIA: ndiag shifted multiply-adds, one fused
            # XLA pass, any dtype. Device arrays flow through params.
            self.gs = (self.m,)
            self._dia_host = {"Mv": M_dia.vals, "Av": A_dia.vals}
            self._spmv_M = lambda U, p=None: dia_matvec(
                (p or self.params)["dia_Mv"], M_dia.offsets, U
            )
            self._spmv_A = lambda U, p=None: dia_matvec(
                (p or self.params)["dia_Av"], A_dia.offsets, U
            )
        self.spatial_format = (
            "stencil" if use_stencil else ("vstencil" if use_vst else "dia")
        )

        # --- inner spatial solver ------------------------------------------
        # Weighted forms on structured square/cubic grids still have the
        # nested P1 hierarchy: Galerkin (RAP) multigrid with DIA level
        # operators (ops/multigrid.GalerkinMultiShiftMultigrid) — mesh-
        # independent inner cost where Chebyshev degrees grow like h⁻¹.
        structured_sq = (
            gs is not None
            and len(set(gs)) == 1
            and min(gs) >= 3
            and (gs[0] + 1) % 2 == 0
        )
        if inner == "auto":
            if self.m <= 4096:
                inner = "dense"
            elif (
                use_stencil
                or (weighted and structured_sq)
                or getattr(system.mesh, "refined_from", None) is not None
            ):
                # structured grids, weighted structured grids, and
                # unstructured meshes with a recorded refinement chain
                # (fem.refine_hierarchy) all have a nested P1 hierarchy.
                inner = "mg"
            else:
                # large unstructured meshes without a refinement record: no
                # hierarchy for mg and dense inverses are O(m²) — Chebyshev
                # polynomial inverses
                inner = "cheb"
        self.inner = inner
        self._mg_weighted = False
        self._host = {"h": time_matrices(grid)["h"]}
        if mg_cycles < 1 or (mg_cycles_kx is not None and mg_cycles_kx < 1):
            # 0 cycles would apply a ZERO K_X/K_Y — PCG then divides by
            # zero curvature and burns maxiter on NaNs with no hint why.
            raise ValueError(
                f"mg_cycles={mg_cycles} / mg_cycles_kx={mg_cycles_kx}: "
                "V-cycle counts must be >= 1"
            )
        if mg_nu < 1 or (mg_nu_kx is not None and mg_nu_kx < 1):
            raise ValueError(
                f"mg_nu={mg_nu} / mg_nu_kx={mg_nu_kx}: "
                "smoothing step counts must be >= 1"
            )
        omegas = [float(self.wt.level_shift[j]) for j in range(self.wt.num_levels + 1)]
        if inner == "dense":
            A_dense = system.A.toarray()
            M_dense = system.M.toarray()
            self._host["Kx_inv"] = np.linalg.inv(A_dense)
            self._host["Minv"] = np.linalg.inv(M_dense)
            sandwiches = []
            for omega in omegas:
                Sj = np.linalg.inv(A_dense + omega * M_dense)
                sandwiches.append(Sj @ A_dense @ Sj)
            self._host["sandwich"] = sandwiches
        elif (
            inner == "mg"
            and self.spatial_format == "dia"
            and getattr(system.mesh, "refined_from", None) is not None
        ):
            # UNSTRUCTURED meshes with a recorded red-refinement chain
            # (fem.refine_hierarchy): the P1 spaces are exactly nested, so
            # Galerkin RAP through the recorded embedding is coarse
            # re-assembly and geometric multigrid needs no structured grid
            # (ops/multigrid.NestedMultiShiftMultigrid — flat dof layout,
            # DIA level matvecs, gather transfers). Replaces the Chebyshev
            # polynomial inverses whose degrees grow like h⁻¹ (935 for the
            # K_Y solve at the L-shape h=1/512, BASELINE.md).
            from ..ops.multigrid import NestedMultiShiftMultigrid

            self.mg_cycles = mg_cycles
            self.mg_cycles_kx = 2 if mg_cycles_kx is None else mg_cycles_kx
            self.mg_nu = mg_nu
            self.mg_nu_kx = mg_nu if mg_nu_kx is None else mg_nu_kx
            self._mg_dim = system.mesh.dim
            # Same floor rule as the structured builds: always coarsen at
            # least once when a chain exists (small meshes otherwise fall
            # under the default coarse cap before building any level).
            m_coarse = mg_coarse if mg_coarse is not None else 1024
            self.msmg, (A_c, M_c) = NestedMultiShiftMultigrid.build(
                system.mesh, system.A, system.M, nu=mg_nu,
                m_coarse=min(m_coarse, max(self.m // 4, 1)),
            )
            self._finish_flat_mg(A_c, M_c, omegas, system)
        elif inner == "amg":
            # Smoothed-aggregation ALGEBRAIC hierarchy
            # (ops/multigrid.SAMultiShiftMultigrid): the inner solver for
            # unstructured meshes with NO refinement record — imported
            # files at native resolution — where 'cheb' is otherwise the
            # only scale option and its polynomial degrees grow like h⁻¹
            # (degree 935 for K_Y at the L-shape h=1/512, BASELINE.md).
            # Coarse spaces come from aggregation of A's graph alone; both
            # A and M Galerkin-coarsen through the same prolongator, so
            # the multi-shift V-cycle machinery applies unchanged.
            if self.spatial_format != "dia":
                raise ValueError(
                    "inner='amg' runs in the flat dof layout "
                    "(spatial_format 'dia'); structured grids "
                    "already have geometric multigrid (inner='mg')"
                )
            from ..ops.multigrid import SAMultiShiftMultigrid

            self.mg_cycles = mg_cycles
            self.mg_cycles_kx = 2 if mg_cycles_kx is None else mg_cycles_kx
            self.mg_nu = mg_nu
            self.mg_nu_kx = mg_nu if mg_nu_kx is None else mg_nu_kx
            self._mg_dim = system.mesh.dim
            m_coarse = mg_coarse if mg_coarse is not None else 1024
            self.msmg, (A_c, M_c) = SAMultiShiftMultigrid.build(
                system.A, system.M, nu=mg_nu,
                m_coarse=min(m_coarse, max(self.m // 4, 1)),
            )
            self._finish_flat_mg(A_c, M_c, omegas, system)
            # Downstream routing (apply_KY/KX, params) treats this as an
            # mg flavor; `solver.mg_flavor` records what was built.
            self.inner = "mg"
        elif inner == "mg" and self.spatial_format != "stencil":
            # Coefficient-weighted (or explicitly DIA-format) operators
            # on structured grids: Galerkin RAP hierarchy off the assembled
            # fine matrices, DIA level matvecs, same multi-shift V-cycle.
            if not (weighted and structured_sq):
                raise ValueError(
                    "inner='mg' requires the structured stencil path (or a "
                    "coefficient-weighted system on a structured "
                    "square/cubic grid; unstructured meshes need a "
                    "refinement chain — fem.refine_hierarchy)"
                )
            if space_n is None:
                space_n = gs[0] + 1
            dim = len(gs)
            self.mg_cycles = mg_cycles
            self.mg_cycles_kx = 2 if mg_cycles_kx is None else mg_cycles_kx
            self.mg_nu = mg_nu
            self.mg_nu_kx = mg_nu if mg_nu_kx is None else mg_nu_kx
            self._mg_dim = dim
            self._mg_weighted = True
            if mg_coarse is None:
                mg_coarse = 32 if dim == 2 else 16
            self.msmg, (A_c, M_c) = GalerkinMultiShiftMultigrid.build(
                dim, space_n, system.A, system.M, nu=mg_nu,
                n_coarse=min(mg_coarse, max(space_n // 2, 4)),
            )
            # K_X-only smoothing strength (same levels, different nu): K_Y
            # sits inside S so its smoother quality is an accuracy choice;
            # K_X's trades outer iterations for per-cycle cost.
            self.msmg_kx = _nu_variant(self.msmg, self.mg_nu_kx)
            self._host["omega_ky"] = np.zeros(self.N)
            self._host["omega_kx"] = np.asarray(
                [float(self.wt.level_shift[j]) for j in self.wt.node_level]
            )
            self._host["mg_cinv_ky"] = np.linalg.inv(A_c)
            self._host["mg_cinv"] = [
                np.linalg.inv(A_c + omega * M_c) for omega in omegas
            ]
            # K_H ≈ M⁻¹: params-threaded Chebyshev in the flat DIA layout
            # (M is the plain mass — its D⁻¹M spectrum is the h-independent
            # structured-family one).
            from ..ops.multigrid import chebyshev_coefficients

            lminM, lmaxM = mass_spectral_bounds(dim)
            self._cheb_spec = {"M": (lminM, lmaxM, 30)}
            self._host["cheb_invM"] = 1.0 / np.asarray(system.M.diagonal())
            self._host["cheb_coefM"] = chebyshev_coefficients(lminM, lmaxM, 30)
        elif inner == "mg":
            if space_n is None:
                if len(set(self.gs)) != 1:
                    raise ValueError("pass space_n for non-square grids")
                space_n = self.gs[0] + 1
            dim = len(self.gs)
            self.mg_cycles = mg_cycles
            # K_Y sits inside S, so its V-cycle count sets the accuracy of
            # the computed solution (3 cycles keeps the discretization-level
            # L2 error; 2 perturbs it measurably at scale — err 3.50→4.40e-6
            # at 33.8 MDoF — and 1 visibly degrades it). K_X is only a
            # preconditioner — its cycle count trades preconditioner quality
            # (outer iteration count) against per-iteration cost without
            # touching the fixed point. Measured at 513²×128ts f32 with the
            # fused pair-grouped kernels: kx-cycles 2/1 → 17/18 outer
            # iterations, 0.89/0.74 s — 2 stays the robust default (in 3D
            # kx=1 costs +4 iterations for ~no net win), 1 is the 2D speed
            # preset (CLI --mg-cycles-kx, BASELINE.md).
            self.mg_cycles_kx = 2 if mg_cycles_kx is None else mg_cycles_kx
            self.mg_nu = mg_nu
            self.mg_nu_kx = mg_nu if mg_nu_kx is None else mg_nu_kx
            self._mg_dim = dim
            # Seed the level cache with the caller's finest system — the MG
            # hierarchy's top level is exactly it (nested unit-domain P1
            # spaces), so re-assembling it is pure waste (seconds at 513²+).
            cache: dict = {}
            if tuple(gs) == (space_n - 1,) * dim:
                cache[space_n] = system
            # A larger coarse level means fewer V-cycle levels (each level
            # adds ~10 device ops whose launch overhead dominates at small
            # sizes) and a more exact coarse solve. The coarse dense
            # inverses bound the choice: 31^2 in 2D is tiny, but 3D grows as
            # (n-1)^6 (16 -> 45 MB f32 per shift level; 32 would be 3.5 GB).
            if mg_coarse is None:
                mg_coarse = 32 if dim == 2 else 16
            self.msmg, (A_c, M_c) = MultiShiftMultigrid.build(
                dim, space_n, nu=mg_nu,
                n_coarse=min(mg_coarse, max(space_n // 2, 4)),
                _system_cache=cache,
            )
            self.msmg_kx = _nu_variant(self.msmg, self.mg_nu_kx)
            # Per-row shifts: K_Y rows solve with A alone (omega = 0); the
            # wavelet rows solve with the shift of their level.
            self._host["omega_ky"] = np.zeros(self.N)
            self._host["omega_kx"] = np.asarray(
                [float(self.wt.level_shift[j]) for j in self.wt.node_level]
            )
            self._host["mg_cinv_ky"] = np.linalg.inv(A_c)
            self._host["mg_cinv"] = [
                np.linalg.inv(A_c + omega * M_c) for omega in omegas
            ]
            lmin, lmax = mass_spectral_bounds(dim)
            M_st = StencilOperator.from_dia(M_dia, self.gs)
            center = dict(zip(M_st.disps, M_st.weights))[(0,) * dim]
            self._cheb_Minv = chebyshev_inverse(M_st, 1.0 / center, lmin, lmax, 30)
        elif inner == "cheb":
            # Generic-mesh scale path: fixed Chebyshev polynomials in the
            # (Jacobi-normalized) spatial operators — linear and symmetric,
            # so the outer normal equations stay SPD (an inner Krylov solve
            # would be nonlinear in the RHS and is not admissible). Spectral
            # bounds are measured once per matrix at setup; shifted-operator
            # bounds derive from the A/M bounds by the row-wise mediant
            # inequality (no per-level eigensolves). Degrees follow the
            # Chebyshev error bound: K_Y/K_H sit inside S (solution-bearing,
            # eps 1e-3); the wavelet sandwich is preconditioner-only
            # (eps 3e-2). kappa(D⁻¹A) grows like h⁻², so degrees grow like
            # h⁻¹ — this trades the reference's splu factorizations for
            # batched bandwidth-bound SpMV chains.
            from ..ops.multigrid import (
                chebyshev_coefficients,
                chebyshev_degree,
                generic_spectral_bounds,
            )

            dA = np.asarray(system.A.diagonal())
            dM = np.asarray(system.M.diagonal())
            rsA = np.asarray(np.abs(system.A).sum(axis=1)).ravel()
            rsM = np.asarray(np.abs(system.M).sum(axis=1)).ravel()
            laA, gaA = generic_spectral_bounds(system.A)
            # P1 mass: certified λmin(D⁻¹M) ≥ 1/2 (see
            # generic_spectral_bounds) — no eigensolve/splu needed.
            laM, gaM = generic_spectral_bounds(system.M, known_lmin=0.5)
            self._cheb_spec = {
                "A": (laA, float((rsA / dA).max()),
                      chebyshev_degree(laA, (rsA / dA).max(), cheb_eps)),
                "M": (laM, float((rsM / dM).max()),
                      chebyshev_degree(laM, (rsM / dM).max(), cheb_eps)),
            }
            shifts = []
            for omega in omegas:
                d_w = dA + omega * dM
                lmin_w = float(((laA * dA + omega * laM * dM) / d_w).min())
                lmax_w = float(((rsA + omega * rsM) / d_w).max())
                shifts.append(
                    (omega, lmin_w, lmax_w,
                     chebyshev_degree(lmin_w, lmax_w, 30.0 * cheb_eps))
                )
            self._cheb_spec["shift"] = shifts
            self._host["cheb_invA"] = 1.0 / dA
            self._host["cheb_invM"] = 1.0 / dM
            self._host["cheb_invS"] = [
                1.0 / (dA + omega * dM) for omega in omegas
            ]
            # Recurrence scalar sequences, scanned on device: degrees grow
            # like h⁻¹, so the polynomial MUST be a lax.scan over these rows,
            # never an unrolled Python loop (HLO size ∝ degree otherwise).
            self._host["cheb_coefA"] = chebyshev_coefficients(
                *self._cheb_spec["A"]
            )
            self._host["cheb_coefM"] = chebyshev_coefficients(
                *self._cheb_spec["M"]
            )
            self._host["cheb_coefS"] = [
                chebyshev_coefficients(lmin_w, lmax_w, deg)
                for (_, lmin_w, lmax_w, deg) in shifts
            ]
        else:
            raise ValueError(f"unknown inner solver {inner!r}")
        self._params_cache: dict = {}
        self._rhs_host = None
        self._rhs_dev: dict = {}
        self.rhs_seconds = 0.0
        # V(nu, nu_post) cycles — see ops/multigrid.MultiShiftMultigrid.
        # nu_post for the measured behavior AND the non-symmetric-
        # preconditioner caveat (diverges with cycles_kx=1; keep >= 2
        # cycles when asymmetric).
        self.mg_nu_post = mg_nu_post
        if mg_nu_post is not None and getattr(self, "msmg", None) is not None:
            self.msmg = dataclasses.replace(self.msmg, nu_post=mg_nu_post)
            self.msmg_kx = dataclasses.replace(
                self.msmg_kx, nu_post=mg_nu_post
            )
        self.params = self.params_for(dtype)
        counts = np.asarray(self.wt.level_counts)
        self.level_bounds = np.concatenate([[0], np.cumsum(counts)]).astype(int)

        if pcg_variant not in ("standard", "fused", "flex"):
            raise ValueError(f"unknown pcg_variant {pcg_variant!r}")
        if pcg_variant != "standard" and loop == "chunked":
            raise ValueError(
                f"pcg_variant={pcg_variant!r} supports the while-loop "
                "driver only"
            )
        # 'fused' = single-reduction (Chronopoulos–Gear) PCG: one global
        # reduction per iteration instead of three — see solver/pcg.py.
        # 'standard' keeps the oracle's arithmetic (bitwise parity path).
        self.pcg_variant = pcg_variant
        if rhs not in ("auto", "host", "device"):
            raise ValueError(f"unknown rhs mode {rhs!r}")
        # Load quadrature: 'host' = the NumPy path shared with the oracle
        # (bitwise parity); 'device' = jitted on-device quadrature
        # (fem/assembly.device_spacetime_loads — at 513²×128ts the host path
        # costs 437 s vs ~1 s of solve). 'auto' keeps host for the f64
        # parity dtype and goes on-device for f32 manufactured problems.
        if rhs == "auto":
            rhs = (
                "device"
                if (
                    problem.exact is not None
                    and jnp.dtype(dtype) != jnp.dtype(jnp.float64)
                )
                else "host"
            )
        if rhs == "device" and problem.exact is None:
            raise ValueError("rhs='device' needs a manufactured problem")
        self.rhs_mode = rhs
        # Capacity lever (single-device memory ceiling, BASELINE.md cfg5): donate
        # the staged RHS load buffers to the solve executable so XLA reuses
        # them as loop temporaries (~2x(N,m) fields — 2.2 GB at 270 MDoF).
        # The staged-device cache is invalidated by donation, so each solve
        # re-stages the loads; keep off for repeated-solve workflows.
        self.donate_rhs = donate_rhs
        self.loop = loop
        self.chunk = chunk
        self._solve_jit_cache = {}
        self.setup_seconds = _time.perf_counter() - t0

    def _pcg_driver(self):
        """The while-loop PCG variant this solver runs: standard (oracle
        arithmetic, bitwise parity), fused (single-reduction
        Chronopoulos-Gear), or flex (Polak-Ribiere flexible CG, tolerant of
        non-symmetric preconditioners like asymmetric V(nu, nu_post)
        cycles — see solver/pcg.pcg_flex)."""
        return {"standard": pcg, "fused": pcg_fused, "flex": pcg_flex}[
            self.pcg_variant
        ]

    def _loop_mode(self) -> str:
        """'while' = one fused lax.while_loop dispatch — the default: no
        host round-trip inside the solve. 'chunked' = fixed-trip fori_loop
        chunks with host convergence checks between them; pays one host
        sync per chunk, useful only when mid-solve host control is needed
        (e.g. periodic checkpointing)."""
        if self.loop != "auto":
            return self.loop
        return "while"

    def params_for(self, dtype):
        """Device params pytree in the requested precision (cached)."""
        key = jnp.dtype(dtype).name
        if key in self._params_cache:
            return self._params_cache[key]
        cast = lambda x: jnp.asarray(x, dtype)
        h = self._host["h"]
        p = {
            "h_half": row_scale(0.5 * h, self.gs, dtype),
            "h_stab": row_scale(h / 16.0, self.gs, dtype),
            "inv_h": row_scale(1.0 / h, self.gs, dtype),
            "wavelet": self.wt.jax_params(dtype),
        }
        if self.spatial_format == "vstencil":
            p["Aw"] = cast(self._vst_host["Aw"])
        if self.spatial_format == "dia":
            p["dia_Mv"] = cast(self._dia_host["Mv"])
            p["dia_Av"] = cast(self._dia_host["Av"])
        if self.inner == "dense":
            p["Kx_inv"] = cast(self._host["Kx_inv"])
            p["Minv"] = cast(self._host["Minv"])
            p["sandwich"] = [cast(S) for S in self._host["sandwich"]]
        elif self.inner == "cheb":
            # Jacobi vectors in the spmv layout (grid shape on the stencil
            # path, flat (m,) otherwise) so they broadcast over time rows.
            gsh = lambda v: cast(v).reshape(self.gs)
            p["cheb_invA"] = gsh(self._host["cheb_invA"])
            p["cheb_invM"] = gsh(self._host["cheb_invM"])
            p["cheb_invS"] = [gsh(v) for v in self._host["cheb_invS"]]
            p["cheb_coefA"] = cast(self._host["cheb_coefA"])
            p["cheb_coefM"] = cast(self._host["cheb_coefM"])
            p["cheb_coefS"] = [cast(c) for c in self._host["cheb_coefS"]]
        else:
            p["mg_cinv_ky"] = cast(self._host["mg_cinv_ky"])
            p["mg_cinv"] = [cast(S) for S in self._host["mg_cinv"]]
            p["ms_ky"] = self.msmg.row_params(self._host["omega_ky"], dtype)
            p["ms_kx"] = self.msmg.row_params(self._host["omega_kx"], dtype)
            if self._mg_weighted:
                p["cheb_invM"] = cast(self._host["cheb_invM"]).reshape(self.gs)
                p["cheb_coefM"] = cast(self._host["cheb_coefM"])
        if not self.wt.is_uniform:
            p["perm"] = jnp.asarray(self.wt.perm_by_level)
            inv_perm = np.empty_like(self.wt.perm_by_level)
            inv_perm[self.wt.perm_by_level] = np.arange(self.N + 1)
            p["inv_perm"] = jnp.asarray(inv_perm)
        self._params_cache[key] = p
        return p

    def _finish_flat_mg(self, A_c, M_c, omegas, system):
        """Shared tail of the flat-dof-layout multigrid setups (nested
        red-refinement hierarchies and smoothed-aggregation AMG): K_X-only
        nu variant, per-row shift vectors, coarse dense inverses per
        wavelet shift, and the K_H ≈ M⁻¹ Chebyshev (generic spectral
        bounds — the same form the cheb inner uses). ``_mg_weighted``
        routes _apply_Minv through that Chebyshev."""
        from ..ops.multigrid import (
            chebyshev_coefficients,
            chebyshev_degree,
            generic_spectral_bounds,
        )

        self.mg_flavor = type(self.msmg).__name__
        self.msmg_kx = _nu_variant(self.msmg, self.mg_nu_kx)
        self._host["omega_ky"] = np.zeros(self.N)
        self._host["omega_kx"] = np.asarray(
            [float(self.wt.level_shift[j]) for j in self.wt.node_level]
        )
        self._host["mg_cinv_ky"] = np.linalg.inv(A_c)
        self._host["mg_cinv"] = [
            np.linalg.inv(A_c + omega * M_c) for omega in omegas
        ]
        self._mg_weighted = True
        dM = np.asarray(system.M.diagonal())
        rsM = np.asarray(np.abs(system.M).sum(axis=1)).ravel()
        # P1 mass: certified λmin(D⁻¹M) ≥ 1/2 (see generic_spectral_bounds)
        # — skips the splu + shift-invert eigsh that dominated AMG setup.
        laM, _ = generic_spectral_bounds(system.M, known_lmin=0.5)
        lmaxM = float((rsM / dM).max())
        self._cheb_spec = {
            "M": (laM, lmaxM, chebyshev_degree(laM, lmaxM, 1e-3))
        }
        self._host["cheb_invM"] = 1.0 / dM
        self._host["cheb_coefM"] = chebyshev_coefficients(
            *self._cheb_spec["M"]
        )

    # ---------------------------------------------------------- operators
    # U has shape (N_t+1, *gs); V (test side) has shape (N_t, *gs).
    # Every method takes the params pytree explicitly (p defaults to
    # self.params for eager use); the jitted path threads p as an argument.

    def _zrow(self, dtype=None):
        return jnp.zeros((1,) + self.gs, dtype or self.dtype)

    def apply_B(self, U, p=None):
        p = self.params if p is None else p
        DU = U[1:] - U[:-1]
        SU = U[1:] + U[:-1]
        return self._spmv_M(DU, p) + p["h_half"] * self._spmv_A(SU, p)

    def apply_BT(self, V, p=None):
        p = self.params if p is None else p
        VM = self._spmv_M(V, p)
        VA = p["h_half"] * self._spmv_A(V, p)
        z = self._zrow(V.dtype)
        return jnp.concatenate([-VM + VA, z]) + jnp.concatenate([z, VM + VA])

    def _cheb_run(self, b, invd, spmv, theta, coef):
        """Chebyshev–Jacobi polynomial application on (...,) spmv-layout
        arrays (the jnp twin of ops.multigrid.chebyshev_generic). The
        recurrence runs as a lax.scan over the precomputed (α_k, β_k)
        coefficient rows (``coef``, threaded through params) — degrees reach
        the hundreds on fine meshes, so unrolling is not an option."""
        r = invd * b
        d = r / theta
        x = d

        def step(carry, ab):
            x, r, d = carry
            r = r - invd * spmv(d)
            d = ab[0] * d + ab[1] * r
            x = x + d
            return (x, r, d), None

        (x, _, _), _ = jax.lax.scan(step, (x, r, d), coef)
        return x

    def _cheb_shift_solve(self, b, j, p):
        """≈ (A + ω_j M)⁻¹ b."""
        omega, lmin, lmax, _ = self._cheb_spec["shift"][j]
        spmv = lambda x: self._spmv_A(x, p) + omega * self._spmv_M(x, p)
        return self._cheb_run(
            b, p["cheb_invS"][j], spmv, 0.5 * (lmax + lmin), p["cheb_coefS"][j]
        )

    def apply_KY(self, V, p=None):
        p = self.params if p is None else p
        if self.inner == "dense":
            # -1, not self.N: the explicit shard_map path (parallel/explicit)
            # applies this to per-device row blocks.
            flat = V.reshape(-1, self.m)
            sol = _dot(flat, p["Kx_inv"]).reshape(V.shape)
        elif self.inner == "cheb":
            lmin, lmax, _ = self._cheb_spec["A"]
            sol = self._cheb_run(
                V, p["cheb_invA"], lambda x: self._spmv_A(x, p),
                0.5 * (lmax + lmin), p["cheb_coefA"],
            )
        else:
            def coarse(bc):
                lead = bc.shape[0]
                return _dot(bc.reshape(lead, -1), p["mg_cinv_ky"]).reshape(bc.shape)

            sol = self.msmg.solve(V, p["ms_ky"], coarse, self.mg_cycles)
        return sol * p["inv_h"]

    def apply_stab(self, U, p=None):
        p = self.params if p is None else p
        D = U[1:] - U[:-1]
        W = p["h_stab"] * self._spmv_A(D, p)
        z = self._zrow(U.dtype)
        return jnp.concatenate([z, W]) - jnp.concatenate([W, z])

    def _apply_Minv(self, X, p):
        """K_H ≈ M_x⁻¹ on (..., *gs) blocks."""
        if self.inner == "dense":
            lead = X.shape[:-len(self.gs)]
            flat = X.reshape((-1, self.m))
            return _dot(flat, p["Minv"]).reshape(lead + self.gs)
        if self.inner == "cheb" or self._mg_weighted:
            lmin, lmax, _ = self._cheb_spec["M"]
            return self._cheb_run(
                X, p["cheb_invM"], lambda x: self._spmv_M(x, p),
                0.5 * (lmax + lmin), p["cheb_coefM"],
            )
        return self._cheb_Minv(X)

    def _trace_row(self, U, p):
        """Row 0 of the trace term: M·K_H·M·U[0], shape (1, *gs)."""
        return self._spmv_M(self._apply_Minv(self._spmv_M(U[0:1], p), p), p)

    def apply_trace(self, U, p=None):
        p = self.params if p is None else p
        r0 = self._trace_row(U, p)
        return jnp.concatenate([r0, jnp.zeros((self.N,) + self.gs, U.dtype)])

    def apply_S(self, U, p=None):
        p = self.params if p is None else p
        out = self.apply_BT(
            self.apply_KY(self.apply_B(U, p), p), p
        ) + self.apply_stab(U, p)
        return out.at[0].add(self._trace_row(U, p)[0])

    def _sandwich_rows(self, rows_flat, j, p):
        """K_j = (A+ω_j M)⁻¹ A (A+ω_j M)⁻¹ on (k, m)-flat rows: precomputed
        dense product (parity phase) or two Chebyshev shifted solves around
        a stiffness matvec (generic scale phase)."""
        if self.inner == "cheb":
            lead = rows_flat.shape[0]
            X = rows_flat.reshape((lead,) + self.gs)  # spmv layout
            Y = self._cheb_shift_solve(X, j, p)
            Y = self._cheb_shift_solve(self._spmv_A(Y, p), j, p)
            return Y.reshape(lead, self.m)
        return _dot(rows_flat, p["sandwich"][j])

    def _coarse_by_level(self, bc, p):
        """Coarsest-grid solve of the multi-shift V-cycle: each wavelet
        level's rows (static strided slices in time order) use their own
        shifted dense inverse (tiny m_coarse x m_coarse GEMMs)."""
        lead = bc.shape[0]
        flat = bc.reshape(lead, -1)
        n_lvl = self.wt.num_levels + 1
        if self.wt.is_uniform:
            N = self.N
            flat = flat.at[0::N].set(_dot(flat[0::N], p["mg_cinv"][0]))
            for j in range(1, n_lvl):
                st = N >> j
                sl = slice(st, N, 2 * st)
                flat = flat.at[sl].set(_dot(flat[sl], p["mg_cinv"][j]))
        else:
            Cs = flat[p["perm"]]
            pieces = []
            for j in range(n_lvl):
                a, b = self.level_bounds[j], self.level_bounds[j + 1]
                if a == b:
                    continue
                pieces.append(_dot(Cs[a:b], p["mg_cinv"][j]))
            flat = jnp.concatenate(pieces)[p["inv_perm"]]
        return flat.reshape(bc.shape)

    def _ms_solve_kx(self, X, p):
        return self.msmg_kx.solve(
            X, p["ms_kx"], lambda bc: self._coarse_by_level(bc, p),
            self.mg_cycles_kx,
        )

    def apply_KX(self, R, p=None):
        p = self.params if p is None else p
        if self.inner == "mg":
            # One multi-shift V-cycle handles every wavelet row at once
            # (shift = the row's level shift); only the coarsest solve
            # distinguishes levels. Everything stays in the (N+1,)+gs grid
            # layout: no (N+1, m) reshape copies between W'/V-cycle/W.
            X = self.wt.adjoint_jax(
                R.reshape((self.N + 1,) + self.gs), p["wavelet"])
            X = self._ms_solve_kx(X, p)
            X = self._spmv_A(X, p)
            X = self._ms_solve_kx(X, p)
            return self.wt.forward_jax(X, p["wavelet"]).reshape(R.shape)
        C = self.wt.adjoint_jax(R.reshape(self.N + 1, self.m), p["wavelet"])
        n_lvl = self.wt.num_levels + 1
        if self.wt.is_uniform:
            # Level rows are static strided slices: level 0 = rows {0, N},
            # level j = odd multiples of N >> j.
            N = self.N
            C = C.at[0::N].set(self._sandwich_rows(C[0::N], 0, p))
            for j in range(1, n_lvl):
                st = N >> j
                sl = slice(st, N, 2 * st)
                C = C.at[sl].set(self._sandwich_rows(C[sl], j, p))
        else:
            Cs = C[p["perm"]]
            pieces = []
            for j in range(n_lvl):
                a, b = self.level_bounds[j], self.level_bounds[j + 1]
                if a == b:
                    continue
                pieces.append(self._sandwich_rows(Cs[a:b], j, p))
            C = jnp.concatenate(pieces)[p["inv_perm"]]
        return self.wt.forward_jax(C, p["wavelet"]).reshape(R.shape)

    # ---------------------------------------------------------------- rhs

    def _rhs_host_arrays(self):
        """Host-side load quadrature, computed once per solver (the loads
        depend only on (problem, mesh, grid) — recomputing them dominated
        end-to-end latency before caching: ~4 s vs ~0.4 s device solve on
        cfg2)."""
        if self._rhs_host is None:
            t0 = _time.perf_counter()
            self._rhs_host = spacetime_loads(self.problem, self.system.mesh, self.grid)
            self.rhs_seconds = _time.perf_counter() - t0
        return self._rhs_host

    def assemble_rhs_host(self, dtype=None):
        """Device-resident (gL, gR, u0_vec), cached per dtype. Despite the
        name (the historical host-quadrature entry point), rhs='device'
        computes the loads on-device and nothing ever crosses the host —
        including the f64 loads solve_refined reads on an f32 solver (the
        device f64 quadrature matches the host one to ~1e-15). An f64
        solver keeps the host loads, its parity contract with the
        oracle."""
        dtype = self.dtype if dtype is None else dtype
        key = jnp.dtype(dtype).name
        f64 = jnp.dtype(jnp.float64)
        if key not in self._rhs_dev:
            if self.rhs_mode == "device" and (
                jnp.dtype(dtype) != f64 or jnp.dtype(self.dtype) != f64
            ):
                from ..fem import device_spacetime_loads

                t0 = _time.perf_counter()
                gL, gR, u0_vec = device_spacetime_loads(
                    self.problem, self.system.mesh, self.grid, dtype
                )
                self._rhs_dev[key] = jax.block_until_ready(
                    (
                        gL.reshape((self.N,) + self.gs),
                        gR.reshape((self.N,) + self.gs),
                        u0_vec,
                    )
                )
                self.rhs_seconds = _time.perf_counter() - t0
            else:
                gL, gR, u0_vec = self._rhs_host_arrays()
                self._rhs_dev[key] = (
                    jnp.asarray(gL, dtype).reshape((self.N,) + self.gs),
                    jnp.asarray(gR, dtype).reshape((self.N,) + self.gs),
                    jnp.asarray(u0_vec, dtype),
                )
        return self._rhs_dev[key]

    def rhs_device(self, gL, gR, u0_vec, p=None):
        p = self.params if p is None else p
        f = self.apply_BT(self.apply_KY(gL + gR, p), p)
        corr = 0.25 * (gL - gR)
        z = self._zrow(gL.dtype)
        f = f - jnp.concatenate([z, corr]) + jnp.concatenate([corr, z])
        u0g = u0_vec.reshape((1,) + self.gs)
        f0 = self._spmv_M(self._apply_Minv(u0g, p), p)
        return f.at[0].add(f0[0])

    # -------------------------------------------------------------- solve

    def _build_solve(self, tol: float, maxiter: int, warm: bool):
        drv = self._pcg_driver()

        def run(gL, gR, u0_vec, p, x0):
            f = self.rhs_device(gL, gR, u0_vec, p)
            return drv(
                lambda U: self.apply_S(U, p), lambda R: self.apply_KX(R, p),
                f, tol, maxiter, x0=x0 if warm else None,
            )

        donate = (0, 1) if self.donate_rhs else ()
        return jax.jit(run, donate_argnums=donate)

    def _build_chunked(self, tol: float, maxiter: int, warm: bool):
        def prep(gL, gR, u0_vec, p, x0):
            f = self.rhs_device(gL, gR, u0_vec, p)
            return pcg_init(
                lambda U: self.apply_S(U, p), lambda R: self.apply_KX(R, p),
                f, maxiter, x0=x0 if warm else None,
            )

        def step(state, p, k):
            return pcg_chunk(
                lambda U: self.apply_S(U, p), lambda R: self.apply_KX(R, p),
                state, tol, k,
            )

        # k static: the final chunk shrinks to hit maxiter exactly (one
        # extra compile at most).
        return jax.jit(prep), jax.jit(step, static_argnums=2)

    def _run_chunked(self, fns, gL, gR, u0_vec, x0_dev, maxiter: int,
                     on_chunk=None, state0=None):
        """``on_chunk(state)`` runs on the host between chunks — the hook
        periodic checkpointing (and any adaptive policy) attaches to.
        ``state0``: a prepared PCGState (exact resume) replacing prep."""
        prep, step = fns
        state = prep(gL, gR, u0_vec, self.params, x0_dev) if state0 is None \
            else state0
        while int(state.it) < maxiter and not bool(state.done):
            k = min(self.chunk, maxiter - int(state.it))
            state = step(state, self.params, k)
            if on_chunk is not None:
                on_chunk(state)
        return PCGResult(
            U=state.U, iterations=state.it, residuals=state.res,
            precond_residuals=state.pres, converged=state.done,
        ), state

    # Layout hooks — overridden by the explicit shard_map path
    # (parallel/explicit), whose device iterate uses a duplicated-halo-row
    # layout rather than the plain (N+1, *gs) array.

    def _solve_params(self):
        """Params pytree handed to the jitted solve."""
        return self.params

    def _prepare_x0(self, x0):
        """Initial iterate in device layout."""
        if x0 is None:
            return jnp.zeros((self.N + 1,) + self.gs, self.dtype)
        return jnp.asarray(x0, self.dtype).reshape((self.N + 1,) + self.gs)

    def _state_from_arrays(self, st: dict, maxiter: int) -> "PCGState":
        """Device PCGState from a full-state checkpoint's arrays (exact
        resume: the Krylov sequence continues where the save left off).
        History buffers are re-sized to the new ``maxiter`` budget."""
        from .pcg import PCGState

        arr = lambda a: self._prepare_x0(a)
        it = int(st["it"])
        if it > maxiter:
            raise ValueError(
                f"checkpoint is at iteration {it} > maxiter {maxiter}"
            )
        hist = lambda h: jnp.asarray(
            np.concatenate([
                np.asarray(h)[: it + 1],
                np.full(maxiter - it, np.nan),
            ]).astype(np.asarray(h).dtype)
        )
        return PCGState(
            it=jnp.int32(it), U=arr(st["U"]), R=arr(st["R"]), P=arr(st["P"]),
            rz=jnp.asarray(st["rz"], self.dtype),
            res=hist(st["res"]), pres=hist(st["pres"]),
            done=jnp.bool_(bool(st["done"])),
            fnorm=jnp.asarray(st["fnorm"], self.dtype),
        )

    def _postprocess_U(self, U_dev) -> np.ndarray:
        """Device iterate -> host (N+1, m) array."""
        return np.asarray(self._device_iterate_flat(U_dev))

    def _device_iterate_flat(self, U_dev):
        """Device iterate -> device (N+1, m) view for on-device analysis
        (None where the layout needs host postprocessing first)."""
        return U_dev.reshape(self.N + 1, self.m)

    def _l2_error(self, U_dev, U_host, device_layout: bool = True) -> float:
        """L2(I×Ω) error; on the device-RHS scale path the quadrature runs
        on-device from the device iterate (the host loop costs minutes at
        the big configs and would ship the iterate back to the host)."""
        # Device path only for non-f64 solvers: an explicit rhs='device' +
        # f64 dtype solve fell back to host parity loads, and its reported
        # error must be parity-grade too. The quadrature itself runs in f64
        # whenever x64 is on: in f32 the rounding of u and u_h (~eps32·|u|
        # per point) is comparable to the discretization error of the
        # large configurations solved to tol 1e-8.
        if self.rhs_mode == "device" and jnp.dtype(self.dtype) != jnp.dtype(
            jnp.float64
        ):
            # ``device_layout=False``: U_dev is already the flat (N+1, m)
            # iterate (solve_refined's global layout) — do not route it
            # through the backend's solve-layout flattener (the explicit
            # backend's expects duplicated halo rows).
            if U_dev is not None and device_layout:
                Ud = self._device_iterate_flat(U_dev)
            else:
                Ud = U_dev
            return device_l2_error_spacetime(
                self.problem, self.system.mesh, self.grid,
                Ud if Ud is not None else jnp.asarray(U_host),
                dtype=(jnp.float64 if jax.config.jax_enable_x64
                       else jnp.float32),
            )
        return l2_error_spacetime(
            self.problem, self.system.mesh, self.grid,
            np.asarray(U_host, np.float64),
        )

    def solve(
        self,
        tol: float = 1e-6,
        maxiter: int = 200,
        compute_error: bool = True,
        x0=None,
        checkpoint_path: str | None = None,
        checkpoint_every: int | None = None,
        resume_state: dict | None = None,
    ) -> SolveResult:
        """``x0`` warm-starts PCG (e.g. a checkpointed iterate);
        ``checkpoint_path`` saves the final iterate via utils.checkpoint.
        ``checkpoint_every`` additionally saves the FULL in-progress PCG
        state to the same path every ~that many iterations (failure
        tolerance for long runs, SURVEY.md §5) — this forces the chunked
        loop driver, paying one host sync per chunk. ``resume_state``
        (utils.checkpoint.load_pcg_state arrays) continues the exact
        Krylov sequence of such a checkpoint; ``x0`` resume of an
        iterate-only checkpoint is a PCG restart instead."""
        mode = self._loop_mode()
        if checkpoint_every is not None or resume_state is not None:
            if checkpoint_every is not None and checkpoint_path is None:
                raise ValueError("checkpoint_every needs checkpoint_path")
            if self.pcg_variant != "standard" or not self.supports_chunked:
                raise ValueError(
                    "periodic checkpointing / exact resume uses the chunked "
                    "driver (standard PCG, single-program solvers only)"
                )
            if resume_state is not None and x0 is not None:
                raise ValueError("pass either resume_state or x0, not both")
            mode = "chunked"  # mid-solve host control
        key = (mode, tol, maxiter, x0 is not None)
        if key not in self._solve_jit_cache:
            build = self._build_solve if mode == "while" else self._build_chunked
            self._solve_jit_cache[key] = build(tol, maxiter, x0 is not None)
        gL, gR, u0_vec = self.assemble_rhs_host()
        if x0 is None and mode == "while" and not self._x0_needs_layout:
            # Cold start: the warm=False trace ignores x0 entirely, so a
            # scalar placeholder satisfies the call signature without
            # staging a full zero field (1+ GB at the cfg5 scales —
            # capacity headroom for the single-device memory ceiling).
            x0_dev = jnp.zeros((), self.dtype)
        else:
            x0_dev = self._prepare_x0(x0)
        params = self._solve_params()
        t0 = _time.perf_counter()
        final_state = None
        if mode == "while":
            out = self._solve_jit_cache[key](gL, gR, u0_vec, params, x0_dev)
            if self.donate_rhs:
                # The staged load buffers were donated to the executable —
                # drop the (now-invalid) device cache; the next solve
                # re-stages them.
                self._rhs_dev.clear()
        else:
            cb = None
            if checkpoint_every:
                from ..utils.checkpoint import save_pcg_state

                last = [0]

                def cb(state):
                    it = int(state.it)
                    if it - last[0] >= checkpoint_every and not bool(state.done):
                        flat = lambda A: np.asarray(A).reshape(
                            self.N + 1, self.m
                        )
                        save_pcg_state(
                            checkpoint_path,
                            state._replace(
                                U=flat(state.U), R=flat(state.R),
                                P=flat(state.P),
                            ),
                            {"iterations": it, "tol": tol, "m": self.m,
                             "N": self.N, "in_progress": True},
                        )
                        last[0] = it

            state0 = (
                None if resume_state is None
                else self._state_from_arrays(resume_state, maxiter)
            )
            out, final_state = self._run_chunked(
                self._solve_jit_cache[key], gL, gR, u0_vec, x0_dev, maxiter,
                on_chunk=cb, state0=state0,
            )
        # Sync on the small arrays first, so time-to-solution and the
        # device->host transfer of the full iterate are reported separately.
        residuals = np.asarray(out.residuals)
        pres = np.asarray(out.precond_residuals)
        it = int(out.iterations)
        converged = bool(out.converged)
        solve_seconds = _time.perf_counter() - t0
        U_dev = out.U
        t0 = _time.perf_counter()
        U_flat = self._postprocess_U(out.U)
        transfer_seconds = _time.perf_counter() - t0
        out = PCGResult(U_flat, it, residuals, pres, converged)
        if checkpoint_path is not None:
            from ..utils.checkpoint import save_pcg_state, save_solution

            if final_state is not None and not converged and checkpoint_every:
                # A truncated long run (the kill/resume scenario): keep the
                # FULL state so the next process continues the exact Krylov
                # sequence (solve(resume_state=...) / CLI --resume-from).
                flat = lambda A: np.asarray(A).reshape(self.N + 1, self.m)
                save_pcg_state(
                    checkpoint_path,
                    final_state._replace(
                        U=flat(final_state.U), R=flat(final_state.R),
                        P=flat(final_state.P),
                    ),
                    {"iterations": it, "tol": tol, "m": self.m,
                     "N": self.N, "in_progress": True},
                )
            else:
                save_solution(
                    checkpoint_path, U_flat,
                    {"iterations": it, "tol": tol, "m": self.m, "N": self.N},
                )
        err = None
        if compute_error and self.problem.exact is not None:
            err = self._l2_error(U_dev, U_flat)
        return SolveResult(
            U=U_flat,
            iterations=it,
            residuals=residuals[: it + 1],
            precond_residuals=pres[: it + 1],
            converged=converged,
            l2_error=err,
            solve_seconds=solve_seconds,
            transfer_seconds=transfer_seconds,
            setup_seconds=self.setup_seconds,
            rhs_seconds=self.rhs_seconds,
        )


    # ------------------------------------------------- mixed precision

    def _refined_params(self, dtype):
        """Params pytree the refinement executables consume — overridden by
        the explicit subclass (its operators read the eparams layout)."""
        return self.params_for(dtype)

    def _build_refined_jits(self, mode: str, inner_tol: float,
                            inner_maxiter: int):
        """(rhs64, resid64, inner) executables of the refinement loop —
        overridden by the GSPMD subclass to attach mesh shardings."""
        rhs64 = jax.jit(lambda a, b, c, p: self.rhs_device(a, b, c, p))
        resid64 = jax.jit(lambda f, u, p: f - self.apply_S(u, p))
        drv = self._pcg_driver()
        if mode == "while":
            # tol rides as a TRACED scalar so solve_refined can loosen the
            # last round's inner solve (round-schedule tuning) without a
            # recompile; it only enters the convergence comparisons.
            inner = jax.jit(
                lambda r32, p, tol32: drv(
                    lambda U: self.apply_S(U, p),
                    lambda R: self.apply_KX(R, p),
                    r32,
                    tol32,
                    inner_maxiter,
                )
            )
        else:
            prep32 = jax.jit(
                lambda r32, p: pcg_init(
                    lambda U: self.apply_S(U, p),
                    lambda R: self.apply_KX(R, p),
                    r32, inner_maxiter,
                )
            )
            step32 = jax.jit(
                lambda st, p: pcg_chunk(
                    lambda U: self.apply_S(U, p),
                    lambda R: self.apply_KX(R, p),
                    st, inner_tol, self.chunk,
                )
            )

            def inner(r32, p, tol32):
                # Chunked driver: tol is baked into step32 (host-controlled
                # loop); the round schedule's loosening is while-mode only.
                del tol32
                st = prep32(r32, p)
                while int(st.it) < inner_maxiter and not bool(st.done):
                    st = step32(st, p)
                return PCGResult(st.U, st.it, st.res, st.pres, st.done)

        return rhs64, resid64, inner

    def solve_refined(
        self,
        tol: float = 1e-8,
        inner_tol: float = 1e-5,
        inner_maxiter: int = 60,
        max_rounds: int = 6,
        compute_error: bool = True,
    ) -> SolveResult:
        """Iterative-refinement solve to tight tolerances.

        Runs PCG corrections in f32 (half the bytes of f64 per pass) inside
        an f64 residual loop — the classical mixed-precision refinement.
        Each round multiplies the residual by ~inner_tol, so tol=1e-8
        typically takes 2 rounds. Requires jax_enable_x64: the true-
        residual legs r = f − S·u are evaluated in float64.
        """
        if not jax.config.jax_enable_x64:
            # Without x64 the "f64" residual loop silently truncates to f32
            # and refinement stalls at ~1e-4 relative (measured) — fail loud.
            raise RuntimeError(
                "solve_refined needs float64 residuals: call "
                "jax.config.update('jax_enable_x64', True) (or "
                "spacetime.utils.ensure_x64()) at process start"
            )
        p64 = self._refined_params(jnp.float64)
        p32 = self._refined_params(jnp.float32)
        gL64, gR64, u064 = self.assemble_rhs_host(jnp.float64)

        mode = self._loop_mode()
        # Keyed like solve()'s jit cache: inner_maxiter is baked into the
        # inner executable as a closure constant. In while mode the
        # tolerance rides as a TRACED scalar (round-schedule loosening), so
        # it must NOT key the cache — re-keying on it forced a full rebuild
        # (minutes at flagship shapes) for a value the executable never
        # bakes in. Chunked mode still bakes inner_tol into step32.
        ir_key = (
            (mode, inner_maxiter) if mode == "while"
            else (mode, inner_tol, inner_maxiter)
        )
        if self.__dict__.get("_ir_key") != ir_key:
            self.__dict__.pop("_ir_jits", None)
            self._ir_key = ir_key
        if "_ir_jits" not in self.__dict__:
            self._ir_jits = self._build_refined_jits(
                mode, inner_tol, inner_maxiter
            )
        rhs64, resid64, inner = self._ir_jits

        t0 = _time.perf_counter()
        f = rhs64(gL64, gR64, u064, p64)
        fnorm = float(jnp.linalg.norm(f))
        # Device-memory lifetime hygiene for the flagship shapes (135 MDoF:
        # every (N+1, m) f64 array is ~1.08 GB): the staged f64 quadrature
        # loads are consumed by rhs64, and the f64 residual must not stay
        # alive across the inner solve.

        del gL64, gR64, u064
        u = jnp.zeros_like(f)
        hist = []
        iters_total = 0
        converged = False
        rnorm_prev = None
        f_real = None
        for k in range(max_rounds):
            if k == 0:
                # u = 0 exactly, so r = f − S·0 = f bitwise — skip the
                # full residual leg (the costliest round-1 op at scale).
                r, rnorm = f, fnorm
            else:
                r = resid64(f, u, p64)
                rnorm = float(jnp.linalg.norm(r))
                # Realized per-round reduction of the TRUE residual.
                # The f32 inner recurrence diverges from it at a scale-
                # dependent floor (accumulated f32 operator noise), so
                # iterations the inner solve spends below that floor are
                # pure waste.
                f_real = rnorm / rnorm_prev
            rnorm_prev = rnorm
            hist.append(rnorm)
            if rnorm <= tol * fnorm:
                converged = True
                break
            # Round schedule: solve each correction no tighter than the
            # outer target needs (0.3 safety), never more than ~20x past
            # the realized reduction of the previous round (pushed rounds
            # deliver better than the last round's realization — measured:
            # a 0.5·f_real clamp made round 1 miss the target by 2.5x at
            # cfg2 and cost an extra f64 leg), and never looser than 0.3
            # (a ~0-iteration round would stall the refinement).
            tol_k = max(inner_tol, 0.3 * tol * fnorm / rnorm)
            if f_real is not None and np.isfinite(f_real):
                tol_k = max(tol_k, 0.05 * f_real)
            tol_k = min(tol_k, 0.3)
            r32 = (r / rnorm).astype(jnp.float32)
            if k > 0:
                del r
            out = inner(r32, p32, jnp.float32(tol_k))
            del r32
            iters_total += int(out.iterations)
            u = u + rnorm * out.U.astype(jnp.float64)
            del out
        solve_seconds = _time.perf_counter() - t0

        U_flat = np.asarray(u).reshape(self.N + 1, self.m)
        err = None
        if compute_error and self.problem.exact is not None:
            err = self._l2_error(
                u.reshape(self.N + 1, self.m), U_flat, device_layout=False
            )
        hist = np.asarray(hist)
        return SolveResult(
            U=U_flat,
            iterations=iters_total,
            residuals=hist,
            precond_residuals=hist,
            converged=converged,
            l2_error=err,
            solve_seconds=solve_seconds,
            setup_seconds=self.setup_seconds,
            rhs_seconds=self.rhs_seconds,
        )


def solve_heat_equation_device(
    problem_name: str = "smooth2d",
    space_n: int = 16,
    time_levels: int = 4,
    extra_time_levels: int = 0,
    tol: float = 1e-6,
    maxiter: int = 200,
    dtype=jnp.float64,
    compute_error: bool = True,
    spatial_format: str = "auto",
) -> SolveResult:
    """One-call driver for the jitted single-device path (mirrors
    ``oracle.solve_heat_equation``)."""
    problem = get_problem(problem_name)
    mesh = domain_mesh(problem.domain, problem.dim, space_n)
    system = P1System.from_problem(problem, mesh)
    if extra_time_levels > 0:
        grid = graded_time_grid(time_levels, extra_time_levels, T=problem.T)
    else:
        grid = uniform_time_grid(time_levels, T=problem.T)
    solver = HeatSolver(problem, system, grid, dtype=dtype, spatial_format=spatial_format)
    return solver.solve(tol=tol, maxiter=maxiter, compute_error=compute_error)
