"""Serial NumPy/SciPy oracle for the minimal-residual space-time solver.

Implements SURVEY.md Appendix A verbatim with exact (sparse-LU) inner solves:

  trial  X^δ = (continuous pw-linear in t) ⊗ (P1 in x), coefficients
         U ∈ R^{(N_t+1) × m} (time-major rows — the layout the device path
         shards over its ``time`` mesh axis);
  test   Y^δ = (pw-constant on the BISECTED time grid) ⊗ (P1 in x);
  B      = A_t⊗M_x + M_t⊗A_x,  trace Γ₀ = e₀ᵀ⊗M_x;
  S      = Bᵀ K_Y B + Γ₀ᵀ K_H Γ₀        (normal equations, SPD),
  K_Y    = D_t⁻¹ ⊗ A_x⁻¹,  K_H = M_x⁻¹;
  K_X    = W · blockdiag_j[(A_x+ω_j M_x)⁻¹ A_x (A_x+ω_j M_x)⁻¹] · Wᵀ
           (wavelet-in-time preconditioner, per-level shifts ω_j);
  solve  S u = f := Bᵀ K_Y g + Γ₀ᵀ K_H u₀  by PCG.

**Test space (important).** Piecewise constants on the SAME grid as the trial
hats are NOT uniformly inf-sup stable: time-alternating modes of high spatial
frequency have vanishing interval averages, and the measured generalized
condition number vs the X-norm Gram grows like h_x^-2 (kappa = 120 -> 3500
over one refinement ladder). Following Andreev's stabilization, the test space
here is pw constants on the bisected grid (two constants per trial interval),
which restores uniform stability (measured kappa vs the X-Gram: 2.4 -> 3.9,
flat). The half-grid normal equations condense algebraically to the same-grid
ones plus a jump stabilization:

  S  = Bᵀ K_Y B + Σ_j (h_j/16)·Δ_jᵀ A_x Δ_j + Γ₀ᵀ K_H Γ₀,
  f  = Bᵀ K_Y ḡ + (1/4)·Σ_j scatter_j(gL_j − gR_j) + Γ₀ᵀ K_H u₀_vec,

where Δ_j = u_{j+1} − u_j, ḡ_j = full-interval load, gL/gR = half-interval
loads (the inner A_x⁻¹ cancels exactly in both stabilization terms, so
stability costs one extra SpMV and no extra inner solves). This condensed
form is what both the oracle and the device path implement.

Everything here is matrix-free in time (banded row operations) and sparse in
space; the hot loops mirror exactly the structure the JAX path compiles,
so residual histories are comparable float64-to-float64.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..fem import P1System, TimeGrid, domain_mesh, time_matrices
from ..fem.timegrid import uniform_time_grid, graded_time_grid
from ..models import Problem, get_problem
from ..ops.wavelets import WaveletTransform, build_wavelet_transform


@dataclasses.dataclass
class OracleResult:
    """Outcome of one oracle solve."""

    U: np.ndarray  # (N_t+1, m) space-time coefficients
    iterations: int
    residuals: np.ndarray  # 2-norm residual history (including iteration 0)
    precond_residuals: np.ndarray  # sqrt(r·K_X r) history
    converged: bool
    l2_error: float | None = None
    solve_seconds: float = 0.0
    setup_seconds: float = 0.0


class OracleSolver:
    """Assembles the space-time system for (problem, mesh, time grid) and
    solves it with wavelet-preconditioned PCG (exact inner solves)."""

    def __init__(self, problem: Problem, system: P1System, grid: TimeGrid):
        t0 = _time.perf_counter()
        self.problem = problem
        self.system = system
        self.grid = grid
        self.wt: WaveletTransform = build_wavelet_transform(grid)

        mats = time_matrices(grid)
        self.h = mats["h"]
        self.M_x = system.M.tocsc()
        self.A_x = system.A.tocsc()
        self.m = system.m
        self.N = grid.num_intervals

        # Factor once, solve many (SURVEY.md §2 "spatial inner solver").
        self._lu_A = spla.splu(self.A_x)
        self._lu_M = spla.splu(self.M_x)
        self._lu_shift = {}
        for j in range(self.wt.num_levels + 1):
            omega = float(self.wt.level_shift[j])
            self._lu_shift[j] = spla.splu((self.A_x + omega * self.M_x).tocsc())
        self._level_rows = [
            np.flatnonzero(self.wt.node_level == j)
            for j in range(self.wt.num_levels + 1)
        ]
        self.setup_seconds = _time.perf_counter() - t0

    # ------------------------------------------------------------ operators

    def apply_B(self, U: np.ndarray) -> np.ndarray:
        """B = A_t⊗M_x + M_t⊗A_x : (N+1, m) -> (N, m)."""
        DU = U[1:] - U[:-1]
        SU = U[1:] + U[:-1]
        return DU @ self.M_x + (0.5 * self.h)[:, None] * (SU @ self.A_x)

    def apply_BT(self, V: np.ndarray) -> np.ndarray:
        """Bᵀ : (N, m) -> (N+1, m)."""
        VM = V @ self.M_x
        VA = (0.5 * self.h)[:, None] * (V @ self.A_x)
        out = np.zeros((self.N + 1, self.m))
        out[:-1] = -VM + VA
        out[1:] += VM + VA
        return out

    def apply_KY(self, V: np.ndarray) -> np.ndarray:
        """K_Y = D_t⁻¹ ⊗ A_x⁻¹ : per-timestep spatial solves."""
        return self._lu_A.solve(V.T).T / self.h[:, None]

    def apply_trace(self, U: np.ndarray) -> np.ndarray:
        """Γ₀ᵀ K_H Γ₀ : only the t=0 row participates."""
        out = np.zeros_like(U)
        out[0] = self.M_x @ self._lu_M.solve(self.M_x @ U[0])
        return out

    def apply_stab(self, U: np.ndarray) -> np.ndarray:
        """Jump stabilization Σ_j (h_j/16)·Δ_jᵀ A_x Δ_j (condensed half-grid
        test space; see module docstring)."""
        D = U[1:] - U[:-1]
        W = (self.h / 16.0)[:, None] * (D @ self.A_x)
        out = np.zeros_like(U)
        out[1:] = W
        out[:-1] -= W
        return out

    def apply_S(self, U: np.ndarray) -> np.ndarray:
        """Normal-equations operator
        S = Bᵀ K_Y B + stab + Γ₀ᵀ K_H Γ₀ (SPD)."""
        return (
            self.apply_BT(self.apply_KY(self.apply_B(U)))
            + self.apply_stab(U)
            + self.apply_trace(U)
        )

    def apply_KX(self, R: np.ndarray) -> np.ndarray:
        """Wavelet preconditioner K_X = W · blockdiag K_j · Wᵀ."""
        C = self.wt.adjoint_np(R)
        for j, rows in enumerate(self._level_rows):
            if rows.size == 0:
                continue
            lu = self._lu_shift[j]
            X = lu.solve(C[rows].T)  # (m, n_j)
            X = self.A_x @ X
            C[rows] = lu.solve(X).T
        return self.wt.forward_np(C)

    # ------------------------------------------------------------------ rhs

    def assemble_rhs(self) -> np.ndarray:
        """f = Bᵀ K_Y ḡ + (1/4)·scatter(gL−gR) + Γ₀ᵀ K_H u₀_vec.

        Half-interval loads gL/gR with 2-point Gauss each (see module
        docstring for the condensed half-grid test space)."""
        from ..fem.assembly import spacetime_loads

        gL, gR, u0_vec = spacetime_loads(self.problem, self.system.mesh, self.grid)
        f = self.apply_BT(self.apply_KY(gL + gR))
        # (r_L - r_R)(u) = -(h_j/4) A Δ_j  ⇒  adjoint puts +corr on node j,
        # -corr on node j+1, with corr = (gL-gR)/4 (A·A⁻¹ cancels).
        corr = 0.25 * (gL - gR)
        f[1:] -= corr
        f[:-1] += corr
        u0_sol = self._lu_M.solve(u0_vec)
        f[0] += self.M_x @ u0_sol
        return f

    # ----------------------------------------------------------------- pcg

    def solve(
        self,
        tol: float = 1e-6,
        maxiter: int = 200,
        compute_error: bool = True,
    ) -> OracleResult:
        t0 = _time.perf_counter()
        f = self.assemble_rhs()
        U = np.zeros_like(f)
        R = f - self.apply_S(U)
        Z = self.apply_KX(R)
        P = Z.copy()
        rz = float(np.vdot(R, Z))
        fnorm = float(np.linalg.norm(f))
        res_hist = [float(np.linalg.norm(R))]
        pres_hist = [np.sqrt(max(rz, 0.0))]
        converged = False
        it = 0
        for it in range(1, maxiter + 1):
            SP = self.apply_S(P)
            alpha = rz / float(np.vdot(P, SP))
            U += alpha * P
            R -= alpha * SP
            rnorm = float(np.linalg.norm(R))
            res_hist.append(rnorm)
            # K_X is applied before the convergence test on purpose: the
            # trailing sqrt(r·z) entry is part of the recorded parity
            # histories, and the jitted drivers mirror this order exactly.
            Z = self.apply_KX(R)
            rz_new = float(np.vdot(R, Z))
            pres_hist.append(np.sqrt(max(rz_new, 0.0)))
            if rnorm <= tol * fnorm:
                converged = True
                break
            P = Z + (rz_new / rz) * P
            rz = rz_new
        solve_seconds = _time.perf_counter() - t0

        err = None
        if compute_error and self.problem.exact is not None:
            err = self.l2_error(U)
        return OracleResult(
            U=U,
            iterations=it,
            residuals=np.asarray(res_hist),
            precond_residuals=np.asarray(pres_hist),
            converged=converged,
            l2_error=err,
            solve_seconds=solve_seconds,
            setup_seconds=self.setup_seconds,
        )

    # ---------------------------------------------------------------- error

    def l2_error(self, U: np.ndarray) -> float:
        """L2(I×Ω) error of the space-time solution vs the exact solution."""
        from ..fem.errors import l2_error_spacetime

        return l2_error_spacetime(self.problem, self.system.mesh, self.grid, U)


def solve_heat_equation(
    problem_name: str = "smooth2d",
    space_n: int = 16,
    time_levels: int = 4,
    extra_time_levels: int = 0,
    tol: float = 1e-6,
    maxiter: int = 200,
    compute_error: bool = True,
) -> OracleResult:
    """One-call driver: mesh + grid + assemble + solve (serial oracle)."""
    problem = get_problem(problem_name)
    mesh = domain_mesh(problem.domain, problem.dim, space_n)
    system = P1System.from_problem(problem, mesh)
    if extra_time_levels > 0:
        grid = graded_time_grid(time_levels, extra_time_levels, t_crit=0.0, T=problem.T)
    else:
        grid = uniform_time_grid(time_levels, T=problem.T)
    solver = OracleSolver(problem, system, grid)
    return solver.solve(tol=tol, maxiter=maxiter, compute_error=compute_error)
