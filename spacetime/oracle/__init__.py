"""Pure NumPy/SciPy serial reference solver — the parity anchor.

The reference binary is unavailable (SURVEY.md §0); this oracle implements the
published algorithm (minimal-residual space-time discretization + wavelet
preconditioned PCG on the normal equations) with exact inner solves, and its
iteration counts / residual histories recorded in BASELINE.md are the numbers
the device path must reproduce.
"""

from .solver import OracleSolver, OracleResult, solve_heat_equation

__all__ = ["OracleSolver", "OracleResult", "solve_heat_equation"]
