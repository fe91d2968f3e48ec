"""JAX solver path: jitted operators, preconditioners, and PCG."""

from .heateq import HeatSolver, SolveResult, solve_heat_equation_device
from .pcg import pcg

__all__ = ["HeatSolver", "SolveResult", "solve_heat_equation_device", "pcg"]
