"""spacetime — parallel-in-time space-time solver for parabolic PDEs.

A JAX/XLA framework with the capabilities of the reference
``Jannertje/spacetime-fullgrid-parallel`` (van Venetië–Westerdiep style
minimal-residual full-grid space-time solver, arXiv:2009.08875), designed
for accelerators:

- ``fem``      — P1 FEM assembly (host-side, runs once) on structured
                 triangulations of the unit square/cube; time grids (uniform
                 and locally refined dyadic) and the banded time matrices.
- ``ops``      — device compute: stencil/DIA sparse spatial operators,
                 multigrid, the Kronecker space-time operator
                 ``B = A_t⊗M_x + M_t⊗A_x`` and its adjoint, and the
                 wavelet-in-time transform as levelwise gather/scatter maps.
- ``models``   — PDE problem definitions (the "model zoo" of this framework):
                 manufactured heat-equation benchmarks in 2D/3D, smooth and
                 singular/moving-peak.
- ``oracle``   — pure NumPy/SciPy serial reference implementation; the parity
                 anchor standing in for the (unavailable) reference binary.
- ``solver``   — preconditioners (K_Y, wavelet K_X), PCG as one fused XLA
                 ``lax.while_loop``, Lanczos condition-number estimation.
- ``parallel`` — ``jax.sharding`` mesh layouts: timesteps sharded over a
                 ``time`` axis (GSPMD-inferred or hand-placed collectives:
                 ppermute halos, psum dots, all_gather'd coarse wavelet
                 levels).
- ``utils``    — profiling counters, JSONL result records, checkpointing.

The reference mount is empty (see SURVEY.md §0); parity targets are defined by
the in-repo NumPy oracle implementing the published algorithm.
"""

__version__ = "0.1.0"

# Lazy top-level conveniences (keep package import light; the CLI and tests
# import submodules directly).
_EXPORTS = {
    "HeatSolver": "spacetime.solver.heateq",
    "solve_heat_equation_device": "spacetime.solver.heateq",
    "ShardedHeatSolver": "spacetime.parallel",
    "ExplicitHeatSolver": "spacetime.parallel",
    "make_time_mesh": "spacetime.parallel",
    "make_spacetime_mesh": "spacetime.parallel",
    "OracleSolver": "spacetime.oracle.solver",
    "P1System": "spacetime.fem",
    "load_mesh": "spacetime.fem",
    "save_mesh": "spacetime.fem",
    "get_problem": "spacetime.models",
    "Problem": "spacetime.models",
    "register_problem": "spacetime.models",
}


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
