"""Host-side P1 finite-element substrate.

Replaces the reference's NGSolve (C++) dependency: mesh generation and sparse
assembly run once on the host (NumPy), emitting operators in device-friendly
formats (stencils / DIA diagonals) for the JAX compute path.
"""

from .mesh import (
    Mesh,
    unit_square_mesh,
    unit_cube_mesh,
    l_shape_mesh,
    nested_interpolation,
    refine_hierarchy,
    refine_uniform,
    sort_vertices_lex,
    domain_mesh,
)
from .assembly import (
    assemble_p1,
    device_spacetime_loads,
    load_vector,
    spacetime_loads,
    P1System,
)
from .evaluate import evaluate_solution, locate_points
from .meshio import load_mesh, save_mesh
from .timegrid import (
    TimeGrid,
    uniform_time_grid,
    graded_time_grid,
    time_matrices,
)

__all__ = [
    "Mesh",
    "unit_square_mesh",
    "unit_cube_mesh",
    "l_shape_mesh",
    "nested_interpolation",
    "refine_hierarchy",
    "refine_uniform",
    "sort_vertices_lex",
    "domain_mesh",
    "load_mesh",
    "save_mesh",
    "evaluate_solution",
    "locate_points",
    "assemble_p1",
    "load_vector",
    "spacetime_loads",
    "device_spacetime_loads",
    "P1System",
    "TimeGrid",
    "uniform_time_grid",
    "graded_time_grid",
    "time_matrices",
]
