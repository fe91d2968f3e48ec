"""Legacy-VTK (ASCII) export of solution snapshots for ParaView/VisIt.

The reference's users visualized through NGSolve's VTK output; this is the
dependency-free equivalent: each time snapshot of the space-time solution
becomes one UnstructuredGrid ``.vtk`` file (triangles/tets, point data).
"""

from __future__ import annotations

import numpy as np

_CELL_TYPE = {3: 5, 4: 10}  # VTK_TRIANGLE, VTK_TETRA


def write_vtk(mesh, point_data: dict[str, np.ndarray], path: str) -> None:
    """Write one legacy-VTK ASCII UnstructuredGrid file.

    ``point_data``: name -> (num_vertices,) array. 2D vertices are padded
    with z = 0 (VTK points are 3-D).
    """
    import os

    verts = np.asarray(mesh.vertices, np.float64)
    elems = np.asarray(mesh.elements)
    nv, d = verts.shape
    ne, nloc = elems.shape
    ctype = _CELL_TYPE[nloc]
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("spacetime solution snapshot\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {nv} double\n")
        for v in verts:
            z = float(v[2]) if d == 3 else 0.0
            f.write(f"{float(v[0])!r} {float(v[1])!r} {z!r}\n")
        f.write(f"CELLS {ne} {ne * (nloc + 1)}\n")
        for e in elems:
            f.write(f"{nloc} " + " ".join(str(int(t)) for t in e) + "\n")
        f.write(f"CELL_TYPES {ne}\n")
        f.write("\n".join([str(ctype)] * ne) + "\n")
        f.write(f"POINT_DATA {nv}\n")
        for name, vals in point_data.items():
            vals = np.asarray(vals, np.float64)
            if vals.shape != (nv,):
                raise ValueError(
                    f"point data {name!r} has shape {vals.shape}, "
                    f"expected ({nv},)"
                )
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            f.write("\n".join(repr(float(x)) for x in vals) + "\n")


def write_vtk_series(
    mesh, U_interior: np.ndarray, grid, prefix: str, stride: int = 1
) -> list[str]:
    """Write every ``stride``-th time snapshot of a space-time solution.

    ``U_interior``: (N_t+1, m) interior-vertex coefficients (a SolveResult's
    ``U``); boundary vertices carry the homogeneous Dirichlet zero. Returns
    the written paths (``{prefix}_{k:04d}.vtk``; ParaView groups them as a
    time series automatically). A ``{prefix}.pvd`` collection file records
    the physical times.
    """
    U_interior = np.asarray(U_interior)
    N = U_interior.shape[0] - 1
    rows = list(range(0, N + 1, max(1, stride)))
    if rows[-1] != N:
        rows.append(N)  # always include the final time
    paths = []
    full = np.zeros(mesh.num_vertices)
    import os

    for k, j in enumerate(rows):
        full[:] = 0.0
        full[mesh.interior] = U_interior[j]
        path = f"{prefix}_{k:04d}.vtk"
        write_vtk(mesh, {"u": full}, path)
        paths.append(path)
    with open(f"{prefix}.pvd", "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="Collection" version="0.1">\n<Collection>\n')
        for k, j in enumerate(rows):
            name = os.path.basename(paths[k])
            f.write(
                f'<DataSet timestep="{float(grid.t[j])!r}" file="{name}"/>\n'
            )
        f.write("</Collection>\n</VTKFile>\n")
    return paths
