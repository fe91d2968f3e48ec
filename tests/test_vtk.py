"""VTK export (utils/vtk.py): snapshot files parse back to the input data."""

import numpy as np
import pytest

from spacetime.fem import unit_cube_mesh, unit_square_mesh, uniform_time_grid
from spacetime.utils import write_vtk, write_vtk_series


def _parse_vtk(path):
    lines = open(path).read().splitlines()
    i = lines.index(next(l for l in lines if l.startswith("POINTS")))
    nv = int(lines[i].split()[1])
    pts = np.array([[float(v) for v in lines[i + 1 + k].split()]
                    for k in range(nv)])
    j = next(k for k, l in enumerate(lines) if l.startswith("CELLS"))
    ne = int(lines[j].split()[1])
    cells = [list(map(int, lines[j + 1 + k].split()[1:])) for k in range(ne)]
    s = next(k for k, l in enumerate(lines) if l.startswith("SCALARS"))
    vals = np.array([float(v) for v in lines[s + 2 : s + 2 + nv]])
    return pts, np.array(cells), vals


@pytest.mark.parametrize("make", [lambda: unit_square_mesh(4),
                                  lambda: unit_cube_mesh(2)])
def test_write_vtk_roundtrip(tmp_path, make):
    mesh = make()
    rng = np.random.default_rng(0)
    u = rng.standard_normal(mesh.num_vertices)
    path = str(tmp_path / "snap.vtk")
    write_vtk(mesh, {"u": u}, path)
    pts, cells, vals = _parse_vtk(path)
    np.testing.assert_array_equal(pts[:, : mesh.dim], mesh.vertices)
    if mesh.dim == 2:
        assert np.all(pts[:, 2] == 0.0)
    np.testing.assert_array_equal(cells, mesh.elements)
    np.testing.assert_array_equal(vals, u)


def test_write_vtk_series(tmp_path):
    mesh = unit_square_mesh(4)
    grid = uniform_time_grid(3)  # 8 intervals
    N, m = grid.num_intervals, mesh.num_interior
    U = np.arange((N + 1) * m, dtype=float).reshape(N + 1, m)
    prefix = str(tmp_path / "run")
    paths = write_vtk_series(mesh, U, grid, prefix, stride=3)
    # rows 0, 3, 6 plus the always-included final row 8
    assert len(paths) == 4
    _, _, vals = _parse_vtk(paths[1])
    full = np.zeros(mesh.num_vertices)
    full[mesh.interior] = U[3]
    np.testing.assert_array_equal(vals, full)
    assert np.all(vals[mesh.boundary] == 0.0)
    pvd = open(prefix + ".pvd").read()
    assert pvd.count("<DataSet") == 4
    assert repr(float(grid.t[-1])) in pvd


def test_cli_save_vtk(tmp_path, capsys):
    from spacetime.run import main

    prefix = str(tmp_path / "sol")
    rc = main([
        "--backend", "jax", "--device", "cpu", "--space-n", "8",
        "--time-levels", "3", "--tol", "1e-5", "--no-error",
        "--save-vtk", prefix, "--vtk-stride", "4", "--out", "",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "VTK snapshots" in out
    import os

    assert os.path.exists(prefix + ".pvd")
    assert os.path.exists(prefix + "_0000.vtk")
