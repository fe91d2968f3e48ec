"""Mesh file import/export (fem/meshio.py).

The reference consumed externally generated meshes through NGSolve's file
loaders (SURVEY.md §2, L0); load_mesh/save_mesh are this framework's
equivalent. Round-trips must preserve geometry and connectivity bitwise so a
solve on a loaded mesh reproduces the solve on the in-memory original.
"""

import numpy as np
import pytest

from spacetime.fem import (
    P1System,
    l_shape_mesh,
    load_mesh,
    save_mesh,
    unit_cube_mesh,
    unit_square_mesh,
    uniform_time_grid,
)
from spacetime.models import get_problem


@pytest.mark.parametrize("fmt,ext", [("gmsh", ".msh"), ("triangle", ".node")])
@pytest.mark.parametrize("make", [lambda: unit_square_mesh(6),
                                  lambda: l_shape_mesh(6),
                                  lambda: unit_cube_mesh(3)])
def test_roundtrip_geometry(tmp_path, fmt, ext, make):
    mesh = make()
    path = str(tmp_path / f"mesh{ext}")
    save_mesh(mesh, path, fmt=fmt)
    loaded = load_mesh(path)
    np.testing.assert_array_equal(loaded.vertices, mesh.vertices)
    np.testing.assert_array_equal(loaded.elements, mesh.elements)
    # Topological boundary detection must agree with the generator's
    # coordinate-based masks (the domains here have no interior holes).
    np.testing.assert_array_equal(loaded.boundary, mesh.boundary)
    np.testing.assert_array_equal(loaded.interior, mesh.interior)
    assert loaded.grid_shape is None


def test_roundtrip_operators_match(tmp_path):
    """Assembled M/A from a loaded mesh are bitwise those of the original."""
    mesh = l_shape_mesh(8)
    path = str(tmp_path / "lshape.msh")
    save_mesh(mesh, path)
    sys_a = P1System.from_mesh(mesh)
    sys_b = P1System.from_mesh(load_mesh(path))
    assert (sys_a.M != sys_b.M).nnz == 0
    assert (sys_a.A != sys_b.A).nnz == 0


def test_solve_on_loaded_mesh_matches(tmp_path):
    """Oracle solve on a file-loaded mesh reproduces the in-memory solve."""
    from spacetime.oracle.solver import OracleSolver

    problem = get_problem("lshape2d")
    grid = uniform_time_grid(3)
    mesh = l_shape_mesh(8)
    path = str(tmp_path / "lshape.node")
    save_mesh(mesh, path)
    res_a = OracleSolver(problem, P1System.from_mesh(mesh), grid).solve(
        tol=1e-6, compute_error=False
    )
    res_b = OracleSolver(
        problem, P1System.from_mesh(load_mesh(path)), grid
    ).solve(tol=1e-6, compute_error=False)
    assert res_a.iterations == res_b.iterations
    np.testing.assert_array_equal(res_a.residuals, res_b.residuals)


def test_triangle_one_indexed(tmp_path):
    """Triangle files may be 1-indexed; indices are honored per file."""
    mesh = unit_square_mesh(4)
    node = tmp_path / "m.node"
    ele = tmp_path / "m.ele"
    d = mesh.dim
    with open(node, "w") as f:
        f.write(f"{mesh.num_vertices} {d} 0 0\n")
        for i, v in enumerate(mesh.vertices):
            f.write(f"{i + 1} {float(v[0])!r} {float(v[1])!r}\n")
    with open(ele, "w") as f:
        f.write(f"{mesh.elements.shape[0]} {d + 1} 0\n")
        for i, e in enumerate(mesh.elements):
            f.write(f"{i + 1} {e[0] + 1} {e[1] + 1} {e[2] + 1}\n")
    loaded = load_mesh(str(node))
    np.testing.assert_array_equal(loaded.vertices, mesh.vertices)
    np.testing.assert_array_equal(loaded.elements, mesh.elements)


def test_gmsh_skips_boundary_elements(tmp_path):
    """Gmsh files mixing boundary lines with triangles load the triangles."""
    mesh = unit_square_mesh(3)
    path = tmp_path / "mixed.msh"
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.num_vertices}\n")
        for i, v in enumerate(mesh.vertices, start=1):
            f.write(f"{i} {float(v[0])!r} {float(v[1])!r} 0.0\n")
        f.write("$EndNodes\n")
        ne = mesh.elements.shape[0]
        f.write(f"$Elements\n{ne + 2}\n")
        # two boundary line elements (type 1), then the triangles
        f.write("1 1 2 0 0 1 2\n2 1 2 0 0 2 3\n")
        for i, e in enumerate(mesh.elements, start=3):
            f.write(f"{i} 2 2 0 0 {e[0] + 1} {e[1] + 1} {e[2] + 1}\n")
        f.write("$EndElements\n")
    loaded = load_mesh(str(path))
    np.testing.assert_array_equal(loaded.elements, mesh.elements)


def test_error_cases(tmp_path):
    bad = tmp_path / "bad.msh"
    bad.write_text("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="version 4.1"):
        load_mesh(str(bad))
    with pytest.raises(ValueError, match="cannot infer"):
        load_mesh("mesh.xyz")
    lonely = tmp_path / "lonely.node"
    lonely.write_text("1 2 0 0\n0 0.0 0.0\n")
    with pytest.raises(FileNotFoundError):
        load_mesh(str(lonely))


def test_cli_mesh_file(tmp_path, capsys):
    """--mesh-file drives the jax backend through the generic path."""
    from spacetime.run import main

    mesh = l_shape_mesh(6)
    path = str(tmp_path / "dom.msh")
    save_mesh(mesh, path)
    rc = main([
        "--backend", "jax", "--device", "cpu", "--problem", "lshape2d",
        "--mesh-file", path, "--time-levels", "3", "--tol", "1e-5",
        "--no-error", "--out", "",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "converged=True" in out


def test_cli_refine_flag(capsys):
    """--refine red-refines the generated mesh through the generic path."""
    from spacetime.run import main

    rc = main([
        "--backend", "jax", "--device", "cpu", "--problem", "lshape2d",
        "--space-n", "8", "--refine", "1", "--time-levels", "3",
        "--tol", "1e-5", "--no-error", "--out", "",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "(m=161)" in out and "converged=True" in out


def test_gmsh_rejects_nonsimplex_volume(tmp_path):
    """Quads/hexes/prisms must fail loudly, not silently mutilate the mesh."""
    path = tmp_path / "quad.msh"
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write("$Nodes\n4\n1 0.0 0.0 0.0\n2 1.0 0.0 0.0\n"
                "3 1.0 1.0 0.0\n4 0.0 1.0 0.0\n$EndNodes\n")
        f.write("$Elements\n2\n")
        f.write("1 2 2 0 0 1 2 3\n")   # one triangle
        f.write("2 3 2 0 0 1 2 3 4\n")  # one quad (type 3)
        f.write("$EndElements\n")
    with pytest.raises(ValueError, match="non-simplex"):
        load_mesh(str(path))


def test_triangle_ele_path_and_bad_base(tmp_path):
    mesh = unit_square_mesh(4)
    node = str(tmp_path / "m.node")
    save_mesh(mesh, node)
    loaded = load_mesh(str(tmp_path / "m.ele"))  # .ele path resolves the pair
    np.testing.assert_array_equal(loaded.elements, mesh.elements)
    with pytest.raises(ValueError, match="must end in .node or .ele"):
        load_mesh(str(tmp_path / "m"), fmt="triangle")


def test_unreferenced_vertices_compacted(tmp_path):
    """Vertices in no element (Triangle without -j) must not become
    interior DoFs with zero operator rows — they are compacted away."""
    mesh = unit_square_mesh(4)
    node = tmp_path / "m.node"
    ele = tmp_path / "m.ele"
    nv = mesh.num_vertices
    with open(node, "w") as f:
        f.write(f"{nv + 1} 2 0 0\n")
        for i, v in enumerate(mesh.vertices):
            f.write(f"{i} {float(v[0])!r} {float(v[1])!r}\n")
        f.write(f"{nv} 9.0 9.0\n")  # orphan vertex
    with open(ele, "w") as f:
        f.write(f"{mesh.elements.shape[0]} 3 0\n")
        for i, e in enumerate(mesh.elements):
            f.write(f"{i} {e[0]} {e[1]} {e[2]}\n")
    loaded = load_mesh(str(node))
    assert loaded.num_vertices == nv
    np.testing.assert_array_equal(loaded.elements, mesh.elements)
    np.testing.assert_array_equal(loaded.interior, mesh.interior)


def test_duplicate_elements_rejected(tmp_path):
    mesh = unit_square_mesh(4)
    node = tmp_path / "m.node"
    ele = tmp_path / "m.ele"
    with open(node, "w") as f:
        f.write(f"{mesh.num_vertices} 2 0 0\n")
        for i, v in enumerate(mesh.vertices):
            f.write(f"{i} {float(v[0])!r} {float(v[1])!r}\n")
    with open(ele, "w") as f:
        f.write(f"{mesh.elements.shape[0] + 1} 3 0\n")
        for i, e in enumerate(mesh.elements):
            f.write(f"{i} {e[0]} {e[1]} {e[2]}\n")
        e = mesh.elements[0]  # repeat the first element
        f.write(f"{mesh.elements.shape[0]} {e[0]} {e[1]} {e[2]}\n")
    with pytest.raises(ValueError, match="duplicate elements"):
        load_mesh(str(node))


def test_degenerate_element_rejected():
    """A zero-area (collinear-vertex) element must fail assembly loudly
    instead of poisoning the operators with inf/NaN."""
    from spacetime.fem import Mesh

    base = unit_square_mesh(2)
    # append a collinear triangle along the bottom edge (distinct vertices)
    degen = np.array([[0, 1, 2]], dtype=np.int32)  # (0,0),(.5,0),(1,0)
    elements = np.concatenate([base.elements, degen])
    mesh = Mesh(base.vertices, elements, base.boundary, base.interior, None)
    with pytest.raises(ValueError, match="degenerate"):
        P1System.from_mesh(mesh)


def test_binary_msh_clear_error(tmp_path):
    path = tmp_path / "bin.msh"
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n2.2 1 8\n")
        f.write(bytes(range(256)))  # binary body
    with pytest.raises(ValueError, match="binary MSH"):
        load_mesh(str(path))
