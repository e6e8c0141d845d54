"""Geometry generator library coverage.

The analog of exercising the reference's Geometries::populate_geometry_list
entries (geometry_disk.h, geometry_annulus.h, geometry_wall.h,
geometry_tank.h, geometry_airfoil.h, geometry_reader.h): each generator must
produce a conforming, positively-oriented quad mesh that assembles.
"""

import numpy as np
import pytest

from ryujin_tpu.offline import assembly, ell, geometry
from ryujin_tpu.offline.mesh import Boundary
from ryujin_tpu.offline.reader import read_msh


def _check(mesh, expected_area=None, tol=2e-2):
    p = mesh.vertices[mesh.cells]
    det = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])
    assert np.all(det > 0), "inverted cells"
    data = assembly.assemble(mesh)
    packed = ell.pack(data)
    assert packed.n_nodes > 0
    np.testing.assert_allclose(
        packed.lumped_mass[: packed.n_nodes].sum(),
        data.measure_of_omega,
        rtol=1e-10,
    )
    if expected_area is not None:
        np.testing.assert_allclose(
            data.measure_of_omega, expected_area, rtol=tol
        )
    return data


def test_disk():
    mesh = geometry.disk(radius=1.2, refinement=3)
    _check(mesh, np.pi * 1.2**2, tol=1e-2)
    assert np.all(mesh.boundary_ids == Boundary.dirichlet)
    r = np.linalg.norm(mesh.vertices[mesh.boundary_faces].reshape(-1, 2),
                       axis=1)
    np.testing.assert_allclose(r, 1.2, rtol=1e-12)


def test_wall():
    mesh = geometry.wall(refinement=2)
    data = _check(mesh, 3.2 * 1.0, tol=1e-12)
    assert data is not None
    ids = mesh.boundary_ids
    assert set(np.unique(ids)) == {
        Boundary.slip, Boundary.do_nothing, Boundary.dirichlet
    }


def test_wave_tank():
    mesh = geometry.wave_tank(
        reservoir_length=1.57, reservoir_width=0.81,
        flume_length=2.0, flume_width=0.24,
    )
    _check(mesh, 1.57 * 0.81 + 2.0 * 0.24, tol=1e-12)
    assert set(np.unique(mesh.boundary_ids)) == {
        Boundary.slip, Boundary.dynamic
    }


def test_annulus():
    mesh = geometry.annulus(refinement=0)
    L, r_i, r_o = 2.0, 0.6, 0.7
    band = np.pi * (r_o**2 - r_i**2)
    data = _check(mesh)
    assert L**2 - band < data.measure_of_omega < L**2 - 0.2 * band
    assert np.all(mesh.boundary_ids == Boundary.slip)
    # obstacle boundary faces lie on the two circles:
    fc = mesh.vertices[mesh.boundary_faces].mean(axis=1)
    interior = np.max(np.abs(fc), axis=1) < L / 2 - 1e-8
    r = np.linalg.norm(fc[interior], axis=1)
    assert np.all((r > r_i - 0.02) & (r < r_o + 0.02))
    # refinement keeps the obstacle arcs on the spherical manifold:
    fine = mesh.refine_global(1)
    fcf = fine.vertices[fine.boundary_faces].mean(axis=1)
    interior_f = np.max(np.abs(fcf), axis=1) < L / 2 - 1e-8
    assert interior_f.sum() == 2 * interior.sum()


def _cell_quality(mesh):
    """Min corner jacobian sign check: no inverted/degenerate quads."""
    p = mesh.vertices[mesh.cells]

    def cross(o, a, b):
        return (a[:, 0] - o[:, 0]) * (b[:, 1] - o[:, 1]) - (
            a[:, 1] - o[:, 1]
        ) * (b[:, 0] - o[:, 0])

    d1 = cross(p[:, 0], p[:, 1], p[:, 2])
    d2 = cross(p[:, 3], p[:, 2], p[:, 1])
    return int(((d1 <= 0) | (d2 <= 0)).sum())


@pytest.mark.parametrize(
    "kind", ["NASA SC(2) 0714", "ONERA OAT15a", "BELL 10", "NACA 0012"]
)
def test_airfoil(kind):
    """Transfinite C-type airfoil meshes: tabulated + generated profiles,
    valid cells, wall-normal grading, correct boundary ids
    (geometry_airfoil.h:823-1416)."""
    mesh = geometry.airfoil(airfoil_type=kind, refinement=1)
    data = _check(mesh)
    assert data.measure_of_omega < np.pi * 3.0**2
    assert set(np.unique(mesh.boundary_ids)) == {
        Boundary.no_slip, Boundary.dynamic
    }
    assert _cell_quality(mesh) == 0


def test_airfoil_grading():
    m0 = geometry.airfoil(refinement=1)
    # nearest off-wall neighbor of a mid-chord upper-surface point:
    import numpy as np

    wall_pts = m0.vertices[
        m0.boundary_faces[m0.boundary_ids == Boundary.no_slip]
    ].reshape(-1, 2)
    p = wall_pts[np.argmin(np.abs(wall_pts[:, 0]) + np.abs(
        wall_pts[:, 1] - 0.14))]
    d = np.linalg.norm(m0.vertices - p, axis=1)
    d = d[d > 1e-12]
    # graded first layer at refinement 1 is ~1e-2; uniform would be ~0.65
    assert d.min() < 0.05


def test_airfoil_unknown_type():
    with pytest.raises(ValueError):
        geometry.airfoil(airfoil_type="ONERA OA209")


def test_airfoil_3d_periodic_extrusion():
    """airfoil(dim=3): the C-mesh extruded over `width` with PERIODIC z
    identification (geometry_airfoil.h:1262-1396)."""
    m2 = geometry.airfoil(refinement=0)
    m3 = geometry.airfoil(refinement=0, dim=3, width=1.0, subdivisions_z=2)
    assert m3.dim == 3
    assert m3.n_vertices == 3 * m2.n_vertices  # 2 layers + 1
    # z faces identified: periodic pairs map the top layer onto layer 0
    pp = np.asarray(m3.periodic_pairs)
    assert len(pp) >= m2.n_vertices
    assert (pp[-m2.n_vertices:, 0] - pp[-m2.n_vertices:, 1]
            == 2 * m2.n_vertices).all()
    # side faces keep the 2D ids; no z-face boundary ids other than
    # periodic:
    ids = set(np.unique(m3.boundary_ids))
    assert ids == {Boundary.no_slip, Boundary.dynamic, Boundary.periodic}
    data = assembly.assemble(m3)
    data.validate()
    # periodic z: every interior-z vertex row sums the same measure
    assert abs(
        data.measure_of_omega
        - _check(m2).measure_of_omega * 1.0
    ) < 1e-8


MSH22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
5
1 3 2 0 1 1 2 3 4
2 1 2 1 1 1 2
3 1 2 2 2 2 3
4 1 2 1 3 3 4
5 1 2 3 4 4 1
$EndElements
"""


def test_reader_msh22(tmp_path):
    f = tmp_path / "square.msh"
    f.write_text(MSH22)
    mesh = read_msh(str(f))
    assert mesh.dim == 2 and mesh.n_cells == 1
    assert len(mesh.boundary_faces) == 4
    assert sorted(mesh.boundary_ids.tolist()) == [1, 1, 2, 3]
    _check(mesh, 1.0, tol=1e-12)


MSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
0 4 1 0
1 0 0 0 1 0 0 1 1 0 2 1 -2
2 1 0 0 1 1 0 1 2 0 2 3 -4
3 0 1 0 1 1 0 1 1 0 2 1 -3
4 0 0 0 0 1 0 1 2 0 2 4 -1
1 0 0 0 1 1 0 0 4 1 2 -3 4
$EndEntities
$Nodes
1 4 1 4
2 1 0 4
1
2
3
4
0 0 0
1 0 0
1 1 0
0 1 0
$EndNodes
$Elements
5 5 1 5
1 1 1 1
1 1 2
1 2 1 1
2 2 3
1 3 1 1
3 3 4
1 4 1 1
4 4 1
2 1 3 1
5 1 2 3 4
$EndElements
$EndFile
"""


def test_reader_msh41(tmp_path):
    f = tmp_path / "square41.msh"
    f.write_text(MSH41)
    mesh = read_msh(str(f))
    assert mesh.dim == 2 and mesh.n_cells == 1
    assert len(mesh.boundary_faces) == 4
    # boundary ids resolve through Entities to physical tags 1 and 2:
    assert sorted(mesh.boundary_ids.tolist()) == [1, 1, 2, 2]
    _check(mesh, 1.0, tol=1e-12)


def test_cylinder_ogrid_structured():
    """The default cylinder variant is a single logically-structured
    O-grid (geometry.cylinder_ogrid): exact channel corners, periodic
    theta seam, canvas-packable with the lane wrap as the periodic
    identification (geometry_cylinder.h analog, canvas-first layout)."""
    from ryujin_tpu.offline import structured

    mesh = geometry.cylinder(refinement=2)
    assert mesh.structured_shape == (65, 17)
    assert mesh.periodic_pairs is not None and len(mesh.periodic_pairs) == 17

    # the four channel corners are mesh vertices:
    for c in ([0, 0], [4, 0], [4, 2], [0, 2]):
        d = np.linalg.norm(mesh.vertices - np.asarray(c, float), axis=1)
        assert d.min() < 1e-12

    data = assembly.assemble(mesh)
    data.validate()
    area = 4.0 * 2.0 - np.pi * 0.25**2
    assert abs(data.measure_of_omega - area) / area < 1e-4

    # boundary tagging: inflow (left), outflow (right), slip elsewhere
    ids = np.asarray(mesh.boundary_ids)
    assert (ids == Boundary.dirichlet).sum() > 0
    assert (ids == Boundary.do_nothing).sum() > 0
    assert (ids == Boundary.slip).sum() > 0

    packed = structured.pack_structured(data, mesh)
    # periodic theta on the minor canvas axis: period 64 is not a
    # multiple of the 128-column minor padding, so the axis is padded to
    # 128 with the two ghost columns of minor_wrap realizing the
    # identification:
    assert packed.shape[-1] == 128
    assert packed.minor_wrap == (64, 128)
    assert packed.n_nodes == 64 * 17


def test_cylinder_blocks_variant():
    mesh = geometry.cylinder(refinement=1, variant="blocks")
    assert mesh.structured_index is None
    data = assembly.assemble(mesh)
    data.validate()
