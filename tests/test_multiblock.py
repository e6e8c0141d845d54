"""Multi-block canvas packing (offline/multiblock.py).

The reference's block-built geometries (annulus: geometry_annulus.h, disk:
geometry_disk.h, airfoil: geometry_airfoil.h, cylinder blocks:
geometry_cylinder.h:62-144) are quilts of logically-structured patches.
These tests check that the automatic block decomposition + multi-block
canvas packing reproduces the padded-ELL reference path bit-for-bit
(cross-interface ghost refresh incl. the reader-frame slot permutation).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ryujin_tpu.equations.euler import Euler
from ryujin_tpu.equations.euler_initial_states import make_initial_state
from ryujin_tpu.offline import assembly, ell, geometry, multiblock
from ryujin_tpu.postprocess.error import interpolate_nodal
from ryujin_tpu.solver.hyperbolic import HyperbolicModule
from ryujin_tpu.solver.integrator import TimeIntegrator


def _bumped_state(eq, packed, init, dtype):
    """Uniform Mach-3 flow with a density/energy bump (limiter active)."""
    U = interpolate_nodal(init, packed, eq, 0.0, dtype)
    pos = np.asarray(packed.positions)
    bump = 1.0 + 0.2 * np.exp(-10.0 * (pos**2).sum(1))
    U = U.at[0].mul(jnp.asarray(bump, dtype))
    U = U.at[3].mul(jnp.asarray(bump, dtype))
    return U


def _advance(eq, packed, init, dtype, n_steps):
    hm = HyperbolicModule(eq, packed, init, dtype=dtype)
    ti = TimeIntegrator(
        hm, scheme="erk 33", cfl_min=0.45, cfl_max=0.9,
        cfl_recovery_strategy="none",
    )
    U0 = _bumped_state(eq, packed, init, dtype)
    U, _, t, tau, _, _ = ti.advance(U0, 0.0, n_steps=n_steps)
    return np.asarray(U), float(t), float(tau)


@pytest.mark.parametrize("sym_mb", ["0", "1"])
@pytest.mark.parametrize(
    "geom,make",
    [
        ("annulus", lambda: geometry.annulus(refinement=0)),
        ("disk", lambda: geometry.disk(refinement=1)),
    ],
)
def test_multiblock_matches_ell(geom, make, sym_mb, monkeypatch):
    """Multi-block canvas == padded ELL on the same mesh (1e-12).

    Runs both the default two-direction evaluation and the env-gated
    half-slot path (RYUJIN_SYM_MB=1: one Riemann solve per undirected
    edge in block interiors + the O(interface) sym_fixup)."""
    monkeypatch.setenv("RYUJIN_SYM_MB", sym_mb)
    mesh = make()
    data = assembly.assemble(mesh)
    sd = multiblock.pack_multiblock(data, mesh, pad_minor=8, pad_major=8)
    el = ell.pack(data)
    assert sd.n_nodes == el.n_nodes
    assert sd.gmap_node is not None and len(sd.gmap_node[0]) > 0

    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    dtype = jnp.float64
    Us, ts, taus = _advance(eq, sd, init, dtype, 3)
    Ue, te, taue = _advance(eq, el, init, dtype, 3)
    assert abs(taus - taue) < 1e-14 * max(1.0, abs(taue))
    A = Us[:, np.asarray(sd.vertex_to_node)]
    B = Ue[:, np.asarray(el.vertex_to_node)]
    assert np.isfinite(A).all()
    np.testing.assert_allclose(A, B, rtol=0.0, atol=1e-12)


def test_extraordinary_vertices_side_rows():
    """The reference-style cylinder block construction has degree-12
    vertices (>8 stencil slots).  Such rows now live on the side ELL
    stencil (StructuredData.ev_side / solver Sideband) while every other
    row keeps the canvas — the whole mesh must reproduce the padded-ELL
    reference."""
    mesh = geometry.cylinder(refinement=1, variant="blocks")
    data = assembly.assemble(mesh)
    sd = multiblock.pack_multiblock(data, mesh, pad_minor=8, pad_major=8)
    assert sd.ev_side is not None
    assert len(sd.ev_side["rows"]) == 6  # the 6 valence-6 block corners
    assert sd.ev_side["mask"].shape[1] == 12  # 12-slot side rows
    el = ell.pack(data)

    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    dtype = jnp.float64
    Us, ts, taus = _advance(eq, sd, init, dtype, 3)
    Ue, te, taue = _advance(eq, el, init, dtype, 3)
    assert abs(taus / taue - 1.0) < 1e-14
    A = Us[:, np.asarray(sd.vertex_to_node)]
    B = Ue[:, np.asarray(el.vertex_to_node)]
    assert np.isfinite(A).all()
    np.testing.assert_allclose(A, B, rtol=0.0, atol=1e-12)


def test_truly_unstructured_falls_back():
    """A mesh with extraordinary rows at a large fraction of nodes is
    genuinely unstructured: packing must raise so the driver falls back
    to padded ELL.  (The cylinder blocks variant at refinement 0 has 6
    EVs among ~50 nodes — above the 1/64 threshold only for tiny
    meshes; synthesize the check via the threshold arithmetic.)"""
    mesh = geometry.cylinder(refinement=0, variant="blocks")
    data = assembly.assemble(mesh)
    try:
        sd = multiblock.pack_multiblock(data, mesh, pad_minor=8,
                                        pad_major=8)
    except multiblock.MultiblockError:
        return  # small mesh over the EV-fraction threshold: fallback ok
    assert sd.ev_side is None or (
        len(sd.ev_side["rows"]) <= max(64, data.n_nodes // 64)
    )


@pytest.mark.parametrize(
    "geom,make",
    [
        ("airfoil", lambda: geometry.airfoil(refinement=0)),
        ("cylinder-blocks",
         lambda: geometry.cylinder(refinement=1, variant="blocks")),
    ],
)
def test_multiblock_sharded_matches_single_device(geom, make):
    """Multi-chip fast path for multi-block canvases: the canvas re-laid
    into 8 ghost-banded slabs (pack_multiblock slabs=8), node axis
    sharded over the 8-virtual-device mesh, must reproduce the unsharded
    single-slab result bit-for-bit — the multi-block rendition of the
    reference's layout-agnostic MPI decomposition (every mesh, not just
    lattices: offline_data.h:136-169, sparse_matrix_simd.h:651-771).
    Communication shape: halos ride collective-permute; no state-sized
    all-gather (the gmap/EV-sideband scatters are two-index (slot, cell)
    ops precisely so GSPMD never merges the slot axis with the sharded
    node axis)."""
    import re

    import jax
    from jax.sharding import Mesh  # noqa: F401 (conftest provides 8 dev)

    from ryujin_tpu.parallel.sharding import (
        make_device_mesh, shard_state, shard_stencil,
    )

    n_dev = len(jax.devices())
    assert n_dev >= 2
    mesh = make()
    data = assembly.assemble(mesh)
    sd1 = multiblock.pack_multiblock(data, mesh, pad_minor=8, pad_major=8)
    sd8 = multiblock.pack_multiblock(data, mesh, pad_minor=8, pad_major=8,
                                     slabs=n_dev)
    assert sd8.slab_spec is not None and sd8.slab_spec[0] == n_dev

    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    dtype = jnp.float64
    U1, t1, tau1 = _advance(eq, sd1, init, dtype, 3)

    hm = HyperbolicModule(eq, sd8, init, dtype=dtype)
    device_mesh = make_device_mesh(n_dev)
    hm.stencil = shard_stencil(hm.stencil, device_mesh, sd8.n_pad)
    ti = TimeIntegrator(hm, scheme="erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    U0 = shard_state(_bumped_state(eq, sd8, init, dtype), device_mesh)
    out = ti.advance(U0, 0.0, n_steps=3)
    Us, taus = np.asarray(out[0]), float(out[3])

    assert abs(taus - tau1) < 1e-14 * max(1.0, abs(tau1))
    A = U1[:, np.asarray(sd1.vertex_to_node)]
    B = Us[:, np.asarray(sd8.vertex_to_node)]
    assert np.isfinite(B).all()
    np.testing.assert_allclose(B, A, rtol=0.0, atol=1e-12)

    # communication shape
    hlo = (
        ti._advance.lower(
            hm.stencil, None, U0, jnp.float64(0.0), jnp.float64(jnp.inf), 1
        ).compile().as_text()
    )
    assert "collective-permute" in hlo
    for m in re.finditer(r"all-gather[^\n]*", hlo):
        line = m.group(0)
        sizes = [int(s) for s in re.findall(r"f64\[([0-9,]+)\]",
                                            line.replace(",", ""))]
        for s in sizes:
            assert s < sd8.n_pad, f"state-sized all-gather: {line[:120]}"


def _amr_mesh(refinement=4, r=2.0):
    """A locally-refined (hanging-node) square: the reference's AMR case."""
    from ryujin_tpu.offline.mesh import Boundary, refine_local

    mesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=refinement,
        boundary_conditions=[Boundary.dirichlet] * 4,
    )
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    m2, _ = refine_local(mesh, (np.abs(centers) < r).all(axis=1))
    assert m2.hanging is not None and len(m2.hanging)
    return m2


def test_amr_multiblock_matches_ell():
    """Locally-refined (2:1 hanging-node) meshes pack onto the multi-block
    canvas: coarse/fine interface rows become EV side rows (incl. EV-EV
    edges transposed side-internally) while block interiors keep the
    canvas.  Must reproduce padded ELL (the reference runs its one CSR
    hot loop on any p4est-adapted mesh,
    hyperbolic_module.template.h:417-420)."""
    m2 = _amr_mesh()
    data = assembly.assemble(m2)
    sd = multiblock.pack_multiblock(data, m2, pad_minor=8, pad_major=8)
    assert sd.ev_side is not None
    assert (sd.ev_side["trans_side"] >= 0).any()  # EV-EV edges present
    el = ell.pack(data)
    assert sd.n_nodes == el.n_nodes

    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    dtype = jnp.float64
    Us, ts, taus = _advance(eq, sd, init, dtype, 3)
    Ue, te, taue = _advance(eq, el, init, dtype, 3)
    assert abs(taus / taue - 1.0) < 1e-14
    A = Us[:, np.asarray(sd.vertex_to_node)]
    B = Ue[:, np.asarray(el.vertex_to_node)]
    assert np.isfinite(A).all()
    np.testing.assert_allclose(A, B, rtol=0.0, atol=1e-12)


def test_amr_multiblock_sharded():
    """The slab-sharded multi-block path on a hanging-node mesh: 8
    virtual devices reproduce the unsharded result, halos ride
    collective-permute, no state-sized all-gather."""
    import re

    import jax

    from ryujin_tpu.parallel.sharding import (
        make_device_mesh, shard_state, shard_stencil,
    )

    n_dev = len(jax.devices())
    assert n_dev >= 2
    m2 = _amr_mesh(refinement=5)
    data = assembly.assemble(m2)
    sd1 = multiblock.pack_multiblock(data, m2, pad_minor=8, pad_major=8)
    sd8 = multiblock.pack_multiblock(data, m2, pad_minor=8, pad_major=8,
                                     slabs=n_dev)

    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    dtype = jnp.float64
    U1, t1, tau1 = _advance(eq, sd1, init, dtype, 3)

    hm = HyperbolicModule(eq, sd8, init, dtype=dtype)
    device_mesh = make_device_mesh(n_dev)
    hm.stencil = shard_stencil(hm.stencil, device_mesh, sd8.n_pad)
    ti = TimeIntegrator(hm, scheme="erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    U0 = shard_state(_bumped_state(eq, sd8, init, dtype), device_mesh)
    out = ti.advance(U0, 0.0, n_steps=3)
    Us, taus = np.asarray(out[0]), float(out[3])
    assert abs(taus - tau1) < 1e-14 * max(1.0, abs(tau1))
    A = U1[:, np.asarray(sd1.vertex_to_node)]
    B = Us[:, np.asarray(sd8.vertex_to_node)]
    assert np.isfinite(B).all()
    np.testing.assert_allclose(B, A, rtol=0.0, atol=1e-12)

    hlo = (
        ti._advance.lower(
            hm.stencil, None, U0, jnp.float64(0.0), jnp.float64(jnp.inf), 1
        ).compile().as_text()
    )
    assert "collective-permute" in hlo
    for m in re.finditer(r"all-gather[^\n]*", hlo):
        line = m.group(0)
        sizes = [int(s) for s in re.findall(r"f64\[([0-9,]+)\]",
                                            line.replace(",", ""))]
        for s in sizes:
            assert s < sd8.n_pad, f"state-sized all-gather: {line[:120]}"


def test_airfoil_multiblock_packs():
    """The transfinite C-type airfoil quilt embeds on a multi-block canvas."""
    mesh = geometry.airfoil(refinement=0)
    data = assembly.assemble(mesh)
    sd = multiblock.pack_multiblock(data, mesh, pad_minor=8, pad_major=8)
    assert sd.n_nodes == int((~data.is_constrained).sum())
    # every directed edge resolved: owner-row mask count equals nnz
    # (ghost rows carry gmap-copied mask entries on top)
    assert int(sd.mask[sd.node_mask > 0].sum()) == len(data.indices)


class TestExtruded3D:
    """Extruded multi-block canvases (pack_multiblock_extruded): the 3D
    airfoil path (geometry_airfoil.h:1279-1290) — a quilt cross-section
    x z lattice.  Statics are synthesized as (2D packed statics) x (1D
    z factors), exact for a uniform planar extrusion; refresh maps are
    z-vectorized."""

    @staticmethod
    def _init(eq):
        def init(x, t):
            rho = 1.0 + 0.1 * jnp.sin(2 * x[0]) * jnp.cos(
                3 * x[1]
            ) * jnp.cos(4 * np.pi * x[2])
            return jnp.stack(
                [rho, 0.1 * rho, -0.05 * rho, 0.02 * rho,
                 1.0 / 0.4 + 0.5 * 0.0125 * rho], 0,
            )

        return init

    @staticmethod
    def _run(packed, eq, init):
        from ryujin_tpu.postprocess.error import interpolate_nodal
        from ryujin_tpu.solver.integrator import TimeIntegrator

        hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                            cfl_recovery_strategy="none")
        U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
        t = 0.0
        for _ in range(2):
            U, tau, ok = ti.step(U, t, 1.0)
            t += float(tau)
            assert bool(ok)
        return np.asarray(U), t

    @pytest.mark.parametrize("periodic_z", [True, False])
    def test_matches_ell(self, periodic_z):
        from ryujin_tpu.equations.euler import Euler
        from ryujin_tpu.offline import ell, geometry
        from ryujin_tpu.offline.geometry import extrude
        from ryujin_tpu.offline.mesh import Boundary

        eq = Euler(dim=3)
        base = geometry.disk(refinement=1)
        bc = Boundary.periodic if periodic_z else Boundary.slip
        mesh3 = extrude(base, 0.0, 0.5, 4, bc_minus=bc, bc_plus=bc)
        data3 = assembly.assemble(mesh3)
        data3.validate()
        packed3 = multiblock.pack_multiblock_extruded(data3, mesh3)
        assert packed3.gmap_edge_z is not None
        pe = ell.pack(data3)
        init = self._init(eq)
        U_e, t_e = self._run(pe, eq, init)
        U_s, t_s = self._run(packed3, eq, init)
        assert abs(t_s - t_e) <= 1e-12 * abs(t_e)
        real = np.flatnonzero(packed3.node_to_vertex >= 0)
        dofs = packed3.node_to_vertex[real]
        np.testing.assert_allclose(
            U_s[:, real], U_e[:, pe.vertex_to_node[dofs]],
            rtol=1e-11, atol=1e-13,
        )


def _hex3_msh(path):
    """A gmsh v2.2 file: hexagon meshed as THREE quads around a central
    valence-3 vertex — a genuinely imported, locally-structured mesh
    whose interior extraordinary vertex exercises the EV sideband
    (the reference reads such meshes via GridIn and runs them through
    the same hot loop, geometry_reader.h:32-49)."""
    import math

    pts = [(0.0, 0.0)] + [
        (math.cos(k * math.pi / 3), math.sin(k * math.pi / 3))
        for k in range(6)
    ]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(len(pts))]
    for i, (x, y) in enumerate(pts):
        lines.append(f"{i + 1} {x} {y} 0")
    lines += ["$EndNodes", "$Elements"]
    # gmsh quads in cyclic corner order (reader maps to deal.II):
    quads = [(1, 2, 3, 4), (1, 4, 5, 6), (1, 6, 7, 2)]
    bnd = [(2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 2)]
    el = []
    eid = 1
    for a, b in bnd:
        el.append(f"{eid} 1 2 4 0 {a} {b}")  # tag 4 = dirichlet
        eid += 1
    for q in quads:
        el.append(f"{eid} 3 2 0 0 {q[0]} {q[1]} {q[2]} {q[3]}")
        eid += 1
    lines.append(str(len(el)))
    lines += el
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def test_gmsh_import_quilts(tmp_path):
    """An imported .msh quilt with an interior extraordinary vertex
    packs onto the multi-block canvas (EV side rows) and reproduces the
    ELL path — the 'generalized quilting for gmsh imports' capability
    (VERDICT r4 item 4)."""
    from ryujin_tpu.offline.reader import read_msh

    path = str(tmp_path / "hex3.msh")
    _hex3_msh(path)
    mesh = read_msh(path).refine_global(3)
    data = assembly.assemble(mesh)
    data.validate()
    packed = multiblock.pack_multiblock(data, mesh)
    # the valence-3 center embeds via the ghost rings (<= 8 neighbors);
    # the cross-block refresh maps are the quilt signature:
    assert packed.gmap_edge is not None and len(packed.gmap_edge[0])
    eq = Euler(dim=2)

    def init(x, t):
        rho = 1.0 + 0.1 * jnp.sin(2 * x[0]) * jnp.cos(3 * x[1])
        return jnp.stack(
            [rho, 0.1 * rho, -0.05 * rho,
             1.0 / 0.4 + 0.5 * 0.0125 * rho], 0,
        )

    def run(p):
        hm = HyperbolicModule(eq, p, init, dtype=jnp.float64)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                            cfl_recovery_strategy="none")
        U = interpolate_nodal(init, p, eq, 0.0, jnp.float64)
        t = 0.0
        for _ in range(2):
            U, tau, ok = ti.step(U, t, 1.0)
            t += float(tau)
            assert bool(ok)
        return np.asarray(U), t

    pe = ell.pack(data)
    U_e, t_e = run(pe)
    U_m, t_m = run(packed)
    assert abs(t_m - t_e) <= 1e-12 * abs(t_e)
    real = np.flatnonzero(packed.node_to_vertex >= 0)
    dofs = packed.node_to_vertex[real]
    np.testing.assert_allclose(
        U_m[:, real], U_e[:, pe.vertex_to_node[dofs]],
        rtol=1e-11, atol=1e-13,
    )
