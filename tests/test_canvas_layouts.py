"""Canvas (structured-lattice) layouts against the padded-ELL reference.

The shift-stencil canvas must reproduce the gather-based ELL path on
meshes whose canvases carry ghost bands (periodic axes), a periodic minor
axis (the O-grid cylinder), and the dense boundary-condition route.
"""

import jax.numpy as jnp
import numpy as np

from ryujin_tpu.equations.euler import Euler
from ryujin_tpu.equations.euler_initial_states import make_initial_state
from ryujin_tpu.offline import assembly, geometry, structured
from ryujin_tpu.postprocess.error import interpolate_nodal
from ryujin_tpu.solver.hyperbolic import HyperbolicModule
from ryujin_tpu.solver.integrator import TimeIntegrator


def test_periodic_ghost_canvas_matches_ell():
    """Periodic-y canvases carry ghost bands refreshed before every
    neighbor access; the roll path must reproduce the ELL reference on a
    fully periodic vortex."""
    from ryujin_tpu.offline import ell
    from ryujin_tpu.offline.mesh import Boundary

    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=4,
        boundary_conditions=[Boundary.periodic] * 4,
    )
    data = assembly.assemble(mesh)
    init = make_initial_state(
        eq, "isentropic vortex", direction=[1, 1], position=[0, 0],
        mach_number=1.0, beta=5.0,
    )
    sd = structured.pack_structured(data, mesh)
    assert any(g is not None for g in sd.ghosts), "expected y ghost band"
    res = {}
    for name, packed in (("ell", ell.pack(data)), ("canvas", sd)):
        hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                            cfl_recovery_strategy="none")
        U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
        out = ti.advance(U, 0.0, 3)
        real = np.asarray(packed.node_mask) > 0
        pos = np.asarray(packed.positions)[real]
        order = np.lexsort(pos.T)
        res[name] = (np.asarray(out[0])[:, real][:, order], float(out[3]))
    np.testing.assert_allclose(
        res["canvas"][0], res["ell"][0], rtol=5e-11, atol=1e-12
    )
    assert abs(res["canvas"][1] / res["ell"][1] - 1.0) < 1e-12


def test_cylinder_ogrid_canvas_matches_ell():
    """The O-grid cylinder (periodic-theta minor axis: the canvas wrap IS
    the periodic identification) must reproduce the ELL reference on the
    Mach-3 channel flow of the benchmark
    (prm/benchmarks/euler-mach3-cylinder-2d.prm analog)."""
    from ryujin_tpu.offline import ell

    eq = Euler(dim=2)
    mesh = geometry.cylinder(refinement=2)
    data = assembly.assemble(mesh)
    init = make_initial_state(
        eq, "uniform", direction=[1, 0], position=[1, 0],
        primitive_state=[1.4, 3.0, 1.0],
    )
    sd = structured.pack_structured(data, mesh)
    res = {}
    for name, packed in (("ell", ell.pack(data)), ("canvas", sd)):
        hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.6, cfl_max=0.6,
                            cfl_recovery_strategy="none")
        U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
        out = ti.advance(U, 0.0, 5)
        real = np.asarray(packed.node_mask) > 0
        pos = np.asarray(packed.positions)[real]
        order = np.lexsort(pos.T)
        res[name] = (np.asarray(out[0])[:, real][:, order], float(out[2]))
    np.testing.assert_allclose(
        res["canvas"][0], res["ell"][0], rtol=5e-11, atol=1e-12
    )
    assert abs(res["canvas"][1] / res["ell"][1] - 1.0) < 1e-12


def test_dense_boundary_conditions_match_scatter(monkeypatch):
    """The dense (where-select) BC application used on large canvases
    (solver/hyperbolic.py _bc_dense) is bitwise-identical to the
    gather/transform/scatter route: apply_boundary_conditions is
    pointwise in (U, normal, dirichlet).  Forced on via RYUJIN_DENSE_BC
    so small test meshes cover the production big-canvas path; a step
    mesh exercises dirichlet + slip + do_nothing and the multi-normal
    corner rounds."""
    from ryujin_tpu.offline.mesh import Boundary

    eq = Euler(dim=2)
    mesh = geometry.step(refinement=0)
    data = assembly.assemble(mesh)
    packed = structured.pack_structured(data, mesh)
    init = make_initial_state(
        eq, "uniform", primitive_state=(1.4, 3.0, 1.0)
    )
    res = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("RYUJIN_DENSE_BC", mode)
        hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
        assert (hm._bc_dense is not None) == (mode == "1")
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.4, cfl_max=0.8,
                            cfl_recovery_strategy="none")
        U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
        pos = jnp.asarray(packed.positions.T, jnp.float64)
        bump = 1.0 + 0.25 * jnp.exp(
            -8.0 * jnp.sum((pos - jnp.asarray([[1.0], [0.5]])) ** 2, 0)
        )
        U = U.at[0].mul(bump).at[3].mul(bump)
        out = ti.advance(U, 0.0, 3)
        res[mode] = (np.asarray(out[0]), float(out[3]))
    real = np.asarray(packed.node_mask) > 0
    np.testing.assert_array_equal(
        res["1"][0][:, real], res["0"][0][:, real]
    )
    assert res["1"][1] == res["0"][1]
