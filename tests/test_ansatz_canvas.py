"""Canvas (structured-lattice) fast path for higher-order / dG ansatz.

The reference runs every ansatz through the same SIMD hot loop
(/root/reference/source/discretization.h:131-173,
hyperbolic_module.template.h:417-420).  Here every tensor ansatz packs
onto the shift-stencil canvas through the assembly-provided node lattice
(offline/assembly.py _node_lattice: cG Qp on the p-refined lattice with
reach-p offsets, dG Qp on the (p+1)-interleaved lattice) and must
reproduce the padded-ELL path up to summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ryujin_tpu.equations.euler import Euler
from ryujin_tpu.offline import assembly, ell, geometry, structured
from ryujin_tpu.offline.mesh import Boundary
from ryujin_tpu.postprocess.error import interpolate_nodal
from ryujin_tpu.solver.hyperbolic import (
    HyperbolicModule, HyperbolicModuleParams,
)
from ryujin_tpu.solver.integrator import TimeIntegrator

ALL = ["cG Q2", "cG Q3", "dG Q0", "dG Q1", "dG Q2"]


def _mesh2d(ref=2, periodic=False):
    bcs = (
        [Boundary.periodic] * 4 if periodic else [Boundary.dirichlet] * 4
    )
    return geometry.rectangular_domain(
        [0, 0], [2, 1], [2, 1], ref, boundary_conditions=bcs
    )


@pytest.mark.parametrize("ansatz", ALL)
def test_node_lattice(ansatz):
    mesh = _mesh2d(2)
    data = assembly.assemble(mesh, ansatz=ansatz)
    assert data.node_lattice_index is not None
    si = data.node_lattice_index
    shape = data.node_lattice_shape
    assert (si >= 0).all() and (si < np.asarray(shape)).all()
    continuous = ansatz.startswith("cG")
    p = int(ansatz[-1])
    nx, ny = 8 + 1, 4 + 1  # subdivisions [2, 1] x 2**2 refinement
    if continuous:
        assert shape == (p * (nx - 1) + 1, p * (ny - 1) + 1)
        # every lattice point is a distinct dof:
        key = si[:, 0] * shape[1] + si[:, 1]
        assert len(np.unique(key)) == data.n_nodes
    else:
        assert shape == ((p + 1) * (nx - 1), (p + 1) * (ny - 1))
    assert data.stencil_reach == max(p, 1)


def _init(eq):
    def init(x, t):
        rho = 1.0 + 0.1 * jnp.sin(2 * np.pi * x[0]) * jnp.cos(
            np.pi * x[1]
        )
        return jnp.stack(
            [rho, 0.2 * rho, -0.1 * rho, 1.0 / 0.4 + 0.5 * 0.05 * rho], 0
        )

    return init


def _run(packed, eq, init, steps=3):
    hm = HyperbolicModule(
        eq, packed, init, params=HyperbolicModuleParams(),
        dtype=jnp.float64,
    )
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                        cfl_recovery_strategy="none")
    U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
    t = 0.0
    taus = []
    for _ in range(steps):
        U, tau, ok = ti.step(U, t, 1.0)
        assert bool(ok)
        t += float(tau)
        taus.append(float(tau))
    return np.asarray(U), taus


def _compare(mesh, ansatz, periodic=False):
    eq = Euler(dim=2)
    data = assembly.assemble(mesh, ansatz=ansatz)
    assert data.node_lattice_index is not None, ansatz
    packed_e = ell.pack(data)
    packed_s = structured.pack_structured(data, mesh)
    assert packed_s.ansatz == ansatz
    if ansatz.startswith("dG"):
        assert packed_s.incidence is not None
    init = _init(eq)
    U_e, tau_e = _run(packed_e, eq, init)
    U_s, tau_s = _run(packed_s, eq, init)
    np.testing.assert_allclose(tau_e, tau_s, rtol=1e-12)
    # map canvas values back to dof numbering for comparison:
    real = np.flatnonzero(packed_s.node_to_vertex >= 0)
    dofs = packed_s.node_to_vertex[real]
    n2e = packed_e.vertex_to_node  # dof id -> ELL row
    np.testing.assert_allclose(
        U_s[:, real], U_e[:, n2e[dofs]], rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("ansatz", ALL)
def test_canvas_matches_ell(ansatz):
    _compare(_mesh2d(2), ansatz)


@pytest.mark.parametrize("ansatz", ["cG Q2", "dG Q1", "dG Q2"])
def test_canvas_matches_ell_periodic(ansatz):
    _compare(_mesh2d(2, periodic=True), ansatz, periodic=True)


def test_driver_q2_uses_canvas(tmp_path):
    """The driver packs cG Q2 onto the canvas."""
    from ryujin_tpu.config import Config
    from ryujin_tpu.driver import TimeLoop

    cfg = Config()
    cfg.time_loop.basename = str(tmp_path / "q2")
    cfg.time_loop.final_time = 0.05
    cfg.time_loop.timer_granularity = 0.05
    cfg.time_loop.enable_compute_error = True
    cfg.equation.equation = "euler"
    cfg.equation.dimension = 2
    cfg.discretization.mesh_refinement = 3
    cfg.discretization.ansatz = "cG Q2"
    cfg.discretization.parameters = {
        "position_bottom_left": [0, 0],
        "position_top_right": [1, 1],
        "boundary_conditions": ["dirichlet"] * 4,
    }
    cfg.initial_values.configuration = "isentropic vortex"
    cfg.initial_values.parameters = {"mach_number": 1.0, "beta": 5.0}
    loop = TimeLoop(cfg)
    assert isinstance(loop.packed, structured.StructuredData)
    assert loop.packed.reach == 2
    result = loop.run(quiet=True)
    assert np.isfinite(result["L2"])


@pytest.mark.parametrize("ansatz", ["cG Q2", "cG Q3"])
def test_periodic_3d_constraints(ansatz):
    """Periodic dof identification for 3D cG Q2/Q3: edge dofs pair
    orientation-aware,
    face dofs through the canonical-frame corner correspondence, with
    translation-invariant signatures preventing false identifications."""
    p = int(ansatz[-1])
    mesh = geometry.rectangular_domain(
        [0, 0, 0], [1, 1, 1], [1, 1, 1], 2,
        [Boundary.periodic] * 6, dim=3,
    )
    data = assembly.assemble(mesh, ansatz=ansatz)
    data.validate()
    n_real = int((~data.is_constrained).sum())
    assert n_real == (4 * p) ** 3  # one dof per fine-lattice point
    np.testing.assert_allclose(
        data.lumped_mass[~data.is_constrained].sum(), 1.0, rtol=1e-12
    )
    # every constrained dof maps to its periodic image:
    pos = data.positions
    con = np.flatnonzero(data.is_constrained)
    dp = (pos[con] - pos[data.master[con]]) % 1.0
    dp = np.minimum(dp, 1.0 - dp)
    assert np.abs(dp).max() < 1e-12

    # the solver runs and conserves mass on the ELL path:
    eq = Euler(dim=3)

    def init(x, t):
        rho = 1.0 + 0.1 * jnp.sin(2 * np.pi * x[0]) * jnp.cos(
            2 * np.pi * x[1]
        )
        z = 0 * rho
        return jnp.stack(
            [rho, 0.1 * rho, z, z, 1.0 / 0.4 + 0.5 * 0.01 * rho], 0
        )

    packed = ell.pack(data)
    U0, _ = _run(packed, eq, init, steps=0)
    U2, _ = _run(packed, eq, init, steps=2)
    m = np.asarray(packed.lumped_mass)
    nm = np.asarray(packed.node_mask) > 0
    m0 = float((U0[0] * m)[nm].sum())
    m2 = float((U2[0] * m)[nm].sum())
    np.testing.assert_allclose(m2, m0, rtol=1e-12)
