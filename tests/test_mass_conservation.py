"""Discrete mass conservation.

The analog of the reference's tests/euler/check-mass-conservation_0{1,2}.prm
(incl. the mpirun=4 variant): a uniform flow in a slip-walled domain is run
for many steps and the total discrete mass  Sigma_i m_i rho_i  must stay
constant to round-off — the IDP update is conservative and slip walls admit
no mass flux (rho u.n = 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ryujin_tpu.equations.euler import Euler
from ryujin_tpu.equations.euler_initial_states import make_initial_state
from ryujin_tpu.offline import assembly, ell, geometry, structured
from ryujin_tpu.offline.mesh import Boundary
from ryujin_tpu.postprocess.error import interpolate_nodal
from ryujin_tpu.solver.hyperbolic import HyperbolicModule
from ryujin_tpu.solver.integrator import TimeIntegrator


def total_mass(U, packed):
    m = np.asarray(packed.lumped_mass) * np.asarray(packed.node_mask)
    return float(np.sum(m * np.asarray(U)[0]))


def _run(packed, eq, init, n_steps, shard=False):
    hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
    if shard:
        from ryujin_tpu.parallel.sharding import (
            make_device_mesh, shard_state, shard_stencil,
        )

        device_mesh = make_device_mesh()
        hm.stencil = shard_stencil(hm.stencil, device_mesh, packed.n_pad)
    ti = TimeIntegrator(hm, "ssprk 33", cfl_min=0.9, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
    if shard:
        from ryujin_tpu.parallel.sharding import shard_state

        U = shard_state(U, device_mesh)
    m0 = total_mass(U, packed)
    out = ti.advance(U, 0.0, n_steps)
    U1 = out[0]
    assert np.all(np.isfinite(np.asarray(U1)))
    return m0, total_mass(U1, packed)


def test_mass_conservation_slip_box():
    """check-mass-conservation_01.prm analog: slip walls on all sides."""
    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [0, 0], [1, 1], [1, 1], refinement=4,
        boundary_conditions=[Boundary.slip] * 4,
    )
    packed = structured.pack_structured(assembly.assemble(mesh), mesh)
    init = make_initial_state(
        eq, "uniform", primitive_state=(1.4, 3.0, 1.0), direction=[1, 0],
    )
    m0, m1 = _run(packed, eq, init, n_steps=25)
    assert abs(m1 - m0) <= 1e-11 * abs(m0)


def test_mass_conservation_annulus():
    """check-mass-conservation_02.prm analog: curved slip boundaries."""
    eq = Euler(dim=2)
    mesh = geometry.annulus(refinement=0)
    packed = ell.pack(assembly.assemble(mesh))
    init = make_initial_state(
        eq, "uniform", primitive_state=(1.4, 3.0, 1.0), direction=[1, 0],
    )
    m0, m1 = _run(packed, eq, init, n_steps=25)
    assert abs(m1 - m0) <= 1e-11 * abs(m0)


def test_mass_conservation_periodic():
    """Periodic box: conservation without any boundary flux at all."""
    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=4,
        boundary_conditions=[Boundary.periodic] * 4,
    )
    packed = structured.pack_structured(assembly.assemble(mesh), mesh)
    init = make_initial_state(
        eq, "isentropic vortex", direction=[1, 1], position=[0, 0],
    )
    m0, m1 = _run(packed, eq, init, n_steps=25)
    assert abs(m1 - m0) <= 1e-11 * abs(m0)


def test_mass_conservation_sharded():
    """mpirun=4 analog: same slip-box run on the 8-device CPU mesh."""
    n_dev = len(jax.devices())
    assert n_dev >= 2
    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [0, 0], [1, 1], [1, 1], refinement=4,
        boundary_conditions=[Boundary.slip] * 4,
    )
    packed = structured.pack_structured(
        assembly.assemble(mesh), mesh, pad_major=8 * n_dev
    )
    init = make_initial_state(
        eq, "uniform", primitive_state=(1.4, 3.0, 1.0), direction=[1, 0],
    )
    m0, m1 = _run(packed, eq, init, n_steps=20, shard=True)
    assert abs(m1 - m0) <= 1e-11 * abs(m0)
