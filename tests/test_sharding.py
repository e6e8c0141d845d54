"""Multi-device SPMD correctness.

The analog of the reference's mpirun=4/8 testsuite variants
(tests/euler/*.mpirun=4.output): the same computation partitioned over
devices must reproduce the single-device result.  Here the node axis of
the state and all stencil arrays is sharded over an 8-device CPU mesh
(tests/conftest.py forces xla_force_host_platform_device_count=8) and
XLA GSPMD inserts the halo collectives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ryujin_tpu.equations.euler import Euler
from ryujin_tpu.equations.euler_initial_states import make_initial_state
from ryujin_tpu.offline import assembly, geometry, structured
from ryujin_tpu.postprocess.error import interpolate_nodal
from ryujin_tpu.solver.hyperbolic import HyperbolicModule
from ryujin_tpu.solver.integrator import TimeIntegrator


def test_sharded_step_matches_single_device():
    n_dev = len(jax.devices())
    assert n_dev >= 2, "conftest should provide 8 virtual devices"

    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=5,
        boundary_conditions=[4, 4, 4, 4],
    )
    data = assembly.assemble(mesh)
    packed = structured.pack_structured(
        data, mesh, pad_major=8 * n_dev
    )
    init = make_initial_state(
        eq, "isentropic vortex", direction=[1, 1], position=[-1, -1],
    )
    hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                        cfl_recovery_strategy="none")
    U0 = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)

    ref = np.asarray(ti.advance(U0, 0.0, 3)[0])

    # shard the node axis:
    from ryujin_tpu.parallel.sharding import (
        make_device_mesh, shard_state, shard_stencil,
    )

    device_mesh = make_device_mesh(n_dev)
    hm.stencil = shard_stencil(hm.stencil, device_mesh, packed.n_pad)
    U0s = shard_state(U0, device_mesh)
    ti2 = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                         cfl_recovery_strategy="none")
    out = np.asarray(ti2.advance(U0s, 0.0, 3)[0])

    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_structured_3d_matches_ell():
    """3D lattice canvas backend (rolls) vs the generic ELL path on one
    Euler step: same states at matched positions."""
    import jax.numpy as jnp
    import numpy as np

    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, ell, geometry, structured
    from ryujin_tpu.offline.mesh import Boundary
    from ryujin_tpu.postprocess.error import interpolate_nodal
    from ryujin_tpu.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu.solver.integrator import TimeIntegrator

    eq = Euler(dim=3)
    mesh = geometry.rectangular_domain(
        [0, 0, 0], [1, 1, 1], [1, 1, 1], 2,
        [Boundary.dirichlet] * 6, dim=3,
    )
    data = assembly.assemble(mesh)
    init = make_initial_state(
        eq, "uniform", primitive_state=(1.4, 1.0, 0.2, 0.1, 1.0)
    )
    res = {}
    for name, packed in (
        ("structured", structured.pack_structured(data, mesh)),
        ("ell", ell.pack(data)),
    ):
        hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.4, cfl_max=0.4,
                            cfl_recovery_strategy="none")
        U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
        U2, tau, ok = ti.step(U, 0.0, 1.0)
        real = np.asarray(packed.node_mask) > 0
        pos = np.asarray(packed.positions)[real]
        order = np.lexsort(pos.T)
        res[name] = (np.asarray(U2)[:, real][:, order], float(tau))
    np.testing.assert_allclose(
        res["structured"][0], res["ell"][0], rtol=5e-12, atol=1e-12
    )
    assert abs(res["structured"][1] / res["ell"][1] - 1.0) < 1e-12


def _sorted_real(U, packed):
    real = np.asarray(packed.node_mask) > 0
    pos = np.asarray(packed.positions)[real]
    return np.asarray(U)[:, real][:, np.lexsort(pos.T)]


def _assert_halo_exchange_only(ti, stencil, U0, n_state):
    """The compiled HLO exchanges halos with collective-permute and never
    all-gathers a state-sized array."""
    import re

    hlo = (
        ti._advance.lower(
            stencil, None, U0, jnp.float64(0.0), jnp.float64(jnp.inf), 1
        )
        .compile()
        .as_text()
    )
    assert "collective-permute" in hlo
    for m in re.finditer(r"all-gather[^\n]*", hlo):
        line = m.group(0)
        sizes = [int(s) for s in re.findall(r"f64\[([0-9,]+)\]",
                                            line.replace(",", ""))]
        for s in sizes:
            assert s < n_state, f"state-sized all-gather: {line[:120]}"


@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_slab_canvas_matches_single_device(dim):
    """GSPMD over a slab canvas: canvas axis 0 packed into n_dev
    ghost-banded slabs (pack_structured slabs=n_dev), node axis sharded,
    ghost refresh = slab-axis roll.  Must reproduce the single-device
    ELL result, with halos riding collective-permute."""
    from ryujin_tpu.offline import ell
    from ryujin_tpu.offline.mesh import Boundary
    from ryujin_tpu.parallel.sharding import (
        make_device_mesh, shard_state, shard_stencil,
    )

    n_dev = len(jax.devices())
    assert n_dev >= 2
    eq = Euler(dim=dim)
    if dim == 2:
        mesh = geometry.rectangular_domain(
            [-5, -5], [5, 5], [1, 1], refinement=4,
            boundary_conditions=[Boundary.dirichlet] * 4,
        )
        init = make_initial_state(
            eq, "isentropic vortex", direction=[1, 1], position=[-1, -1],
        )
        n_steps = 3
    else:
        mesh = geometry.rectangular_domain(
            [0, 0, 0], [1, 1, 1], [1, 1, 1], 3,
            [Boundary.dirichlet] * 6, dim=3,
        )
        init = make_initial_state(
            eq, "uniform", primitive_state=(1.4, 1.0, 0.2, 0.1, 1.0)
        )
        n_steps = 1
    data = assembly.assemble(mesh)

    def bump(packed, U):
        pos = jnp.asarray(packed.positions.T, jnp.float64)
        c = jnp.full((dim, 1), 0.5 if dim == 3 else 0.0)
        b = 1.0 + 0.3 * jnp.exp(-2.0 * jnp.sum((pos - c) ** 2, axis=0))
        return U.at[0].mul(b).at[-1].mul(b)

    def run(packed, device_mesh=None):
        hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                            cfl_recovery_strategy="none")
        U0 = bump(packed, interpolate_nodal(init, packed, eq, 0.0,
                                            jnp.float64))
        if device_mesh is not None:
            hm.stencil = shard_stencil(hm.stencil, device_mesh,
                                       packed.n_pad)
            U0 = shard_state(U0, device_mesh)
        return ti, hm, U0, ti.advance(U0, 0.0, n_steps)

    packed_ref = ell.pack(data)
    _, _, _, out_r = run(packed_ref)
    packed = structured.pack_structured(data, mesh, slabs=n_dev)
    assert packed.slab_spec[0] == n_dev
    device_mesh = make_device_mesh(n_dev)
    ti, hm, U0, out = run(packed, device_mesh)
    assert len(out[0].sharding.device_set) == n_dev

    np.testing.assert_allclose(
        _sorted_real(out[0], packed), _sorted_real(out_r[0], packed_ref),
        rtol=1e-11, atol=1e-12,
    )
    assert abs(float(out[3]) / float(out_r[3]) - 1.0) < 1e-11
    if dim == 2:
        _assert_halo_exchange_only(ti, hm.stencil, U0, packed.n_pad)


def test_chip_smoke_sharded_phase_on_virtual_devices():
    """chip_smoke's four-card phase (GSPMD step + multi-block slabs, one
    step from a perturbed state against one device, f32 bounds of the
    multi-device dry run) at tiny size on four virtual CPU devices."""
    import chip_smoke

    assert len(jax.devices()) >= 4
    chip_smoke.phase_sharded(n_dev=4, step_refinement=0,
                             cylinder_refinement=1, n_time_steps=1)


def test_sharded_navier_stokes_step_matches_single_device():
    """Backward-Euler parabolic solve (CG + boundary projections) under
    node-axis sharding agrees with the single-device result — the analog
    of the reference's becker mpirun=4 testsuite variants."""
    import jax.numpy as jnp
    import numpy as np

    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, ell, geometry
    from ryujin_tpu.offline.mesh import Boundary
    from ryujin_tpu.parallel.sharding import (
        make_device_mesh, shard_state, shard_stencil,
    )
    from ryujin_tpu.postprocess.error import interpolate_nodal
    from ryujin_tpu.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu.solver.parabolic import ParabolicSolver, ParabolicSystem

    eq = Euler(dim=1)
    init = make_initial_state(
        eq, "becker solution", position=[-0.125],
        velocity_galilean_frame=0.125, mu=0.01,
    )
    mesh = geometry.rectangular_domain(
        [-0.25], [0.25], [1], refinement=6,
        boundary_conditions=[Boundary.dirichlet] * 2, dim=1,
    )
    data = assembly.assemble(mesh)
    packed = ell.pack(data)
    hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64)
    ps = ParabolicSolver(
        eq, ParabolicSystem(mu=0.01), packed, data, mesh, init,
        hm.stencil, dtype=jnp.float64,
    )
    U0 = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
    step = jax.jit(lambda U: ps.backward_euler_step(U, 0.0, 1e-3))
    U_ref, ok_ref = step(U0)

    device_mesh = make_device_mesh()
    ps.stencil = shard_stencil(hm.stencil, device_mesh, packed.n_pad)
    arr = ps.arrays
    import dataclasses as dc

    ps.arrays = dc.replace(
        arr,
        **{
            f.name: shard_state(getattr(arr, f.name), device_mesh)
            for f in dc.fields(arr)
        },
    )
    U0s = shard_state(U0, device_mesh)
    U_sh, ok_sh = jax.jit(lambda U: ps.backward_euler_step(U, 0.0, 1e-3))(
        U0s
    )
    np.testing.assert_allclose(
        np.asarray(U_sh), np.asarray(U_ref), rtol=1e-11, atol=1e-13
    )
    assert bool(ok_sh) == bool(ok_ref)
