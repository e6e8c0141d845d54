"""The canvas layout across equation families.

The canvas and ELL layouts share the phase functions of
solver/hyperbolic.py, so every equation must produce identical physics
on both.  These tests pin the families with non-Euler feature flags:

  * shallow water — equilibrated states, affine shift, high-order flux,
    limiter fluxes, nodal sources (hyperbolic_module.template.h:700-795)
  * scalar conservation — user flux, 2*dim precomputed values, periodic
    canvas (KPP analog, prm/benchmarks/kpp.prm)
  * euler_aeos — TWO precomputation cycles with a stencil gamma_min
    (euler_aeos/hyperbolic_system.h:433)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ryujin_tpu.offline import assembly, ell, geometry, structured
from ryujin_tpu.offline.mesh import Boundary
from ryujin_tpu.postprocess.error import interpolate_nodal
from ryujin_tpu.solver.hyperbolic import HyperbolicModule
from ryujin_tpu.solver.integrator import TimeIntegrator


def _compare_layouts(eq, mesh, init, n_steps, cfl=0.3,
                     initial_precomputed=None, rtol=5e-11, atol=1e-12):
    data = assembly.assemble(mesh)
    sd = structured.pack_structured(data, mesh)
    res = {}
    for name, packed in (("ell", ell.pack(data)), ("canvas", sd)):
        ip = None
        if initial_precomputed is not None:
            pos = jnp.asarray(packed.positions.T, jnp.float64)
            ip = initial_precomputed(pos)[None]
        hm = HyperbolicModule(eq, packed, init, dtype=jnp.float64,
                              initial_precomputed=ip)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=cfl, cfl_max=cfl,
                            cfl_recovery_strategy="none")
        U = interpolate_nodal(init, packed, eq, 0.0, jnp.float64)
        out = ti.advance(U, 0.0, n_steps)
        real = np.asarray(packed.node_mask) > 0
        pos = np.asarray(packed.positions)[real]
        order = np.lexsort(pos.T)
        res[name] = (np.asarray(out[0])[:, real][:, order], float(out[3]))
    assert np.isfinite(res["canvas"][0]).all()
    np.testing.assert_allclose(
        res["canvas"][0], res["ell"][0], rtol=rtol, atol=atol
    )
    assert abs(res["canvas"][1] / res["ell"][1] - 1.0) < 1e-11


@pytest.mark.slow
def test_shallow_water_canvas_matches_ell():
    """SW smooth vortex exercises equilibrated states + affine shift +
    high-order flux + the 5-bound KE limiter on the canvas."""
    from ryujin_tpu.equations import shallow_water_initial_states as sw
    from ryujin_tpu.equations.shallow_water import (
        ShallowWater, ShallowWaterParams,
    )

    eq = ShallowWater(dim=2, params=ShallowWaterParams(gravity=9.81))
    init = sw.make_initial_state(
        eq, "smooth vortex", direction=[1.0, 1.0], position=[-1.0, -1.0],
        reference_depth=2.0, mach_number=1.0, beta=2.0,
    )
    mesh = geometry.rectangular_domain(
        [-6, -6], [6, 6], [1, 1], refinement=4,
        boundary_conditions=[Boundary.dirichlet] * 4,
    )
    _compare_layouts(eq, mesh, init.state, n_steps=3, cfl=0.25,
                      initial_precomputed=init.bathymetry)


@pytest.mark.slow
def test_shallow_water_sources_canvas_matches_ell():
    """Manning friction turns on nodal sources (shallow_water/
    hyperbolic_system.h:561-575); the canvas must apply them."""
    from ryujin_tpu.equations import shallow_water_initial_states as sw
    from ryujin_tpu.equations.shallow_water import (
        ShallowWater, ShallowWaterParams,
    )

    eq = ShallowWater(dim=2, params=ShallowWaterParams(
        gravity=9.81, manning_friction_coefficient=0.02,
    ))
    init = sw.make_initial_state(eq, "circular dam break")
    mesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=4,
        boundary_conditions=[Boundary.do_nothing] * 4,
    )
    _compare_layouts(eq, mesh, init.state, n_steps=3, cfl=0.4,
                      initial_precomputed=init.bathymetry)


@pytest.mark.slow
def test_scalar_kpp_periodic_canvas_matches_ell():
    """KPP rotating flux on a fully periodic canvas (ghost bands + minor
    axis wrap), the prm/benchmarks/kpp.prm analog."""
    from ryujin_tpu.equations.scalar_conservation import (
        ScalarConservation, kpp,
    )

    eq = ScalarConservation(dim=2, flux=kpp(2))

    def init(points, t):
        r = jnp.sqrt(points[0] ** 2 + points[1] ** 2)
        return jnp.where(r < 1.0, 3.5 * jnp.pi, 0.25 * jnp.pi)[None]

    mesh = geometry.rectangular_domain(
        [-2, -2], [2, 2], [1, 1], refinement=4,
        boundary_conditions=[Boundary.periodic] * 4,
    )
    _compare_layouts(eq, mesh, init, n_steps=3, cfl=0.4)


def test_aeos_nasg_canvas_matches_ell():
    """Euler-AEOS runs TWO precomputation cycles (surrogate gamma from a
    stencil min); the canvas stencil path must agree with ELL."""
    from ryujin_tpu.equations import euler_aeos as ae
    from ryujin_tpu.equations.euler_initial_states import make_initial_state

    import types

    eq = ae.EulerAEOS(
        dim=2,
        eos=ae.noble_abel_stiffened_gas(
            gamma=1.4, b=0.0, q=0.0, pinf=0.0,
        ),
    )
    # the vortex profile only depends on gamma; reuse the euler library
    # via a facade (initial_state_library_euler_aeos.h does the same):
    facade = types.SimpleNamespace(
        params=types.SimpleNamespace(gamma=1.4), dim=2
    )
    init = make_initial_state(
        facade, "isentropic vortex", direction=[1, 1], position=[-1, -1],
        mach_number=1.0, beta=5.0,
    )
    mesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=4,
        boundary_conditions=[Boundary.dirichlet] * 4,
    )
    _compare_layouts(eq, mesh, init, n_steps=3, cfl=0.3)
