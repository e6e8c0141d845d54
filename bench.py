"""Throughput benchmark on one GPU: f32 IDP substeps per second.

Prints one JSON line {"metric", "value", "unit", "device", ...}.

Metric: MQ/s = million DoF (Q-point) updates per second per device, the
reference's primary throughput figure (time_loop.template.h:1160-1214):
n_dofs * n_substeps / wall.  Runs only on a GPU listed in the peak table
(ryujin_tpu/utils/device.py); any other device is an error.

Every case develops the flow before timing (>= 1000-step warmup so the
limiter Newton runs everywhere; a thin warmup overstates throughput).
Cases via BENCH_CASE:

  step2d      2D Mach-3 forward-facing step (default)
  box3d       3D Mach-3 box
  cylinder3d  3D Mach-3 cylinder (O-grid x z extrusion)
  amr2d       locally-refined square with 2:1 hanging nodes (multiblock)
  q2step2d    2D Mach-3 step with cG Q2 (reach-2 canvas)
"""

from __future__ import annotations

import json
import os
import time

def _case_step2d(jnp):
    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, geometry, structured

    refinement = int(os.environ.get("BENCH_REFINEMENT", "3"))
    eq = Euler(dim=2)
    mesh = geometry.step(refinement=refinement)
    data = assembly.assemble(mesh)
    packed = structured.pack_structured(data, mesh)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    return eq, packed, init, "euler2d_mach3_step_throughput", 1500


def _case_q2step2d(jnp):
    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, geometry, structured

    refinement = int(os.environ.get("BENCH_REFINEMENT", "2"))
    ansatz = os.environ.get("BENCH_ANSATZ", "cG Q2")
    eq = Euler(dim=2)
    mesh = geometry.step(refinement=refinement)
    data = assembly.assemble(mesh, ansatz=ansatz)
    packed = structured.pack_structured(data, mesh)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    name = "euler2d_mach3_step_" + ansatz.replace(" ", "").lower()
    return eq, packed, init, name, 1000


def _case_box3d(jnp):
    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, geometry, structured
    from ryujin_tpu.offline.mesh import Boundary

    subdiv = json.loads(os.environ.get("BENCH_SUBDIV", "[31, 16, 16]"))
    refinement = int(os.environ.get("BENCH_REFINEMENT", "2"))
    eq = Euler(dim=3)
    mesh = geometry.rectangular_domain(
        [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], subdiv, refinement=refinement,
        boundary_conditions=[
            Boundary.dirichlet, Boundary.do_nothing,
            Boundary.slip, Boundary.slip, Boundary.slip, Boundary.slip,
        ],
        dim=3,
    )
    data = assembly.assemble(mesh)
    packed = structured.pack_structured(data, mesh)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    return eq, packed, init, "euler3d_mach3_box_throughput", 1000


def _case_cylinder3d(jnp):
    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, geometry, structured

    refinement = int(os.environ.get("BENCH_REFINEMENT", "3"))
    eq = Euler(dim=3)
    mesh = geometry.cylinder(refinement=refinement, dim=3)
    data = assembly.assemble(mesh)
    packed = structured.pack_structured(data, mesh)
    init = make_initial_state(
        eq, "uniform", direction=[1, 0, 0], position=[1, 0, 0],
        primitive_state=[1.4, 3.0, 1.0],
    )
    return eq, packed, init, "euler3d_mach3_cylinder_throughput", 1000


def _case_amr2d(jnp):
    import numpy as np

    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, geometry, multiblock
    from ryujin_tpu.offline.mesh import Boundary, refine_local

    refinement = int(os.environ.get("BENCH_REFINEMENT", "9"))
    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=refinement,
        boundary_conditions=[Boundary.dirichlet] * 4,
    )
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    mesh, _ = refine_local(mesh, (np.abs(centers) < 2.0).all(axis=1))
    data = assembly.assemble(mesh)
    blocks = multiblock.split_sparse_blocks(multiblock.decompose(mesh))
    packed = multiblock.pack_multiblock(data, mesh, blocks=blocks)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    return eq, packed, init, "euler2d_amr_adapted_throughput", 1000


CASES = {
    "step2d": _case_step2d,
    "q2step2d": _case_q2step2d,
    "box3d": _case_box3d,
    "cylinder3d": _case_cylinder3d,
    "amr2d": _case_amr2d,
}


def main():
    from ryujin_tpu.utils import device

    smi = device.query_nvidia_smi()  # before this process touches the card
    from ryujin_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import jax
    import jax.numpy as jnp

    from ryujin_tpu.postprocess.error import interpolate_nodal
    from ryujin_tpu.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu.solver.integrator import TimeIntegrator

    dev = device.require_gpu()
    peak = device.peaks(dev["kind"])
    case = os.environ.get("BENCH_CASE", "step2d")
    n_steps = int(os.environ.get("BENCH_STEPS", "20"))
    dtype = jnp.float32

    eq, packed, init, metric, warmup_default = CASES[case](jnp)
    warmup = int(os.environ.get("BENCH_WARMUP", str(warmup_default)))

    hm = HyperbolicModule(eq, packed, init, dtype=dtype)
    ti = TimeIntegrator(
        hm, scheme="erk 33", cfl_min=0.45, cfl_max=0.9,
        cfl_recovery_strategy=(
            "none" if case == "step2d" else "bang bang control"
        ),
    )
    substeps_per_step = 3  # erk 33
    n_dofs = packed.n_nodes

    U = interpolate_nodal(init, packed, eq, 0.0, dtype)
    # compile + develop the flow (device-resident, one sync):
    U, _, t, _, _, _ = jax.block_until_ready(
        ti.advance(U, 0.0, n_steps=max(warmup, 2))
    )

    reps = int(os.environ.get("BENCH_REPS", "1"))
    mqs_reps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(ti.advance(U, t, n_steps=n_steps))
        wall = time.perf_counter() - t0
        mqs_reps.append(n_dofs * n_steps * substeps_per_step / wall / 1e6)
    mqs = mqs_reps[-1]

    rec = {
        "metric": metric,
        "value": round(mqs, 3),
        "unit": "MQ/s/device",
        "device": dev,
        "nvidia_smi": smi,
        "precision": "float32",
    }
    if reps > 1:
        rec["reps"] = [round(v, 2) for v in mqs_reps]
    # flops per substep from XLA's cost analysis of one substep
    # (transcendentals counted as 1 flop: a lower bound), against the
    # device's published f32 peak:
    def substep(Uf, tau):
        Up, prec = hm.prepare_state_vector(Uf, 0.0)
        return hm.step(
            Up, prec,
            jnp.zeros((0,) + Up.shape, dtype),
            jnp.zeros((0,) + prec.shape, dtype),
            jnp.zeros((0,), dtype),
            tau, jnp.asarray(0.9, dtype),
            jnp.asarray(jnp.inf, dtype), compute_tau=True,
        )

    cost = (
        jax.jit(substep).lower(out[0], jnp.zeros((), dtype)).compile()
        .cost_analysis()
    )
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    fps = flops * mqs * 1e6 / n_dofs  # flops/substep * substeps/s
    rec["flops_per_substep"] = round(flops, 0)
    rec["flops_per_qdof"] = round(flops / n_dofs, 1)
    rec["fp32_peak_share"] = round(fps / peak["fp32_flops"], 4)
    rec["peak_source"] = peak["source"]
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
