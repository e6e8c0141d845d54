#!/usr/bin/env python3
"""End-to-end proof that the solver runs on an NVIDIA GPU.

    python3 chip_smoke.py           # one GPU: every phase below
    python3 chip_smoke.py --four    # four GPUs: the sharded phase only

Phases, all in this one process (each runs even after another failed; the
exit code is 1 if any failed):

  device       JAX version, platform, device kind and count, and the
               card's name and power limit from nvidia-smi.  Fails unless
               JAX's platform is gpu: there is no CPU fallback.
  step-f32,    the Mach-3 forward-facing step benchmark config at its
  step-f64     shipped size (refinement 3, ~1.03M nodes) through TimeLoop:
               compile + first chunk, steady MQ/s over a few hundred
               device-resident steps, peak device memory, the compiled
               advance's memory analysis, finite + admissible final state,
               and a short TimeLoop.run() with VTU output off.
  ell-3d       the Mach-3 cylinder 3D config at its shipped refinement 3,
               which the driver packs as ELL: a few dozen steps, finite +
               admissible, MQ/s.
  gpu-vs-cpu   the step at refinement 1, 20 f64 steps on the GPU against
               the same steps on this process's CPU backend (the plain
               reference); only the order of floating-point sums differs.
  vortex-f64   Euler isentropic vortex at 4225 dofs against the
               reference's double baseline, within 1%.
  vortex-f32   the vortex at levels 6/7/8 against the reference's float
               baselines (L1, L2 within 1.3x, Linf within 1.5x).
  sw-vortex    shallow-water smooth vortex at level 6 in f32, L1 within 5%
               of the reference's double baseline.
  sharded      (--four only) GSPMD node-axis sharding over four GPUs: the
               step at refinement 4 (~4.1M nodes) and the multi-block
               cylinder at refinement 6 (~0.53M nodes, 4 slabs), each one
               f32 step against the same step on one GPU: from the
               uniform state within rtol 1e-5 / atol 1e-6 (tau within
               1e-9), from a perturbed state within 1e-5 of each
               component's maximum; then 10 timed sharded steps.

The last line of standard output is one JSON object, printed only when
every phase passed:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from ryujin_tpu.utils import device as _device

ROOT = Path(__file__).resolve().parent
STEP_CONFIG = ROOT / "configs/benchmarks/euler-mach3-forward-facing-step.yaml"
CYLINDER_3D_CONFIG = ROOT / "configs/benchmarks/euler-mach3-cylinder-3d.yaml"

# euler-isentropic_vortex-erk33.baseline: double (4225 dofs) and float
# (Linf, L1, L2) per refinement level; refinement 6 = 4225 dofs
VORTEX_DOUBLE_L6 = (5.465e-3, 4.017e-4, 9.442e-4)
VORTEX_FLOAT = {
    6: (5.4715e-3, 4.03722e-4, 9.44413e-4),
    7: (6.57314e-4, 5.98743e-5, 1.18905e-4),
    8: (1.63494e-4, 2.87595e-5, 3.67441e-5),  # the f32 plateau
}
# shallow_water-smooth_vortex-erk33.baseline, double, 4225 dofs
SW_VORTEX_DOUBLE_L1 = 6.27538e-4


class PhaseFailure(AssertionError):
    """A phase computed something outside its stated bounds."""


def _say(msg: str) -> None:
    print(msg, flush=True)


def check_device(rec) -> None:
    if rec["platform"] != "gpu":
        raise PhaseFailure(
            f"JAX found no GPU: platform {rec['platform']!r} "
            f"({rec['kind']}); chip_smoke has no CPU fallback"
        )


def _real_nodes(packed) -> np.ndarray:
    return np.asarray(packed.node_mask) > 0


def check_state(eq, packed, U, what: str) -> None:
    """Every real node's state is finite and inside the invariant domain."""
    import jax.numpy as jnp

    Ur = np.asarray(U)[:, _real_nodes(packed)]
    if not np.isfinite(Ur).all():
        raise PhaseFailure(f"{what}: non-finite state")
    adm = np.asarray(eq.is_admissible(jnp.asarray(Ur)))
    if not adm.all():
        raise PhaseFailure(
            f"{what}: {int((~adm).sum())} of {adm.size} nodes "
            f"not admissible"
        )


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: not available on this backend"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f[:-9]} {getattr(ma, f, 'n/a')}" for f in fields
    )


def _peak_bytes(dev=None) -> str:
    import jax

    stats = (dev or jax.devices()[0]).memory_stats()
    if not stats:
        return "not reported by this backend"
    return str(stats.get("peak_bytes_in_use", "not reported"))


def load_config(path, **overrides):
    """The shipped config with `section.field` overrides (dots as __)."""
    from ryujin_tpu.config import Config

    cfg = Config.load(str(path))
    for key, value in overrides.items():
        obj = cfg
        parts = key.split("__")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], value)
    cfg.validate()
    return cfg


def phase_time_loop(config_path, precision: str, n_steps: int,
                    chunk: int = 32, refinement=None, label="",
                    card="", run_check: bool = True,
                    expect_layout=None) -> dict:
    """Config -> TimeLoop -> device-resident TimeIntegrator.advance."""
    import jax
    import jax.numpy as jnp

    from ryujin_tpu.driver import TimeLoop
    from ryujin_tpu.postprocess.error import interpolate_nodal
    from ryujin_tpu.solver.integrator import TABLEAUX

    with tempfile.TemporaryDirectory() as tmp:
        over = {
            "precision": precision,
            "time_loop__enable_output_full": False,
            "time_loop__basename": os.path.join(tmp, "smoke"),
        }
        if refinement is not None:
            over["discretization__mesh_refinement"] = refinement
        cfg = load_config(config_path, **over)
        t0 = time.perf_counter()
        loop = TimeLoop(cfg)
        t_setup = time.perf_counter() - t0
        ti, hm, packed = loop.time_integrator, loop.hyperbolic_module, \
            loop.packed
        substeps = TABLEAUX[ti.scheme].n_sub
        layout = type(packed).__name__
        _say(f"  {label}: {packed.n_nodes} nodes (n_pad {packed.n_pad}), "
             f"layout {layout}, backend {loop.backend}, dtype "
             f"{jnp.dtype(loop.dtype).name}, host set-up {t_setup:.2f} s")
        if expect_layout is not None and layout != expect_layout:
            raise PhaseFailure(f"{label}: the driver chose {layout}, "
                               f"expected {expect_layout}")

        U0 = interpolate_nodal(loop.initial_state_fn, packed, loop.eq, 0.0,
                               loop.dtype)
        t0 = time.perf_counter()
        out = jax.block_until_ready(ti.advance(U0, 0.0, chunk))
        t_first = time.perf_counter() - t0
        t_chunk1 = float(out[2])
        n_chunks = max(1, n_steps // chunk)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            out = ti.advance(out[0], out[2], chunk)
        out = jax.block_until_ready(out)
        wall = time.perf_counter() - t0
        steps = n_chunks * chunk
        mqs = packed.n_nodes * steps * substeps / wall / 1e6
        restarts, warns = int(out[4]), int(out[5])
        _say(f"  {label}: set-up (compile + first {chunk}-step chunk) "
             f"{t_first:.2f} s; steady {steps} steps in {wall:.3f} s = "
             f"{mqs:.3f} MQ/s [{card}, {precision}]; t = "
             f"{float(out[2]):.6g}, restarts {restarts}, warnings {warns}")
        _say(f"  {label}: peak_bytes_in_use {_peak_bytes()}")
        t0 = time.perf_counter()
        compiled = ti._advance.lower(
            hm.stencil, ti._parrays(), U0, jnp.asarray(0.0, loop.dtype),
            jnp.asarray(jnp.inf, loop.dtype), chunk,
        ).compile()
        _say(f"  {label}: {_memory_line(compiled)} (lower + compile "
             f"again {time.perf_counter() - t0:.2f} s)")
        check_state(loop.eq, packed, out[0], label)
        _say(f"  {label}: final state finite and admissible on all "
             f"{packed.n_nodes} nodes")
        if run_check:
            # the user's entry path: TimeLoop.run to the time of the
            # first chunk, two ticks, VTU output off
            loop.config.time_loop.final_time = t_chunk1
            loop.config.time_loop.timer_granularity = t_chunk1 / 2
            t0 = time.perf_counter()
            res = loop.run(chunk=chunk, quiet=True)
            if abs(res["t"] - t_chunk1) > 1e-6 * max(1.0, t_chunk1):
                raise PhaseFailure(
                    f"{label}: TimeLoop.run stopped at t = {res['t']}, "
                    f"expected {t_chunk1}"
                )
            check_state(loop.eq, packed, res["U"], label + " run()")
            _say(f"  {label}: TimeLoop.run() to t = {res['t']:.6g} in "
                 f"{res['cycles']} cycles, {time.perf_counter() - t0:.2f} "
                 f"s, finite and admissible")
        return {"mqs": mqs, "n_nodes": packed.n_nodes, "layout": layout,
                "setup_s": t_first}


def phase_gpu_vs_cpu(refinement: int = 1, n_steps: int = 20,
                     rtol: float = 1e-10) -> float:
    """The same f64 steps on the default device and on the CPU backend.

    Returns the largest per-component max|dU| / max|U_cpu|."""
    import jax

    from ryujin_tpu.driver import TimeLoop
    from ryujin_tpu.postprocess.error import interpolate_nodal

    def run():
        with tempfile.TemporaryDirectory() as tmp:
            cfg = load_config(
                STEP_CONFIG, precision="float64",
                discretization__mesh_refinement=refinement,
                time_loop__enable_output_full=False,
                time_loop__basename=os.path.join(tmp, "ref"),
            )
            loop = TimeLoop(cfg)
            U0 = interpolate_nodal(loop.initial_state_fn, loop.packed,
                                   loop.eq, 0.0, loop.dtype)
            out = loop.time_integrator.advance(U0, 0.0, n_steps)
            U, t = np.asarray(out[0]), float(out[2])
            return U, t, loop

    U_dev, t_dev, loop = run()
    with jax.default_device(jax.devices("cpu")[0]):
        U_cpu, t_cpu, _ = run()
    real = _real_nodes(loop.packed)
    a, b = U_dev[:, real], U_cpu[:, real]
    rel = float(max(
        np.abs(a[c] - b[c]).max() / np.abs(b[c]).max()
        for c in range(a.shape[0])
    ))
    dt = abs(t_dev - t_cpu) / abs(t_cpu)
    _say(f"  gpu-vs-cpu: step refinement {refinement} "
         f"({loop.packed.n_nodes} nodes), {n_steps} f64 steps on "
         f"{jax.devices()[0].device_kind} vs CPU: max_c max|dU_c|/max|U_c| "
         f"= {rel:.3e} (limit {rtol:.0e}), |dt|/t = {dt:.3e} (limit "
         f"{rtol:.0e})")
    if not (rel <= rtol and dt <= rtol):
        raise PhaseFailure("gpu-vs-cpu: device and CPU results differ")
    return rel


def verification_errors(problem: str, level: int, dtype_name: str):
    """(Linf, L1, L2) of a verification problem after t = 2 on the canvas
    layout the driver picks for it, through the XLA path."""
    import jax
    import jax.numpy as jnp

    from ryujin_tpu.offline import assembly, geometry, structured
    from ryujin_tpu.offline.mesh import Boundary
    from ryujin_tpu.postprocess.error import compute_error, interpolate_nodal
    from ryujin_tpu.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu.solver.integrator import TimeIntegrator

    dtype = jnp.dtype(dtype_name)
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    if problem == "vortex":
        from ryujin_tpu.equations.euler import Euler
        from ryujin_tpu.equations.euler_initial_states import (
            make_initial_state,
        )

        eq = Euler(dim=2)
        init = make_initial_state(
            eq, "isentropic vortex", direction=[1, 1], position=[-1, -1],
            mach_number=1.0, beta=5.0,
        )
        bathymetry, lo, cfl = None, 5.0, 0.2
        components = ("rho", "m_1", "m_2", "E")
    elif problem == "sw-vortex":
        from ryujin_tpu.equations import shallow_water_initial_states as sws
        from ryujin_tpu.equations.shallow_water import (
            ShallowWater, ShallowWaterParams,
        )

        eq = ShallowWater(dim=2, params=ShallowWaterParams(gravity=9.81))
        sw_init = sws.make_initial_state(
            eq, "smooth vortex", direction=[1.0, 1.0],
            position=[-1.0, -1.0], reference_depth=2.0, mach_number=1.0,
            beta=2.0,
        )
        init, bathymetry, lo, cfl = sw_init.state, sw_init.bathymetry, \
            6.0, 0.25
        components = ("h", "q_1", "q_2")
    else:
        raise ValueError(f"unknown verification problem {problem!r}")
    mesh = geometry.rectangular_domain(
        [-lo, -lo], [lo, lo], [1, 1], refinement=level,
        boundary_conditions=[Boundary.dirichlet] * 4,
    )
    packed = structured.pack_structured(assembly.assemble(mesh), mesh)
    ip = None
    if bathymetry is not None:
        ip = bathymetry(jnp.asarray(packed.positions.T, dtype))[None]
    hm = HyperbolicModule(eq, packed, init, dtype=dtype,
                          initial_precomputed=ip)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=cfl, cfl_max=cfl,
                        cfl_recovery_strategy="none")
    U = interpolate_nodal(init, packed, eq, 0.0, dtype)
    t, t_final = 0.0, 2.0
    while t < t_final - 1e-6:
        U, _, t_dev, _, _, _ = ti.advance(U, t, 200, t_final=t_final)
        t = float(t_dev)
    Up, _ = hm.prepare_state_vector(U, t)
    check_state(eq, packed, Up, f"{problem} l{level} {dtype_name}")
    return compute_error(eq, mesh, packed, np.asarray(Up), t, init,
                         components=list(components))


def phase_vortex_f64(level: int = 6, reference=VORTEX_DOUBLE_L6,
                     band: float = 0.01):
    errs = verification_errors("vortex", level, "float64")
    ok = all(abs(e / r - 1.0) <= band for e, r in zip(errs, reference))
    _say(f"  vortex-f64 l{level}: " + "  ".join(
        f"{n} {e:.4e} (ref {r:.4e}, |rel| {abs(e / r - 1):.2e} <= {band})"
        for n, e, r in zip(("Linf", "L1", "L2"), errs, reference)
    ) + f"  {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("vortex-f64: outside 1% of the double baseline")
    return errs


def phase_vortex_f32(levels=(6, 7, 8), reference=VORTEX_FLOAT):
    failed = []
    for level in levels:
        linf, l1, l2 = verification_errors("vortex", level, "float32")
        ri, r1, r2 = reference[level]
        ok = l1 < 1.3 * r1 and linf < 1.5 * ri and l2 < 1.3 * r2
        _say(f"  vortex-f32 l{level}: Linf {linf:.4e} (limit 1.5 x "
             f"{ri:.4e})  L1 {l1:.4e} (limit 1.3 x {r1:.4e})  L2 "
             f"{l2:.4e} (limit 1.3 x {r2:.4e})  {'PASS' if ok else 'FAIL'}")
        if not ok:
            failed.append(level)
    if failed:
        raise PhaseFailure(f"vortex-f32: levels {failed} outside the bands")


def phase_sw_vortex_f32(level: int = 6, reference=SW_VORTEX_DOUBLE_L1,
                        band: float = 0.05):
    _, l1, _ = verification_errors("sw-vortex", level, "float32")
    ok = abs(l1 / reference - 1.0) < band
    _say(f"  sw-vortex-f32 l{level}: L1 {l1:.4e} (ref double "
         f"{reference:.4e}, |rel| {abs(l1 / reference - 1):.2e} < {band})"
         f"  {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("sw-vortex: outside 5% of the double baseline")
    return l1


def _check_placement(arrays, n_dev: int, n_pad: int, what: str) -> None:
    """Every node-axis array is split over all devices: none lands whole
    on one device."""
    for name, x in arrays:
        if getattr(x, "ndim", 0) < 1 or x.shape[-1] != n_pad:
            continue
        devs = x.sharding.device_set
        shard_n = {s.data.shape[-1] for s in x.addressable_shards}
        if len(devs) != n_dev or shard_n != {n_pad // n_dev}:
            raise PhaseFailure(
                f"{what}: {name} {x.shape} is not split over {n_dev} "
                f"devices (devices {len(devs)}, shard widths {shard_n})"
            )


def _sharded_vs_single(label, eq, packed, init, n_dev, n_time_steps,
                       to_vertices=None):
    """One ERK33 step sharded over n_dev devices against the same step on
    one device, from two states, then n_time_steps timed sharded steps.

    From the uniform initial state the step is held to the f32 bounds of
    the multi-device dry run, elementwise (rtol 1e-5, atol 1e-6, tau
    within 1e-9).  Uniform data cannot show a wrong halo, so the step is
    also compared from a smoothly perturbed state (a function of
    position, so every layout sees the same state): every slab boundary
    then carries varying data and a wrong halo shows as an O(1)
    difference, held to max|dU_c| <= 1e-5 max|U_c| per component.  More
    than one step is not compared: at a shock, 1-ulp differences from
    different fusion of the partitioned program grow past the f32 bounds
    within ten steps."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ryujin_tpu.parallel.sharding import (
        make_device_mesh, shard_state, shard_stencil,
    )
    from ryujin_tpu.postprocess.error import interpolate_nodal
    from ryujin_tpu.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu.solver.integrator import TimeIntegrator

    dtype = jnp.float32
    x, y = np.asarray(packed.positions).T
    factor = np.where(np.asarray(packed.node_mask) > 0,
                      1.0 + 0.2 * np.sin(5.0 * x) * np.cos(7.0 * y), 1.0)
    U_uniform = interpolate_nodal(init, packed, eq, 0.0, dtype)
    starts = {"uniform": U_uniform,
              "perturbed": U_uniform * jnp.asarray(factor, dtype)[None]}

    def build():
        hm = HyperbolicModule(eq, packed, init, dtype=dtype)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                            cfl_recovery_strategy="none")
        return hm, ti

    dmesh = make_device_mesh(n_dev)
    hm, ti = build()
    hm.stencil = shard_stencil(hm.stencil, dmesh, packed.n_pad)
    t0 = time.perf_counter()
    sharded = {
        k: jax.block_until_ready(ti.advance(shard_state(U, dmesh), 0.0, 1))
        for k, U in starts.items()
    }
    t_first = time.perf_counter() - t0
    out = sharded["perturbed"]
    # same input shardings and argument kinds as the first calls, so the
    # timed call reuses their compilation:
    U1, t1 = shard_state(out[0], dmesh), float(out[2])
    t0 = time.perf_counter()
    jax.block_until_ready(ti.advance(U1, t1, n_time_steps))
    wall = time.perf_counter() - t0
    mqs = packed.n_nodes * n_time_steps * 3 / wall / 1e6
    _check_placement(
        [("U", out[0])] + [
            (f.name, getattr(hm.stencil, f.name))
            for f in dataclasses.fields(hm.stencil)
        ],
        n_dev, packed.n_pad, label,
    )
    in_use = [d.memory_stats() or {} for d in jax.devices()[:n_dev]]
    _say(f"  {label}: {packed.n_nodes} nodes (n_pad {packed.n_pad}) on "
         f"{n_dev} devices: compile + 2 single steps {t_first:.2f} s, next "
         f"{n_time_steps} steps {wall:.3f} s = {mqs:.3f} MQ/s; "
         f"bytes_in_use per device "
         f"{[s.get('bytes_in_use', 'n/a') for s in in_use]}")

    hm1, ti1 = build()
    failed = []
    for k, U in starts.items():
        ref = jax.block_until_ready(ti1.advance(U, 0.0, 1))
        A, B = np.asarray(sharded[k][0]), np.asarray(ref[0])
        if to_vertices is not None:
            A, B = A[:, to_vertices], B[:, to_vertices]
        dtau = abs(float(sharded[k][3]) - float(ref[3]))
        dU = np.abs(A - B)
        if k == "uniform":
            share = float((dU / (1e-6 + 1e-5 * np.abs(B))).max())
            bound = "elementwise rtol 1e-5, atol 1e-6"
        else:
            share = float(max(dU[c].max() / (1e-5 * np.abs(B[c]).max())
                              for c in range(B.shape[0])))
            bound = "max|dU_c| <= 1e-5 max|U_c|"
        ok = share <= 1.0 and dtau < 1e-9
        _say(f"  {label}: sharded vs one device, 1 f32 step from the {k} "
             f"state: max|dU| {float(dU.max()):.3e}, share of the bound "
             f"({bound}) {share:.3f}, |dtau| {dtau:.3e} (limit 1e-9)  "
             f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            failed.append(k)
    if failed:
        raise PhaseFailure(f"{label}: sharded result differs from the "
                           f"{failed} start(s)")
    check_state(eq, packed, out[0], label)


def phase_sharded(n_dev: int = 4, step_refinement: int = 4,
                  cylinder_refinement: int = 6,
                  n_time_steps: int = 10) -> None:
    """GSPMD node-axis sharding against the same problem on one device."""
    import jax

    from ryujin_tpu.equations.euler import Euler
    from ryujin_tpu.equations.euler_initial_states import make_initial_state
    from ryujin_tpu.offline import assembly, geometry, multiblock, structured

    if len(jax.devices()) < n_dev:
        raise PhaseFailure(
            f"sharded: needs {n_dev} devices, found {len(jax.devices())}"
        )
    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", direction=[1, 0],
                              position=[1, 0],
                              primitive_state=[1.4, 3.0, 1.0])
    failures = []

    def run(label, packed, **kw):
        try:
            _sharded_vs_single(label, eq, packed, init, n_dev, n_time_steps,
                               **kw)
        except PhaseFailure as exc:
            _say(f"  {exc}")
            failures.append(label)

    mesh = geometry.step(refinement=step_refinement)
    run(f"sharded step r{step_refinement}",
        structured.pack_structured(assembly.assemble(mesh), mesh,
                                   pad_major=8 * n_dev))

    mesh = geometry.cylinder(refinement=cylinder_refinement,
                             variant="blocks")
    t0 = time.perf_counter()
    packed = multiblock.pack_multiblock(
        assembly.assemble(mesh), mesh, pad_minor=8, pad_major=8,
        slabs=n_dev,
    )
    _say(f"  sharded multi-block: host packing {time.perf_counter() - t0:.1f}"
         f" s")
    run(f"sharded multi-block cylinder r{cylinder_refinement}", packed,
        to_vertices=np.asarray(packed.vertex_to_node))
    if failures:
        raise PhaseFailure(f"sharded: {failures} differ from one device")


def _run_phase(name, fn, failures) -> None:
    _say(f"[{name}]")
    t0 = time.perf_counter()
    try:
        fn()
    except Exception:  # report every phase, then fail at the end
        traceback.print_exc(file=sys.stdout)
        failures.append(name)
        _say(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
    else:
        _say(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU sharded phase")
    args = parser.parse_args(argv)

    smi = _device.query_nvidia_smi()  # before this process touches a card
    from ryujin_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    import jax

    rec = _device.device_record()
    _say(f"[device] jax {jax.__version__}, platform {rec['platform']}, "
         f"device_kind {rec['kind']}, count {rec['count']}; compile cache "
         f"{cache}")
    _say(f"[device] nvidia-smi name, power.limit: {smi}")
    try:
        check_device(rec)
    except PhaseFailure as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    card = smi.splitlines()[0] if smi else rec["kind"]

    failures = []
    if args.four:
        _run_phase("sharded", lambda: phase_sharded(n_dev=4), failures)
    else:
        _run_phase("step-f32", lambda: phase_time_loop(
            STEP_CONFIG, "float32", 256, label="step-f32", card=card,
            expect_layout="StructuredData",
        ), failures)
        _run_phase("step-f64", lambda: phase_time_loop(
            STEP_CONFIG, "float64", 256, label="step-f64", card=card,
            expect_layout="StructuredData",
        ), failures)
        _run_phase("ell-3d", lambda: phase_time_loop(
            CYLINDER_3D_CONFIG, "float64", 32, label="ell-3d", card=card,
            run_check=False, expect_layout="EllData",
        ), failures)
        _run_phase("gpu-vs-cpu", phase_gpu_vs_cpu, failures)
        _run_phase("vortex-f64", phase_vortex_f64, failures)
        _run_phase("vortex-f32", phase_vortex_f32, failures)
        _run_phase("sw-vortex", phase_sw_vortex_f32, failures)
    if failures:
        _say(f"chip_smoke: FAILED phases: {failures}")
        return 1
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
