"""Top-level time loop driver.

Re-design of /root/reference/source/time_loop.template.h:219-435:
construct the full object graph from a Config, interpolate or resume the
initial state, then advance in device-resident chunks between "timer
ticks" at which output, checkpointing, quantities accumulation, and
statistics happen.  The reference synchronizes MPI ranks at every cycle;
here the device advances `chunk` steps per host round trip and the host
only syncs at tick boundaries.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .equations.dispatch import make_equation, make_initial_state
from .io.checkpoint import read_checkpoint, write_checkpoint
from .io.vtu import VTUOutput
from .offline import assembly, ell, geometry, structured
from .offline.mesh import Boundary
from .postprocess.error import compute_error, interpolate_nodal
from .postprocess.postprocessor import Postprocessor
from .postprocess.quantities import Quantities
from .solver.hyperbolic import HyperbolicModule, HyperbolicModuleParams
from .solver.integrator import TimeIntegrator

_BOUNDARY_NAMES = {
    "do nothing": Boundary.do_nothing,
    "periodic": Boundary.periodic,
    "slip": Boundary.slip,
    "no slip": Boundary.no_slip,
    "dirichlet": Boundary.dirichlet,
    "dynamic": Boundary.dynamic,
    "dirichlet momentum": Boundary.dirichlet_momentum,
}


def make_mesh(cfg: Config):
    """Geometry dispatch (the analog of Geometries::populate_geometry_list,
    /root/reference/source/geometry_library.h:35)."""
    d = cfg.discretization
    p = dict(d.parameters)
    dim = cfg.equation.dimension
    if d.geometry == "rectangular domain":
        bcs = [
            _BOUNDARY_NAMES[b] if isinstance(b, str) else b
            for b in p.pop(
                "boundary_conditions", ["dirichlet"] * (2 * dim)
            )
        ]
        mesh = geometry.rectangular_domain(
            p.pop("position_bottom_left", [0.0] * dim),
            p.pop("position_top_right", [1.0] * dim),
            p.pop("subdivisions", [1] * dim),
            refinement=d.mesh_refinement,
            boundary_conditions=bcs,
            dim=dim,
            grading_pull_back=p.pop("grading_pull_back", None),
            grading_push_forward=p.pop("grading_push_forward", None),
        )
    elif d.geometry == "step":
        mesh = geometry.step(refinement=d.mesh_refinement, **p)
        p = {}
    elif d.geometry == "cylinder":
        mesh = geometry.cylinder(refinement=d.mesh_refinement, dim=dim, **p)
        p = {}
    elif d.geometry == "disk":
        if "boundary_condition" in p:
            b = p.pop("boundary_condition")
            p["boundary"] = _BOUNDARY_NAMES[b] if isinstance(b, str) else b
        mesh = geometry.disk(refinement=d.mesh_refinement, **p)
        p = {}
    elif d.geometry == "annulus":
        mesh = geometry.annulus(refinement=d.mesh_refinement, **p)
        p = {}
    elif d.geometry == "wall":
        mesh = geometry.wall(refinement=d.mesh_refinement, **p)
        p = {}
    elif d.geometry == "wave tank":
        mesh = geometry.wave_tank(refinement=d.mesh_refinement, **p)
        p = {}
    elif d.geometry == "airfoil":
        mesh = geometry.airfoil(refinement=d.mesh_refinement, **p)
        p = {}
    elif d.geometry == "reader":
        from .offline.reader import read_msh

        mesh = read_msh(p.pop("filename", "ryujin.msh"))
        if d.mesh_refinement:
            mesh = mesh.refine_global(d.mesh_refinement)
    else:
        raise ValueError(f"unknown geometry '{d.geometry}'")
    if p:
        raise ValueError(f"unknown geometry parameters: {sorted(p)}")
    return mesh


class TimeLoop:
    """Constructs the object graph and runs the main loop."""

    def __init__(self, config: Config):
        config.validate()
        self.config = config
        self.dtype = _enable_precision(config.precision)
        self.eq = make_equation(config.equation)
        self.mesh = make_mesh(config)

        ma = config.mesh_adaptor
        self.mesh_adaptor = None
        if ma.adaptation_time_points:
            from .offline.mesh_adaptor import MeshAdaptor

            self.mesh_adaptor = MeshAdaptor(
                adaptation_strategy=ma.adaptation_strategy,
                marking_strategy=ma.marking_strategy,
                time_point_selection_strategy=(
                    ma.time_point_selection_strategy
                ),
                adaptation_time_points=ma.adaptation_time_points,
                refinement_fraction=ma.refinement_fraction,
                coarsening_fraction=ma.coarsening_fraction,
                random_seed=ma.random_adaptation_seed,
            )

        self._prepare_compute_kernels()

        # statistics
        self.n_steps_total = 0
        self.wall_compute = 0.0

    def _prepare_compute_kernels(self):
        """(Re)build everything that depends on the current mesh.

        The analog of the `prepare_compute_kernels` callable the reference
        TimeLoop re-invokes after mesh adaptation
        (time_loop.template.h:667)."""
        config = self.config
        ansatz = config.discretization.ansatz
        self.offline_data = assembly.assemble(self.mesh, ansatz=ansatz)
        # the canvas fast path covers cG Q1 on the mesh's vertex lattice
        # AND every other tensor ansatz through the assembly-provided
        # node lattice (cG Q2/Q3 on the p-refined lattice, dG Q0-Q3 on
        # the (p+1)-interleaved lattice; offline/assembly._node_lattice)
        # — the analog of the reference running one SIMD hot loop for
        # every ansatz (hyperbolic_module.template.h:417-420):
        structured_ok = self.mesh.structured_index is not None and (
            ansatz == "cG Q1"
            or self.offline_data.node_lattice_index is not None
        )
        mb_env = os.environ.get("RYUJIN_MULTIBLOCK") == "1"
        multiblock_ok = (
            not structured_ok
            and ansatz == "cG Q1"
            and self.mesh.dim == 2
            and self.mesh.periodic_pairs is None
            and mb_env
        )
        # 3D extrusions of a multi-block base (the reference's 3D
        # airfoil, geometry_airfoil.h:1279-1290): quilt x z canvas
        multiblock3d_ok = (
            not structured_ok
            and ansatz == "cG Q1"
            and self.mesh.dim == 3
            and self.mesh.extrusion_base is not None
            and self.mesh.extrusion_base.periodic_pairs is None
            and mb_env
        )
        if structured_ok and self.mesh.dim <= 2:
            # 3D canvases carry extra padding, so ELL is the 3D layout.
            # Which layout wins on the H100 is not measured yet.
            self.packed = structured.pack_structured(
                self.offline_data, self.mesh
            )
        elif multiblock_ok:
            # block-decomposable quilts (airfoil, disk, annulus, cylinder
            # "blocks", gmsh imports of multi-block meshes) pack onto a
            # multi-block canvas; truly irregular meshes fall back to
            # padded ELL:
            from .offline import multiblock

            try:
                self.packed = multiblock.pack_multiblock(
                    self.offline_data, self.mesh
                )
            except multiblock.MultiblockError:
                self.packed = ell.pack(self.offline_data)
        elif multiblock3d_ok:
            from .offline import multiblock

            try:
                self.packed = multiblock.pack_multiblock_extruded(
                    self.offline_data, self.mesh
                )
            except multiblock.MultiblockError:
                self.packed = ell.pack(self.offline_data)
        else:
            self.packed = ell.pack(self.offline_data)

        self.backend = "xla"

        init = make_initial_state(self.eq, config.initial_values)
        initial_precomputed = None
        if hasattr(init, "bathymetry"):
            pos = jnp.asarray(self.packed.positions.T, self.dtype)
            initial_precomputed = init.bathymetry(pos)[None]
            init = init.state
        self.initial_state_fn = init
        self._initial_precomputed = initial_precomputed
        hm_cfg = config.hyperbolic_module
        params = HyperbolicModuleParams(
            evc_factor=hm_cfg.evc_factor,
            limiter_iterations=hm_cfg.limiter_iterations,
            limiter_newton_max_iterations=hm_cfg.limiter_newton_max_iterations,
            limiter_newton_tolerance=hm_cfg.limiter_newton_tolerance,
            limiter_relaxation_factor=hm_cfg.limiter_relaxation_factor,
            riemann_newton_max_iterations=hm_cfg.riemann_newton_max_iterations,
            riemann_newton_tolerance=hm_cfg.riemann_newton_tolerance,
        )
        self.hyperbolic_module = HyperbolicModule(
            self.eq, self.packed, self.initial_state_fn,
            params=params, dtype=self.dtype,
            initial_precomputed=self._initial_precomputed,
        )
        # parabolic subsystem (navier stokes):
        from .equations.dispatch import REGISTRY

        self.parabolic_solver = None
        entry = REGISTRY.get(config.equation.equation, {})
        if "parabolic" in entry:
            from .solver.parabolic import ParabolicSolver

            system = entry["parabolic"](config.equation)
            ps_cfg = config.parabolic_solver
            gmg_params, mesh_chain = None, None
            if ps_cfg.multigrid_velocity or ps_cfg.multigrid_energy:
                from .solver.gmg import GMGParams, check_chain

                gmg_params = GMGParams(
                    velocity=ps_cfg.multigrid_velocity,
                    energy=ps_cfg.multigrid_energy,
                    chebyshev_degree=ps_cfg.chebyshev_degree,
                    power_iterations=ps_cfg.chebyshev_power_iterations,
                    smoother_range_velocity=ps_cfg.smoother_range_velocity,
                    smoother_range_energy=ps_cfg.smoother_range_energy,
                )
                # level hierarchy: regenerate the geometry at a reduced
                # refinement and refine it globally back up (the chain's
                # finest mesh is matched to the solver mesh by position
                # inside GMG, so generator numbering does not matter)
                import dataclasses as _dc

                r_fine = config.discretization.mesh_refinement
                r0 = max(0, r_fine - max(1, ps_cfg.gmg_levels))
                c2 = _dc.replace(
                    config,
                    discretization=_dc.replace(
                        config.discretization, mesh_refinement=r0
                    ),
                )
                mesh_chain = [make_mesh(c2)]
                for _ in range(r_fine - r0):
                    mesh_chain.append(mesh_chain[-1].refine_global(1))
                if not check_chain(mesh_chain):
                    print(
                        "[ryujin] geometry does not form a refinement "
                        "chain; multigrid disabled"
                    )
                    gmg_params, mesh_chain = None, None
            self.parabolic_solver = ParabolicSolver(
                self.eq, system, self.packed, self.offline_data, self.mesh,
                self.initial_state_fn,
                self.hyperbolic_module.stencil, dtype=self.dtype,
                tolerance=ps_cfg.tolerance,
                max_iterations=ps_cfg.max_iterations,
                gmg_params=gmg_params, mesh_chain=mesh_chain,
            )

        ti_cfg = config.time_integrator
        self.time_integrator = TimeIntegrator(
            self.hyperbolic_module,
            scheme=ti_cfg.time_stepping_scheme,
            cfl_min=ti_cfg.cfl_min,
            cfl_max=ti_cfg.cfl_max,
            cfl_recovery_strategy=ti_cfg.cfl_recovery_strategy,
            parabolic_module=self.parabolic_solver,
        )

        v_cfg = config.vtu_output
        self.postprocessor = Postprocessor(
            eq=self.eq,
            stencil=self.hyperbolic_module.stencil,
            schlieren_beta=v_cfg.schlieren_beta,
            schlieren_quantities=tuple(v_cfg.schlieren_quantities),
            vorticity_quantities=tuple(v_cfg.vorticity_quantities),
        )
        self.vtu_output = VTUOutput(
            self.eq, self.mesh, self.packed,
            postprocessor=self.postprocessor,
            use_primitive=v_cfg.use_primitive,
            manifolds=v_cfg.manifolds,
            vtu_output_quantities=v_cfg.vtu_output_quantities,
        )
        self.quantities = Quantities(
            self.eq, self.packed, config.quantities,
            basename=config.time_loop.basename,
        )

    def _adapt_mesh_and_transfer(self, U):
        """Coarsen + refine, re-pack, re-jit, and interpolate the state
        (time_loop.template.h:616-689)."""
        from .offline.mesh_adaptor import transfer_state

        old_mesh, old_packed = self.mesh, self.packed
        self.mesh, transfer = self.mesh_adaptor.adapt(old_mesh)
        self._prepare_compute_kernels()
        U_np = transfer_state(
            np.asarray(U), old_packed, old_mesh, transfer,
            self.mesh, self.packed,
        )
        return jnp.asarray(U_np, self.dtype)

    # ------------------------------------------------------------------
    def _open_logfile(self, resume: bool):
        """Rank-0 logfile `basename.log` with the effective parameter dump,
        plus `basename-parameters.yaml` (time_loop.template.h:229-232,
        910-913)."""
        cfg = self.config.time_loop
        self._logfile = open(cfg.basename + ".log", "a" if resume else "w")
        self._log("# ryujin_tpu")
        self._log("# effective parameters:")
        for line in self.config.dumps().splitlines():
            self._log("#   " + line)
        self.config.save(cfg.basename + "-parameters.yaml")

    def _log(self, msg: str):
        if getattr(self, "_logfile", None) is not None:
            self._logfile.write(msg + "\n")
            self._logfile.flush()

    def run(self, chunk: int = 32, quiet: bool = False) -> Dict:
        cfg = self.config.time_loop
        eq = self.eq
        self._open_logfile(resume=cfg.resume)

        if cfg.resume:
            U_np, t, cycle, extra, restored = read_checkpoint(
                cfg.basename, self.mesh
            )
            if restored is not None:
                # the checkpoint was written on an adapted mesh: rebuild
                # everything on it (read_checkpoint -> prepare_compute_
                # kernels, time_loop.template.h:440-533); the packed state
                # layout is deterministic per mesh, so U loads verbatim
                self.mesh = restored
                self._prepare_compute_kernels()
            U = jnp.asarray(U_np, self.dtype)
            self.quantities.load_state(extra)
        else:
            U = interpolate_nodal(
                self.initial_state_fn, self.packed, eq, 0.0, self.dtype
            )
            pert = self.config.initial_values.perturbation
            if pert != 0.0:
                # random multiplicative perturbation of the initial state
                # (initial_values.template.h:198-216):
                noise = np.random.default_rng().uniform(-1.0, 1.0, U.shape)
                U = U * (1.0 + pert * jnp.asarray(noise, self.dtype))
            t, cycle = 0.0, 0
            self._tick_output(U, t, cycle)

        t_final = cfg.final_time
        granularity = cfg.timer_granularity
        last_report = time.perf_counter()
        if self.mesh_adaptor is not None:
            self.mesh_adaptor.prepare(t)

        while t < t_final - 1e-12:
            next_tick = min(t_final, (int(t / granularity) + 1) * granularity)
            wall0 = time.perf_counter()
            steps_this_tick = 0
            while t < next_tick - 1e-12:
                ti = self.time_integrator
                U, _, t_dev, tau, restarts, warns = ti.advance(
                    U, t, chunk, t_final=next_tick
                )
                t = float(t_dev)
                ti.n_restarts += int(restarts)
                ti.n_warnings += int(warns)
                steps_this_tick += chunk
                tau_f = float(tau)
                if not np.isfinite(tau_f) or not np.isfinite(t):
                    # the analog of the reference's τ_max sanity abort
                    # (hyperbolic_module.template.h:573-576):
                    msg = (
                        f"ryujin_tpu: computed time-step size tau = {tau_f} "
                        f"at t = {t} is not a finite number; the state has "
                        f"likely left the invariant domain (NaN/Inf). "
                        f"Aborting."
                    )
                    self._log(msg)
                    raise FloatingPointError(msg)
                if tau_f <= 0.0:
                    break
                now = time.perf_counter()
                if (
                    not quiet
                    and now - last_report > cfg.terminal_update_interval
                ):
                    self._print_cycle(t, steps_this_tick, now - wall0)
                    last_report = now
            self.wall_compute += time.perf_counter() - wall0
            self.n_steps_total += steps_this_tick
            cycle += 1
            self._log(
                f"cycle {cycle}  t = {t:.8g}  steps = {self.n_steps_total}  "
                f"restarts = {self.time_integrator.n_restarts}"
            )
            self._tick_output(U, t, cycle)
            if self.mesh_adaptor is not None and t < t_final - 1e-12:
                self.mesh_adaptor.analyze(U, t, cycle)
                if self.mesh_adaptor.need_mesh_adaptation:
                    U = self._adapt_mesh_and_transfer(U)
                    self.mesh_adaptor.need_mesh_adaptation = False
                    if not quiet:
                        print(
                            f"        mesh adaptation at t = {t:.6g}: "
                            f"{self.packed.n_nodes} dofs"
                        )
            if not quiet:
                self._print_cycle(t, steps_this_tick,
                                  time.perf_counter() - wall0)

        result = {"t": t, "cycles": cycle, "U": U}
        if cfg.enable_compute_error:
            comps = list(cfg.error_quantities) or eq.component_names
            linf, l1, l2 = compute_error(
                eq, self.mesh, self.packed, np.asarray(U), t,
                self.initial_state_fn, components=comps,
                normalize=cfg.error_normalize,
            )
            result.update({"Linf": linf, "L1": l1, "L2": l2})
            n_dofs = self.packed.n_nodes
            error_block = (
                "Normalized consolidated Linf, L1, and L2 errors at "
                "final time\n"
                f"#dofs = {n_dofs}\n"
                f"t     = {t:.14g}\n"
                f"Linf  = {linf:.14g}\n"
                f"L1    = {l1:.14g}\n"
                f"L2    = {l2:.14g}"
            )
            self._log(error_block)
            if not quiet:
                print(error_block)
        if not quiet:
            self._print_summary()
        self._log(f"run complete: t = {t:.8g}, {cycle} cycles, "
                  f"{self.n_steps_total} steps")
        self._logfile.close()
        self._logfile = None
        return result

    # ------------------------------------------------------------------
    def _tick_output(self, U, t, cycle):
        cfg = self.config.time_loop
        Up, _ = self.hyperbolic_module.prepare_state_vector(
            U, jnp.asarray(t, self.dtype)
        )
        if cfg.enable_output_full:
            self.vtu_output.schedule_output(
                f"{cfg.basename}-{cycle:05d}.vtu", Up
            )
        self.quantities.accumulate(Up, t)
        self.quantities.write_out(Up, t, cycle)
        if (
            cfg.enable_checkpointing
            and cycle % max(1, cfg.timer_checkpoint_multiplier) == 0
        ):
            write_checkpoint(
                cfg.basename, self.mesh, np.asarray(U), t, cycle,
                extra=self.quantities.state_dict(),
            )

    def _print_cycle(self, t, steps, wall):
        n = self.packed.n_nodes
        substeps = steps * _substeps_per_step(self.time_integrator)
        mqs = n * substeps / max(wall, 1e-9) / 1e6
        # ETA from current progress (time_loop.template.h:1240-1260):
        t_final = self.config.time_loop.final_time
        frac = max(t / max(t_final, 1e-30), 1e-9)
        eta = self.wall_compute * (1.0 - frac) / frac
        print(
            f"  t = {t:10.6f}  |  {steps} steps  |  "
            f"{mqs:9.2f} MQ/s  |  restarts "
            f"{self.time_integrator.n_restarts}  |  eta {eta:8.1f} s"
        )

    def _print_summary(self):
        """Throughput/metrics block (time_loop.template.h:1107-1267)."""
        n = self.packed.n_nodes
        substeps = self.n_steps_total * _substeps_per_step(self.time_integrator)
        wall = max(self.wall_compute, 1e-9)
        eff = self.time_integrator.efficiency
        mqs = n * substeps / wall / 1e6
        print("Timer and throughput summary:")
        print(f"  dofs:              {n}")
        print(f"  steps:             {self.n_steps_total}")
        print(f"  cycles/s:          {self.n_steps_total / wall:.2f}")
        print(f"  wall (compute):    {wall:.2f} s")
        print(f"  MQ/s:              {mqs:.2f}")
        print(f"  MQ/s (eff. norm.): {mqs / max(eff, 1e-9):.2f}")
        print(f"  s/Qdof/substep:    {wall / max(n * substeps, 1):.3e}")
        print(f"  restarts:          {self.time_integrator.n_restarts}")
        print(f"  warnings:          {self.time_integrator.n_warnings}")
        try:  # VmRSS (time_loop.template.h:994-1019); linux-only
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        print(f"  memory (VmRSS):    {line.split()[1]} kB")
                        break
        except OSError:
            pass
        from .utils.scope import timer_statistics

        stats = timer_statistics()
        if stats:
            print("  per-phase timers:")
            for name, (total, count) in sorted(stats.items()):
                print(f"    {name:<40s} {total:9.3f} s  ({count}x)")


def _enable_precision(precision: str):
    """The state dtype for `precision`.  float64 needs JAX's 64-bit mode;
    without it every array would silently be float32, so it is switched
    on here, and a build whose float64 still comes out float32 fails."""
    if precision == "float32":
        return jnp.float32
    jax.config.update("jax_enable_x64", True)
    if jnp.zeros((), jnp.float64).dtype != jnp.float64:
        raise RuntimeError("precision float64 requested but JAX's 64-bit "
                           "mode could not be enabled")
    return jnp.float64


def _substeps_per_step(ti: TimeIntegrator) -> int:
    from .solver.integrator import TABLEAUX

    tb = TABLEAUX.get(ti.scheme)
    return tb.n_sub if tb is not None else 1
