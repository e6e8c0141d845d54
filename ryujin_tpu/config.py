"""Typed runtime configuration tree.

Analog of the reference's dealii::ParameterAcceptor `.prm` system
(/root/reference/source/time_loop.template.h:28-215 and the per-class
parameter registrations): one YAML file with sections mirroring
the reference's `A - TimeLoop` ... `K - Quantities` structure.  Free-form
subsections (equation parameters, geometry parameters, initial state
parameters) stay dicts so each module can register what it needs —
the analog of ParameterAcceptor's late binding.  Files are read and
written by utils/yaml_subset.py, so no YAML library is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from .utils import yaml_subset


@dataclasses.dataclass
class TimeLoopConfig:
    """Section A (time_loop.template.h:80-215)."""

    basename: str = "output"
    final_time: float = 5.0
    timer_granularity: float = 1.0
    enable_output_full: bool = False
    enable_compute_error: bool = False
    error_normalize: bool = True
    error_quantities: Sequence[str] = ()
    enable_checkpointing: bool = False
    timer_checkpoint_multiplier: int = 1
    resume: bool = False
    terminal_update_interval: float = 5.0


@dataclasses.dataclass
class EquationConfig:
    """Section B."""

    dimension: int = 2
    equation: str = "euler"
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DiscretizationConfig:
    """Section C."""

    geometry: str = "rectangular domain"
    mesh_refinement: int = 5
    # finite element ansatz (discretization.h:131-173):
    # "cG Q1" | "cG Q2" | "cG Q3" | "dG Q0" | "dG Q1" | "dG Q2" | "dG Q3"
    ansatz: str = "cG Q1"
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class InitialValuesConfig:
    """Section E (initial_values.h:38-155)."""

    configuration: str = "uniform"
    direction: Optional[Sequence[float]] = None
    position: Optional[Sequence[float]] = None
    # multiplicative random perturbation of the interpolated initial state
    # (initial_values.template.h:51-216); 0 disables:
    perturbation: float = 0.0
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class HyperbolicModuleConfig:
    """Section F (indicator/limiter/riemann parameters)."""

    evc_factor: float = 1.0
    limiter_iterations: int = 2
    limiter_newton_max_iterations: int = 2
    limiter_newton_tolerance: float = 1.0e-10
    limiter_relaxation_factor: float = 1.0
    riemann_newton_max_iterations: int = 0
    riemann_newton_tolerance: float = 1.0e-10


@dataclasses.dataclass
class TimeIntegratorConfig:
    """Section H (time_integrator.h:41-58)."""

    cfl_min: float = 0.45
    cfl_max: float = 0.90
    cfl_recovery_strategy: str = "bang bang control"
    time_stepping_scheme: str = "erk 33"


@dataclasses.dataclass
class ParabolicSolverConfig:
    """Navier-Stokes implicit solver parameters
    (navier_stokes/parabolic_solver.template.h:40-110)."""

    tolerance: float = 1.0e-12
    max_iterations: int = 200
    # geometric multigrid preconditioner (default off, like the reference)
    multigrid_velocity: bool = False
    multigrid_energy: bool = False
    gmg_levels: int = 3  # coarse levels below the finest
    chebyshev_degree: int = 3
    chebyshev_power_iterations: int = 8
    smoother_range_velocity: float = 8.0
    smoother_range_energy: float = 15.0


@dataclasses.dataclass
class VTUOutputConfig:
    """Section I."""

    use_primitive: bool = True
    schlieren_beta: float = 10.0
    schlieren_quantities: Sequence[str] = ()
    vorticity_quantities: Sequence[str] = ()
    # level-set expressions restricting a companion "-levelsets.vtu" to
    # cut cells (vtu_output.template.h:47-51):
    manifolds: Sequence[str] = ()
    # restrict written fields to this list (selected_components_extractor
    # analog); empty = everything:
    vtu_output_quantities: Sequence[str] = ()


@dataclasses.dataclass
class QuantitiesConfig:
    """Section K: time series over interior manifolds.

    manifolds: list of [name, expression] where the expression is
    evaluated over nodal coordinates (variables x, y, z; numpy namespace);
    nodes with expression >= 0 belong to the manifold — the analog of the
    reference's level-set defined interior manifolds (quantities.h:29-240).
    """

    manifolds: Sequence[Sequence[str]] = ()
    # boundary manifolds: same format, selecting boundary dofs weighted by
    # boundary mass (quantities.template.h:73-79):
    boundary_manifolds: Sequence[Sequence[str]] = ()
    # reset time-averaged statistics after each write-out
    # (quantities.template.h:82-86):
    clear_statistics_on_writeout: bool = True


@dataclasses.dataclass
class MeshAdaptorConfig:
    """Section: AMR driver (mesh_adaptor.h:22-60,88-160)."""

    adaptation_strategy: str = "global refinement"  # | "random adaptation"
    marking_strategy: str = "fixed number"
    time_point_selection_strategy: str = "fixed adaptation time points"
    adaptation_time_points: Sequence[float] = ()
    refinement_fraction: float = 0.3
    coarsening_fraction: float = 0.3
    random_adaptation_seed: int = 42


@dataclasses.dataclass
class Config:
    time_loop: TimeLoopConfig = dataclasses.field(default_factory=TimeLoopConfig)
    equation: EquationConfig = dataclasses.field(default_factory=EquationConfig)
    discretization: DiscretizationConfig = dataclasses.field(
        default_factory=DiscretizationConfig
    )
    initial_values: InitialValuesConfig = dataclasses.field(
        default_factory=InitialValuesConfig
    )
    parabolic_solver: ParabolicSolverConfig = dataclasses.field(
        default_factory=ParabolicSolverConfig
    )
    hyperbolic_module: HyperbolicModuleConfig = dataclasses.field(
        default_factory=HyperbolicModuleConfig
    )
    time_integrator: TimeIntegratorConfig = dataclasses.field(
        default_factory=TimeIntegratorConfig
    )
    vtu_output: VTUOutputConfig = dataclasses.field(
        default_factory=VTUOutputConfig
    )
    quantities: QuantitiesConfig = dataclasses.field(
        default_factory=QuantitiesConfig
    )
    mesh_adaptor: MeshAdaptorConfig = dataclasses.field(
        default_factory=MeshAdaptorConfig
    )
    precision: str = "float64"  # or "float32"
    # the substep is always the XLA path; "auto" is kept so that older
    # configuration files still load:
    backend: str = "auto"  # "auto" | "xla"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        cfg = Config()
        for f in dataclasses.fields(Config):
            if f.name not in d or d[f.name] is None:
                continue
            v = d[f.name]
            cur = getattr(cfg, f.name)
            if dataclasses.is_dataclass(cur):
                known = {x.name for x in dataclasses.fields(cur)}
                unknown = set(v) - known
                if unknown:
                    raise ValueError(
                        f"unknown keys in section '{f.name}': {sorted(unknown)}"
                    )
                setattr(cfg, f.name, type(cur)(**v))
            else:
                setattr(cfg, f.name, v)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        """Reject values with no implementation behind them."""
        if self.precision not in ("float32", "float64"):
            raise ValueError(
                f"precision must be 'float32' or 'float64', not "
                f"{self.precision!r}"
            )
        if self.backend not in ("auto", "xla"):
            raise ValueError(
                f"backend {self.backend!r} is not available: the fused "
                f"kernels of the 'pallas' backend have been removed; use "
                f"'auto' or 'xla'"
            )

    @staticmethod
    def load(path: str) -> "Config":
        with open(path) as f:
            return Config.from_dict(yaml_subset.load(f.read()) or {})

    def dumps(self) -> str:
        return yaml_subset.dump(self.to_dict())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())
