"""Equation registry and dispatch.

Analog of /root/reference/source/equation_dispatch.h:33-159:
each equation module registers a builder under its configuration name;
the driver selects by the `equation` string of the config file.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax.numpy as jnp

from ..config import EquationConfig, InitialValuesConfig


def _expression_fn(expr: str, n_comp: int, dim: int):
    """Build (points [dim, ...], t) -> state [n_comp, ...] from expression
    strings — the analog of the reference's muparser FunctionParser
    (initial_state_function.h).  `expr` may be a single expression or a
    list of n_comp expressions over x, y, z, t.
    """
    exprs = [expr] if isinstance(expr, str) else list(expr)
    assert len(exprs) == n_comp, (exprs, n_comp)
    compiled = [compile(e, "<config expression>", "eval") for e in exprs]

    def fn(points, t):
        names = {"x": points[0], "t": t, "jnp": jnp}
        if dim >= 2:
            names["y"] = points[1]
        if dim >= 3:
            names["z"] = points[2]
        env = {"__builtins__": {}}
        env.update(
            {k: getattr(jnp, k) for k in (
                "sin", "cos", "tan", "exp", "log", "sqrt", "abs", "sign",
                "tanh", "where", "minimum", "maximum", "pi",
            )}
        )
        env.update(names)
        vals = [eval(c, env) for c in compiled]  # noqa: S307 (config file)
        vals = [v + 0.0 * points[0] for v in vals]  # broadcast constants
        return jnp.stack(vals, axis=0)

    return fn


def _build_euler(cfg: EquationConfig):
    from .euler import Euler, EulerParams

    keys = {"gamma", "reference_density", "vacuum_state_relaxation_small",
            "vacuum_state_relaxation_large"}
    params = {k: v for k, v in cfg.parameters.items() if k in keys}
    return Euler(dim=cfg.dimension, params=EulerParams(**params))


def _euler_initial(eq, cfg: InitialValuesConfig):
    from . import euler_initial_states as lib

    if cfg.configuration == "function":
        from .euler_initial_states import galilei_wrap

        fn = _expression_fn(cfg.parameters["expression"], eq.n_comp, eq.dim)
        direction = cfg.direction or [1.0] + [0.0] * (eq.dim - 1)
        position = cfg.position or [0.0] * eq.dim
        return galilei_wrap(fn, direction, position, eq.dim)
    return lib.make_initial_state(
        eq, cfg.configuration, direction=cfg.direction,
        position=cfg.position, **cfg.parameters,
    )


def _build_scalar(cfg: EquationConfig):
    from .scalar_conservation import (
        FLUX_LIBRARY, RiemannParams, ScalarConservation, function_flux,
    )

    p = dict(cfg.parameters)
    flux_name = p.pop("flux", "burgers")
    if flux_name == "function":
        exprs = p.pop("flux_expressions")
        exprs = [exprs] if isinstance(exprs, str) else list(exprs)
        delta = p.pop("derivative_approximation_delta", 1.0e-10)
        fns = [
            (lambda e: (lambda u: _eval_u(e, u)))(e) for e in exprs
        ]
        flux = function_flux(cfg.dimension, fns, delta=delta)
    else:
        flux = FLUX_LIBRARY[flux_name](cfg.dimension)
    riemann = RiemannParams(
        use_greedy_wavespeed=p.pop("use_greedy_wavespeed", False),
        use_averaged_entropy=p.pop("use_averaged_entropy", False),
        random_entropies=p.pop("random_entropies", 0),
    )
    if p:
        raise ValueError(f"unknown scalar conservation parameters: {p}")
    return ScalarConservation(dim=cfg.dimension, flux=flux, riemann=riemann)


def _eval_u(expr: str, u):
    env = {"__builtins__": {}, "u": u}
    env.update(
        {k: getattr(jnp, k) for k in (
            "sin", "cos", "exp", "log", "sqrt", "abs", "sign", "pi",
        )}
    )
    return eval(expr, env)  # noqa: S307 (config file)


def _scalar_initial(eq, cfg: InitialValuesConfig):
    if cfg.configuration == "uniform":
        value = float(cfg.parameters.get("value", 1.0))

        def fn(points, t):
            return jnp.full((1,) + points.shape[1:], value, points.dtype)

        return fn
    if cfg.configuration == "function":
        return _expression_fn(cfg.parameters["expression"], 1, eq.dim)
    raise ValueError(f"unknown configuration '{cfg.configuration}'")


def _build_shallow_water(cfg: EquationConfig):
    from .shallow_water import (
        ShallowWater, ShallowWaterParams, SWLimiterOptions,
    )

    p = dict(cfg.parameters)
    opts = SWLimiterOptions(
        limit_on_kinetic_energy=p.pop("limit_on_kinetic_energy", False),
        limit_on_square_velocity=p.pop("limit_on_square_velocity", True),
    )
    return ShallowWater(
        dim=cfg.dimension, params=ShallowWaterParams(**p),
        limiter_options=opts,
    )


def _shallow_water_initial(eq, cfg: InitialValuesConfig):
    from . import shallow_water_initial_states as lib

    return lib.make_initial_state(
        eq, cfg.configuration, direction=cfg.direction,
        position=cfg.position, **cfg.parameters,
    )


def _build_euler_aeos(cfg: EquationConfig):
    from . import euler_aeos as ae

    p = dict(cfg.parameters)
    eos_name = p.pop("equation_of_state", "polytropic gas")
    eos_params = p.pop("eos_parameters", {})
    eos = ae.EOS_LIBRARY[eos_name](**eos_params)
    return ae.EulerAEOS(
        dim=cfg.dimension, eos=eos, params=ae.EulerAEOSParams(**p)
    )


def _euler_aeos_initial(eq, cfg: InitialValuesConfig):
    # the gamma-law initial states (vortex etc.) apply whenever the EOS
    # carries a polytropic gamma; fall back to expression states:
    import types

    from . import euler_initial_states as lib

    if cfg.configuration == "function":
        from .euler_initial_states import galilei_wrap

        fn = _expression_fn(cfg.parameters["expression"], eq.n_comp, eq.dim)
        direction = cfg.direction or [1.0] + [0.0] * (eq.dim - 1)
        position = cfg.position or [0.0] * eq.dim
        return galilei_wrap(fn, direction, position, eq.dim)
    params = dict(cfg.parameters)
    gamma = params.pop("gamma", 1.4)
    facade = types.SimpleNamespace(
        params=types.SimpleNamespace(gamma=gamma), dim=eq.dim
    )
    return lib.make_initial_state(
        facade, cfg.configuration, direction=cfg.direction,
        position=cfg.position, **params,
    )


def _build_navier_stokes(cfg: EquationConfig):
    # the hyperbolic part IS the Euler system
    # (navier_stokes/description.h:31-49):
    keys = {"gamma", "reference_density", "vacuum_state_relaxation_small",
            "vacuum_state_relaxation_large"}
    from .euler import Euler, EulerParams

    params = {k: v for k, v in cfg.parameters.items() if k in keys}
    return Euler(dim=cfg.dimension, params=EulerParams(**params))


def _navier_stokes_parabolic(cfg: EquationConfig):
    from ..solver.parabolic import ParabolicSystem

    p = cfg.parameters
    return ParabolicSystem(
        mu=p.get("mu", 1.0e-3),
        lambda_=p.get("lambda_", 0.0),
        cv_inverse_kappa=p.get("kappa", 1.866666666666666e-2),
    )


REGISTRY: Dict[str, Dict[str, Callable]] = {
    "euler": {"equation": _build_euler, "initial_state": _euler_initial},
    "navier stokes": {
        "equation": _build_navier_stokes,
        "initial_state": _euler_initial,
        "parabolic": _navier_stokes_parabolic,
    },
    "euler aeos": {
        "equation": _build_euler_aeos, "initial_state": _euler_aeos_initial,
    },
    "scalar conservation": {
        "equation": _build_scalar, "initial_state": _scalar_initial,
    },
    "shallow water": {
        "equation": _build_shallow_water,
        "initial_state": _shallow_water_initial,
    },
}


def make_equation(cfg: EquationConfig):
    try:
        return REGISTRY[cfg.equation]["equation"](cfg)
    except KeyError:
        raise ValueError(
            f"unknown equation '{cfg.equation}'; "
            f"available: {sorted(REGISTRY)}"
        ) from None


def make_initial_state(eq, cfg: InitialValuesConfig):
    name = getattr(eq, "name", None)
    for key, entry in REGISTRY.items():
        if key == name:
            return entry["initial_state"](eq, cfg)
    raise ValueError(f"no initial state library for equation '{name}'")
