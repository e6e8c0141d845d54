"""Time integration schemes.

Re-implementation of /root/reference/source/time_integrator.template.h.

The reference expresses its explicit Runge-Kutta schemes as chains of
forward-Euler IDP substeps with per-stage weight arrays (e.g. erk_33:
stages {-1} and {0.75, -2}, reference :373-403).  Here each scheme is a
static *tableau* (stage-weight matrix W, convex-combination coefficients,
substep time offsets) and the whole time step runs on device:

  * one jit-compiled IDP substep (uniform signature: stage buffer of S
    slots with traced weights) is lax.scan-ned over the substeps,
  * the Restart exception + bang-bang CFL control of the reference
    (:250-275) becomes a lax.while_loop retrying the scheme at cfl_min,
  * `advance` wraps n_steps of that in an outer lax.scan.

This keeps the compiled graph small and requires zero host
synchronisation per step — the host only syncs at output ticks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .hyperbolic import HyperbolicModule


@dataclasses.dataclass(frozen=True)
class Tableau:
    """Explicit scheme table (reference time_integrator.template.h:278-512).

    W[i][s]: weight of stage-buffer slot s in substep i.  The stage buffer
    holds [U^n prepared, T0 prepared, T1 prepared, ...] in order.
    comb[i]: (a, b) convex combination T <- a*T + b*U^n after substep i.
    c[i]: time offset (units of tau) at which substep i's *output* lives.
    eff: total advance per step = eff * tau (the reference's "efficiency").
    """

    n_sub: int
    S: int
    W: Tuple[Tuple[float, ...], ...]
    comb: Tuple[Tuple[float, float], ...]
    c: Tuple[float, ...]
    eff: float


_T = Tableau
TABLEAUX = {
    "erk 11": _T(1, 0, ((),), ((1.0, 0.0),), (1.0,), 1.0),
    "ssprk 22": _T(
        2, 0, ((), ()), ((1.0, 0.0), (0.5, 0.5)), (1.0, 1.0), 1.0
    ),
    "ssprk 33": _T(
        3,
        0,
        ((), (), ()),
        ((1.0, 0.0), (0.25, 0.75), (2.0 / 3.0, 1.0 / 3.0)),
        (1.0, 0.5, 1.0),
        1.0,
    ),
    "erk 22": _T(
        2, 1, ((0.0,), (-1.0,)), ((1.0, 0.0),) * 2, (1.0, 2.0), 2.0
    ),
    "erk 33": _T(
        3,
        2,
        ((0.0, 0.0), (-1.0, 0.0), (0.75, -2.0)),
        ((1.0, 0.0),) * 3,
        (1.0, 2.0, 3.0),
        3.0,
    ),
    "erk 43": _T(
        4,
        3,
        (
            (0.0, 0.0, 0.0),
            (-1.0, 0.0, 0.0),
            (0.0, -1.0, 0.0),
            (0.0, 5.0 / 3.0, -10.0 / 3.0),
        ),
        ((1.0, 0.0),) * 4,
        (1.0, 2.0, 3.0, 4.0),
        4.0,
    ),
}


def _erk54_tableau() -> Tableau:
    # ERK(5,4) with equidistant c_i (reference :445-512)
    c = 0.2
    a_21 = +0.2
    a_31 = +0.26075582269554909
    a_32 = +0.13924417730445096
    a_41 = -0.25856517872570289
    a_42 = +0.91136274166280729
    a_43 = -0.05279756293710430
    a_51 = +0.21623276431503774
    a_52 = +0.51534223099602405
    a_53 = -0.81662794199265554
    a_54 = +0.88505294668159373
    a_61 = -0.10511678454691901
    a_62 = +0.87880047152100838
    a_63 = -0.58903404061484477
    a_64 = +0.46213380485434047
    W = (
        (0.0, 0.0, 0.0, 0.0),
        ((a_31 - a_21) / c, 0.0, 0.0, 0.0),
        ((a_41 - a_31) / c, (a_42 - a_32) / c, 0.0, 0.0),
        ((a_51 - a_41) / c, (a_52 - a_42) / c, (a_53 - a_43) / c, 0.0),
        (
            (a_61 - a_51) / c,
            (a_62 - a_52) / c,
            (a_63 - a_53) / c,
            (a_64 - a_54) / c,
        ),
    )
    return Tableau(
        5, 4, W, ((1.0, 0.0),) * 5, (1.0, 2.0, 3.0, 4.0, 5.0), 5.0
    )


TABLEAUX["erk 54"] = _erk54_tableau()

EFFICIENCY = {name: tb.eff for name, tb in TABLEAUX.items()}
# Strang split schemes (reference time_integrator.template.h:515-681):
# explicit part A over n_sub substeps, Crank-Nicolson (backward Euler +
# extrapolation, :539-543) over the full advance, explicit part C with
# the fixed tau of part A.
STRANG = {
    "strang ssprk 33 cn": "ssprk 33",
    "strang erk 33 cn": "erk 33",
    "strang erk 43 cn": "erk 43",
}
EFFICIENCY.update(
    {name: 2.0 * TABLEAUX[base].eff for name, base in STRANG.items()}
)
EFFICIENCY.update({"imex 11": 1.0, "imex 22": 2.0, "imex 33": 3.0})


@dataclasses.dataclass
class TimeIntegrator:
    """Drives time steps of the selected scheme, entirely on device.

    parabolic_module: optional; required for strang/imex schemes.
    """

    hyperbolic_module: HyperbolicModule
    scheme: str = "erk 33"
    cfl_min: float = 0.45
    cfl_max: float = 0.90
    cfl_recovery_strategy: str = "bang bang control"  # or "none"
    parabolic_module: Optional[object] = None

    def __post_init__(self):
        if self.scheme not in EFFICIENCY:
            raise ValueError(f"unknown time stepping scheme '{self.scheme}'")
        if self.scheme not in TABLEAUX:
            if self.scheme in ("imex 22", "imex 33"):
                # matching the reference: parabolic_module.template.h:73
                # asserts stages == 0 ("Although IMEX schemes are
                # implemented, the high order fluxes are not.")
                raise NotImplementedError(
                    f"scheme '{self.scheme}' requires high-order parabolic "
                    "fluxes which the reference asserts out as well"
                )
            if self.scheme not in STRANG and self.scheme != "imex 11":
                raise NotImplementedError(
                    f"scheme '{self.scheme}' is not implemented yet"
                )
            if self.parabolic_module is None:
                raise ValueError(
                    f"scheme '{self.scheme}' requires a parabolic module"
                )
        self._advance = jax.jit(self._advance_impl)
        self.n_restarts = 0
        self.n_warnings = 0

    @property
    def efficiency(self) -> float:
        return EFFICIENCY[self.scheme]

    def _parrays(self):
        pm = self.parabolic_module
        return pm.arrays if pm is not None else None

    # -- public host-level entries ----------------------------------------
    def step(self, U, t, t_final=jnp.inf):
        """One full scheme step.  Returns (U_new, tau_total, ok).

        U may be un-prepared; the returned state is prepared (BCs applied,
        precomputed filled) at the new time.  Restart statistics are synced
        to host counters (one device round trip per call — use `advance`
        for sync-free multi-step driving).
        """
        dtype = self.hyperbolic_module.dtype
        U2, prec, t2, tau, restarts, warns = self._advance(
            self.hyperbolic_module.stencil,
            self._parrays(),
            U,
            jnp.asarray(t, dtype),
            jnp.asarray(t_final, dtype),
            1,
        )
        self.n_restarts += int(restarts)
        self.n_warnings += int(warns)
        return U2, tau, warns == 0

    def advance(self, U, t, n_steps, t_final=jnp.inf):
        """Advance n_steps on device without host synchronisation.

        n_steps may be a traced/dynamic value (fori_loop inside; a single
        compiled artifact serves any step count).  Returns (U_prepared,
        precomputed, t_new, tau_last, n_restarts, n_warnings) — all device
        values.
        """
        dtype = self.hyperbolic_module.dtype
        return self._advance(
            self.hyperbolic_module.stencil,
            self._parrays(),
            U,
            jnp.asarray(t, dtype),
            jnp.asarray(t_final, dtype),
            n_steps,
        )

    # -- device-side implementation ---------------------------------------
    def _scheme_device(self, stencil, parrays, Up, prec, t, cfl, tau_cap):
        """One full scheme step on device: explicit tableau or Strang split.

        Returns (U_prepared, prec, tau_unit, ok) with the step advancing
        EFFICIENCY[scheme] * tau_unit.
        """
        hm = self.hyperbolic_module
        if self.scheme == "imex 11":
            U1, p1, tau, okA = self._scheme_scan(
                stencil, Up, prec, t, cfl, tau_cap, "erk 11",
                jnp.zeros((), hm.dtype), True,
            )
            U2, okP = self.parabolic_module.backward_euler_step(
                U1, t, tau, parrays=parrays
            )
            U2p, p2 = hm.prepare_state_vector(U2, t + tau, stencil=stencil)
            return U2p, p2, tau, okA & okP
        if self.scheme in STRANG:
            base = STRANG[self.scheme]
            tb = TABLEAUX[base]
            dtype = hm.dtype
            # part A: explicit half step (computes tau):
            U1, p1, tau, okA = self._scheme_scan(
                stencil, Up, prec, t, cfl, tau_cap / 2.0, base,
                jnp.zeros((), dtype), True,
            )
            # Crank-Nicolson over the full advance 2 * eff * tau
            # (backward Euler + extrapolation, reference :539-543):
            pm = self.parabolic_module
            U_be, okP = pm.backward_euler_step(
                U1, t, tb.eff * tau, parrays=parrays
            )
            U2 = 2.0 * U_be - U1
            U2p, p2 = hm.prepare_state_vector(
                U2, t + tb.eff * tau, stencil=stencil
            )
            # part C: explicit half step at the fixed tau:
            U3, p3, _, okC = self._scheme_scan(
                stencil, U2p, p2, t + tb.eff * tau, cfl, tau_cap, base,
                tau, False,
            )
            return U3, p3, tau, okA & okP & okC
        return self._scheme_scan(
            stencil, Up, prec, t, cfl, tau_cap, self.scheme,
            jnp.zeros((), hm.dtype), True,
        )

    def _scheme_scan(self, stencil, Up, prec, t, cfl, tau_cap, scheme,
                     tau_in, compute_tau: bool):
        """Run all substeps of the tableau, UNROLLED with static weights.

        Up/prec must be prepared.  Returns (U_prepared@t+eff*tau, prec,
        tau, ok).

        The tableau weights are compile-time constants, so each substep
        passes only its ACTIVE stage slots to hm.step and the dead stages'
        neighbor accesses and flux evaluations are never traced (e.g.
        erk33's first substep has no stage work at all).  The stage-buffer
        bookkeeping and the (1, 0) convex combinations disappear
        statically too.
        """
        hm = self.hyperbolic_module
        tb = TABLEAUX[scheme]
        dtype = hm.dtype
        S = tb.S

        bufs = [(Up, prec)]  # slot 0 = U^n prepared; slots 1.. = T_i
        Tp, pn = Up, prec
        tau = jnp.asarray(tau_in, dtype)
        ok = jnp.asarray(True)
        for idx in range(tb.n_sub):
            w_row = tb.W[idx]
            active = [s for s in range(S) if w_row[s] != 0.0]
            if active:
                sU = jnp.stack([bufs[s][0] for s in active])
                sP = jnp.stack([bufs[s][1] for s in active])
                wts = jnp.asarray([w_row[s] for s in active], dtype)
            else:
                sU = jnp.zeros((0,) + Up.shape, dtype)
                sP = jnp.zeros((0,) + prec.shape, dtype)
                wts = jnp.zeros((0,), dtype)
            cap_i = (
                tau_cap / tb.eff if idx == 0
                else jnp.asarray(jnp.inf, dtype)
            )
            T, tau, ok_i = hm.step(
                Tp, pn, sU, sP, wts, tau, cfl, cap_i,
                compute_tau=compute_tau and idx == 0, stencil=stencil,
            )
            a, b = tb.comb[idx]
            if (a, b) != (1.0, 0.0):
                T = a * T + b * bufs[0][0]
            Tp, pn = hm.prepare_state_vector(
                T, t + tb.c[idx] * tau, stencil=stencil
            )
            if idx + 1 < S:
                bufs.append((Tp, pn))
            ok = ok & ok_i
        return Tp, pn, tau, ok

    def _step_recover(self, stencil, parrays, Up, prec, t, tau_cap):
        """Bang-bang CFL recovery (reference :250-275) as a while_loop.

        Returns (U, prec, tau, ok, attempts); the scheme graph appears
        exactly once (the retry re-enters the same loop body).
        """
        dtype = self.hyperbolic_module.dtype
        max_att = 2 if self.cfl_recovery_strategy == "bang bang control" else 1

        def cond_fn(c):
            _, _, _, ok, att = c
            return (att == 0) | ((~ok) & (att < max_att))

        def body_fn(c):
            _, _, _, _, att = c
            cfl = jnp.where(
                att == 0,
                jnp.asarray(self.cfl_max, dtype),
                jnp.asarray(self.cfl_min, dtype),
            )
            U2, p2, tau, ok = self._scheme_device(
                stencil, parrays, Up, prec, t, cfl, tau_cap
            )
            return (U2, p2, tau, ok, att + 1)

        init = (
            Up,
            prec,
            jnp.zeros((), dtype),
            jnp.asarray(False),
            jnp.zeros((), jnp.int32),
        )
        return jax.lax.while_loop(cond_fn, body_fn, init)

    def _advance_impl(self, stencil, parrays, U0, t0, t_final, n_steps):
        hm = self.hyperbolic_module
        eff = EFFICIENCY[self.scheme]
        dtype = hm.dtype
        Up, prec = hm.prepare_state_vector(U0, t0, stencil=stencil)

        def body(_, carry):
            Up, prec, t, tau_last, restarts, warns = carry
            cap = jnp.maximum(t_final - t, 0.0)
            U2, p2, tau, ok, att = self._step_recover(
                stencil, parrays, Up, prec, t, cap
            )
            tau_total = eff * tau
            restarts = restarts + (att - 1)
            warns = warns + jnp.where(ok, 0, 1)
            return (U2, p2, t + tau_total, tau_total, restarts, warns)

        init = (
            Up,
            prec,
            t0,
            jnp.zeros((), dtype),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
        )
        return jax.lax.fori_loop(0, n_steps, body, init)
