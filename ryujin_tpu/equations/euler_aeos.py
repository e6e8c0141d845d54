"""Compressible Euler equations with arbitrary equation of state.

Re-implementation of /root/reference/source/euler_aeos/:
  * EOS abstraction + library (polytropic gas, Noble-Abel stiffened gas,
    Jones-Wilkins-Lee, van der Waals, user function, tabulated):
      equation_of_state.h:29-189, equation_of_state_*.h
  * NASG-surrogate machinery (surrogate gamma / pressure / entropies):
      hyperbolic_system.h:1040-1200
  * two-cycle precomputation: cycle 0 calls the EOS for the pressure and
    the surrogate gamma, cycle 1 takes the stencil minimum of gamma and
    derives the surrogate entropies: hyperbolic_system.h:841-980
  * NASG-aware Riemann solver (RS/SS/interpolated/failsafe p* estimates):
      riemann_solver.template.h:60-665
  * EVC indicator and convex limiter on the surrogate entropy with the
    covolume-corrected upper density bound:
      indicator.h:185-265, limiter.h:260-445, limiter.template.h:15-330

Layout: component-first states [2+dim, ...], node axis last (see
equations/euler.py).  The tabulated EOS evaluates on-device via table
lookup — the analog of the reference's EOSPAC/sesame + spline path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..offline.mesh import Boundary
from .euler import quadratic_newton_step


def _pos(x):
    return jnp.maximum(x, 0.0)


def _neg(x):
    return jnp.maximum(-x, 0.0)


# ---------------------------------------------------------------------------
# Equation of state library (equation_of_state_library.cc:34-39)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EquationOfState:
    """pressure(rho, e), specific_internal_energy(rho, p) and optionally
    temperature/speed_of_sound, plus the NASG interpolation constants
    (b, pinfty, q) used by the surrogate machinery."""

    name: str
    pressure: Callable
    specific_internal_energy: Callable
    speed_of_sound: Optional[Callable] = None
    temperature: Optional[Callable] = None
    interpolation_b: float = 0.0
    interpolation_pinfty: float = 0.0
    interpolation_q: float = 0.0


def polytropic_gas(gamma: float = 1.4) -> EquationOfState:
    """(equation_of_state_polytropic_gas.h)."""
    return EquationOfState(
        name="polytropic gas",
        pressure=lambda rho, e: (gamma - 1.0) * rho * e,
        specific_internal_energy=lambda rho, p: p / ((gamma - 1.0) * rho),
        speed_of_sound=lambda rho, e: jnp.sqrt(gamma * (gamma - 1.0) * e),
    )


def noble_abel_stiffened_gas(
    gamma: float = 1.4, b: float = 0.0, q: float = 0.0, pinf: float = 0.0
) -> EquationOfState:
    """(equation_of_state_noble_abel_stiffened_gas.h:71-115)."""

    def pressure(rho, e):
        return (gamma - 1.0) * rho * (e - q) / (1.0 - b * rho) - gamma * pinf

    def sie(rho, p):
        return q + (p + gamma * pinf) * (1.0 - b * rho) / (rho * (gamma - 1.0))

    def sos(rho, e):
        covolume = 1.0 - b * rho
        num = gamma * (gamma - 1.0) * (rho * (e - q) - pinf * covolume) / rho
        return jnp.sqrt(num) / covolume

    return EquationOfState(
        name="noble abel stiffened gas",
        pressure=pressure,
        specific_internal_energy=sie,
        speed_of_sound=sos,
        interpolation_b=b,
        interpolation_pinfty=pinf,
        interpolation_q=q,
    )


def jones_wilkins_lee(
    capA: float = 6.321e13,
    capB: float = -4.472e9,
    R1: float = 11.3,
    R2: float = 1.13,
    omega: float = 0.8938,
    rho_0: float = 1895.0,
    q_0: float = 0.0,
) -> EquationOfState:
    """(equation_of_state_jones_wilkins_lee.h:67-110)."""

    def _ref_terms(rho):
        ratio = rho / rho_0
        first = capA * (1.0 - omega / R1 * ratio) * jnp.exp(-R1 / ratio)
        second = capB * (1.0 - omega / R2 * ratio) * jnp.exp(-R2 / ratio)
        return first + second

    def pressure(rho, e):
        return _ref_terms(rho) + omega * rho * (e + q_0)

    def sie(rho, p):
        return (p - _ref_terms(rho)) / (omega * rho) - q_0

    return EquationOfState(
        name="jones wilkins lee",
        pressure=pressure,
        specific_internal_energy=sie,
    )


def van_der_waals(
    gamma: float = 1.4, a: float = 0.0, b: float = 0.0
) -> EquationOfState:
    """(equation_of_state_van_der_waals.h:66-95)."""

    def pressure(rho, e):
        inter = a * rho * rho
        return (gamma - 1.0) * (rho * e + inter) / (1.0 - b * rho) - inter

    def sie(rho, p):
        inter = a * rho * rho
        return ((p + inter) * (1.0 - b * rho) / (gamma - 1.0) - inter) / rho

    return EquationOfState(
        name="van der waals",
        pressure=pressure,
        specific_internal_energy=sie,
        interpolation_b=b,
    )


def function_eos(pressure_fn: Callable, sie_fn: Callable) -> EquationOfState:
    """User-supplied callables (equation_of_state_function.h)."""
    return EquationOfState(
        name="function",
        pressure=pressure_fn,
        specific_internal_energy=sie_fn,
    )


def tabulated(
    rho_grid: np.ndarray,
    e_grid: np.ndarray,
    p_table: np.ndarray,
) -> EquationOfState:
    """Tabulated EOS with on-device bilinear lookup.

    Analog of the reference's sesame/EOSPAC + cubic-spline path
    (equation_of_state_sesame.h, cubic_spline.h): the table lives in
    device memory
    and evaluation is a vectorized interpolation — EOSPAC itself is a
    proprietary host library and is not bundled.  For smooth 1D tabulated
    data, ryujin_tpu.utils.cubic_spline.CubicSpline provides the GSL
    natural-spline analog used to build higher-order function_eos tables.
    """
    rho_g = jnp.asarray(rho_grid)
    e_g = jnp.asarray(e_grid)
    p_t = jnp.asarray(p_table)

    def _interp2(rho, e):
        ri = jnp.clip(
            jnp.searchsorted(rho_g, rho) - 1, 0, rho_g.shape[0] - 2
        )
        ei = jnp.clip(jnp.searchsorted(e_g, e) - 1, 0, e_g.shape[0] - 2)
        fr = (rho - rho_g[ri]) / (rho_g[ri + 1] - rho_g[ri])
        fe = (e - e_g[ei]) / (e_g[ei + 1] - e_g[ei])
        p00 = p_t[ri, ei]
        p10 = p_t[ri + 1, ei]
        p01 = p_t[ri, ei + 1]
        p11 = p_t[ri + 1, ei + 1]
        return (
            p00 * (1 - fr) * (1 - fe)
            + p10 * fr * (1 - fe)
            + p01 * (1 - fr) * fe
            + p11 * fr * fe
        )

    def sie(rho, p):
        # invert the table along e by bisection (vectorized):
        lo = jnp.full_like(rho, float(e_grid[0]))
        hi = jnp.full_like(rho, float(e_grid[-1]))
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            too_low = _interp2(rho, mid) < p
            lo = jnp.where(too_low, mid, lo)
            hi = jnp.where(too_low, hi, mid)
        return 0.5 * (lo + hi)

    return EquationOfState(
        name="sesame", pressure=_interp2, specific_internal_energy=sie
    )


def sesame(filename: str) -> EquationOfState:
    """Tabulated EOS loaded from a table file.

    The analog of the reference's sesame/EOSPAC6 material-table path
    (equation_of_state_library.cc:34-39, equation_of_state_sesame.h);
    the proprietary EOSPAC binary format is not readable without the
    vendor library, so the reader ingests open formats carrying the same
    (rho, e) -> p data:

    * ``.npz`` with arrays ``rho`` [Nr], ``e`` [Ne], ``p`` [Nr, Ne]
    * whitespace text: a header line ``Nr Ne``, then the rho grid, the
      e grid, and the row-major p table.

    Grids must be strictly increasing; the table is mapped onto the
    on-device bilinear `tabulated` EOS.
    """
    import os

    if not os.path.exists(filename):
        raise FileNotFoundError(f"EOS table '{filename}' not found")
    if filename.endswith(".npz"):
        with np.load(filename, allow_pickle=False) as z:
            rho_g = np.asarray(z["rho"], np.float64)
            e_g = np.asarray(z["e"], np.float64)
            p_t = np.asarray(z["p"], np.float64)
    else:
        vals = np.fromstring(
            " ".join(
                ln for ln in open(filename)
                if not ln.lstrip().startswith("#")
            ),
            sep=" ",
        )
        nr, ne = int(vals[0]), int(vals[1])
        need = 2 + nr + ne + nr * ne
        if len(vals) < need:
            raise ValueError(
                f"EOS table '{filename}': expected {need} values, "
                f"got {len(vals)}"
            )
        rho_g = vals[2 : 2 + nr]
        e_g = vals[2 + nr : 2 + nr + ne]
        p_t = vals[2 + nr + ne : need].reshape(nr, ne)
    if p_t.shape != (len(rho_g), len(e_g)):
        raise ValueError(
            f"EOS table '{filename}': p shape {p_t.shape} does not match "
            f"grids ({len(rho_g)}, {len(e_g)})"
        )
    if not (np.all(np.diff(rho_g) > 0) and np.all(np.diff(e_g) > 0)):
        raise ValueError(f"EOS table '{filename}': grids must increase")
    return tabulated(rho_g, e_g, p_t)


EOS_LIBRARY = {
    "polytropic gas": polytropic_gas,
    "noble abel stiffened gas": noble_abel_stiffened_gas,
    "jones wilkins lee": jones_wilkins_lee,
    "van der waals": van_der_waals,
    "sesame": sesame,
}


# ---------------------------------------------------------------------------
# The equation module
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EulerAEOSParams:
    """(hyperbolic_system.h:770-800)."""

    reference_density: float = 1.0
    vacuum_state_relaxation_small: float = 1.0e2
    vacuum_state_relaxation_large: float = 1.0e4
    compute_strict_bounds: bool = True


@dataclasses.dataclass(frozen=True)
class EulerAEOS:
    """The Euler-AEOS "Description"."""

    dim: int
    eos: EquationOfState = dataclasses.field(
        default_factory=polytropic_gas
    )
    params: EulerAEOSParams = EulerAEOSParams()

    name = "euler aeos"
    n_precomputed = 4  # [p, surrogate_gamma_min, surrogate_s, surrogate_eta]
    n_initial_precomputed = 0
    n_precomputation_cycles = 2
    n_bounds = 4  # [rho_min, rho_max, s_min, gamma_min]
    have_high_order_flux = False
    have_source_terms = False
    have_equilibrated_states = False
    is_identity_parabolic = True

    @property
    def n_comp(self) -> int:
        return 2 + self.dim

    @property
    def component_names(self):
        return (
            ["rho"] + [f"m_{i+1}" for i in range(self.dim)] + ["E"]
            if self.dim > 1
            else ["rho", "m", "E"]
        )

    @property
    def primitive_component_names(self):
        return (
            ["rho"] + [f"v_{i+1}" for i in range(self.dim)] + ["e"]
            if self.dim > 1
            else ["rho", "v", "e"]
        )

    precomputed_names = (
        "p", "surrogate_gamma", "surrogate_specific_entropy",
        "surrogate_harten_entropy",
    )

    # ---- basic quantities ------------------------------------------------
    def density(self, U):
        return U[0]

    def momentum(self, U):
        return U[1 : 1 + self.dim]

    def total_energy(self, U):
        return U[1 + self.dim]

    def internal_energy(self, U):
        rho_inv = 1.0 / self.density(U)
        m = self.momentum(U)
        return self.total_energy(U) - 0.5 * jnp.sum(m * m, 0) * rho_inv

    def internal_energy_derivative(self, U):
        rho_inv = 1.0 / self.density(U)
        u = self.momentum(U) * rho_inv[None]
        return jnp.concatenate(
            [(0.5 * jnp.sum(u * u, 0))[None], -u, jnp.ones_like(U[:1])],
            axis=0,
        )

    def filter_vacuum_density(self, rho):
        eps = jnp.finfo(rho.dtype).eps
        cutoff = (
            self.params.reference_density
            * self.params.vacuum_state_relaxation_large
            * eps
        )
        return jnp.where(jnp.abs(rho) < cutoff, jnp.zeros_like(rho), rho)

    # ---- NASG surrogate machinery (hyperbolic_system.h:1040-1200) ----------
    def surrogate_specific_entropy(self, U, gamma_min):
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        q = self.eos.interpolation_q
        rho = self.density(U)
        rho_inv = 1.0 / rho
        covolume = 1.0 - b * rho
        shift = self.internal_energy(U) - rho * q - pinf * covolume
        return shift * jnp.power(rho_inv - b, gamma_min) / covolume

    def surrogate_harten_entropy(self, U, gamma_min):
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        q = self.eos.interpolation_q
        rho = self.density(U)
        m = self.momentum(U)
        E = self.total_energy(U)
        rho_rho_e_q = rho * E - 0.5 * jnp.sum(m * m, 0) - rho * rho * q
        exponent = 1.0 / (gamma_min + 1.0)
        covolume = 1.0 - b * rho
        covolume_term = jnp.power(covolume, gamma_min - 1.0)
        rho_pinfcov = rho * pinf * covolume
        return jnp.power(
            (rho_rho_e_q - rho_pinfcov) * covolume_term, exponent
        )

    def surrogate_harten_entropy_derivative(self, U, eta, gamma_min):
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        q = self.eos.interpolation_q
        rho = self.density(U)
        m = self.momentum(U)
        E = self.total_energy(U)
        covolume = 1.0 - b * rho
        covolume_inverse = 1.0 / covolume
        shift = (
            rho * E - 0.5 * jnp.sum(m * m, 0) - rho * rho * q
            - rho * pinf * covolume
        )
        factor = (
            jnp.power(eta * covolume_inverse, -gamma_min)
            * covolume_inverse * covolume_inverse
            / (gamma_min + 1.0)
        )
        first_term = E - 2.0 * rho * q - pinf * (1.0 - 2.0 * b * rho)
        second_term = -(gamma_min - 1.0) * shift * b
        return jnp.concatenate(
            [
                (factor * (covolume * first_term + second_term))[None],
                -(factor * covolume)[None] * m,
                (factor * covolume * rho)[None],
            ],
            axis=0,
        )

    def surrogate_gamma(self, U, p):
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        q = self.eos.interpolation_q
        rho = self.density(U)
        rho_e = self.internal_energy(U)
        covolume = 1.0 - b * rho
        numerator = (p + pinf) * covolume
        denominator = rho_e - rho * q - covolume * pinf
        return 1.0 + numerator / denominator

    def surrogate_pressure(self, U, gamma):
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        q = self.eos.interpolation_q
        rho = self.density(U)
        rho_e = self.internal_energy(U)
        covolume = 1.0 - b * rho
        return (gamma - 1.0) * (rho_e - rho * q) / covolume - gamma * pinf

    def is_admissible(self, U):
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        q = self.eos.interpolation_q
        rho = self.density(U)
        covolume = 1.0 - b * rho
        shift = self.internal_energy(U) - rho * q - pinf * covolume
        return (rho > 0) & (covolume > 0) & (shift > 0)

    # ---- state transforms --------------------------------------------------
    def from_primitive_state(self, prim):
        """prim = [rho, v.., e] (hyperbolic_system.h primitive convention)."""
        rho = prim[0]
        v = prim[1 : 1 + self.dim]
        e = prim[1 + self.dim]
        E = rho * e + 0.5 * rho * jnp.sum(v * v, 0)
        return jnp.concatenate([rho[None], rho[None] * v, E[None]], axis=0)

    def to_primitive_state(self, U):
        rho_inv = 1.0 / self.density(U)
        e = self.internal_energy(U) * rho_inv
        return jnp.concatenate(
            [U[:1], self.momentum(U) * rho_inv[None], e[None]], axis=0
        )

    # ---- precomputation (two cycles, hyperbolic_system.h:841-980) -----------
    def precompute(self, U, initial_precomputed, cycle: int = 0, prev=None,
                   stencil=None):
        del initial_precomputed
        if cycle == 0:
            rho = self.density(U)
            e = self.internal_energy(U) / rho
            p = self.eos.pressure(rho, e)
            gamma = self.surrogate_gamma(U, p)
            zero = jnp.zeros_like(p)
            return jnp.stack([p, gamma, zero, zero], axis=0)
        # cycle 1: gamma_min over the stencil, then surrogate entropies
        assert prev is not None and stencil is not None
        p = prev[0]
        gamma = prev[1]
        gamma_j = stencil.nbr(gamma)  # [K, n]
        big = jnp.asarray(jnp.finfo(gamma.dtype).max, gamma.dtype)
        gamma_min = jnp.minimum(
            gamma,
            jnp.min(jnp.where(stencil.mask > 0, gamma_j, big), axis=0),
        )
        s = self.surrogate_specific_entropy(U, gamma_min)
        eta = self.surrogate_harten_entropy(U, gamma_min)
        return jnp.stack([p, gamma_min, s, eta], axis=0)

    # ---- fluxes -------------------------------------------------------------
    def f(self, U, p):
        """Flux tensor [C, dim, ...] with explicit pressure."""
        d = self.dim
        rho_inv = 1.0 / self.density(U)
        m = self.momentum(U)
        E = self.total_energy(U)
        v = m * rho_inv[None]
        rows = [m]
        for a in range(d):
            comps = [m[a] * v[bb] for bb in range(d)]
            comps[a] = comps[a] + p
            rows.append(jnp.stack(comps, axis=0))
        rows.append(v * (E + p)[None])
        return jnp.stack(rows, axis=0)

    def flux_contribution(self, precomputed, initial_precomputed, U):
        del initial_precomputed
        return self.f(U, precomputed[0])

    def flux_divergence(self, flux_i, flux_j, c_ij):
        return -jnp.sum((flux_i + flux_j) * c_ij[None], axis=1)

    # ---- Riemann solver (riemann_solver.template.h:60-665) -------------------
    def _c_gamma(self, gamma):
        slope = -0.34976871477801828189920753948709
        first = (3.0 * gamma + 11.0) / (6.0 * gamma + 6.0)
        second = 5.0 / 6.0 + slope * (gamma - 3.0)
        radicand = jnp.clip(jnp.minimum(first, second), 0.5, 1.0)
        return jnp.sqrt(radicand)

    def _alpha(self, rho, gamma, a):
        b = self.eos.interpolation_b
        return 2.0 * a * (1.0 - b * rho) / (gamma - 1.0)

    def _riemann_data(self, U, p, n_ij):
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        rho = self.density(U)
        rho_inv = 1.0 / rho
        proj_m = jnp.sum(n_ij * self.momentum(U), axis=0)
        gamma = self.surrogate_gamma(U, p)
        x = 1.0 - b * rho
        a = jnp.sqrt(gamma * (p + pinf) / (rho * x))
        return rho, proj_m * rho_inv, p, gamma, a

    def riemann_lambda_max(
        self, U_i, U_j, n_ij, prec_i=None, prec_j=None,
        newton_iterations: int = 0, newton_tol: float = 1e-10,
    ):
        del newton_iterations, newton_tol
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        di = self._riemann_data(U_i, prec_i[0], n_ij)
        dj = self._riemann_data(U_j, prec_j[0], n_ij)
        rho_i, u_i, p_i, gamma_i, a_i = di
        rho_j, u_j, p_j, gamma_j, a_j = dj

        p_max = jnp.maximum(p_i, p_j) + pinf

        # phi(p_max) (:440-470)
        ri = 0.5 * rho_i / (1.0 - b * rho_i) * (
            (gamma_i + 1.0) * p_max + (gamma_i - 1.0) * (p_i + pinf)
        )
        vi = (p_max - p_i) / jnp.sqrt(ri)
        rj = 0.5 * rho_j / (1.0 - b * rho_j) * (
            (gamma_j + 1.0) * p_max + (gamma_j - 1.0) * (p_j + pinf)
        )
        vj = (p_max - p_j) / jnp.sqrt(rj)
        phi_p_max = vi + vj + u_j - u_i

        alpha_i = self._alpha(rho_i, gamma_i, a_i)
        alpha_j = self._alpha(rho_j, gamma_j, a_j)
        p_lt = p_i < p_j
        p_min_ = jnp.minimum(p_i, p_j)
        p_max_ = jnp.maximum(p_i, p_j)
        gamma_min = jnp.where(p_lt, gamma_i, gamma_j)
        gamma_max = jnp.where(p_lt, gamma_j, gamma_i)
        alpha_min = jnp.where(p_lt, alpha_i, alpha_j)
        alpha_max = jnp.where(p_lt, alpha_j, alpha_i)
        alpha_hat_min = self._c_gamma(gamma_min) * alpha_min
        alpha_hat_max = self._c_gamma(gamma_max) * alpha_max
        gamma_m = jnp.minimum(gamma_i, gamma_j)
        gamma_M = jnp.maximum(gamma_i, gamma_j)

        # p_star_RS_full (:100-200)
        numerator = _pos(alpha_hat_min + alpha_max - (u_j - u_i))
        p_ratio_RS = (p_min_ + pinf) / (p_max_ + pinf)
        r_exponent = (gamma_M - gamma_min) / (2.0 * gamma_min * gamma_M)
        first_exponent = (gamma_M - 1.0) / (2.0 * gamma_M)
        first_denom = (
            alpha_hat_min
            * jnp.power(p_ratio_RS, r_exponent - first_exponent)
            + alpha_max
        )
        p_1_tilde = (p_max_ + pinf) * jnp.power(
            numerator / first_denom, 1.0 / first_exponent
        ) - pinf
        second_exponent = (gamma_m - 1.0) / (2.0 * gamma_m)
        second_denom = (
            alpha_hat_min * jnp.power(p_ratio_RS, -second_exponent)
            + alpha_max * jnp.power(p_ratio_RS, r_exponent)
        )
        p_2_tilde = (p_max_ + pinf) * jnp.power(
            numerator / second_denom, 1.0 / second_exponent
        ) - pinf
        p_star_RS = jnp.minimum(p_1_tilde, p_2_tilde)

        # p_star_failsafe (:240-300)
        radicand_i = 2.0 * (1.0 - b * rho_i) * p_max / (
            rho_i * (
                (gamma_i + 1.0) * p_max + (gamma_i - 1.0) * (p_i + pinf)
            )
        )
        x_i = jnp.sqrt(radicand_i)
        radicand_j = 2.0 * (1.0 - b * rho_j) * p_max / (
            rho_j * (
                (gamma_j + 1.0) * p_max + (gamma_j - 1.0) * (p_j + pinf)
            )
        )
        x_j = jnp.sqrt(radicand_j)
        a_q = x_i + x_j
        b_q = u_j - u_i
        c_q = -(p_i + pinf) * x_i - (p_j + pinf) * x_j
        base = (-b_q + jnp.sqrt(b_q * b_q - 4.0 * a_q * c_q)) / (2.0 * a_q)
        p_star_failsafe = base * base - pinf

        # p_star_SS_full (:206-238)
        alpha_hat_i = self._c_gamma(gamma_i) * alpha_i
        alpha_hat_j = self._c_gamma(gamma_j) * alpha_j
        exponent_SS = (gamma_m - 1.0) / (2.0 * gamma_m)
        numerator_SS = _pos(alpha_hat_i + alpha_hat_j - (u_j - u_i))
        denominator_SS = (
            alpha_hat_i
            * jnp.power((p_i + pinf) / (p_j + pinf), -exponent_SS)
            + alpha_hat_j
        )
        p_SS_1 = (p_j + pinf) * jnp.power(
            numerator_SS / denominator_SS, 1.0 / exponent_SS
        ) - pinf
        p_star_SS = jnp.minimum(p_SS_1, p_star_failsafe)

        if self.params.compute_strict_bounds:
            p_2 = jnp.where(
                phi_p_max < 0.0, p_star_SS, jnp.minimum(p_max, p_star_RS)
            )
        else:
            # p_star_interpolated (:300-350)
            p_ratio = (p_min_ + pinf) / (p_max_ + pinf)
            exponent = (gamma_m - 1.0) / (2.0 * gamma_m)
            numerator_I = _pos(alpha_hat_min + alpha_max - (u_j - u_i))
            denominator_I = (
                alpha_hat_min * jnp.power(p_ratio, -exponent)
                + alpha_hat_max * jnp.power(p_ratio, r_exponent)
            )
            p_interp = (p_max_ + pinf) * jnp.power(
                numerator_I / denominator_I, 1.0 / exponent
            ) - pinf
            p_2 = jnp.where(
                phi_p_max < 0.0,
                jnp.minimum(p_interp, p_star_failsafe),
                jnp.minimum(p_max, p_interp),
            )

        def lambda1_minus(data, p_star):
            rho, u, p, gamma, a = data
            factor = 0.5 * (gamma + 1.0) / gamma
            tmp = _pos((p_star - p) / (p + pinf))
            return u - a * jnp.sqrt(1.0 + factor * tmp)

        def lambda3_plus(data, p_star):
            rho, u, p, gamma, a = data
            factor = 0.5 * (gamma + 1.0) / gamma
            tmp = _pos((p_star - p) / (p + pinf))
            return u + a * jnp.sqrt(1.0 + factor * tmp)

        nu_11 = lambda1_minus(di, p_2)
        nu_32 = lambda3_plus(dj, p_2)
        return jnp.maximum(_pos(nu_32), _neg(nu_11))

    # ---- indicator (euler_aeos/indicator.h:185-265) ----------------------------
    def indicator_alpha(
        self, U_i, prec_i, U_j, prec_j, c_ij, mask, hd_i,
        evc_factor: float = 1.0,
    ):
        gamma_min = prec_i[1]
        eta_i = prec_i[3]
        rho_i = self.density(U_i)
        rho_i_inv = 1.0 / rho_i
        d_eta_i = self.surrogate_harten_entropy_derivative(
            U_i, eta_i, gamma_min
        )
        d_eta_i = jnp.concatenate(
            [(d_eta_i[0] - eta_i * rho_i_inv)[None], d_eta_i[1:]], axis=0
        )
        f_i = self.f(U_i, self.surrogate_pressure(U_i, gamma_min))

        eta_j = self.surrogate_harten_entropy(U_j, gamma_min[None])
        rho_j = self.density(U_j)
        m_j = self.momentum(U_j)
        f_j = self.f(U_j, self.surrogate_pressure(U_j, gamma_min[None]))

        entropy_flux = (
            eta_j / rho_j - (eta_i * rho_i_inv)[None]
        ) * jnp.sum(m_j * c_ij, axis=0)
        left = jnp.sum(entropy_flux * mask, axis=0)

        components = jnp.sum(
            (f_j - f_i[:, :, None]) * c_ij[None], axis=1
        )
        right = jnp.sum(components * mask[None], axis=1)

        numerator = left - jnp.sum(d_eta_i * right, axis=0)
        denominator = jnp.abs(left) + jnp.sum(
            jnp.abs(d_eta_i * right), axis=0
        )
        quotient = jnp.abs(numerator) / (denominator + hd_i * jnp.abs(eta_i))
        return jnp.minimum(1.0, evc_factor * quotient)

    # ---- limiter (euler_aeos/limiter.h:260-445) ---------------------------------
    def limiter_bounds(
        self,
        U_i,
        prec_i,
        U_j,
        prec_j,
        scaled_c_ij,
        mask,
        hd_i,
        relaxation_factor: float = 1.0,
    ):
        dtype = U_i.dtype
        gamma_min = prec_i[1]
        rho_i = self.density(U_i)
        rho_j = self.density(U_j)
        f_i = self.f(U_i, prec_i[0])
        f_j = self.f(U_j, prec_j[0])

        U_ij_bar = 0.5 * (U_i[:, None] + U_j) - 0.5 * jnp.sum(
            (f_j - f_i[:, :, None]) * scaled_c_ij[None], axis=1
        )
        rho_ij_bar = self.density(U_ij_bar)
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        rho_min = jnp.min(jnp.where(mask > 0, rho_ij_bar, big), axis=0)
        rho_max = jnp.max(jnp.where(mask > 0, rho_ij_bar, 0.0), axis=0)
        rho_min = jnp.minimum(rho_min, rho_i)  # diagonal entry
        rho_max = jnp.maximum(rho_max, rho_i)

        k_count = jnp.sum(mask, axis=0)
        rho_relax_num = (
            jnp.sum((rho_i[None] + rho_j) * mask, axis=0) + 2.0 * rho_i
        )
        rho_relax_den = k_count + 1.0

        gm = gamma_min[None]
        if self.params.compute_strict_bounds:
            s_j = self.surrogate_specific_entropy(U_j, gm)
            s_ij_bar = self.surrogate_specific_entropy(U_ij_bar, gm)
            s_interp = self.surrogate_specific_entropy(
                0.5 * (U_i[:, None] + U_j), gm
            )
            s_min = jnp.min(
                jnp.where(mask > 0, jnp.minimum(s_j, s_ij_bar), big), axis=0
            )
            s_interp_max = jnp.max(
                jnp.where(mask > 0, s_interp, -big), axis=0
            )
        else:
            s_j = prec_j[2]
            s_ij_bar = self.surrogate_specific_entropy(U_ij_bar, gm)
            s_min = jnp.min(
                jnp.where(mask > 0, jnp.minimum(s_j, s_ij_bar), big), axis=0
            )
            s_interp_max = jnp.max(
                jnp.where(mask > 0, s_ij_bar, -big), axis=0
            )
        # diagonal contribution:
        s_i = self.surrogate_specific_entropy(U_i, gamma_min)
        s_min = jnp.minimum(s_min, s_i)
        s_interp_max = jnp.maximum(s_interp_max, s_i)

        r_i = jnp.sqrt(hd_i)
        if self.dim == 2:
            r_i = jnp.sqrt(jnp.sqrt(hd_i)) ** 3
        elif self.dim == 1:
            r_i = jnp.sqrt(hd_i) ** 3
        r_i = r_i * relaxation_factor

        eps = jnp.finfo(dtype).eps
        rho_relaxation = jnp.abs(rho_relax_num) / (
            jnp.abs(rho_relax_den) + eps
        )
        relaxation = 2.0 * relaxation_factor * rho_relaxation
        rho_min = jnp.maximum((1.0 - r_i) * rho_min, rho_min - relaxation)
        rho_max = jnp.minimum((1.0 + r_i) * rho_max, rho_max + relaxation)

        entropy_relaxation = relaxation_factor * (s_interp_max - s_min)
        s_min = jnp.maximum((1.0 - r_i) * s_min, s_min - entropy_relaxation)

        # covolume-corrected maximal density (limiter.h:415-430):
        b = self.eos.interpolation_b
        upper = (gamma_min + 1.0) * rho_max / (
            gamma_min - 1.0 + 2.0 * b * rho_max
        )
        rho_max = jnp.minimum(upper, rho_max) if b else rho_max

        return jnp.stack([rho_min, rho_max, s_min, gamma_min], axis=0)

    def limiter_limit(
        self,
        bounds,
        U,
        P,
        newton_iterations: int = 2,
        newton_tol: float = 1.0e-10,
        t_min=0.0,
        t_max=1.0,
    ):
        """(euler_aeos/limiter.template.h:15-330)."""
        dtype = U.dtype
        eps = jnp.finfo(dtype).eps
        relax_small = 1.0 + self.params.vacuum_state_relaxation_small * eps
        relax = 1.0 + self.params.vacuum_state_relaxation_large * eps
        b = self.eos.interpolation_b
        pinf = self.eos.interpolation_pinfty
        q = self.eos.interpolation_q

        rho_min, rho_max, s_min, gamma = (
            bounds[0], bounds[1], bounds[2], bounds[3],
        )
        gm1 = gamma - 1.0

        rho_U = self.density(U)
        rho_P = self.density(P)

        test_min = self.filter_vacuum_density(_pos(rho_U - relax * rho_max))
        test_max = self.filter_vacuum_density(_pos(rho_min - relax * rho_U))
        success = (test_min == 0.0) & (test_max == 0.0)

        denominator = 1.0 / (jnp.abs(rho_P) + eps * rho_max)
        t_r = jnp.full(
            jnp.broadcast_shapes(rho_U.shape, rho_P.shape), t_max, dtype
        )
        t_r = jnp.where(
            rho_max < rho_U + t_r * rho_P, (rho_max - rho_U) * denominator, t_r
        )
        t_r = jnp.where(
            rho_U + t_r * rho_P < rho_min, (rho_U - rho_min) * denominator, t_r
        )
        t_r = jnp.clip(t_r, t_min, t_max)

        t_l = jnp.full_like(t_r, t_min)

        def psi_of(t):
            U_t = U + t[None] * P
            rho = self.density(U_t)
            rho_gamma = jnp.power(rho, gamma)
            covolume = 1.0 - b * rho
            rho_e = self.internal_energy(U_t)
            shift = rho_e - rho * q - pinf * covolume
            psi = relax_small * rho * shift - s_min * rho * rho_gamma * \
                jnp.power(covolume, -gm1)
            return rho, rho_gamma, covolume, rho_e, shift, psi

        for n in range(newton_iterations):
            rho_r, rho_r_g, cov_r, rho_e_r, shift_r, psi_r = psi_of(t_r)
            t_l = jnp.where(psi_r > 0.0, t_r, t_l)
            rho_l, rho_l_g, cov_l, rho_e_l, shift_l, psi_l = psi_of(t_l)

            if n == 0:
                lower_bound = (
                    (1.0 - relax) * s_min * rho_l * rho_l_g
                    * jnp.power(cov_l, -gm1)
                )
                success = success & (
                    jnp.minimum(0.0, psi_l - lower_bound) == 0.0
                )

            drho = rho_P
            drho_e_l = jnp.sum(
                self.internal_energy_derivative(U + t_l[None] * P) * P, 0
            )
            drho_e_r = jnp.sum(
                self.internal_energy_derivative(U + t_r[None] * P) * P, 0
            )
            q_pinf_l = 2.0 * rho_l * q + pinf * (1.0 - 2.0 * b * rho_l)
            q_pinf_r = 2.0 * rho_r * q + pinf * (1.0 - 2.0 * b * rho_r)
            extra_l = s_min * jnp.power(rho_l / cov_l, gamma) * (
                cov_l + gamma - b * rho_l
            )
            extra_r = s_min * jnp.power(rho_r / cov_r, gamma) * (
                cov_r + gamma - b * rho_r
            )
            dpsi_l = rho_l * drho_e_l + (rho_e_l - q_pinf_l - extra_l) * drho
            dpsi_r = rho_r * drho_e_r + (rho_e_r - q_pinf_r - extra_r) * drho

            nl, nr = quadratic_newton_step(
                t_l, t_r, psi_l, psi_r, dpsi_l, dpsi_r, sign=-1.0
            )
            active = (t_r - t_l) > newton_tol
            t_l = jnp.where(active, nl, t_l)
            t_r = jnp.where(active, nr, t_r)

        return t_l, success

    def combine_bounds(self, a, b):
        return jnp.stack(
            [
                jnp.minimum(a[0], b[0]),
                jnp.maximum(a[1], b[1]),
                jnp.minimum(a[2], b[2]),
                jnp.minimum(a[3], b[3]),
            ],
            axis=0,
        )

    # ---- boundary conditions ---------------------------------------------------
    def apply_boundary_conditions(self, bc_id: int, U, normal, dirichlet_data):
        if bc_id == Boundary.do_nothing:
            return U
        if bc_id == Boundary.dirichlet:
            return dirichlet_data
        if bc_id == Boundary.slip:
            m = self.momentum(U)
            m = m - jnp.sum(m * normal, 0, keepdims=True) * normal
            return jnp.concatenate([U[:1], m, U[1 + self.dim :]], axis=0)
        if bc_id == Boundary.no_slip:
            return jnp.concatenate(
                [U[:1], jnp.zeros_like(self.momentum(U)), U[1 + self.dim :]],
                axis=0,
            )
        raise ValueError(
            f"boundary id {bc_id} not implemented for euler aeos"
        )
