"""Compressible Euler equations with polytropic gas EOS.

Re-implementation of the reference Euler module:
  * state transforms / derived quantities:
      /root/reference/source/euler/hyperbolic_system.h:740-1306
  * approximate Riemann solver (Guermond-Popov two-rarefaction bound):
      /root/reference/source/euler/riemann_solver.template.h
  * entropy-viscosity-commutator indicator:
      /root/reference/source/euler/indicator.h:187-258
  * convex limiter (density interval + specific entropy minimum principle
    with quadratic Newton):
      /root/reference/source/euler/limiter.h + limiter.template.h

Layout convention: the COMPONENT axis comes FIRST and the (large) node
axis LAST — states are [C, ...batch] with components [rho, m_1..m_dim,
E], so the contiguous axis is the long one and elementwise work on it is
unit-stride.  All functions
broadcast over arbitrary trailing batch axes ([n], [K, n], ...) and
contain no loops — the solver maps them over edge/node arrays and lets
XLA fuse.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..offline.mesh import Boundary


def _pos(x):
    return jnp.maximum(x, 0.0)


def _neg(x):
    return jnp.maximum(-x, 0.0)


def _pow(x, e: float):
    """jnp.power with (near-)integer exponents strength-reduced to
    multiplies (binary exponentiation).

    For gamma = 1.4 the two-rarefaction exponent 2 gamma / (gamma - 1)
    evaluates to 7 + O(eps); the transcendental pow dominates the Riemann
    solver's arithmetic, and the reference's SIMD pow is likewise
    approximate (simd_fast_pow.template.h), so snapping the exponent to
    the nearest integer is within the method's accuracy."""
    er = round(e)
    if abs(e - er) < 1.0e-8 and 1 <= abs(er) <= 16:
        n = abs(er)
        acc = None
        base = x
        while n:
            if n & 1:
                acc = base if acc is None else acc * base
            n >>= 1
            if n:
                base = base * base
        return acc if er > 0 else 1.0 / acc
    return jnp.power(x, e)


@dataclasses.dataclass(frozen=True)
class EulerParams:
    """Runtime parameters (euler/hyperbolic_system.h:665-699)."""

    gamma: float = 1.4
    reference_density: float = 1.0
    vacuum_state_relaxation_small: float = 1.0e2
    vacuum_state_relaxation_large: float = 1.0e4


@dataclasses.dataclass(frozen=True)
class Euler:
    """The Euler "Description": hyperbolic system + riemann/indicator/limiter.

    dim and params are static Python values; every method is traceable.
    """

    dim: int
    params: EulerParams = EulerParams()

    # ---- structure ----------------------------------------------------
    name = "euler"
    n_precomputed = 2  # [s, eta_harten]
    n_initial_precomputed = 0
    n_precomputation_cycles = 1
    n_bounds = 3  # [rho_min, rho_max, s_min]
    have_high_order_flux = False
    have_source_terms = False
    have_equilibrated_states = False
    # lambda_max(U_i, U_j, n) == lambda_max(U_j, U_i, -n) exactly (the
    # two-rarefaction p* and the failsafe are symmetric under the swap),
    # so the solver may evaluate one direction per undirected edge and
    # reuse it -- the analog of the reference's upper-triangle pass +
    # d_ji = d_ij symmetrization (hyperbolic_module.template.h:432-490):
    riemann_symmetric = True
    is_identity_parabolic = True  # no parabolic subsystem

    @property
    def n_comp(self) -> int:
        return 2 + self.dim

    @property
    def component_names(self):
        return (
            ["rho"]
            + [f"m_{i+1}" for i in range(self.dim)]
            + ["E"]
        ) if self.dim > 1 else ["rho", "m", "E"]

    @property
    def primitive_component_names(self):
        return (
            ["rho"]
            + [f"v_{i+1}" for i in range(self.dim)]
            + ["p"]
        ) if self.dim > 1 else ["rho", "v", "p"]

    precomputed_names = ("s", "eta_h")

    # ---- derived quantities (hyperbolic_system.h:740-979) --------------
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
            [
                (0.5 * jnp.sum(u * u, 0))[None],
                -u,
                jnp.ones_like(U[:1]),
            ],
            axis=0,
        )

    def pressure(self, U):
        return (self.params.gamma - 1.0) * self.internal_energy(U)

    def speed_of_sound(self, U):
        g = self.params.gamma
        return jnp.sqrt(g * self.pressure(U) / self.density(U))

    def specific_entropy(self, U):
        g = self.params.gamma
        rho_inv = 1.0 / self.density(U)
        return self.internal_energy(U) * jnp.power(rho_inv, g)

    def harten_entropy(self, U):
        g = self.params.gamma
        rho = self.density(U)
        m = self.momentum(U)
        E = self.total_energy(U)
        rho_rho_e = rho * E - 0.5 * jnp.sum(m * m, 0)
        return jnp.power(rho_rho_e, 1.0 / (g + 1.0))

    def harten_entropy_derivative(self, U):
        g = self.params.gamma
        rho = self.density(U)
        m = self.momentum(U)
        E = self.total_energy(U)
        rho_rho_e = rho * E - 0.5 * jnp.sum(m * m, 0)
        factor = (1.0 / (g + 1.0)) * jnp.power(rho_rho_e, -g / (g + 1.0))
        return jnp.concatenate(
            [
                (factor * E)[None],
                -factor[None] * m,
                (factor * rho)[None],
            ],
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

    def is_admissible(self, U):
        return (
            (self.density(U) > 0)
            & (self.internal_energy(U) > 0)
            & (self.specific_entropy(U) > 0)
        )

    # ---- state transforms ---------------------------------------------
    def from_primitive_state(self, prim):
        g = self.params.gamma
        rho = prim[0]
        u = prim[1 : 1 + self.dim]
        p = prim[1 + self.dim]
        E = p / (g - 1.0) + 0.5 * rho * jnp.sum(u * u, 0)
        return jnp.concatenate([rho[None], rho[None] * u, E[None]], axis=0)

    def to_primitive_state(self, U):
        rho_inv = 1.0 / self.density(U)
        p = self.pressure(U)
        return jnp.concatenate(
            [U[:1], self.momentum(U) * rho_inv[None], p[None]], axis=0
        )

    # ---- precomputation (hyperbolic_system.h:702-737) -------------------
    def precompute(self, U, initial_precomputed, cycle: int = 0):
        del initial_precomputed, cycle
        return jnp.stack(
            [self.specific_entropy(U), self.harten_entropy(U)], axis=0
        )

    # ---- fluxes (hyperbolic_system.h:1162-1216) -------------------------
    def f(self, U):
        """Flux tensor [C, dim, ...batch]."""
        d = self.dim
        rho_inv = 1.0 / self.density(U)
        m = self.momentum(U)  # [dim, ...]
        p = self.pressure(U)
        E = self.total_energy(U)
        v = m * rho_inv[None]
        rows = [m]
        for a in range(d):
            comps = [m[a] * v[b] for b in range(d)]
            comps[a] = comps[a] + p
            rows.append(jnp.stack(comps, axis=0))
        rows.append(v * (E + p)[None])
        return jnp.stack(rows, axis=0)

    def flux_contribution(self, precomputed, initial_precomputed, U):
        del precomputed, initial_precomputed
        return self.f(U)

    def flux_divergence(self, flux_i, flux_j, c_ij):
        """-(f_i + f_j) . c_ij  (hyperbolic_system.h:1208-1216).

        flux_* [C, dim, ...], c_ij [dim, ...] -> [C, ...].
        """
        return -jnp.sum((flux_i + flux_j) * c_ij[None], axis=1)

    # ---- Riemann solver (riemann_solver.template.h) ---------------------
    def riemann_precompute(self, U):
        """Node-local Riemann inputs (p, a, 1/rho, 1/p, log2 p), hoisted
        out of the per-edge evaluation (the projection leaves pressure and
        sound speed direction-independent: the perpendicular kinetic
        energy removed from E reappears in the projected kinetic energy).
        The inverses remove per-edge divides; log2 p turns the
        two-rarefaction pressure-ratio power into a single exp2."""
        g = self.params.gamma
        rho = self.density(U)
        rho_inv = 1.0 / rho
        m = self.momentum(U)
        rho_e = self.total_energy(U) - 0.5 * jnp.sum(m * m, 0) * rho_inv
        p = (g - 1.0) * rho_e
        a = jnp.sqrt(g * p * rho_inv)
        return p, a, rho_inv, 1.0 / p, jnp.log2(p)

    def riemann_data(self, U, n, pa=None):
        """Project onto 1D data (rho, u_n, p, a, 1/p, log2 p or None)
        (riemann_solver.template.h:377-403)."""
        rho = self.density(U)
        m = self.momentum(U)
        proj_m = jnp.sum(n * m, 0)
        if pa is None:
            rho_inv = 1.0 / rho
            perp = m - proj_m[None] * n
            E = self.total_energy(U) - 0.5 * jnp.sum(perp * perp, 0) * rho_inv
            g = self.params.gamma
            rho_e = E - 0.5 * proj_m * proj_m * rho_inv
            p = (g - 1.0) * rho_e
            a = jnp.sqrt(g * p * rho_inv)
            p_inv, lp = 1.0 / p, None
        else:
            p, a, rho_inv = pa[0], pa[1], pa[2]
            p_inv = pa[3] if len(pa) > 3 else 1.0 / p
            lp = pa[4] if len(pa) > 4 else None
        return rho, proj_m * rho_inv, p, a, p_inv, lp

    def riemann_lambda_max(
        self, U_i, U_j, n_ij, prec_i=None, prec_j=None,
        newton_iterations: int = 0, newton_tol: float = 1e-10,
        pa_i=None, pa_j=None,
    ):
        """Upper bound on the maximal wave speed (riemann_solver.template.h:406-582)."""
        g = self.params.gamma
        di = self.riemann_data(U_i, n_ij, pa_i)
        dj = self.riemann_data(U_j, n_ij, pa_j)
        rho_i, u_i, p_i, a_i, p_inv_i, lp_i = di
        rho_j, u_j, p_j, a_j, p_inv_j, lp_j = dj

        p_max = jnp.maximum(p_i, p_j)

        # two-rarefaction estimate (:274-319)
        factor = (g - 1.0) * 0.5
        num = _pos(a_i + a_j - factor * (u_j - u_i))
        if lp_i is not None and lp_j is not None:
            # (p_i/p_j)^(-factor/g) as one exp2 of precomputed log2 p
            ratio_pow = jnp.exp2((-factor / g) * (lp_i - lp_j))
        else:
            ratio_pow = jnp.power(p_i / p_j, -factor / g)
        den = a_i * ratio_pow + a_j
        exponent = 2.0 * g / (g - 1.0)
        p_rarefaction = p_j * _pow(num / den, exponent)

        # failsafe estimate (:330-374); sqrt(x/y) as sqrt(x)*rsqrt(y) —
        # rsqrt avoids the divide
        sqrt_2pmax = jnp.sqrt(2.0 * p_max)
        ri = rho_i * ((g + 1.0) * p_max + (g - 1.0) * p_i)
        rj = rho_j * ((g + 1.0) * p_max + (g - 1.0) * p_j)
        ri_rsqrt = jax.lax.rsqrt(ri)
        rj_rsqrt = jax.lax.rsqrt(rj)
        x_i = sqrt_2pmax * ri_rsqrt
        x_j = sqrt_2pmax * rj_rsqrt
        a_q = x_i + x_j
        b_q = u_j - u_i
        c_q = -p_i * x_i - p_j * x_j
        base = (-b_q + jnp.sqrt(b_q * b_q - 4.0 * a_q * c_q)) / (2.0 * a_q)
        p_failsafe = base * base

        p_star_tilde = jnp.minimum(p_rarefaction, p_failsafe)

        # phi(p_max) (:122-149); 1/sqrt(ri/2) = sqrt(2) * rsqrt(ri)
        sqrt2 = float(np.sqrt(2.0))
        vi = (p_max - p_i) * (sqrt2 * ri_rsqrt)
        vj = (p_max - p_j) * (sqrt2 * rj_rsqrt)
        phi_p_max = vi + vj + u_j - u_i

        p_2 = jnp.where(
            phi_p_max < 0.0, p_star_tilde, jnp.minimum(p_max, p_star_tilde)
        )

        def lambda1_minus(data, p_star):
            rho, u, p, a, p_inv, _ = data
            fac = (g + 1.0) * 0.5 / g
            tmp = _pos((p_star - p) * p_inv)
            return u - a * jnp.sqrt(1.0 + fac * tmp)

        def lambda3_plus(data, p_star):
            rho, u, p, a, p_inv, _ = data
            fac = (g + 1.0) * 0.5 / g
            tmp = _pos((p_star - p) * p_inv)
            return u + a * jnp.sqrt(1.0 + fac * tmp)

        def compute_lambda(p_star):
            nu_11 = lambda1_minus(di, p_star)
            nu_32 = lambda3_plus(dj, p_star)
            return jnp.maximum(_pos(nu_32), _neg(nu_11))

        if newton_iterations == 0:
            return compute_lambda(p_2)

        # quadratic Newton refinement (:508-575)
        p_min = jnp.minimum(p_i, p_j)
        p_1 = jnp.where(phi_p_max < 0.0, p_max, p_min)
        p_1 = jnp.where(p_1 <= p_2, p_1, p_2)

        def f_rs(data, p_star):
            rho, u, p, a, _, _ = data
            Az = 2.0 / (rho * (g + 1.0))
            Bz = (g - 1.0) / (g + 1.0) * p
            shock = (p_star - p) * jnp.sqrt(Az / (p_star + Bz))
            exponent_ = 0.5 * (g - 1.0) / g
            rare = 2.0 * a * (jnp.power(p_star / p, exponent_) - 1.0) / (g - 1.0)
            return jnp.where(p_star >= p, shock, rare)

        def df_rs(data, p_star):
            rho, u, p, a, _, _ = data
            radicand_inverse = 0.5 * rho * ((g + 1.0) * p_star + (g - 1.0) * p)
            denom = p_star + (g - 1.0) / (g + 1.0) * p
            true_value = (denom - 0.5 * (p_star - p)) / (
                denom * jnp.sqrt(radicand_inverse)
            )
            exponent_ = (-1.0 - g) * 0.5 / g
            factor_ = (g - 1.0) * 0.5 / g * jnp.power(p_star / p, exponent_) / p
            false_value = factor_ * 2.0 * a / (g - 1.0)
            return jnp.where(p_star >= p, true_value, false_value)

        def phi(p):
            return f_rs(di, p) + f_rs(dj, p) + u_j - u_i

        def dphi(p):
            return df_rs(di, p) + df_rs(dj, p)

        def gap_and_lambda(p1, p2):
            nu_11 = lambda1_minus(di, p2)
            nu_12 = lambda1_minus(di, p1)
            nu_31 = lambda3_plus(dj, p1)
            nu_32 = lambda3_plus(dj, p2)
            lam = jnp.maximum(_pos(nu_32), _neg(nu_11))
            gap = jnp.maximum(jnp.abs(nu_32 - nu_31), jnp.abs(nu_12 - nu_11))
            return gap, lam

        gap, lam = gap_and_lambda(p_1, p_2)
        for _ in range(newton_iterations):
            active = gap > newton_tol
            np1, np2 = quadratic_newton_step(
                p_1, p_2, phi(p_1), phi(p_2), dphi(p_1), dphi(p_2), sign=1.0
            )
            p_1 = jnp.where(active, np1, p_1)
            p_2 = jnp.where(active, np2, p_2)
            gap, lam = gap_and_lambda(p_1, p_2)
        return lam

    # ---- indicator (euler/indicator.h:187-258) --------------------------
    def indicator_alpha(
        self, U_i, prec_i, U_j, prec_j, c_ij, mask, hd_i,
        evc_factor: float = 1.0,
    ):
        """Entropy viscosity commutator over the stencil.

        Shapes: U_i [C, n], U_j [C, K, n], c_ij [dim, K, n], mask [K, n],
        prec_* carry (s, eta).  Returns alpha [n].
        """
        eta_i = prec_i[1]
        rho_i = self.density(U_i)
        rho_i_inv = 1.0 / rho_i
        d_eta_i = self.harten_entropy_derivative(U_i)
        d_eta_i = jnp.concatenate(
            [(d_eta_i[0] - eta_i * rho_i_inv)[None], d_eta_i[1:]], axis=0
        )
        f_i = self.f(U_i)  # [C, dim, n]

        eta_j = prec_j[1]
        rho_j = self.density(U_j)
        m_j = self.momentum(U_j)  # [dim, K, n]
        f_j = self.f(U_j)  # [C, dim, K, n]

        entropy_flux = (
            eta_j / rho_j - (eta_i * rho_i_inv)[None]
        ) * jnp.sum(m_j * c_ij, axis=0)
        left = jnp.sum(entropy_flux * mask, axis=0)  # [n]

        components = jnp.sum(
            (f_j - f_i[:, :, None]) * c_ij[None], axis=1
        )  # [C, K, n]
        right = jnp.sum(components * mask[None], axis=1)  # [C, n]

        numerator = left - jnp.sum(d_eta_i * right, axis=0)
        denominator = jnp.abs(left) + jnp.sum(jnp.abs(d_eta_i * right), axis=0)
        quotient = jnp.abs(numerator) / (denominator + hd_i * jnp.abs(eta_i))
        return jnp.minimum(1.0, evc_factor * quotient)

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
        """Accumulate + relax bounds (euler/limiter.h:255-363).

        Returns [3, n] = (rho_min, rho_max, s_min).  Includes the diagonal
        (j = i) contributions analytically: the reference's stencil loop
        runs over the full row including the diagonal entry
        (hyperbolic_module.template.h:722-795).
        """
        dtype = U_i.dtype
        rho_i = self.density(U_i)
        m_i = self.momentum(U_i)  # [dim, n]
        rho_j = self.density(U_j)  # [K, n]
        m_j = self.momentum(U_j)  # [dim, K, n]

        rho_ij_bar = 0.5 * (
            rho_i[None]
            + rho_j
            + jnp.sum((m_i[:, None] - m_j) * scaled_c_ij, axis=0)
        )
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        rho_min = jnp.min(jnp.where(mask > 0, rho_ij_bar, big), axis=0)
        rho_max = jnp.max(jnp.where(mask > 0, rho_ij_bar, -big), axis=0)
        rho_min = jnp.minimum(rho_min, rho_i)  # diagonal entry
        rho_max = jnp.maximum(rho_max, rho_i)

        s_j = prec_j[0]
        s_min = jnp.min(jnp.where(mask > 0, s_j, big), axis=0)
        s_i = prec_i[0]
        s_min = jnp.minimum(s_min, s_i)

        # relaxation accumulation (beta_ij = 1), incl. diagonal:
        k_count = jnp.sum(mask, axis=0)
        rho_relax_num = (
            jnp.sum((rho_i[None] + rho_j) * mask, axis=0) + 2.0 * rho_i
        )
        rho_relax_den = k_count + 1.0

        s_interp = self.specific_entropy(0.5 * (U_i[:, None] + U_j))
        s_interp_max = jnp.max(jnp.where(mask > 0, s_interp, -big), axis=0)
        s_interp_max = jnp.maximum(s_interp_max, s_i)

        # relaxation (limiter.h:330-363)
        r_i = jnp.sqrt(hd_i)
        if self.dim == 2:
            r_i = jnp.sqrt(jnp.sqrt(hd_i)) ** 3
        elif self.dim == 1:
            r_i = jnp.sqrt(hd_i) ** 3
        r_i = r_i * relaxation_factor

        eps = jnp.finfo(dtype).eps
        rho_relaxation = jnp.abs(rho_relax_num) / (jnp.abs(rho_relax_den) + eps)
        relaxation = 2.0 * relaxation_factor * rho_relaxation

        rho_min = jnp.maximum((1.0 - r_i) * rho_min, rho_min - relaxation)
        rho_max = jnp.minimum((1.0 + r_i) * rho_max, rho_max + relaxation)

        entropy_relaxation = relaxation_factor * (s_interp_max - s_min)
        s_min = jnp.maximum((1.0 - r_i) * s_min, s_min - entropy_relaxation)

        return jnp.stack([rho_min, rho_max, s_min], axis=0)

    def limiter_psi0(self, bounds, U):
        """Node-local (rho, rho^gamma, rho_e, psi) at t = 0.

        The limiter is invoked once per stencil slot with the SAME base
        state U (the reference's per-edge loop likewise re-derives these
        per edge, euler/limiter.template.h:177-221); hoisting the t = 0
        evaluation across the K slot calls removes K-1 transcendental
        pows per node, and `limiter_limit` composes its first left-state
        evaluation from (psi0, psi_r0) instead of a third pow."""
        dtype = U.dtype
        g = self.params.gamma
        eps = jnp.finfo(dtype).eps
        relax_small = 1.0 + self.params.vacuum_state_relaxation_small * eps
        s_min = bounds[2]
        rho = self.density(U)
        rho_gamma = jnp.power(rho, g)
        m = self.momentum(U)
        # rho * rho_e in expanded (divide-free) form; the t = 0
        # coefficient of the quadratic polynomial used by limiter_limit:
        ae = rho * self.total_energy(U) - 0.5 * jnp.sum(m * m, 0)
        psi = relax_small * ae - s_min * rho_gamma * rho
        return rho, rho_gamma, ae, psi

    def limiter_limit(
        self,
        bounds,
        U,
        P,
        newton_iterations: int = 2,
        newton_tol: float = 1.0e-10,
        t_min=0.0,
        t_max=1.0,
        psi0=None,
    ):
        """Convex limiter (euler/limiter.template.h:15-327).

        bounds [3, ...], U [C, ...], P [C, ...].  Returns (l, success).
        psi0, if given, is `limiter_psi0(bounds, U)` hoisted by the
        caller; valid only with t_min == 0 (checked).
        """
        dtype = U.dtype
        g = self.params.gamma
        gp1 = g + 1.0
        eps = jnp.finfo(dtype).eps
        relax_small = 1.0 + self.params.vacuum_state_relaxation_small * eps
        relax = 1.0 + self.params.vacuum_state_relaxation_large * eps

        rho_min = bounds[0]
        rho_max = bounds[1]
        s_min = bounds[2]

        rho_U = self.density(U)
        rho_P = self.density(P)

        # -- density limiting (limiter.template.h:40-134)
        test_min = self.filter_vacuum_density(_pos(rho_U - relax * rho_max))
        test_max = self.filter_vacuum_density(_pos(rho_min - relax * rho_U))
        success = (test_min == 0.0) & (test_max == 0.0)

        t_r = jnp.full(jnp.broadcast_shapes(rho_U.shape, rho_P.shape),
                       t_max, dtype)
        denominator = 1.0 / (jnp.abs(rho_P) + eps * rho_max)
        t_r = jnp.where(
            rho_max < rho_U + t_r * rho_P, (rho_max - rho_U) * denominator, t_r
        )
        t_r = jnp.where(
            rho_U + t_r * rho_P < rho_min, (rho_U - rho_min) * denominator, t_r
        )
        t_r = jnp.clip(t_r, t_min, t_max)

        # -- specific entropy limiting via quadratic Newton (:143-291)
        #
        # rho*rho_e along the limit line is an exact quadratic polynomial
        # in t (rho_t E_t - 0.5|m_t|^2 with affine U_t = U + t P), so
        # each psi evaluation costs one transcendental pow (rho_t^gamma)
        # plus a few fmas -- no divide and no re-derived internal energy.
        # The reference re-evaluates rho_e and its gradient per Newton
        # point instead (euler/limiter.template.h:177-291); the values
        # are algebraically identical.
        E_U = self.total_energy(U)
        E_P = self.total_energy(P)
        m_U = self.momentum(U)
        m_P = self.momentum(P)
        if psi0 is not None:
            ae = psi0[2]
        else:
            ae = rho_U * E_U - 0.5 * jnp.sum(m_U * m_U, 0)
        be = rho_U * E_P + rho_P * E_U - jnp.sum(m_U * m_P, 0)
        ce = rho_P * E_P - 0.5 * jnp.sum(m_P * m_P, 0)

        def psi_eval(t):
            rho_t = rho_U + t * rho_P
            rho_g = jnp.power(rho_t, g)
            psi = relax_small * (ae + t * (be + t * ce)) \
                - s_min * rho_g * rho_t
            return rho_t, rho_g, psi

        def dpsi_eval(t, rho_g):
            # d(rho*rho_e)/dt - s_min (gamma+1) rho^gamma drho; like the
            # reference, the small relaxation factor is dropped from the
            # derivative (limiter.template.h:243-263).
            return (be + 2.0 * ce * t) - gp1 * s_min * rho_g * rho_P

        rho_r0, rho_r_gamma0, psi_r0 = psi_eval(t_r)
        lower_bound_r = (1.0 - relax) * s_min * rho_r0 * rho_r_gamma0

        def skip_newton(_):
            # All lanes satisfy psi(t_r) > 0: the Newton loop degenerates
            # to t_l = t_r exactly (accept sets t_l = t_r, the bracket
            # collapses, `active` is false), so return t_r directly.  The
            # vectorized analog of the reference's all-lanes early exit
            # (euler/limiter.template.h:215-219).
            ok = success & (psi_r0 - lower_bound_r >= 0.0)
            return t_r, ok.astype(t_r.dtype)

        use_psi0 = (
            psi0 is not None
            and isinstance(t_min, float)
            and t_min == 0.0
        )

        def full_newton(_):
            t_l = jnp.full_like(t_r, t_min)
            t_r_ = t_r
            psi_r = psi_r0
            rho_r, rho_r_gamma = rho_r0, rho_r_gamma0
            succ = success
            for n in range(newton_iterations):
                if n > 0:
                    rho_r, rho_r_gamma, psi_r = psi_eval(t_r_)
                # accept right state where psi_r > 0:
                pr_pos = psi_r > 0.0
                t_l = jnp.where(pr_pos, t_r_, t_l)

                if n == 0 and use_psi0:
                    # t_l is t_r (just evaluated) or 0 (hoisted psi0):
                    # compose instead of a fresh pow — bit-identical to
                    # psi_eval(t_l) at these points.
                    rho_l = jnp.where(pr_pos, rho_r, psi0[0])
                    rho_l_gamma = jnp.where(pr_pos, rho_r_gamma, psi0[1])
                    psi_l = jnp.where(pr_pos, psi_r, psi0[3])
                else:
                    rho_l, rho_l_gamma, psi_l = psi_eval(t_l)

                if n == 0:
                    lower_bound = (1.0 - relax) * s_min * rho_l * rho_l_gamma
                    succ = succ & (psi_l - lower_bound >= 0.0)

                dpsi_l = dpsi_eval(t_l, rho_l_gamma)
                dpsi_r = dpsi_eval(t_r_, rho_r_gamma)

                nl, nr = quadratic_newton_step(
                    t_l, t_r_, psi_l, psi_r, dpsi_l, dpsi_r, sign=-1.0
                )
                active = (t_r_ - t_l) > newton_tol
                t_l = jnp.where(active, nl, t_l)
                t_r_ = jnp.where(active, nr, t_r_)
            return t_l, succ.astype(t_l.dtype)

        if newton_iterations == 0:
            # loop body never runs: t_l stays at t_min (limiter.template.h:143)
            return jnp.full_like(t_r, t_min), success
        # carry success through the cond as 0/1 floats:
        t_l, succ_f = jax.lax.cond(
            jnp.all(psi_r0 > 0.0), skip_newton, full_newton, None
        )
        return t_l, succ_f > 0.5

    def combine_bounds(self, a, b):
        return jnp.stack(
            [
                jnp.minimum(a[0], b[0]),
                jnp.maximum(a[1], b[1]),
                jnp.minimum(a[2], b[2]),
            ],
            axis=0,
        )

    # ---- boundary conditions (hyperbolic_system.h:1096-1159) -------------
    def apply_boundary_conditions(self, bc_id: int, U, normal, dirichlet_data):
        """Vectorized over a group of boundary nodes sharing one bc id.

        U [C, k], normal [dim, k].
        """
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
        if bc_id == Boundary.dynamic:
            m = self.momentum(U)
            rho = self.density(U)
            a = self.speed_of_sound(U)
            vn = jnp.sum(m * normal, 0) / rho
            U_d = dirichlet_data
            sup_in = vn < -a
            sub_in = (vn >= -a) & (vn <= 0.0)
            sub_out = (vn > 0.0) & (vn <= a)
            r_sub_in = self.prescribe_riemann_characteristic(
                U_d, U, normal, component=2
            )
            r_sub_out = self.prescribe_riemann_characteristic(
                U, U_d, normal, component=1
            )
            result = U
            result = jnp.where(sub_out[None], r_sub_out, result)
            result = jnp.where(sub_in[None], r_sub_in, result)
            result = jnp.where(sup_in[None], U_d, result)
            return result
        if bc_id == Boundary.dirichlet_momentum:
            m_d = self.momentum(dirichlet_data)
            return jnp.concatenate([U[:1], m_d, U[1 + self.dim :]], axis=0)
        raise ValueError(f"unknown boundary id {bc_id}")

    def prescribe_riemann_characteristic(self, U, U_bar, normal, component: int):
        """(hyperbolic_system.h:1037-1093)."""
        g = self.params.gamma
        m = self.momentum(U)
        rho = self.density(U)
        a = self.speed_of_sound(U)
        vn = jnp.sum(m * normal, 0) / rho

        m_bar = self.momentum(U_bar)
        rho_bar = self.density(U_bar)
        a_bar = self.speed_of_sound(U_bar)
        vn_bar = jnp.sum(m_bar * normal, 0) / rho_bar

        R_1 = (
            vn_bar - 2.0 * a_bar / (g - 1.0)
            if component == 1
            else vn - 2.0 * a / (g - 1.0)
        )
        R_2 = (
            vn_bar + 2.0 * a_bar / (g - 1.0)
            if component == 2
            else vn + 2.0 * a / (g - 1.0)
        )

        p = self.pressure(U)
        s = p / jnp.power(rho, g)

        vperp = m / rho[None] - vn[None] * normal
        vn_new = 0.5 * (R_1 + R_2)

        rho_new = 1.0 / (g * s) * jnp.square((g - 1.0) / 4.0 * (R_2 - R_1))
        rho_new = jnp.power(rho_new, 1.0 / (g - 1.0))
        p_new = s * jnp.power(rho_new, g)

        mom_new = rho_new[None] * (vn_new[None] * normal + vperp)
        E_new = p_new / (g - 1.0) + 0.5 * rho_new * (
            vn_new * vn_new + jnp.sum(vperp * vperp, 0)
        )
        return jnp.concatenate([rho_new[None], mom_new, E_new[None]], axis=0)


def quadratic_newton_step(p_1, p_2, phi_p_1, phi_p_2, dphi_p_1, dphi_p_2, sign=1.0):
    """One step of the two-sided quadratic Newton method.

    Vectorized translation of /root/reference/source/newton.h:37-101
    (divided-difference form; roots of the two osculating parabolas,
    clamped to [p_1, p_2]).
    """
    dtype = jnp.result_type(p_1)
    eps = jnp.finfo(dtype).eps

    scaling = 1.0 / (p_2 - p_1 + eps)

    dd_11 = dphi_p_1
    dd_12 = (phi_p_2 - phi_p_1) * scaling
    dd_22 = dphi_p_2

    dd_112 = (dd_12 - dd_11) * scaling
    dd_122 = (dd_22 - dd_12) * scaling

    discriminant_1 = jnp.abs(dphi_p_1 * dphi_p_1 - 4.0 * phi_p_1 * dd_112)
    discriminant_2 = jnp.abs(dphi_p_2 * dphi_p_2 - 4.0 * phi_p_2 * dd_122)

    denominator_1 = dphi_p_1 + sign * jnp.sqrt(discriminant_1)
    denominator_2 = dphi_p_2 + sign * jnp.sqrt(discriminant_2)

    t_1 = p_1 - jnp.where(
        jnp.abs(denominator_1) < eps,
        jnp.zeros_like(p_1),
        2.0 * phi_p_1 / jnp.where(jnp.abs(denominator_1) < eps, 1.0, denominator_1),
    )
    t_2 = p_2 - jnp.where(
        jnp.abs(denominator_2) < eps,
        jnp.zeros_like(p_2),
        2.0 * phi_p_2 / jnp.where(jnp.abs(denominator_2) < eps, 1.0, denominator_2),
    )

    t_1 = jnp.clip(t_1, p_1, p_2)
    t_2 = jnp.clip(t_2, p_1, p_2)

    new_p1 = jnp.minimum(t_1, t_2)
    new_p2 = jnp.maximum(t_1, t_2)
    return new_p1, new_p2
