"""Shallow water equations with bathymetry, dry states, and friction.

Re-implementation of /root/reference/source/shallow_water/:
  * hyperbolic system with mollified/sharp water depth, hydrostatic
    reconstruction (star states), low/high-order flux divergences,
    affine shift, Gauckler-Manning friction source:
      hyperbolic_system.h:640-1335
  * Riemann solver with the h* estimate from double-rarefaction/
    double-shock/expansion-shock cases: riemann_solver.template.h:26-260
  * entropy-viscosity-commutator indicator on the mathematical entropy:
      indicator.h:150-240
  * convex limiter with water-depth bounds, dry-state cutoff h_small,
    and optional kinetic-energy / square-velocity limiting:
      limiter.h:130-350, limiter.template.h:15-452

Layout: component-first states [1+dim, ...] = [h, q_1..q_dim], node axis
last (see equations/euler.py).  Flux contributions are (U, Z) tuples with
Z the bathymetry (the one precomputed initial value).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..offline.mesh import Boundary
from .euler import quadratic_newton_step


def _pos(x):
    return jnp.maximum(x, 0.0)


def _neg(x):
    return jnp.maximum(-x, 0.0)


@dataclasses.dataclass(frozen=True)
class ShallowWaterParams:
    """(hyperbolic_system.h:643-672)."""

    gravity: float = 9.81
    manning_friction_coefficient: float = 0.0
    reference_water_depth: float = 1.0
    dry_state_relaxation_factor: float = 2.0e-1
    dry_state_relaxation_small: float = 1.0e2
    dry_state_relaxation_large: float = 1.0e4


@dataclasses.dataclass(frozen=True)
class SWLimiterOptions:
    """(shallow_water/limiter.h:50-58)."""

    limit_on_kinetic_energy: bool = False
    limit_on_square_velocity: bool = True


@dataclasses.dataclass(frozen=True)
class ShallowWater:
    """The shallow water "Description"."""

    dim: int
    params: ShallowWaterParams = ShallowWaterParams()
    limiter_options: SWLimiterOptions = SWLimiterOptions()

    name = "shallow water"
    n_precomputed = 2  # [eta_m, h_star]
    n_initial_precomputed = 1  # [bathymetry Z]
    n_precomputation_cycles = 1
    n_bounds = 5  # [h_min, h_max, h_small, kin_max, v2_max]
    have_high_order_flux = True
    have_equilibrated_states = True
    limiter_needs_fluxes = True
    is_identity_parabolic = True

    @property
    def have_source_terms(self) -> bool:
        return self.params.manning_friction_coefficient != 0.0

    @property
    def n_comp(self) -> int:
        return 1 + self.dim

    @property
    def component_names(self):
        if self.dim == 1:
            return ["h", "q"]
        return ["h"] + [f"q_{i+1}" for i in range(self.dim)]

    @property
    def primitive_component_names(self):
        if self.dim == 1:
            return ["h", "v"]
        return ["h"] + [f"v_{i+1}" for i in range(self.dim)]

    precomputed_names = ("eta_m", "h_star")
    initial_precomputed_names = ("bathymetry",)

    # ---- water depth helpers (hyperbolic_system.h:720-785) ---------------
    def water_depth(self, U):
        return U[0]

    def momentum(self, U):
        return U[1 : 1 + self.dim]

    def inverse_water_depth_mollified(self, U):
        eps = jnp.finfo(U.dtype).eps
        cutoff = (
            self.params.reference_water_depth
            * self.params.dry_state_relaxation_large
            * eps
        )
        h = self.water_depth(U)
        h_pos = _pos(h)
        h_max = jnp.maximum(h, cutoff)
        return 2.0 * h_pos / (h * h + h_max * h_max)

    def water_depth_sharp(self, U):
        eps = jnp.finfo(U.dtype).eps
        cutoff = (
            self.params.reference_water_depth
            * self.params.dry_state_relaxation_small
            * eps
        )
        return jnp.maximum(self.water_depth(U), cutoff)

    def inverse_water_depth_sharp(self, U):
        return 1.0 / self.water_depth_sharp(U)

    def filter_dry_water_depth(self, h):
        eps = jnp.finfo(h.dtype).eps
        cutoff = (
            self.params.reference_water_depth
            * self.params.dry_state_relaxation_large
            * eps
        )
        return jnp.where(jnp.abs(h) < cutoff, jnp.zeros_like(h), h)

    # ---- derived quantities ----------------------------------------------
    def kinetic_energy(self, U):
        h = self.water_depth(U)
        vel = self.momentum(U) * self.inverse_water_depth_sharp(U)[None]
        return 0.5 * h * jnp.sum(vel * vel, axis=0)

    def pressure(self, U):
        return 0.5 * self.params.gravity * U[0] * U[0]

    def speed_of_sound(self, U):
        return jnp.sqrt(self.params.gravity * U[0])

    def mathematical_entropy(self, U):
        return self.pressure(U) + self.kinetic_energy(U)

    def mathematical_entropy_derivative(self, U):
        vel = self.momentum(U) * self.inverse_water_depth_sharp(U)[None]
        h_comp = self.params.gravity * U[0] - 0.5 * jnp.sum(vel * vel, 0)
        return jnp.concatenate([h_comp[None], vel], axis=0)

    def is_admissible(self, U):
        return self.filter_dry_water_depth(self.water_depth(U)) >= 0.0

    # ---- state transforms --------------------------------------------------
    def from_primitive_state(self, prim):
        h = prim[0]
        return jnp.concatenate([h[None], h[None] * prim[1:]], axis=0)

    def to_primitive_state(self, U):
        h_inv = self.inverse_water_depth_sharp(U)
        return jnp.concatenate([U[:1], U[1:] * h_inv[None]], axis=0)

    # ---- precomputation (hyperbolic_system.h:678-717) -----------------------
    def precompute(self, U, initial_precomputed, cycle: int = 0):
        del initial_precomputed, cycle
        eta_m = self.mathematical_entropy(U)
        h_star = jnp.power(self.water_depth_sharp(U), 4.0 / 3.0)
        return jnp.stack([eta_m, h_star], axis=0)

    # ---- fluxes (hyperbolic_system.h:1040-1180) ------------------------------
    def f(self, U):
        """Full flux with pressure [C, dim, ...]."""
        h_inv = self.inverse_water_depth_sharp(U)
        m = self.momentum(U)
        p = self.pressure(U)
        v = m * h_inv[None]
        rows = [U[0] * v]
        for a in range(self.dim):
            comps = [v[b] * m[a] for b in range(self.dim)]
            comps[a] = comps[a] + p
            rows.append(jnp.stack(comps, axis=0))
        return jnp.stack(rows, axis=0)

    def g_flux(self, U):
        """Flux without the pressure contribution (hyperbolic_system.h:1063)."""
        h_inv = self.inverse_water_depth_sharp(U)
        m = self.momentum(U)
        v = m * h_inv[None]
        rows = [U[0] * v]
        for a in range(self.dim):
            rows.append(jnp.stack([v[b] * m[a] for b in range(self.dim)], 0))
        return jnp.stack(rows, axis=0)

    def star_state(self, U, Z_left, Z_right):
        """Hydrostatic reconstruction (hyperbolic_system.h:1083-1094)."""
        Z_max = jnp.maximum(Z_left, Z_right)
        h = self.water_depth(U)
        H_star = jnp.maximum(0.0, h + Z_left - Z_max)
        return U * (H_star * self.inverse_water_depth_mollified(U))[None]

    def equilibrated_states(self, flux_i, flux_j):
        U_i, Z_i = flux_i
        U_j, Z_j = flux_j
        return (
            self.star_state(U_i, Z_i, Z_j),
            self.star_state(U_j, Z_j, Z_i),
        )

    def flux_contribution(self, precomputed, initial_precomputed, U):
        del precomputed
        return (U, initial_precomputed[0])

    def flux_divergence(self, flux_i, flux_j, c_ij):
        """Low-order flux with hydrostatic terms (hyperbolic_system.h:1118-1148)."""
        U_i, Z_i = flux_i
        U_star_ij, U_star_ji = self.equilibrated_states(flux_i, flux_j)
        H_i = self.water_depth(U_i)
        H_star_ij = self.water_depth(U_star_ij)
        H_star_ji = self.water_depth(U_star_ji)
        g_i = self.g_flux(U_star_ij)
        g_j = self.g_flux(U_star_ji)
        result = -(g_i + g_j)  # [C, dim, ...]
        factor = (
            0.5 * (H_star_ji * H_star_ji - H_star_ij * H_star_ij) + H_i * H_i
        ) * self.params.gravity
        rows = [result[0]]
        for a in range(self.dim):
            row = result[1 + a]
            row = row.at[a].add(-factor) if False else jnp.stack(
                [
                    row[b] - factor if b == a else row[b]
                    for b in range(self.dim)
                ],
                axis=0,
            )
            rows.append(row)
        result = jnp.stack(rows, axis=0)
        return jnp.sum(result * c_ij[None], axis=1)

    def high_order_flux_divergence(self, flux_i, flux_j, c_ij):
        """(hyperbolic_system.h:1153-1177)."""
        U_i, Z_i = flux_i
        U_j, Z_j = flux_j
        H_i = self.water_depth(U_i)
        H_j = self.water_depth(U_j)
        g_i = self.g_flux(U_i)
        g_j = self.g_flux(U_j)
        result = -(g_i + g_j)
        factor = self.params.gravity * H_i * (H_j + Z_j - Z_i)
        rows = [result[0]]
        for a in range(self.dim):
            row = result[1 + a]
            rows.append(
                jnp.stack(
                    [
                        row[b] - factor if b == a else row[b]
                        for b in range(self.dim)
                    ],
                    axis=0,
                )
            )
        result = jnp.stack(rows, axis=0)
        return jnp.sum(result * c_ij[None], axis=1)

    def affine_shift(self, flux_i, flux_j, c_ij, d_ij):
        """(hyperbolic_system.h:1182-1197)."""
        U_i, Z_i = flux_i
        U_j, Z_j = flux_j
        U_star_ij = self.star_state(U_i, Z_i, Z_j)
        h_inv = self.inverse_water_depth_sharp(U_i)
        m = self.momentum(U_i)
        factor = 2.0 * (d_ij + h_inv * jnp.sum(m * c_ij, axis=0))
        return -factor[None] * (U_star_ij - U_i)

    # ---- sources (hyperbolic_system.h:1195-1250) -----------------------------
    def manning_friction(self, U, h_star, tau):
        g = self.params.gravity
        n = self.params.manning_friction_coefficient
        h_inv = self.inverse_water_depth_mollified(U)
        m = self.momentum(U)
        v_norm = jnp.sqrt(jnp.sum((m * h_inv[None]) ** 2, axis=0))
        factor = 2.0 * g * n * n * v_norm
        denominator = h_star + jnp.maximum(h_star, tau * factor)
        coeff = -factor / denominator
        return jnp.concatenate(
            [jnp.zeros_like(U[:1]), coeff[None] * m], axis=0
        )

    def nodal_source(self, precomputed, U, tau):
        h_star = precomputed[1]
        return self.manning_friction(U, h_star, tau)

    # ---- Riemann solver (riemann_solver.template.h:26-260) -------------------
    def _riemann_data(self, U, n_ij):
        h = self.water_depth_sharp(U)
        vel = self.momentum(U) / h[None]
        u = jnp.sum(n_ij * vel, axis=0)
        a = jnp.sqrt(h * self.params.gravity)
        return h, u, a

    def _f_z(self, h_Z, a_Z, h):
        g = self.params.gravity
        left = 2.0 * (jnp.sqrt(g * h) - a_Z)
        radicand = 0.5 * g * (h + h_Z) / (h * h_Z)
        right = (h - h_Z) * jnp.sqrt(radicand)
        return jnp.where(h <= h_Z, left, right)

    def riemann_lambda_max(
        self, U_i, U_j, n_ij, prec_i=None, prec_j=None,
        newton_iterations: int = 0, newton_tol: float = 1e-10,
    ):
        del prec_i, prec_j, newton_iterations, newton_tol
        g = self.params.gravity
        h_i, u_i, a_i = self._riemann_data(U_i, n_ij)
        h_j, u_j, a_j = self._riemann_data(U_j, n_ij)

        h_min = jnp.minimum(h_i, h_j)
        h_max = jnp.maximum(h_i, h_j)
        a_min = jnp.sqrt(g * h_min)
        a_max = jnp.sqrt(g * h_max)
        sqrt_two = float(np.sqrt(2.0))
        x0 = 9.0 - 4.0 * sqrt_two  # (2 sqrt(2) - 1)^2

        def phi(h):
            return (
                self._f_z(h_i, a_i, h) + self._f_z(h_j, a_j, h) + u_j - u_i
            )

        phi_value_min = phi(x0 * h_min)
        phi_value_max = phi(x0 * h_max)

        tmp = _pos(u_i - u_j + 2.0 * (a_i + a_j))
        h_star_left = 0.0625 / g * tmp * tmp
        tmp = 1.0 + sqrt_two * (u_i - u_j) / (a_min + a_max)
        h_star_middle = jnp.sqrt(h_min * h_max) * tmp
        left_radicand = 3.0 * h_min + 2.0 * sqrt_two * jnp.sqrt(h_min * h_max)
        right_radicand = sqrt_two * jnp.sqrt(h_min / g) * (u_i - u_j)
        tmp = jnp.sqrt(_pos(left_radicand + right_radicand))
        tmp = tmp - sqrt_two * jnp.sqrt(h_min)
        h_star_right = tmp * tmp

        # NOTE: faithfully reproduces the reference's final selection
        # (riemann_solver.template.h:186-194) where the second assignment
        # overwrites the first (the double-rarefaction branch is shadowed):
        h_star = jnp.where(0.0 <= phi_value_min, h_star_left, h_star_right)
        h_star = jnp.where(phi_value_max < 0.0, h_star_middle, h_star_right)

        def lam1_minus(h, u, a, h_star):
            factor = _pos((h_star - h) / h)
            return u - a * jnp.sqrt((1.0 + 0.5 * factor) * (1.0 + factor))

        def lam3_plus(h, u, a, h_star):
            factor = _pos((h_star - h) / h)
            return u + a * jnp.sqrt((1.0 + 0.5 * factor) * (1.0 + factor))

        lambda1 = lam1_minus(h_i, u_i, a_i, h_star)
        lambda3 = lam3_plus(h_j, u_j, a_j, h_star)
        return jnp.maximum(_neg(lambda1), _pos(lambda3))

    # ---- indicator (shallow_water/indicator.h:150-240) -----------------------
    def indicator_alpha(
        self, U_i, prec_i, U_j, prec_j, c_ij, mask, hd_i,
        evc_factor: float = 1.0,
    ):
        eta_i = prec_i[0]
        d_eta_i = self.mathematical_entropy_derivative(U_i)  # [C, n]
        f_i = self.f(U_i)  # [C, dim, n]

        eta_j = prec_j[0]  # [K, n]
        vel_j = self.momentum(U_j) * self.inverse_water_depth_sharp(U_j)[None]
        f_j = self.f(U_j)
        pressure_j = self.pressure(U_j)

        left = jnp.sum(
            (eta_j + pressure_j) * jnp.sum(vel_j * c_ij, axis=0) * mask,
            axis=0,
        )
        components = jnp.sum(
            (f_j - f_i[:, :, None]) * c_ij[None], axis=1
        )  # [C, K, n]
        right = jnp.sum(components * mask[None], axis=1)  # [C, n]
        my_sum = jnp.sum(d_eta_i * right, axis=0)

        dtype = U_i.dtype
        reg = jnp.asarray(100.0 * np.finfo(np.dtype(dtype)).tiny, dtype)
        numerator = jnp.abs(left - my_sum)
        denominator = jnp.abs(left) + jnp.abs(my_sum)
        quotient = numerator / (
            denominator + jnp.maximum(hd_i * jnp.abs(eta_i), reg)
        )
        return jnp.minimum(1.0, evc_factor * quotient)

    # ---- limiter (shallow_water/limiter.h:170-350) ----------------------------
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
        flux_i=None,
        flux_j=None,
        affine_shift=0.0,
    ):
        dtype = U_i.dtype
        U_star_ij, U_star_ji = self.equilibrated_states(flux_i, flux_j)
        f_star_ij = self.f(U_star_ij)
        f_star_ji = self.f(U_star_ji)

        shift = (
            affine_shift[:, None]
            if hasattr(affine_shift, "ndim")
            else affine_shift
        )
        U_ij_bar = (
            0.5
            * (
                U_star_ij
                + U_star_ji
                + jnp.sum((f_star_ij - f_star_ji) * scaled_c_ij[None], axis=1)
            )
            + shift
        )

        h_bar = self.water_depth(U_ij_bar)  # [K, n]
        kin_bar = self.kinetic_energy(U_ij_bar)
        v_bar = (
            self.momentum(U_ij_bar)
            * self.inverse_water_depth_mollified(U_ij_bar)[None]
        )
        v2_bar = jnp.sum(v_bar * v_bar, axis=0)

        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        h_min = jnp.min(jnp.where(mask > 0, h_bar, big), axis=0)
        h_max = jnp.max(jnp.where(mask > 0, h_bar, 0.0), axis=0)
        kin_max = jnp.max(jnp.where(mask > 0, kin_bar, 0.0), axis=0)
        v2_max = jnp.max(jnp.where(mask > 0, v2_bar, 0.0), axis=0)

        # diagonal contribution (stencil row includes j = i; U*_ii = the
        # star state against itself, bar state = U*_ii + shift):
        Z_i = flux_i[1][0]  # drop the broadcast edge axis (leading)
        U_star_ii = self.star_state(U_i, Z_i, Z_i)
        U_ii_bar = U_star_ii + (
            affine_shift if hasattr(affine_shift, "ndim") else 0.0
        )
        h_min = jnp.minimum(h_min, self.water_depth(U_ii_bar))
        h_max = jnp.maximum(h_max, self.water_depth(U_ii_bar))
        kin_max = jnp.maximum(kin_max, self.kinetic_energy(U_ii_bar))
        v_ii = (
            self.momentum(U_ii_bar)
            * self.inverse_water_depth_mollified(U_ii_bar)[None]
        )
        v2_max = jnp.maximum(v2_max, jnp.sum(v_ii * v_ii, axis=0))

        # relaxation accumulation (uniform beta, incl. diagonal):
        h_i = self.water_depth(U_i)
        h_j = self.water_depth(U_j)
        kin_i = self.kinetic_energy(U_i)
        kin_j = self.kinetic_energy(U_j)
        vel_i = self.momentum(U_i) * self.inverse_water_depth_mollified(U_i)[None]
        vel_j = self.momentum(U_j) * self.inverse_water_depth_mollified(U_j)[None]
        v2_i = jnp.sum(vel_i * vel_i, axis=0)
        v2_j = jnp.sum(vel_j * vel_j, axis=0)

        denom = jnp.sum(mask, axis=0) + 1.0
        h_num = jnp.sum((h_i[None] + h_j) * mask, axis=0) + 2.0 * h_i
        kin_num = jnp.sum((kin_i[None] + kin_j) * mask, axis=0) + 2.0 * kin_i
        v2_num = jnp.sum((-v2_i[None] + v2_j) * mask, axis=0)

        r_i = jnp.sqrt(hd_i)
        if self.dim == 2:
            r_i = jnp.sqrt(jnp.sqrt(hd_i)) ** 3
        elif self.dim == 1:
            r_i = jnp.sqrt(hd_i) ** 3
        r_i = r_i * relaxation_factor

        eps = jnp.finfo(dtype).eps
        h_relaxed = 2.0 * jnp.abs(h_num) / (denom + eps)
        h_min = jnp.maximum((1.0 - r_i) * h_min, h_min - h_relaxed)
        h_max = jnp.minimum((1.0 + r_i) * h_max, h_max + h_relaxed)
        kin_relaxed = 2.0 * jnp.abs(kin_num) / (denom + eps)
        kin_max = jnp.minimum((1.0 + r_i) * kin_max, kin_max + kin_relaxed)
        v2_relaxed = 2.0 * jnp.abs(v2_num) / (denom + eps)
        v2_max = jnp.minimum((1.0 + r_i) * v2_max, v2_max + v2_relaxed)

        # dry-state cutoff h_small, r_i = factor (m_i/|Omega|)^(1/d):
        r2 = hd_i if self.dim != 2 else jnp.sqrt(hd_i)
        h_small = (
            self.params.reference_water_depth
            * self.params.dry_state_relaxation_factor
            * r2
        ) * jnp.ones_like(h_min)

        return jnp.stack([h_min, h_max, h_small, kin_max, v2_max], axis=0)

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
        """(shallow_water/limiter.template.h:15-452)."""
        dtype = U.dtype
        eps = jnp.finfo(dtype).eps
        tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
        relax_small = 1.0 + self.params.dry_state_relaxation_small * eps
        relax = 1.0 + self.params.dry_state_relaxation_large * eps

        h_min, h_max, h_small, kin_max, v2_max = (
            bounds[0], bounds[1], bounds[2], bounds[3], bounds[4],
        )
        h_U = self.water_depth(U)
        h_P = self.water_depth(P)

        # -- water depth limiting
        test_min = self.filter_dry_water_depth(_pos(h_U - relax * h_max))
        test_max = self.filter_dry_water_depth(_pos(h_min - relax * h_U))
        success = (test_min == 0.0) & (test_max == 0.0)

        denominator = 1.0 / (jnp.abs(h_P) + eps * h_max + tiny)
        t_r = jnp.full(
            jnp.broadcast_shapes(h_U.shape, h_P.shape), t_max, dtype
        )
        t_r = jnp.where(
            h_max < h_U + t_r * h_P, (h_max - h_U) * denominator, t_r
        )
        h_min_tilde = jnp.maximum(h_small, h_min)
        t_r = jnp.where(
            h_U + t_r * h_P < h_min_tilde,
            (h_U - h_min_tilde) * denominator,
            t_r,
        )
        t_r = jnp.clip(t_r, t_min, t_max)

        t_l = jnp.full_like(t_r, t_min)
        opts = self.limiter_options
        if not (opts.limit_on_kinetic_energy or opts.limit_on_square_velocity):
            return t_l, success

        q_U = self.momentum(U)
        q_P = self.momentum(P)

        if opts.limit_on_kinetic_energy:
            # psi = relax_small h kin_max - 1/2 |q|^2
            def psi_ke(t):
                U_t = U + t[None] * P
                q = self.momentum(U_t)
                return relax_small * self.water_depth(
                    U_t
                ) * kin_max - 0.5 * jnp.sum(q * q, axis=0)

            psi_r = psi_ke(t_r)
            t_l = jnp.where(psi_r > 0.0, t_r, t_l)
            psi_l = psi_ke(t_l)
            h_l = self.water_depth(U + t_l[None] * P)
            lower_bound = (
                (1.0 - relax) * self.filter_dry_water_depth(h_l) * kin_max
                - eps
            )
            success = success & (jnp.minimum(0.0, psi_l - lower_bound) == 0.0)
            # psi is QUADRATIC in t, so the reference applies exactly ONE
            # guarded quadratic-Newton step (limiter.template.h:225-264;
            # no newton_max_iterations loop in the SW limiter):
            psi_r = psi_ke(t_r)
            qq = jnp.sum(q_U * q_P, axis=0)
            qp2 = jnp.sum(q_P * q_P, axis=0)
            dpsi_l = h_P * kin_max - qq - qp2 * t_l
            dpsi_r = h_P * kin_max - qq - qp2 * t_r
            nl, nr = quadratic_newton_step(
                t_l, t_r, psi_l, psi_r, dpsi_l, dpsi_r, sign=-1.0
            )
            active = (t_r - t_l) > newton_tol
            t_l = jnp.where(active, nl, t_l)
            t_r = jnp.where(active, nr, t_r)
            if opts.limit_on_square_velocity:
                t_r = t_l
                t_l = jnp.full_like(t_l, t_min)

        if opts.limit_on_square_velocity:
            # psi = relax_small h^2 v2_max - |q|^2
            def psi_v2(t):
                U_t = U + t[None] * P
                h = self.water_depth(U_t)
                q = self.momentum(U_t)
                return relax_small * h * h * v2_max - jnp.sum(q * q, axis=0)

            psi_r = psi_v2(t_r)
            t_l = jnp.where(psi_r > 0.0, t_r, t_l)
            psi_l = psi_v2(t_l)
            h_l = self.water_depth(U + t_l[None] * P)
            fh = self.filter_dry_water_depth(h_l)
            lower_bound = (1.0 - relax) * fh * fh * v2_max - 100.0 * eps
            success = success & (jnp.minimum(0.0, psi_l - lower_bound) == 0.0)
            # One guarded quadratic-Newton step with the REFERENCE's
            # dpsi formula (limiter.template.h:390-404):
            #   dpsi = (h_U + t h_P) h_P v2_max - 2 (q_U.q_P - |q_P|^2 t)
            # This is not the textbook derivative of psi (that would be
            # 2 (h_U + t h_P) h_P v2_max - 2 q_U.q_P - 2 |q_P|^2 t), and
            # with a single step the iterate depends on it — reproduce
            # the reference's exact semantics (observable on the
            # paraboloid-2D dry-front baseline at the ~10% level):
            psi_l = psi_v2(t_l)
            psi_r = psi_v2(t_r)
            h_tl = h_U + t_l * h_P
            h_tr = h_U + t_r * h_P
            qq = jnp.sum(q_U * q_P, axis=0)
            qp2 = jnp.sum(q_P * q_P, axis=0)
            dpsi_l = h_tl * h_P * v2_max - 2.0 * (qq - qp2 * t_l)
            dpsi_r = h_tr * h_P * v2_max - 2.0 * (qq - qp2 * t_r)
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
                jnp.maximum(a[2], b[2]),
                jnp.maximum(a[3], b[3]),
                jnp.maximum(a[4], b[4]),
            ],
            axis=0,
        )

    # ---- boundary conditions (hyperbolic_system.h:905-1035) -------------------
    def prescribe_riemann_characteristic(self, U, U_bar, normal, component):
        g = self.params.gravity
        m = self.momentum(U)
        a = self.speed_of_sound(U)
        h_inv = self.inverse_water_depth_sharp(U)
        vn = jnp.sum(m * normal, 0) * h_inv

        m_bar = self.momentum(U_bar)
        a_bar = self.speed_of_sound(U_bar)
        vn_bar = jnp.sum(m_bar * normal, 0) * self.inverse_water_depth_sharp(
            U_bar
        )

        R_1 = vn_bar - 2.0 * a_bar if component == 1 else vn - 2.0 * a
        R_2 = vn_bar + 2.0 * a_bar if component == 2 else vn + 2.0 * a

        vperp = m * h_inv[None] - vn[None] * normal
        vn_new = 0.5 * (R_1 + R_2)
        h_new = ((R_2 - R_1) / 4.0) ** 2 / g
        mom_new = h_new[None] * (vn_new[None] * normal + vperp)
        return jnp.concatenate([h_new[None], mom_new], axis=0)

    def apply_boundary_conditions(self, bc_id: int, U, normal, dirichlet_data):
        if bc_id == Boundary.do_nothing:
            return U
        if bc_id == Boundary.dirichlet:
            return dirichlet_data
        if bc_id == Boundary.dirichlet_momentum:
            return jnp.concatenate(
                [U[:1], self.momentum(dirichlet_data)], axis=0
            )
        if bc_id == Boundary.slip:
            m = self.momentum(U)
            m = m - jnp.sum(m * normal, 0, keepdims=True) * normal
            return jnp.concatenate([U[:1], m], axis=0)
        if bc_id == Boundary.no_slip:
            return jnp.concatenate(
                [U[:1], jnp.zeros_like(self.momentum(U))], axis=0
            )
        if bc_id == Boundary.dynamic:
            m = self.momentum(U)
            a = self.speed_of_sound(U)
            vn = jnp.sum(m * normal, 0) * self.inverse_water_depth_sharp(U)
            U_d = dirichlet_data
            r_sub_in = self.prescribe_riemann_characteristic(
                U_d, U, normal, component=2
            )
            r_sub_out = self.prescribe_riemann_characteristic(
                U, U_d, normal, component=1
            )
            result = U
            result = jnp.where(((vn > 0.0) & (vn <= a))[None], r_sub_out, result)
            result = jnp.where(((vn >= -a) & (vn <= 0.0))[None], r_sub_in, result)
            result = jnp.where((vn < -a)[None], U_d, result)
            return result
        raise ValueError(f"unknown boundary id {bc_id}")
