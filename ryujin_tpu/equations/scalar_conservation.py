"""Generic scalar conservation equation u_t + div f(u) = 0.

Re-implementation of /root/reference/source/scalar_conservation/:
  * hyperbolic system + precomputation of (f(u), f'(u)) per direction:
      hyperbolic_system.h:200-660
  * guaranteed wavespeed bound from the regularized Roe average plus flux
    derivative envelope / optional greedy estimate and Kruzkov entropy
    inequalities: riemann_solver.template.h:22-230
  * Kruzkov entropy-viscosity-commutator indicator: indicator.h:150-205
  * convex limiter with u-interval bounds: limiter.h:200-320,
    limiter.template.h:15-131
  * flux library (burgers, kpp, user function with central-difference
    derivative): flux_burgers.h, flux_kpp.h, flux_function.h

Layout: component-first ([1, ...] states), node axis last — see
equations/euler.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..offline.mesh import Boundary


@dataclasses.dataclass(frozen=True)
class FluxFunction:
    """A scalar flux f: R -> R^dim (flux.h:29-60).

    value(u) and gradient(u) map [...] -> [dim, ...].  If gradient is None
    it is approximated by the same central difference the reference's
    FunctionParser flux uses (flux_function.h:55-70).
    """

    name: str
    dim: int
    value: Callable
    gradient: Optional[Callable] = None
    derivative_approximation_delta: float = 1.0e4 * float(np.finfo(np.float64).eps)

    def grad(self, u):
        if self.gradient is not None:
            return self.gradient(u)
        d = jnp.asarray(self.derivative_approximation_delta, u.dtype)
        return (self.value(u + d) - self.value(u - d)) / (2.0 * d)


def burgers(dim: int) -> FluxFunction:
    """f(u) = 0.5 u^2 in every direction (flux_burgers.h:29-40)."""
    return FluxFunction(
        name="burgers",
        dim=dim,
        value=lambda u: jnp.stack([0.5 * u * u] * dim, axis=0),
        gradient=lambda u: jnp.stack([u] * dim, axis=0),
    )


def kpp(dim: int = 2) -> FluxFunction:
    """f(u) = (sin u, cos u) (flux_kpp.h:25-55)."""
    assert dim == 2

    def val(u):
        return jnp.stack([jnp.sin(u), jnp.cos(u)], axis=0)

    def grd(u):
        return jnp.stack([jnp.cos(u), -jnp.sin(u)], axis=0)

    return FluxFunction(name="kpp", dim=dim, value=val, gradient=grd)


def function_flux(dim: int, fns: Sequence[Callable],
                  delta: float = 1.0e-10) -> FluxFunction:
    """User-supplied per-direction flux expressions (flux_function.h).

    The derivative is approximated by a central difference with step
    `delta`, matching the reference's FunctionParser behavior.
    """

    def val(u):
        return jnp.stack([f(u) for f in fns], axis=0)

    return FluxFunction(
        name="function", dim=dim, value=val, gradient=None,
        derivative_approximation_delta=delta,
    )


FLUX_LIBRARY = {
    "burgers": burgers,
    "kpp": kpp,
    "function": function_flux,
}


@dataclasses.dataclass(frozen=True)
class RiemannParams:
    """(riemann_solver.h:23-50)."""

    use_greedy_wavespeed: bool = False
    use_averaged_entropy: bool = False
    random_entropies: int = 0


@dataclasses.dataclass(frozen=True)
class ScalarConservation:
    """The scalar conservation "Description"."""

    dim: int
    flux: FluxFunction
    riemann: RiemannParams = RiemannParams()

    name = "scalar conservation"
    n_initial_precomputed = 0
    n_precomputation_cycles = 1
    n_bounds = 2  # [u_min, u_max]
    have_high_order_flux = False
    have_source_terms = False
    have_equilibrated_states = False
    is_identity_parabolic = True

    @property
    def n_comp(self) -> int:
        return 1

    @property
    def n_precomputed(self) -> int:
        return 2 * self.dim  # [f_1..f_dim, df_1..df_dim]

    @property
    def component_names(self):
        return ["u"]

    primitive_component_names = ["u"]

    @property
    def precomputed_names(self):
        if self.dim == 1:
            return ("f", "df")
        return tuple(
            [f"f_{k+1}" for k in range(self.dim)]
            + [f"df_{k+1}" for k in range(self.dim)]
        )

    # ---- derived quantities ---------------------------------------------
    def state(self, U):
        return U[0]

    def square_entropy(self, u):
        return 0.5 * u * u

    def kruzkov_entropy(self, k, u):
        return jnp.abs(u - k)

    def kruzkov_entropy_derivative(self, k, u):
        return jnp.sign(u - k)

    def is_admissible(self, U):
        return jnp.ones(U.shape[1:], bool)

    def from_primitive_state(self, prim):
        return prim

    def to_primitive_state(self, U):
        return U

    # ---- precomputation (hyperbolic_system.h:600-645) ---------------------
    def precompute(self, U, initial_precomputed, cycle: int = 0):
        del initial_precomputed, cycle
        u = self.state(U)
        return jnp.concatenate([self.flux.value(u), self.flux.grad(u)], axis=0)

    # ---- fluxes -----------------------------------------------------------
    def flux_contribution(self, precomputed, initial_precomputed, U):
        """Flux tensor [1, dim, ...] read from the precomputed values."""
        del initial_precomputed, U
        return precomputed[: self.dim][None]

    def flux_divergence(self, flux_i, flux_j, c_ij):
        return -jnp.sum((flux_i + flux_j) * c_ij[None], axis=1)

    # ---- Riemann solver (riemann_solver.template.h:22-230) ----------------
    def riemann_lambda_max(
        self, U_i, U_j, n_ij, prec_i=None, prec_j=None,
        newton_iterations: int = 0, newton_tol: float = 1e-10,
    ):
        del newton_iterations, newton_tol
        u_i = self.state(U_i)
        u_j = self.state(U_j)
        dim = self.dim
        f_i = jnp.sum(prec_i[:dim] * n_ij, axis=0)
        f_j = jnp.sum(prec_j[:dim] * n_ij, axis=0)
        df_i = jnp.sum(prec_i[dim:] * n_ij, axis=0)
        df_j = jnp.sum(prec_j[dim:] * n_ij, axis=0)

        h2 = jnp.asarray(
            2.0 * self.flux.derivative_approximation_delta, u_i.dtype
        )

        # regularized Roe average:
        lam = jnp.abs(f_i - f_j) / jnp.maximum(jnp.abs(u_i - u_j), h2)

        if self.riemann.use_greedy_wavespeed:
            lam = jnp.where(
                jnp.abs(u_i - u_j) >= h2,
                lam,
                jnp.abs(0.5 * (df_i + df_j)),
            )
        else:
            lam = jnp.maximum(lam, jnp.abs(df_i))
            lam = jnp.maximum(lam, jnp.abs(df_j))

        def enforce_entropy(lam, k):
            f_k = jnp.sum(self.flux.value(k) * n_ij, axis=0)
            eta_i = self.kruzkov_entropy(k, u_i)
            q_i = self.kruzkov_entropy_derivative(k, u_i) * (f_i - f_k)
            eta_j = self.kruzkov_entropy(k, u_j)
            q_j = self.kruzkov_entropy_derivative(k, u_j) * (f_j - f_k)
            a = u_i + u_j - 2.0 * k
            b = f_j - f_i
            c = eta_i + eta_j
            d = q_j - q_i
            lam_left = jnp.abs(d + b) / (jnp.abs(c + a) + h2)
            lam_right = jnp.abs(d - b) / (jnp.abs(c - a) + h2)
            return jnp.maximum(lam, jnp.maximum(lam_left, lam_right))

        if self.riemann.use_averaged_entropy:
            lam = enforce_entropy(lam, 0.5 * (u_i + u_j))

        # deterministic quadrature stands in for the reference's random
        # entropies (riemann_solver.template.h:165-186): fixed convex
        # combinations are reproducible and jit-friendly.
        n_e = self.riemann.random_entropies
        for m in range(n_e):
            factor = (m + 0.5) / n_e
            lam = enforce_entropy(lam, factor * u_i + (1.0 - factor) * u_j)

        return lam

    # ---- indicator (indicator.h:150-205) -----------------------------------
    def indicator_alpha(
        self, U_i, prec_i, U_j, prec_j, c_ij, mask, hd_i,
        evc_factor: float = 1.0,
    ):
        dim = self.dim
        u_i = self.state(U_i)  # [n]
        u_j = self.state(U_j)  # [K, n]
        f_i = prec_i[:dim]  # [dim, n]
        f_j = prec_j[:dim]  # [dim, K, n]

        d_eta_j = self.kruzkov_entropy_derivative(u_i[None], u_j)  # [K, n]
        left = jnp.sum(
            d_eta_j * jnp.sum(f_j * c_ij, axis=0) * mask, axis=0
        )
        right = jnp.sum(
            d_eta_j * jnp.sum(f_i[:, None] * c_ij, axis=0) * mask, axis=0
        )

        u_abs_max = jnp.maximum(
            jnp.abs(u_i),
            jnp.max(jnp.where(mask > 0, jnp.abs(u_j), 0.0), axis=0),
        )

        dtype = u_i.dtype
        reg = jnp.asarray(100.0 * np.finfo(np.dtype(dtype)).tiny, dtype)
        numerator = left - right
        denominator = jnp.abs(left) + jnp.abs(right)
        quotient = jnp.abs(numerator) / (
            denominator + jnp.maximum(hd_i * u_abs_max, reg)
        )
        return jnp.minimum(1.0, evc_factor * quotient)

    # ---- limiter (limiter.h:200-320) ----------------------------------------
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
        dim = self.dim
        dtype = U_i.dtype
        u_i = self.state(U_i)
        u_j = self.state(U_j)
        f_i = prec_i[:dim]
        f_j = prec_j[:dim]

        u_ij_bar = 0.5 * (u_i[None] + u_j) - 0.5 * jnp.sum(
            (f_j - f_i[:, None]) * scaled_c_ij, axis=0
        )
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        u_min = jnp.min(jnp.where(mask > 0, u_ij_bar, big), axis=0)
        u_max = jnp.max(jnp.where(mask > 0, u_ij_bar, -big), axis=0)
        u_min = jnp.minimum(u_min, u_i)  # diagonal entry
        u_max = jnp.maximum(u_max, u_i)

        # relaxation (uniform beta_ij = 1), including the diagonal:
        k_count = jnp.sum(mask, axis=0)
        num = jnp.sum((u_i[None] + u_j) * mask, axis=0) + 2.0 * u_i
        den = k_count + 1.0

        r_i = jnp.sqrt(hd_i)
        if self.dim == 2:
            r_i = jnp.sqrt(jnp.sqrt(hd_i)) ** 3
        elif self.dim == 1:
            r_i = jnp.sqrt(hd_i) ** 3
        r_i = r_i * relaxation_factor

        eps = jnp.finfo(dtype).eps
        u_relaxation = jnp.abs(num) / (jnp.abs(den) + eps)

        u_min = jnp.maximum(
            jnp.minimum((1.0 - r_i) * u_min, (1.0 + r_i) * u_min),
            u_min - 2.0 * u_relaxation,
        )
        u_max = jnp.minimum(
            jnp.maximum((1.0 + r_i) * u_max, (1.0 - r_i) * u_max),
            u_max + 2.0 * u_relaxation,
        )
        return jnp.stack([u_min, u_max], axis=0)

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
        """(limiter.template.h:15-131)."""
        del newton_iterations, newton_tol
        dtype = U.dtype
        eps = jnp.finfo(dtype).eps
        relax = 1.0 + 10000.0 * eps
        u_min, u_max = bounds[0], bounds[1]
        u_U = self.state(U)
        u_P = self.state(P)

        test_max = jnp.maximum(
            0.0, jnp.minimum(u_U - relax * u_max, relax * u_U - u_max)
        )
        test_min = jnp.maximum(
            0.0, jnp.minimum(u_min - relax * u_U, relax * u_min - u_U)
        )
        success = (test_max == 0.0) & (test_min == 0.0)

        reg = jnp.asarray(100.0 * np.finfo(np.dtype(dtype)).tiny, dtype)
        denominator = 1.0 / jnp.maximum(reg, jnp.abs(u_P) + eps * u_max)

        t_r = jnp.full(
            jnp.broadcast_shapes(u_U.shape, u_P.shape), t_max, dtype
        )
        t_r = jnp.where(
            u_max < u_U + t_r * u_P, (u_max - u_U) * denominator, t_r
        )
        t_r = jnp.where(
            u_U + t_r * u_P < u_min, (u_U - u_min) * denominator, t_r
        )
        t_r = jnp.clip(t_r, t_min, t_max)
        return t_r, success

    def combine_bounds(self, a, b):
        return jnp.stack(
            [jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1])], axis=0
        )

    # ---- boundary conditions (hyperbolic_system.h:694-740) ------------------
    def apply_boundary_conditions(self, bc_id: int, U, normal, dirichlet_data):
        if bc_id == Boundary.do_nothing:
            return U
        if bc_id == Boundary.dirichlet:
            return dirichlet_data
        raise ValueError(
            f"boundary id {bc_id} not admissible for scalar conservation"
        )
