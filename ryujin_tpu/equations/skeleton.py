"""Skeleton equation module: the minimal "Description" surface.

Analog of /root/reference/source/skeleton/ — a template for
adding new equations.  It documents every hook the solver core calls:

  structure:   n_comp, n_precomputed, n_initial_precomputed,
               n_precomputation_cycles, n_bounds, component names,
               have_high_order_flux / have_source_terms /
               have_equilibrated_states / is_identity_parabolic
  physics:     precompute, flux_contribution, flux_divergence,
               riemann_lambda_max, indicator_alpha,
               limiter_bounds / limiter_limit / combine_bounds,
               apply_boundary_conditions, is_admissible,
               from/to_primitive_state

All arrays are component-first with the node axis last (see
equations/euler.py).  This skeleton implements a trivial single-component
system with zero flux and unit wave speed: states are transported nowhere
and remain constant, which makes it convenient for smoke tests.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..offline.mesh import Boundary


@dataclasses.dataclass(frozen=True)
class Skeleton:
    dim: int

    name = "skeleton"
    n_precomputed = 0
    n_initial_precomputed = 0
    n_precomputation_cycles = 1
    n_bounds = 2
    have_high_order_flux = False
    have_source_terms = False
    have_equilibrated_states = False
    is_identity_parabolic = True

    @property
    def n_comp(self) -> int:
        return 1

    component_names = ["u"]
    primitive_component_names = ["u"]
    precomputed_names = ()

    # -- state transforms -------------------------------------------------
    def from_primitive_state(self, prim):
        return prim

    def to_primitive_state(self, U):
        return U

    def is_admissible(self, U):
        return jnp.ones(U.shape[1:], bool)

    # -- hooks called once per substep -------------------------------------
    def precompute(self, U, initial_precomputed, cycle: int = 0):
        del initial_precomputed, cycle
        return jnp.zeros((0,) + U.shape[1:], U.dtype)

    def flux_contribution(self, precomputed, initial_precomputed, U):
        del precomputed, initial_precomputed
        return jnp.zeros((1, self.dim) + U.shape[1:], U.dtype)

    def flux_divergence(self, flux_i, flux_j, c_ij):
        return -jnp.sum((flux_i + flux_j) * c_ij[None], axis=1)

    def riemann_lambda_max(self, U_i, U_j, n_ij, prec_i=None, prec_j=None,
                           newton_iterations=0, newton_tol=1e-10):
        return jnp.ones(jnp.broadcast_shapes(U_i.shape, U_j.shape)[1:],
                        U_i.dtype)

    def indicator_alpha(self, U_i, prec_i, U_j, prec_j, c_ij, mask, hd_i,
                        evc_factor=1.0):
        return jnp.zeros(U_i.shape[1:], U_i.dtype)

    def limiter_bounds(self, U_i, prec_i, U_j, prec_j, scaled_c_ij, mask,
                       hd_i, relaxation_factor=1.0):
        big = jnp.finfo(U_i.dtype).max
        return jnp.stack(
            [jnp.full(U_i.shape[1:], -big, U_i.dtype),
             jnp.full(U_i.shape[1:], big, U_i.dtype)],
            axis=0,
        )

    def limiter_limit(self, bounds, U, P, newton_iterations=2,
                      newton_tol=1e-10, t_min=0.0, t_max=1.0):
        t = jnp.full(jnp.broadcast_shapes(U.shape, P.shape)[1:], t_max,
                     U.dtype)
        return t, jnp.ones_like(t, bool)

    def combine_bounds(self, a, b):
        return jnp.stack(
            [jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1])], axis=0
        )

    def apply_boundary_conditions(self, bc_id, U, normal, dirichlet_data):
        if bc_id == Boundary.dirichlet:
            return dirichlet_data
        return U
