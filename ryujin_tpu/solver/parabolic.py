"""Implicit parabolic (Navier-Stokes) solver: backward Euler + CG.

Re-design of
/root/reference/source/navier_stokes/parabolic_solver.template.h:212-860:
one implicit backward-Euler step of the parabolic subsystem (Newtonian
stress for the velocity, Fourier heat flux for the internal energy),
each solved with a matrix-free preconditioned conjugate-gradient method.

The reference evaluates the stress/diffusion bilinear forms cell-wise
with FEEvaluation; here the operators are stencil matvecs over the
statically assembled gradient-product family K^{ab}_ij = int d_a phi_i
d_b phi_j (offline/assembly.py assemble_stiffness):

  stress(V)_{d,i} = sum_j [ mu (L_ij V_{d,j} + K^{bd}_ij V_{b,j})
                            + (lambda - 2/3 mu) K^{db}_ij V_{b,j} ]
  with L = sum_b K^{bb}   (and the 1D collapse (4/3 mu + lambda) L)

  velocity operator: A V = m_i rho_i V_i + tau * stress(V)     (5.4)
  energy operator:   B e = m_i rho_i e_i + tau * kappa_cv L e  (5.5)

Boundary conditions enter as a projection P (slip: remove the normal
component, no_slip/dirichlet: freeze the node) applied around the
operator, with the initial guess lifted to the prescribed values.

The stress dissipation K_i entering the internal-energy right hand side
is evaluated from the lumped-mass nodal velocity gradient (c_ij based,
second-order consistent) instead of the reference's cell-quadrature
projection — a deliberate graph-native approximation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..offline.mesh import Boundary

# f32 contractions would otherwise be allowed to run as TF32 on GPUs
# (10-bit mantissa); HIGHEST keeps the f32 solve what it is on the CPU.
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def matvec_family(stencil, pa, V):
    """Returns (L V [dim, n], K^{bd} V [d, n], K^{db} V [d, n]) for the
    gradient-product family pa.kab/pa.kab_ii over `stencil`."""
    V_j = stencil.nbr(V)  # [dim, K, n]
    lap_edge = _einsum("bbkn->kn", pa.kab)  # sum_b K^{bb}, [K, n]
    lap_diag = _einsum("bbn->n", pa.kab_ii)
    LV = (
        jnp.sum(lap_edge[None] * V_j * pa.mask[None], axis=1)
        + lap_diag[None] * V
    )
    # T2_d = sum_b K^{bd} V_b ; T3_d = sum_b K^{db} V_b
    T2 = (
        _einsum("bdkn,bkn->dn", pa.kab * pa.mask[None, None], V_j)
        + _einsum("bdn,bn->dn", pa.kab_ii, V)
    )
    T3 = (
        _einsum("dbkn,bkn->dn", pa.kab * pa.mask[None, None], V_j)
        + _einsum("dbn,bn->dn", pa.kab_ii, V)
    )
    return LV, T2, T3


def stress_matvec(stencil, pa, mu, lam, dim, V):
    """Newtonian stress bilinear form matvec (eq. 5.4 of the reference)."""
    LV, T2, T3 = matvec_family(stencil, pa, V)
    if dim == 1:
        return (4.0 / 3.0 * mu + lam) * LV
    return mu * (LV + T2) + (lam - 2.0 / 3.0 * mu) * T3


def laplace_matvec(stencil, pa, e):
    """Scalar diffusion matvec sum_b K^{bb} (heat flux operator)."""
    e_j = stencil.nbr(e)  # [K, n]
    lap_edge = _einsum("bbkn->kn", pa.kab)
    lap_diag = _einsum("bbn->n", pa.kab_ii)
    return jnp.sum(lap_edge * e_j * pa.mask, axis=0) + lap_diag * e


def stress_diagonal(pa, mu, lam, dim):
    """Per-component diagonal of the stress operator [dim, n]."""
    lap_diag = _einsum("bbn->n", pa.kab_ii)
    if dim == 1:
        return ((4.0 / 3.0 * mu + lam) * lap_diag)[None]
    kdd = _einsum("ddn->dn", pa.kab_ii)
    return mu * (lap_diag[None] + kdd) + (lam - 2.0 / 3.0 * mu) * kdd


def laplace_diagonal(pa):
    return _einsum("bbn->n", pa.kab_ii)


@dataclasses.dataclass(frozen=True)
class ParabolicSystem:
    """Newtonian fluid + Fourier heat flux parameters
    (navier_stokes/parabolic_system.h:40-60)."""

    mu: float = 1.0e-3
    lambda_: float = 0.0
    cv_inverse_kappa: float = 1.866666666666666e-2
    is_identity = False


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ParabolicArrays:
    """Device arrays for the parabolic operators (traced pytree)."""

    kab: jax.Array  # [dim, dim, K, n] off-diagonal K^{ab}
    kab_ii: jax.Array  # [dim, dim, n] diagonal
    m_lumped: jax.Array  # [n]
    cij: jax.Array  # [dim, K, n]
    cii: jax.Array  # [dim, n]
    mask: jax.Array  # [K, n]
    node_mask: jax.Array  # [n]


class ParabolicSolver:
    """Owns the operator data and provides backward_euler_step (jittable)."""

    def __init__(
        self,
        eq,
        system: ParabolicSystem,
        packed,
        offline_data,
        mesh,
        initial_state_fn: Callable,
        stencil,
        dtype=jnp.float64,
        tolerance: float = 1.0e-12,
        max_iterations: int = 200,
        gmg_params=None,
        mesh_chain=None,
    ):
        from ..offline import assembly as _assembly
        from ..offline import ell as _ell
        from ..offline import structured as _structured

        self.eq = eq
        self.system = system
        self.dtype = dtype
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        self.initial_state_fn = initial_state_fn
        self.stencil = stencil  # gather/shift-capable stencil (nbr)
        self.dim = eq.dim

        kab_off, kab_diag = _assembly.assemble_stiffness(mesh, offline_data)
        if isinstance(packed, _structured.StructuredData):
            kab_e = _structured.pack_edge_values(
                packed, offline_data, mesh, kab_off
            )
            kab_n = _structured.pack_node_values(packed, kab_diag)
        else:
            kab_e = _ell.pack_edge_values(packed, offline_data, kab_off)
            kab_n = _ell.pack_node_values(packed, kab_diag)

        def f(x):
            return jnp.asarray(x, dtype)

        self.arrays = ParabolicArrays(
            kab=f(np.transpose(kab_e, (2, 3, 1, 0))),  # [dim,dim,K,n]
            kab_ii=f(np.transpose(kab_n, (1, 2, 0))),  # [dim,dim,n]
            m_lumped=stencil.m_lumped,
            cij=stencil.cij,
            cii=stencil.cii,
            mask=stencil.mask,
            node_mask=stencil.node_mask,
        )

        # boundary classification (host-side static index sets):
        dim = eq.dim
        n_pad = packed.n_pad
        slip_idx, slip_normal = [], []
        fixed_v = np.zeros(n_pad, bool)  # no_slip or dirichlet: velocity row
        zero_v = np.zeros(n_pad, bool)  # no_slip: velocity forced to zero
        dirichlet = np.zeros(n_pad, bool)
        d_idx, d_pos = [], []
        for rnd in packed.boundary_rounds:
            for bc_id, g in rnd.items():
                if bc_id == Boundary.slip:
                    slip_idx.append(g.index)
                    slip_normal.append(g.normal)
                elif bc_id == Boundary.no_slip:
                    fixed_v[g.index] = True
                    zero_v[g.index] = True
                elif bc_id == Boundary.dirichlet:
                    fixed_v[g.index] = True
                    dirichlet[g.index] = True
                    d_idx.append(g.index)
                    d_pos.append(g.position)
        self._slip_idx = (
            np.concatenate(slip_idx) if slip_idx else np.zeros(0, np.int64)
        )
        self._slip_normal = (
            np.concatenate(slip_normal).T
            if slip_normal
            else np.zeros((dim, 0))
        )
        self._fixed_v = jnp.asarray(fixed_v)
        self._zero_v = jnp.asarray(zero_v)
        self._dirichlet = jnp.asarray(dirichlet)
        self._d_idx = (
            np.concatenate(d_idx) if d_idx else np.zeros(0, np.int64)
        )
        self._d_pos = (
            np.concatenate(d_pos).T if d_pos else np.zeros((dim, 0))
        )

        # geometric multigrid preconditioner over the refinement chain
        # (parabolic_solver.h:205-287); optional, diagonal CG otherwise.
        self.gmg = None
        if (
            gmg_params is not None
            and (gmg_params.velocity or gmg_params.energy)
            and mesh_chain is not None
            and len(mesh_chain) >= 2
        ):
            from .gmg import GMG

            try:
                self.gmg = GMG(self, gmg_params, mesh_chain, packed)
            except ValueError as exc:
                print(f"[ryujin] multigrid disabled: {exc}")
                self.gmg = None

    # -- operators ---------------------------------------------------------
    def _matvec_family(self, pa: ParabolicArrays, V):
        return matvec_family(self.stencil, pa, V)

    def stress_matvec(self, pa: ParabolicArrays, V):
        return stress_matvec(
            self.stencil, pa, self.system.mu, self.system.lambda_,
            self.dim, V,
        )

    def laplace_matvec(self, pa: ParabolicArrays, e):
        return laplace_matvec(self.stencil, pa, e)

    # -- boundary projections ------------------------------------------------
    def _project_v(self, V):
        """Zero out the constrained velocity components (P)."""
        if len(self._slip_idx):
            idx = jnp.asarray(self._slip_idx)
            nrm = jnp.asarray(self._slip_normal, V.dtype)
            Vb = V[:, idx]
            Vb = Vb - jnp.sum(Vb * nrm, 0, keepdims=True) * nrm
            V = V.at[:, idx].set(Vb)
        return jnp.where(self._fixed_v[None], 0.0, V)

    def _project_e(self, e):
        return jnp.where(self._dirichlet, 0.0, e)

    def _lift_v(self, V, t_new):
        """Impose boundary values on the initial guess."""
        if len(self._slip_idx):
            idx = jnp.asarray(self._slip_idx)
            nrm = jnp.asarray(self._slip_normal, V.dtype)
            Vb = V[:, idx]
            Vb = Vb - jnp.sum(Vb * nrm, 0, keepdims=True) * nrm
            V = V.at[:, idx].set(Vb)
        V = jnp.where(self._zero_v[None], 0.0, V)
        if len(self._d_idx):
            idx = jnp.asarray(self._d_idx)
            pos = jnp.asarray(self._d_pos, V.dtype)
            U_d = self.initial_state_fn(pos, t_new)
            rho_d = self.eq.density(U_d)
            V = V.at[:, idx].set(self.eq.momentum(U_d) / rho_d[None])
        return V

    def _lift_e(self, e, t_new):
        if len(self._d_idx):
            idx = jnp.asarray(self._d_idx)
            pos = jnp.asarray(self._d_pos, e.dtype)
            U_d = self.initial_state_fn(pos, t_new)
            rho_d = self.eq.density(U_d)
            e_d = self.eq.internal_energy(U_d) / rho_d
            e = e.at[idx].set(e_d)
        return e

    # -- CG ------------------------------------------------------------------
    def _cg(self, A, P, x0, b, precond):
        """Projected preconditioned CG: solve P A P dx = P (b - A x0).

        `precond` is a callable r -> approximate A^{-1} r (diagonal scaling
        or a GMG V-cycle, cf. parabolic_solver.template.h:485-507)."""
        r = P(b - A(x0))
        z = P(precond(r))
        p = z
        rz = jnp.sum(r * z)

        def cond(state):
            x, r, p, rz, it = state
            return (it < self.max_iterations) & (
                jnp.sqrt(jnp.abs(rz)) > self.tolerance
            )

        def body(state):
            x, r, p, rz, it = state
            Ap = P(A(p))
            alpha = rz / jnp.maximum(
                jnp.sum(p * Ap), jnp.finfo(x.dtype).tiny
            )
            x = x + alpha * p
            r = r - alpha * Ap
            z = P(precond(r))
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.maximum(rz, jnp.finfo(x.dtype).tiny)
            p = z + beta * p
            return x, r, p, rz_new, it + 1

        x, r, p, rz, it = jax.lax.while_loop(
            cond, body, (x0, r, p, rz, jnp.zeros((), jnp.int32))
        )
        return x

    # -- the backward Euler step ----------------------------------------------
    def backward_euler_step(self, U, t, tau, parrays=None):
        """One implicit step over tau.  Returns (U_new, ok)."""
        eq = self.eq
        pa = parrays if parrays is not None else self.arrays
        mu, lam = self.system.mu, self.system.lambda_
        kcv = self.system.cv_inverse_kappa
        t_new = t + tau

        rho = eq.density(U)
        V_old = eq.momentum(U) / rho[None]
        e_old = eq.internal_energy(U) / rho
        m = pa.m_lumped
        mrho = m * rho
        diag_inv = 1.0 / mrho

        # ---- velocity solve (step P1, reference :250-510) ----------------
        rhs_v = mrho[None] * V_old
        x0 = self._lift_v(V_old, t_new)

        def A_v(V):
            return mrho[None] * V + tau * self.stress_matvec(pa, V)

        if self.gmg is not None and self.gmg.params.velocity:
            precond_v = self.gmg.build_preconditioner(
                "velocity", tau, mrho, A_v, self._project_v, pa
            )
        else:
            precond_v = lambda r: diag_inv[None] * r  # noqa: E731
        V_new = self._cg(A_v, self._project_v, x0, rhs_v, precond_v)

        # ---- internal energy solve (step P2, reference :510-790) ---------
        # Stress dissipation integrated against phi_i via the edge form
        #   (m K)_i = -1/2 sum_j (V_i - V_j)^T S_ij (V_i - V_j)
        # with S_ij the off-diagonal stress coupling blocks.  This is the
        # nodal split of V^T S V (the operator's exact energy balance) and
        # coincides with the reference's quadrature projection in 1D.
        st = self.stencil
        V_j = st.nbr(V_new)  # [dim, K, n]
        dV = V_new[:, None] - V_j  # [dim, K, n]
        lap_edge = _einsum("bbkn->kn", pa.kab)
        if self.dim == 1:
            quad = (4.0 / 3.0 * mu + lam) * lap_edge * dV[0] * dV[0]
        else:
            # S_ij[d, b] = mu (L_ij delta_db + K^{bd}_ij)
            #              + (lam - 2/3 mu) K^{db}_ij
            t_lap = lap_edge * jnp.sum(dV * dV, axis=0)
            t_bd = _einsum("bdkn,bkn,dkn->kn", pa.kab, dV, dV)
            quad = mu * (t_lap + t_bd) + (lam - 2.0 / 3.0 * mu) * t_bd
        mK_i = -0.5 * jnp.sum(quad * pa.mask, axis=0)

        correction = 0.5 * jnp.sum((V_old - V_new) ** 2, axis=0)
        rhs_e = mrho * (e_old + correction) + tau * mK_i
        e0 = self._lift_e(e_old, t_new)

        def A_e(e):
            return mrho * e + tau * kcv * self.laplace_matvec(pa, e)

        if self.gmg is not None and self.gmg.params.energy:
            precond_e = self.gmg.build_preconditioner(
                "energy", tau, mrho, A_e, self._project_e, pa
            )
        else:
            precond_e = lambda r: diag_inv * r  # noqa: E731
        e_new = self._cg(A_e, self._project_e, e0, rhs_e, precond_e)

        # ---- restart check + write back (reference :760-860) -------------
        big = jnp.asarray(jnp.finfo(U.dtype).max, U.dtype)
        nm = pa.node_mask > 0
        e_min_old = jnp.min(jnp.where(nm, e_old, big))
        e_min_new = jnp.min(jnp.where(nm, e_new, big))
        ok = e_min_new >= e_min_old

        m_new = rho[None] * V_new
        E_new = rho * e_new + 0.5 * jnp.sum(m_new * m_new, 0) / rho
        U_new = jnp.concatenate([U[:1], m_new, E_new[None]], axis=0)
        return U_new, ok
