"""Geometric multigrid preconditioner for the Navier-Stokes parabolic CG.

Analog of the reference's GMG-preconditioned matrix-free
solves (navier_stokes/parabolic_solver.h:205-287 and
parabolic_solver_gmg_operators.h: DiagonalMatrix, VelocityMatrix,
MGTransferVelocity, EnergyMatrix, MGTransferEnergy), redesigned for
XLA:

* The level hierarchy is the global-refinement chain of the mesh.
  `offline.mesh._refine_once` appends the new (edge/face/cell midpoint)
  vertices after the coarse ones, so coarse dofs are a prefix of fine
  dofs and the Q1 prolongation is a static 2/4/8-wide gather; the
  restriction is its transpose, packed as another gather (ELL form) so
  the V-cycle contains no scatters at all.
* Level operators are geometrically re-assembled stiffness families
  (offline.assembly.assemble_stiffness per level mesh) with the density
  restricted through the transfer chain (mass-weighted, the analog of
  MGTransferVelocity::interpolate_to_mg of rho).
* Smoothing is a fixed-degree Chebyshev iteration on the
  diagonally-scaled operator (the analog of PreconditionChebyshev in
  float, parabolic_solver.h:255-275); the largest eigenvalue is
  estimated inside jit with a fixed-iteration power method (the analog
  of the smoother's `eig_cg_n_iterations` setup solves), multiplied by
  a 1.2 safety factor.
* Boundary conditions are enforced per level with the same projection
  (slip: remove the normal component; no_slip/dirichlet: zero) as the
  fine-level CG, mirroring deal.II's MGConstrainedDoFs.

The preconditioner requires the mesh chain to be constraint-free
(no periodic masters, no hanging nodes); callers fall back to the
diagonal preconditioner otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..offline.mesh import Boundary, Mesh, _FACE_VERTICES, _unique_rows


@dataclasses.dataclass(frozen=True)
class GMGParams:
    """Mirrors the reference's GMG parameters
    (parabolic_solver.template.h:54-110)."""

    velocity: bool = False          # "multigrid velocity"
    energy: bool = False            # "multigrid energy"
    chebyshev_degree: int = 3       # "multigrid - chebyshev degree"
    coarse_degree: int = 8          # coarse-grid smoother degree
    power_iterations: int = 8       # analog of "chebyshev cg iter"
    smoother_range_velocity: float = 8.0   # "chebyshev range"
    smoother_range_energy: float = 15.0
    max_eig_safety: float = 1.2
    min_level: int = 0              # "multigrid - min level"


def refinement_groups(coarse: Mesh) -> List[np.ndarray]:
    """The vertex groups `_refine_once` appends, in appended order.

    Each group row lists the coarse vertices whose Q1 average gives the
    new vertex value (edge midpoints [n,2], 3D face midpoints [n,4],
    cell midpoints [n, 2**dim])."""
    dim, cells = coarse.dim, coarse.cells
    if dim == 1:
        return [cells]
    if dim == 2:
        edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
        uniq_e, _ = _unique_rows(cells[:, edge_local].reshape(-1, 2))
        return [uniq_e, cells]
    edge_local = np.array(
        [[0, 1], [2, 3], [4, 5], [6, 7],
         [0, 2], [1, 3], [4, 6], [5, 7],
         [0, 4], [1, 5], [2, 6], [3, 7]]
    )
    uniq_e, _ = _unique_rows(cells[:, edge_local].reshape(-1, 2))
    uniq_f, _ = _unique_rows(
        cells[:, np.stack(_FACE_VERTICES[3])].reshape(-1, 4)
    )
    return [uniq_e, uniq_f, cells]


def check_chain(chain: Sequence[Mesh]) -> bool:
    """Validate that chain[k+1] is `_refine_once(chain[k])` (prefix
    vertex numbering) and that no mesh carries constraints."""
    for k in range(len(chain) - 1):
        c, f = chain[k], chain[k + 1]
        if c.hanging is not None and len(c.hanging):
            return False
        if c.periodic_pairs is not None and len(c.periodic_pairs):
            return False
        n_new = sum(len(g) for g in refinement_groups(c))
        if f.n_vertices != c.n_vertices + n_new:
            return False
        if not np.allclose(f.vertices[: c.n_vertices], c.vertices):
            return False
    return True


def _transfer_ell(groups, n_coarse, n_fine_pad, n_coarse_pad,
                  fine_raw_to_node, coarse_raw_to_node, dtype):
    """Build gather-form prolongation/restriction between two levels.

    fine_raw_to_node / coarse_raw_to_node map raw vertex ids to the
    packed node ids of each level's vectors (identity + padding for the
    coarse levels; the solver's locality permutation at the top level).

    Returns (cols_p [Kp, n_fine_pad], w_p, cols_r [Kr, n_coarse_pad],
    w_r) such that prolong(c) = sum_k w_p * c[cols_p] and
    restrict(f) = sum_k w_r * f[cols_r]."""
    # prolongation sources per fine raw id
    Kp = max((g.shape[1] for g in groups), default=1)
    n_fine_raw = len(fine_raw_to_node)
    src = np.zeros((n_fine_raw, Kp), np.int64)
    w = np.zeros((n_fine_raw, Kp))
    src[:n_coarse, 0] = np.arange(n_coarse)
    w[:n_coarse, 0] = 1.0
    off = n_coarse
    for g in groups:
        m, width = g.shape
        src[off : off + m, :width] = g
        w[off : off + m, :width] = 1.0 / width
        off += m
    assert off == n_fine_raw

    cols_p = np.zeros((n_fine_pad, Kp), np.int64)
    w_p = np.zeros((n_fine_pad, Kp))
    fnode = fine_raw_to_node
    valid = fnode >= 0
    cols_p[fnode[valid]] = coarse_raw_to_node[src[valid]]
    w_p[fnode[valid]] = w[valid]

    # restriction = transpose: per coarse raw id, list of (fine, weight)
    from collections import defaultdict

    contrib = defaultdict(list)
    for fr in np.flatnonzero(valid):
        for k in range(Kp):
            if w[fr, k] != 0.0:
                contrib[int(src[fr, k])].append((int(fnode[fr]), w[fr, k]))
    Kr = max((len(v) for v in contrib.values()), default=1)
    cols_r = np.zeros((n_coarse_pad, Kr), np.int64)
    w_r = np.zeros((n_coarse_pad, Kr))
    for cr, lst in contrib.items():
        node = coarse_raw_to_node[cr]
        for k, (fn, wv) in enumerate(lst):
            cols_r[node, k] = fn
            w_r[node, k] = wv

    f = lambda x: jnp.asarray(x)  # noqa: E731
    return (
        f(cols_p.T.astype(np.int32)), jnp.asarray(w_p.T, dtype),
        f(cols_r.T.astype(np.int32)), jnp.asarray(w_r.T, dtype),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _LevelArrays:
    """Device arrays of one coarse level (pytree)."""

    kab: jax.Array      # [dim, dim, K, n]
    kab_ii: jax.Array   # [dim, dim, n]
    mask: jax.Array     # [K, n]
    node_mask: jax.Array  # [n]
    m_lumped: jax.Array   # [n] level lumped mass (geometric)
    fixed_v: jax.Array    # [n] bool
    dirichlet: jax.Array  # [n] bool
    slip_idx: jax.Array   # [s]
    slip_normal: jax.Array  # [dim, s]
    start: jax.Array      # [n] deterministic power-iteration start


class GMG:
    """Builds level data at construction; produces V-cycle closures."""

    def __init__(self, solver, params: GMGParams, chain: Sequence[Mesh],
                 packed):
        from ..offline import assembly as _assembly
        from ..offline import ell as _ell
        from .hyperbolic import _stencil_from_ell

        self.solver = solver
        self.params = params
        self.dtype = solver.dtype
        # coarse levels always run in float32 (the reference's GMG levels
        # are always float, parabolic_solver.h:255-275): the V-cycle is a
        # preconditioner, so reduced precision costs CG iterations at
        # most, never accuracy; in f32 solver runs this is a no-op
        self.level_dtype = jnp.float32
        dim = solver.dim

        if not hasattr(packed, "node_to_vertex"):
            raise ValueError("GMG requires the ELL (xla) backend")

        lo = max(0, params.min_level)
        chain = list(chain)[lo:]
        if len(chain) < 2:
            raise ValueError("GMG needs at least two levels")
        if not check_chain(chain):
            raise ValueError("mesh chain is not a global-refinement chain")

        rng = np.random.RandomState(42)

        # ---- coarse levels (all but the finest) -------------------------
        self.levels: List[_LevelArrays] = []
        self.level_stencils = []
        level_packed = []
        for m in chain[:-1]:
            data = _assembly.assemble(m)
            assert not data.is_constrained.any()
            lp = _ell.pack(data, reorder=False)
            st = _stencil_from_ell(lp, self.level_dtype)
            kab_off, kab_diag = _assembly.assemble_stiffness(m, data)
            kab_e = _ell.pack_edge_values(lp, data, kab_off)
            kab_n = _ell.pack_node_values(lp, kab_diag)
            fixed_v, dirichlet, slip_idx, slip_normal = _classify(
                lp.boundary_rounds, lp.n_pad, dim
            )
            self.levels.append(_LevelArrays(
                kab=jnp.asarray(
                    np.transpose(kab_e, (2, 3, 1, 0)), self.level_dtype
                ),
                kab_ii=jnp.asarray(
                    np.transpose(kab_n, (1, 2, 0)), self.level_dtype
                ),
                mask=st.mask,
                node_mask=st.node_mask,
                m_lumped=st.m_lumped,
                fixed_v=jnp.asarray(fixed_v),
                dirichlet=jnp.asarray(dirichlet),
                slip_idx=jnp.asarray(slip_idx.astype(np.int32)),
                slip_normal=jnp.asarray(slip_normal, self.level_dtype),
                start=jnp.asarray(
                    rng.uniform(0.5, 1.5, lp.n_pad), self.level_dtype
                ),
            ))
            self.level_stencils.append(st)
            level_packed.append(lp)

        # fine-level power-iteration start vector
        self.fine_start = jnp.asarray(
            rng.uniform(0.5, 1.5, packed.n_pad), self.dtype
        )

        # ---- transfers --------------------------------------------------
        # raw -> node maps per level; coarse levels are identity+pad.  The
        # finest chain mesh is matched to the solver's packed nodes by
        # position (the chain is built by refine_global of the coarse
        # mesh, so its numbering differs from the solver mesh's).
        raw_to_node = [
            np.arange(m.n_vertices, dtype=np.int64) for m in chain[:-1]
        ]
        from scipy.spatial import cKDTree

        fine = chain[-1]
        node_pos = np.asarray(packed.positions[: packed.n_nodes])
        if len(node_pos) != fine.n_vertices:
            raise ValueError(
                "solver mesh and refinement chain disagree "
                f"({len(node_pos)} packed nodes vs {fine.n_vertices} "
                "chain vertices); is the ansatz cG Q1?"
            )
        scale = max(1.0, float(np.abs(fine.vertices).max()))
        d, idx = cKDTree(node_pos).query(fine.vertices)
        if d.max() > 1.0e-8 * scale or len(np.unique(idx)) != len(idx):
            raise ValueError(
                "refinement chain does not reproduce the solver mesh"
            )
        raw_to_node.append(idx.astype(np.int64))
        n_pads = [lp.n_pad for lp in level_packed] + [packed.n_pad]

        self.transfers = []
        for k in range(len(chain) - 1):
            groups = refinement_groups(chain[k])
            self.transfers.append(_transfer_ell(
                groups, chain[k].n_vertices, n_pads[k + 1], n_pads[k],
                raw_to_node[k + 1], raw_to_node[k], self.level_dtype,
            ))

    # ---- device-side pieces --------------------------------------------
    def _prolong(self, k, c):
        cols_p, w_p, _, _ = self.transfers[k]
        return jnp.sum(w_p * c[..., cols_p], axis=-2)

    def _restrict(self, k, f):
        _, _, cols_r, w_r = self.transfers[k]
        return jnp.sum(w_r * f[..., cols_r], axis=-2)

    def _level_project(self, lvl: _LevelArrays, which, V):
        if which == "velocity":
            if lvl.slip_idx.shape[0]:
                Vb = V[:, lvl.slip_idx]
                Vb = Vb - (
                    jnp.sum(Vb * lvl.slip_normal, 0, keepdims=True)
                    * lvl.slip_normal
                )
                V = V.at[:, lvl.slip_idx].set(Vb)
            return jnp.where(lvl.fixed_v[None], 0.0, V)
        return jnp.where(lvl.dirichlet, 0.0, V)

    def build_preconditioner(self, which, tau, mrho_fine, A_fine, P_fine,
                             pa_fine) -> Callable:
        """Return r -> V-cycle(r), closed over the current tau/density.

        Rebuilt (inside jit) every backward-Euler step — the analog of
        the reference reinitializing the GMG hierarchy periodically
        (parabolic_module.template.h:78), but exact instead of stale."""
        from . import parabolic as _p

        solver = self.solver
        prm = self.params
        sys_ = solver.system
        dim = solver.dim
        rng_range = (
            prm.smoother_range_velocity if which == "velocity"
            else prm.smoother_range_energy
        )

        # restrict m*rho down the hierarchy (mass-weighted density);
        # coarse levels run in level_dtype (float32)
        mrho = [mrho_fine]
        for k in range(len(self.transfers) - 1, -1, -1):
            mrho.insert(0, self._restrict(k, mrho[0]))
        mrho = [
            m.astype(self.level_dtype) for m in mrho[:-1]
        ] + [mrho[-1]]

        ops = []
        for k, (lvl, st) in enumerate(
            zip(self.levels, self.level_stencils)
        ):
            mr = mrho[k]

            def A(V, lvl=lvl, st=st, mr=mr):
                if which == "velocity":
                    return mr[None] * V + tau * _p.stress_matvec(
                        st, lvl, sys_.mu, sys_.lambda_, dim, V
                    )
                return mr * V + tau * sys_.cv_inverse_kappa * (
                    _p.laplace_matvec(st, lvl, V)
                )

            if which == "velocity":
                D = mr[None] + tau * _p.stress_diagonal(
                    lvl, sys_.mu, sys_.lambda_, dim
                )
                start = jnp.broadcast_to(
                    lvl.start[None], (dim,) + lvl.start.shape
                )
            else:
                D = mr + tau * sys_.cv_inverse_kappa * (
                    _p.laplace_diagonal(lvl)
                )
                start = lvl.start
            nm = lvl.node_mask > 0
            Dinv = jnp.where(
                nm if which == "energy" else nm[None],
                1.0 / jnp.maximum(D, jnp.finfo(self.dtype).tiny), 0.0,
            )

            def P(V, lvl=lvl):
                return self._level_project(lvl, which, V)

            ops.append(dict(A=A, P=P, Dinv=Dinv, start=start, level=k))

        # finest level: the solver's own operator
        if which == "velocity":
            D_f = mrho_fine[None] + tau * _p.stress_diagonal(
                pa_fine, sys_.mu, sys_.lambda_, dim
            )
            start_f = jnp.broadcast_to(
                self.fine_start[None], (dim,) + self.fine_start.shape
            )
        else:
            D_f = mrho_fine + tau * sys_.cv_inverse_kappa * (
                _p.laplace_diagonal(pa_fine)
            )
            start_f = self.fine_start
        nm_f = pa_fine.node_mask > 0
        Dinv_f = jnp.where(
            nm_f if which == "energy" else nm_f[None],
            1.0 / jnp.maximum(D_f, jnp.finfo(self.dtype).tiny), 0.0,
        )
        ops.append(dict(A=A_fine, P=P_fine, Dinv=Dinv_f, start=start_f,
                        level=len(self.levels)))

        # eigenvalue estimates (power method, fixed iterations)
        tiny = jnp.finfo(self.dtype).tiny
        for op in ops:
            A, P, Dinv = op["A"], op["P"], op["Dinv"]

            def M(x, A=A, P=P, Dinv=Dinv):
                return P(Dinv * A(P(x)))

            x = P(op["start"])
            for _ in range(self.params.power_iterations):
                y = M(x)
                x = y / jnp.maximum(jnp.sqrt(jnp.sum(y * y)), tiny)
            y = M(x)
            lmax = prm.max_eig_safety * jnp.abs(
                jnp.sum(x * y) / jnp.maximum(jnp.sum(x * x), tiny)
            )
            op["lmax"] = jnp.maximum(lmax, 1.0e-8)
            op["lmin"] = op["lmax"] / rng_range

        def cheb(op, r, degree):
            """Chebyshev iteration for A z = r from z = 0 on the
            diagonally-preconditioned spectrum [lmin, lmax]."""
            A, P, Dinv = op["A"], op["P"], op["Dinv"]
            theta = 0.5 * (op["lmax"] + op["lmin"])
            delta = 0.5 * (op["lmax"] - op["lmin"])
            sigma = theta / delta
            rho = 1.0 / sigma
            z = P(Dinv * r) / theta
            dz = z
            for _ in range(degree - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                res = r - A(z)
                dz = rho_new * rho * dz + (
                    2.0 * rho_new / delta
                ) * P(Dinv * res)
                z = z + dz
                rho = rho_new
            return z

        def cycle(k, r):
            if k == 0:
                return cheb(ops[0], r, prm.coarse_degree)
            op = ops[k]
            z = cheb(op, r, prm.chebyshev_degree)
            r2 = r - op["A"](z)
            zc = cycle(k - 1, ops[k - 1]["P"](
                self._restrict(k - 1, r2).astype(self.level_dtype)
            ))
            z = z + op["P"](
                self._prolong(k - 1, zc).astype(r.dtype)
            )
            z = z + cheb(op, r - op["A"](z), prm.chebyshev_degree)
            return z

        return lambda r: cycle(len(ops) - 1, r)


def _classify(boundary_rounds, n_pad, dim):
    """Boundary masks for one level (same logic as ParabolicSolver)."""
    fixed_v = np.zeros(n_pad, bool)
    dirichlet = np.zeros(n_pad, bool)
    slip_idx, slip_normal = [], []
    for rnd in boundary_rounds:
        for bc_id, g in rnd.items():
            if bc_id == Boundary.slip:
                slip_idx.append(g.index)
                slip_normal.append(g.normal)
            elif bc_id == Boundary.no_slip:
                fixed_v[g.index] = True
            elif bc_id == Boundary.dirichlet:
                fixed_v[g.index] = True
                dirichlet[g.index] = True
    si = (np.concatenate(slip_idx) if slip_idx
          else np.zeros(0, np.int64))
    sn = (np.concatenate(slip_normal).T if slip_normal
          else np.zeros((dim, 0)))
    return fixed_v, dirichlet, si, sn
