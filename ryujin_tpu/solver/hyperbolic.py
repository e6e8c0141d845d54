"""The hyperbolic module: graph-viscosity IDP update with convex limiting.

Re-design of /root/reference/source/hyperbolic_module.template.h.
The reference performs seven fused passes over a SIMD-blocked CSR stencil
with overlapped MPI ghost exchange.  Here the whole update is a single
jit-compiled dataflow graph over stencil arrays:

  step 1   apply boundary conditions + precompute (prepare_state_vector,
           reference :96-193)
  step 2   d_ij for *all* directed edges via the approximate Riemann solver
           + indicator alpha_i (reference :341-424 computes the upper
           triangle only and symmetrizes; here each directed edge is
           evaluated once and the transpose-max reproduces the
           boundary-pair fixup of reference :461-490)
  step 3   d_ii = -sum_j d_ij and tau_max (reference :494-564)
  step 4   low-order update, limiter bounds, r_i, first part of P_ij
           (reference :597-884)
  step 5   mass-matrix correction (Neumann series b_ij), first limiter pass
           (reference :892-1041)
  step 6/7 symmetrized l_ij, high-order updates, second limiter pass with
           the (1 - l^(1)) l^(2) shortcut (reference :1054-1182)

Layout (see equations/euler.py): node axis LAST, component and edge-slot
axes first — states [C, n], edge data [K, n], [dim, K, n].  The large
node axis is the contiguous one, and the axis that sharding splits.

The restart mechanism (invariant-domain violation -> Restart exception,
reference :1190-1207) is functional here: step() returns an `ok` flag and
the TimeIntegrator retries with cfl_min (bang-bang control).
"""

from __future__ import annotations

import dataclasses
import os as _os
from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..offline.ell import EllData
from ..offline.mesh import Boundary
from ..offline.structured import StructuredData


def _f(x, dtype):
    return jnp.asarray(x, dtype=dtype)


def _sorted_map(m):
    """(dst, src) index pair sorted by dst, as device arrays — lets the
    ghost-refresh scatters claim unique_indices + indices_are_sorted."""
    dst, src = (np.asarray(a) for a in m)
    o = np.argsort(dst, kind="stable")
    return (jnp.asarray(dst[o]), jnp.asarray(src[o]))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Stencil:
    """Device-resident padded ELL stencil (see offline/ell.py).

    Layout: node axis last.  cols/trans are [K, n] gather indices.
    """

    cols: jax.Array  # [K, n] int32
    cij: jax.Array  # [dim, K, n]
    mij: jax.Array  # [K, n]
    mask: jax.Array  # [K, n]
    trans: jax.Array  # [K, n] int32 (flattened over [K, n])
    cii: jax.Array  # [dim, n]
    m_lumped: jax.Array  # [n]
    m_lumped_inv: jax.Array  # [n]
    n_nbrs: jax.Array  # [n]
    node_mask: jax.Array  # [n]
    measure_inv: jax.Array  # scalar
    # dG incidence matrix beta_ij [K, n] (offline_data.template.h:809-940);
    # None for a continuous ansatz:
    incidence: Optional[jax.Array] = None

    @property
    def K(self) -> int:
        return self.cols.shape[0]

    def nbr(self, X: jax.Array) -> jax.Array:
        """Gather neighbor values: [..., n] -> [..., K, n]."""
        return X[..., self.cols]

    def transpose_edge(self, E: jax.Array) -> jax.Array:
        """Transposed-edge gather: out[..., k, i] = E at the (j -> i) edge."""
        K, n = self.cols.shape
        flat = E.reshape(E.shape[:-2] + (K * n,))
        return flat[..., self.trans]

def _edge_vec(x):
    """Host [n, K, dim] -> device [dim, K, n]."""
    return np.transpose(x, (2, 1, 0))


def _stencil_from_ell(ell: EllData, dtype=jnp.float64) -> Stencil:
    """Transpose host ELL arrays into the node-last device layout.

    ell.trans holds flat indices into the row-major [n, K] edge numbering;
    the device layout flattens [K, n], so (j, k_rev) -> k_rev * n + j.
    """
    K = ell.max_degree
    n = ell.n_pad
    j = ell.trans // K
    k_rev = ell.trans % K
    trans = (k_rev * n + j).T
    return Stencil(
        cols=jnp.asarray(ell.cols.T.astype(np.int32)),
        cij=_f(_edge_vec(ell.cij), dtype),
        mij=_f(ell.mij.T, dtype),
        mask=_f(ell.mask.T, dtype),
        trans=jnp.asarray(trans.astype(np.int32)),
        cii=_f(ell.cii.T, dtype),
        m_lumped=_f(ell.lumped_mass, dtype),
        m_lumped_inv=_f(1.0 / ell.lumped_mass, dtype),
        n_nbrs=_f(ell.n_nbrs, dtype),
        node_mask=_f(ell.node_mask, dtype),
        measure_inv=_f(1.0 / ell.measure_of_omega, dtype),
        incidence=(
            None if ell.incidence is None else _f(ell.incidence.T, dtype)
        ),
    )


@partial(
    jax.tree_util.register_dataclass,
    meta_fields=("shape", "offsets", "ghosts", "slab_spec", "minor_wrap"),
    data_fields=(
        "cij", "mij", "mask", "cii", "m_lumped", "m_lumped_inv",
        "n_nbrs", "node_mask", "measure_inv", "gmap_node", "gmap_edge",
        "incidence", "gmap_node_z", "gmap_edge_z",
    ),
)
@dataclasses.dataclass(frozen=True)
class StructuredStencil:
    """Lattice-canvas stencil: neighbor access by static shifts, no gathers.

    Node axis last, canvas-flattened.  `nbr` and `transpose_edge` reshape
    the node axis to the canvas and use jnp.roll with static shifts
    (slice + concat, no gather).  Wrapped-in values at non-periodic
    canvas edges correspond to masked edges; for the periodic minor axis
    the wrap is exactly the periodic identification.  Periodic LEADING
    axes instead carry ghost bands (offline/structured.py ghosts): their
    wrapped values are copied into the ghost rows by `refresh_ghosts`,
    which nbr/transpose_edge apply before shifting.  The transposed slot
    of offset k is K-1-k (lattice_offsets ordering).
    """

    shape: Tuple[int, ...]
    offsets: Tuple[Tuple[int, ...], ...]
    ghosts: Tuple[Optional[Tuple[int, int]], ...]

    cij: jax.Array  # [dim, K, n]
    mij: jax.Array  # [K, n]
    mask: jax.Array  # [K, n]
    cii: jax.Array  # [dim, n]
    m_lumped: jax.Array  # [n]
    m_lumped_inv: jax.Array  # [n]
    n_nbrs: jax.Array  # [n]
    node_mask: jax.Array  # [n]
    measure_inv: jax.Array  # scalar
    slab_spec: Optional[Tuple[int, int, int]] = None
    # Multi-block cross-interface refresh maps (offline/multiblock.py):
    # (dst, src) int32 index pairs — gmap_node over canvas cells, gmap_edge
    # over the flattened [K * n] device edge layout:
    gmap_node: Optional[Tuple[jax.Array, jax.Array]] = None
    gmap_edge: Optional[Tuple[jax.Array, jax.Array]] = None
    # Periodic minor axis padded to the minor padding width: (P, W) — ghost
    # cols [P, P+reach) <- [0, reach), [W-reach, W) <- [P-reach, P)
    # (StructuredData.minor_wrap):
    minor_wrap: Optional[Tuple[int, int]] = None
    # dG incidence matrix beta_ij [K, n] (None for a continuous ansatz):
    incidence: Optional[jax.Array] = None
    # z-vectorized multi-block refresh maps (extruded quilts,
    # offline/multiblock.py pack_multiblock_extruded): one 2D map
    # applied to every z plane — (dst2, src2) cells of the [H*W]
    # cross-section, and (dst_k, dst2, src_k, src2) for edge arrays:
    gmap_node_z: Optional[Tuple[jax.Array, jax.Array]] = None
    gmap_edge_z: Optional[Tuple[jax.Array, ...]] = None

    @property
    def K(self) -> int:
        return len(self.offsets)

    @property
    def reach(self) -> int:
        return max(abs(o) for off in self.offsets for o in off)

    @property
    def have_ghosts(self) -> bool:
        return (
            any(g is not None for g in self.ghosts)
            or self.slab_spec is not None
            or self.gmap_node is not None
            or self.gmap_node_z is not None
            or self.minor_wrap is not None
        )

    def refresh_ghosts(self, X: jax.Array) -> jax.Array:
        """Copy the wrapped real rows into the ghost bands of [..., n]."""
        if not self.have_ghosts:
            return X
        if self.gmap_node is not None:
            dst, src = self.gmap_node
            X = X.at[..., dst].set(
                X[..., src], unique_indices=True, indices_are_sorted=True
            )
        if self.gmap_node_z is not None:
            # extruded multi-block: one cross-section map per z plane,
            # the D axis free-riding as a leading slice
            dst2, src2 = self.gmap_node_z
            D = self.shape[0]
            n2p = self.shape[1] * self.shape[2]
            Xr = X.reshape(X.shape[:-1] + (D, n2p))
            Xr = Xr.at[..., dst2].set(
                Xr[..., src2],
                unique_indices=True, indices_are_sorted=True,
            )
            X = Xr.reshape(X.shape)
        return self._roll_ghosts(X)

    def _roll_ghosts(self, X: jax.Array) -> jax.Array:
        """The band/slab/minor-wrap (whole-row copy) part of the ghost
        refresh — shared by the node and edge refresh paths."""
        lead = X.shape[:-1]
        Xc = X.reshape(lead + self.shape)
        if self.slab_spec is not None:
            # slab ghosts of canvas axis 0: a cyclic roll along the slab
            # axis — a collective-permute when that axis is sharded
            n_sl, Ls, g = self.slab_spec
            A = Ls + 2 * g
            Xs = Xc.reshape(lead + (n_sl, A) + self.shape[1:])
            a = len(lead) + 1
            top = jnp.roll(
                jax.lax.slice_in_dim(Xs, Ls, Ls + g, axis=a), 1,
                axis=len(lead),
            )
            bot = jnp.roll(
                jax.lax.slice_in_dim(Xs, g, 2 * g, axis=a), -1,
                axis=len(lead),
            )
            Xs = jax.lax.dynamic_update_slice_in_dim(Xs, top, 0, a)
            Xs = jax.lax.dynamic_update_slice_in_dim(Xs, bot, g + Ls, a)
            Xc = Xs.reshape(lead + self.shape)
        for ax, gh in enumerate(self.ghosts):
            if gh is None:
                continue
            g, P = gh
            a = len(lead) + ax
            top = jax.lax.slice_in_dim(Xc, P, P + g, axis=a)
            bot = jax.lax.slice_in_dim(Xc, g, 2 * g, axis=a)
            Xc = jax.lax.dynamic_update_slice_in_dim(Xc, top, 0, a)
            Xc = jax.lax.dynamic_update_slice_in_dim(Xc, bot, g + P, a)
        if self.minor_wrap is not None:
            # periodic minor axis on a padded canvas: 2*reach ghost
            # columns realize the identification (last, for corner
            # completeness)
            P, W = self.minor_wrap
            r = self.reach
            a = Xc.ndim - 1
            c0 = jax.lax.slice_in_dim(Xc, 0, r, axis=a)
            Xc = jax.lax.dynamic_update_slice_in_dim(Xc, c0, P, a)
            cP = jax.lax.slice_in_dim(Xc, P - r, P, axis=a)
            Xc = jax.lax.dynamic_update_slice_in_dim(Xc, cP, W - r, a)
        return Xc.reshape(X.shape)

    def _shift(self, Xc: jax.Array, off) -> jax.Array:
        d = len(self.shape)
        axes = tuple(range(Xc.ndim - d, Xc.ndim))
        return jnp.roll(Xc, tuple(-o for o in off), axis=axes)

    def nbr(self, X: jax.Array) -> jax.Array:
        """[..., n] -> [..., K, n] via K static canvas shifts."""
        X = self.refresh_ghosts(X)
        lead = X.shape[:-1]
        Xc = X.reshape(lead + self.shape)
        out = jnp.stack(
            [self._shift(Xc, off) for off in self.offsets],
            axis=len(lead),
        )
        return out.reshape(lead + (len(self.offsets),) + X.shape[-1:])

    def refresh_edges(self, E: jax.Array) -> jax.Array:
        """Refresh ghost values of an edge array [..., K, n].

        Band/slab ghosts copy whole rows (uniform slot layout), so the
        node refresh applies per slot.  Multi-block ghosts instead apply
        the reader-frame slot permutation gmap_edge — as a (slot, cell)
        two-index scatter so the node axis never merges with the
        (replicated) slot axis, which keeps the op GSPMD-partitionable
        when the node axis is sharded (slabified multi-block canvases).
        A slabified canvas needs BOTH: gmap first (owner slots propagate
        into ring cells), then the slab-axis roll copies the refreshed
        edge rows into the ghost bands."""
        if self.gmap_edge is not None:
            dst, src = self.gmap_edge
            n = E.shape[-1]
            E = E.at[..., dst // n, dst % n].set(
                E[..., src // n, src % n],
                unique_indices=True, indices_are_sorted=True,
            )
            return self._roll_ghosts(E)
        if self.gmap_edge_z is not None:
            # extruded multi-block: the slot permutation is z-preserving,
            # so scatter (k, cell2) pairs with the D axis as a window dim
            # (vmapped over z -> one batched scatter of D-length rows)
            kd, cd, ks, cs = self.gmap_edge_z
            K = E.shape[-2]
            D = self.shape[0]
            n2p = self.shape[1] * self.shape[2]
            lead = E.shape[:-2]
            B = 1
            for s in lead:
                B *= s
            E4 = E.reshape((B, K, D, n2p))

            def _sc(x):  # [B, K, n2p]
                return x.at[:, kd, cd].set(
                    x[:, ks, cs],
                    unique_indices=True, indices_are_sorted=True,
                )

            E4 = jax.vmap(_sc, in_axes=2, out_axes=2)(E4)
            E = E4.reshape(E.shape)
            return self._roll_ghosts(E)
        return self.refresh_ghosts(E)

    def transpose_edge(self, E: jax.Array) -> jax.Array:
        """[..., K, n] -> [..., K, n]: out[..., k, i] = E[..., K-1-k, i+off_k]."""
        E = self.refresh_edges(E)
        K = E.shape[-2]
        lead = E.shape[:-2]
        Ec = E.reshape(lead + (K,) + self.shape)
        kax = len(lead)
        out = jnp.stack(
            [
                self._shift(jnp.take(Ec, K - 1 - k, axis=kax), off)
                for k, off in enumerate(self.offsets)
            ],
            axis=kax,
        )
        return out.reshape(E.shape)

    @staticmethod
    def from_data(sd: StructuredData, dtype=jnp.float64) -> "StructuredStencil":
        return StructuredStencil(
            shape=tuple(sd.shape),
            offsets=tuple(map(tuple, sd.offsets)),
            ghosts=tuple(getattr(sd, "ghosts", ()) or
                         (None,) * len(sd.shape)),
            slab_spec=getattr(sd, "slab_spec", None),
            cij=_f(_edge_vec(sd.cij), dtype),
            mij=_f(sd.mij.T, dtype),
            mask=_f(sd.mask.T, dtype),
            cii=_f(sd.cii.T, dtype),
            m_lumped=_f(sd.lumped_mass, dtype),
            m_lumped_inv=_f(1.0 / sd.lumped_mass, dtype),
            n_nbrs=_f(sd.n_nbrs, dtype),
            node_mask=_f(sd.node_mask, dtype),
            measure_inv=_f(1.0 / sd.measure_of_omega, dtype),
            gmap_node=(
                None if getattr(sd, "gmap_node", None) is None
                else _sorted_map(sd.gmap_node)
            ),
            gmap_edge=(
                None if getattr(sd, "gmap_edge", None) is None
                else _sorted_map(sd.gmap_edge)
            ),
            minor_wrap=getattr(sd, "minor_wrap", None),
            incidence=(
                None if getattr(sd, "incidence", None) is None
                else _f(sd.incidence.T, dtype)
            ),
            gmap_node_z=(
                None if getattr(sd, "gmap_node_z", None) is None
                else tuple(
                    jnp.asarray(np.asarray(a), jnp.int32)
                    for a in sd.gmap_node_z
                )
            ),
            gmap_edge_z=(
                None if getattr(sd, "gmap_edge_z", None) is None
                else tuple(
                    jnp.asarray(np.asarray(a), jnp.int32)
                    for a in sd.gmap_edge_z
                )
            ),
        )



# ---------------------------------------------------------------------------
# Phase functions: the IDP substep split at its global synchronisation
# points (tau reduction, F/l halo exchanges).  Each phase is pure math over
# node-last arrays; all neighbor-gathered inputs are passed in explicitly,
# so the same code serves the canvas and ELL layouts and the extraordinary-
# vertex side rows.
# ---------------------------------------------------------------------------


def phase_e_alpha(eq, p, sa, U, prec, U_j, prec_j, half=False):
    """Step 2 (forward half): directed wavespeed products e_ij and alpha_i.

    e[k, i] = ||c_ij|| * lambda_max(U_i, U_j, n_ij).  The backward product
    ||c_ji|| * lambda_max(U_j, U_i, n_ji) equals the transposed-edge gather
    of e exactly: cij_t is constructed as the transpose-roll of cij
    (offline/structured.py StructuredData.cij_t), so the forward evaluation
    at node j for the opposite offset sees bit-identical inputs.  Callers
    therefore form d = max(e, transpose_edge(e)) * mask — one Riemann
    evaluation per directed edge, half of evaluating both directions, and
    the local analog of the reference's upper-triangle + transposed
    exchange symmetrization (hyperbolic_module.template.h:432-490).

    Returns (e [K, n] unmasked, alpha [n]).
    """
    dtype = U.dtype
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)

    norm = jnp.sqrt(jnp.sum(sa.cij * sa.cij, axis=0))  # [K, n]
    n_ij = sa.cij / jnp.maximum(norm, tiny)[None]

    U_i = U[:, None]
    prec_i = prec[:, None]
    kw = {}
    if hasattr(eq, "riemann_precompute"):
        # node-local (p, a) hoisted out of the per-edge Riemann solve
        kw["pa_i"] = eq.riemann_precompute(U)
        kw["pa_j"] = eq.riemann_precompute(U_j)
    if half:
        # symmetric lambda (eq.riemann_symmetric): evaluate only the
        # first K/2 directed slots; callers rebuild the full d via
        # d_from_lambda (the K-1-k slot at the neighbor holds the same
        # undirected edge).  Returns RAW lambda (no |c_ij| factor).
        K2 = sa.cij.shape[1] // 2
        U_jh, prec_jh, n_h = U_j[:, :K2], prec_j[:, :K2], n_ij[:, :K2]
        if "pa_j" in kw:
            kw["pa_j"] = tuple(x[:K2] for x in kw["pa_j"])
        e = eq.riemann_lambda_max(
            U_i, U_jh, n_h, prec_i=prec_i, prec_j=prec_jh,
            newton_iterations=p.riemann_newton_max_iterations,
            newton_tol=p.riemann_newton_tolerance, **kw,
        )
    else:
        lam_f = eq.riemann_lambda_max(
            U_i, U_j, n_ij, prec_i=prec_i, prec_j=prec_j,
            newton_iterations=p.riemann_newton_max_iterations,
            newton_tol=p.riemann_newton_tolerance, **kw,
        )
        e = norm * lam_f

    hd_i = sa.m_lumped * sa.measure_inv
    alpha = eq.indicator_alpha(
        U, prec, U_j, prec_j, sa.cij, sa.mask, hd_i,
        evc_factor=p.evc_factor,
    )
    return e, alpha


def _boundary_pair_data(st, dtype):
    """Host precompute of the coupling-boundary-pair slots for the
    symmetric-Riemann path: directed slots k < K/2 whose transposed edge
    coefficient c_ji differs from -c_ij (both endpoints on the domain
    boundary, offline_data.template.h:1367-1462).  Returns device arrays
    {k, i, j, n_T, w_fwd, w_rev} or None when no such slots exist."""
    cij = np.asarray(st.cij, np.float64)  # [dim, K, n]
    mask = np.asarray(st.mask)
    cT = np.asarray(st.transpose_edge(jnp.asarray(cij)))
    K = mask.shape[0]
    K2 = K // 2
    mis = np.linalg.norm(cij + cT, axis=0)
    scale = np.linalg.norm(cij, axis=0) + np.linalg.norm(cT, axis=0)
    # restrict to real rows: ghost-band rows carry copied coefficients
    # whose transpose-mismatch is meaningless (and the outer slab bands
    # may hold wrapped garbage)
    nm = np.asarray(st.node_mask) > 0
    mismatch = (mask > 0) & (mis > 1.0e-10 * np.maximum(scale, 1e-300))
    mismatch &= nm[None]
    kk, nn = np.nonzero(mismatch[:K2])
    if len(kk) == 0:
        return None
    if hasattr(st, "cols"):
        jj = np.asarray(st.cols)[kk, nn]
    else:  # StructuredStencil: neighbor = rolled flat index (any dim)
        shape = st.shape
        offs = np.asarray(st.offsets)
        midx = np.stack(np.unravel_index(nn, shape), axis=1)  # [m, nd]
        midx = (midx + offs[kk]) % np.asarray(shape)[None]
        jj = np.ravel_multi_index(tuple(midx.T), shape)
        if st.gmap_node is not None:
            # multi-block: a neighbor may be a ghost cell; remap to its
            # owner so U reads see real (non-refreshed) values
            dst, src = (np.asarray(a) for a in st.gmap_node)
            own = np.arange(int(np.prod(shape)), dtype=np.int64)
            own[dst] = src
            jj = own[jj]
        if getattr(st, "slab_spec", None) is not None:
            # slab canvas: a neighbor across a slab boundary sits in a
            # ghost band whose U value is refreshed only inside nbr();
            # the fixup gathers U directly, so remap to the owner row
            # (top ghost [0, g) <- slab s-1 local Ls+a, bottom ghost
            # [g+Ls, A) <- slab s+1 local a-Ls, both cyclic — matching
            # _fill_slab_ghosts).  Without this the fixup reads stale
            # ghost values whenever a slab boundary cuts through a
            # coupling-boundary-pair region (e.g. the step notch row).
            n_sl, Ls, g = st.slab_spec
            A = Ls + 2 * g
            midx_j = np.stack(np.unravel_index(jj, shape), axis=1)
            r = midx_j[:, 0]
            s_sl = r // A
            a_loc = r - s_sl * A
            r_owner = np.where(
                a_loc < g,
                ((s_sl - 1) % n_sl) * A + Ls + a_loc,
                np.where(
                    a_loc >= g + Ls,
                    ((s_sl + 1) % n_sl) * A + (a_loc - Ls),
                    r,
                ),
            )
            midx_j[:, 0] = r_owner
            jj = np.ravel_multi_index(tuple(midx_j.T), shape)
        if st.minor_wrap is not None:
            # padded periodic minor axis: neighbors at the 2*reach ghost
            # columns remap to their owner columns (cols [P, P+r) -> [0,
            # r), cols [W-r, W) -> [P-r, P)) so U reads see real values
            P, W = st.minor_wrap
            r = st.reach
            midx_j = np.stack(np.unravel_index(jj, shape), axis=1)
            mx = midx_j[:, -1]
            mx = np.where((mx >= P) & (mx < P + r), mx - P, mx)
            mx = np.where(mx >= W - r, mx - (W - P), mx)
            midx_j[:, -1] = mx
            jj = np.ravel_multi_index(tuple(midx_j.T), shape)
    c_f = cij[:, kk, nn]
    c_r = cT[:, kk, nn]
    nf = np.linalg.norm(c_f, axis=0)
    nr = np.linalg.norm(c_r, axis=0)
    cmax = np.maximum(nf, nr)
    n_T = c_r / np.maximum(nr, 1e-300)[None]
    return {
        "k": jnp.asarray(kk.astype(np.int32)),
        "i": jnp.asarray(nn.astype(np.int32)),
        "j": jnp.asarray(jj.astype(np.int32)),
        "n_T": jnp.asarray(n_T, dtype),
        "w_fwd": jnp.asarray(nf / np.maximum(cmax, 1e-300), dtype),
        "w_rev": jnp.asarray(nr / np.maximum(cmax, 1e-300), dtype),
    }


def d_from_lambda(st, lam_half, mask):
    """d = lambda * max(|c_ij|, |c_ji|) from the half-slot symmetric
    lambda (one Riemann solve per undirected edge).  The max over both
    |c| factors reproduces the reference's coupling-boundary-pair fixup
    d_ij = max(d_ij, d_ji) (hyperbolic_module.template.h:461-490) for
    slots whose lambda is direction-independent; direction-DEPENDENT
    boundary slots are corrected beforehand by
    HyperbolicModule._lambda_fixup."""
    K = mask.shape[0]
    K2 = K // 2
    lam_pad = jnp.concatenate(
        [lam_half, jnp.zeros_like(lam_half)], axis=0
    )
    lam_T = st.transpose_edge(lam_pad)[K2:]
    lam_full = jnp.concatenate([lam_half, lam_T], axis=0)
    norm = jnp.sqrt(jnp.sum(st.cij * st.cij, axis=0))
    cmax = jnp.maximum(norm, st.transpose_edge(norm))
    return jnp.where(
        mask > 0, lam_full * cmax, jnp.zeros_like(lam_full)
    )


def d_from_e(mask, e, e_T):
    """Step 2 (symmetrization): d = max(e_ij, e_ji) on unmasked edges.

    jnp.where (not multiplication by the mask) so that garbage at masked
    slots (never-refreshed ghost rows) cannot poison d (NaN * 0 == NaN)."""
    return jnp.where(mask > 0, jnp.maximum(e, e_T), jnp.zeros_like(e))


class Sideband:
    """Extraordinary-vertex side rows of a multi-block canvas.

    Rows whose stencil exceeds the canvas 8-neighborhood (valence != 4
    block corners, StructuredData.ev_side) are recomputed here on a tiny
    ELL stencil — one XLA evaluation of each phase over O(#EV) rows —
    and scattered back into the canvas arrays after each phase, so
    every other row keeps the shift stencil.  The reference
    handles such rows for free in its uniform CSR loop
    (sparse_matrix_simd.h:63-297); this is the canvas rendition.

    Gathers read OWNER cells (always-valid values, no refresh needed);
    the transposed-edge gathers (`trans`) read regular reader rows of
    the flat [K * n] canvas edge layout; the e/l scatter (`edst/esrc`)
    writes each side edge's value to its owner slot (when embedded) and
    to every reader's transpose-route entry (disjoint by the canvas
    frame, deduplicated and dst-sorted at pack time)."""

    def __init__(self, eq, params, sd, dtype,
                 initial_precomputed=None):
        ev = sd.ev_side
        self.eq, self.p = eq, params
        self.dtype = dtype
        n = sd.n_pad
        self.cells = jnp.asarray(ev["cells"], jnp.int32)  # [r]
        self.cols = jnp.asarray(ev["cols_cell"].T, jnp.int32)  # [Ks, r]
        # flat k * n + cell entries split into (slot, cell) index pairs:
        # two-index gathers/scatters keep the node axis intact, so the ops
        # stay GSPMD-partitionable when the node axis is sharded (a flat
        # [K * n] reshape merges the replicated slot axis with the sharded
        # node axis and forces a state-sized all-gather):
        tk, tc = np.divmod(np.asarray(ev["trans"].T, np.int64), n)
        self.trans_k = jnp.asarray(tk, jnp.int32)  # [Ks, r]
        self.trans_c = jnp.asarray(tc, jnp.int32)  # [Ks, r]
        # side-internal transpose (EV-EV edges, e.g. the coarse interface
        # line of a 2:1 AMR interface): indices into the [r, Ks] flat side
        # edge layout where >= 0; the canvas trans applies elsewhere:
        ts = np.asarray(
            ev.get("trans_side",
                   np.full(ev["trans"].shape, -1, np.int64))
        ).T  # [Ks, r]
        self._has_side_trans = bool((ts >= 0).any())
        self.trans_side = jnp.asarray(np.maximum(ts, 0), jnp.int32)
        self.trans_is_side = jnp.asarray(ts >= 0)
        dk, dc = np.divmod(np.asarray(ev["edst"], np.int64), n)
        self.edst_k = jnp.asarray(dk, jnp.int32)
        self.edst_c = jnp.asarray(dc, jnp.int32)
        self.esrc = jnp.asarray(ev["esrc"], jnp.int32)  # into [r, Ks] flat
        r = len(ev["rows"])
        self.n_rows = r
        mask = np.asarray(ev["mask"].T)  # [Ks, r]
        m_l = np.asarray(ev["m_lumped"])
        self.st = Stencil(
            cols=self.cols,
            cij=_f(np.transpose(ev["cij"], (2, 1, 0)), dtype),  # [dim,Ks,r]
            mij=_f(ev["mij"].T, dtype),
            mask=_f(mask, dtype),
            trans=self.trans_c,  # unused (canvas gathers done here)
            cii=_f(ev["cii"].T, dtype),
            m_lumped=_f(m_l, dtype),
            m_lumped_inv=_f(1.0 / m_l, dtype),
            n_nbrs=_f(np.maximum(ev["n_nbrs"], 1), dtype),
            node_mask=_f(np.ones(r), dtype),
            measure_inv=_f(1.0 / sd.measure_of_omega, dtype),
        )
        ip = initial_precomputed
        if ip is None or ip.shape[0] == 0:
            Ks = mask.shape[0]
            self.ip = jnp.zeros((0, r), dtype)
            self.ip_j = jnp.zeros((0, Ks, r), dtype)
        else:
            self.ip = ip[:, self.cells]
            self.ip_j = ip[:, self.cols]

    # -- gather helpers ----------------------------------------------------
    def ctr(self, X):
        return X[..., self.cells]

    def nbr(self, X):
        return X[..., self.cols]

    def edge_T(self, E, side_vals=None):
        """Transposed-edge gather from the [K, n] canvas edge layout;
        side-internal entries (EV-EV edges) read the side's own values
        [Ks, r] instead."""
        out = E[self.trans_k, self.trans_c]
        if self._has_side_trans:
            sv = side_vals.T.reshape(-1)[self.trans_side]
            out = jnp.where(self.trans_is_side, sv, out)
        return out

    def scatter_edge(self, E, vals):
        """Scatter side edge values [Ks, r] into the canvas edge array
        [K, n] at every consumer entry (owner slots + reader routes).
        Two-index (slot, cell) scatter; edst is flat-sorted at pack time,
        i.e. lexicographic in (slot, cell)."""
        v = vals.T.reshape(-1)[self.esrc]
        return E.at[self.edst_k, self.edst_c].set(
            v, unique_indices=True, indices_are_sorted=True
        )

    # -- phases ------------------------------------------------------------
    def e_alpha(self, U, prec):
        U_j, prec_j = self.nbr(U), self.nbr(prec)
        e, alpha = phase_e_alpha(
            self.eq, self.p, self.st, self.ctr(U), self.ctr(prec),
            U_j, prec_j,
        )
        return e, alpha

    def d_side(self, e_side, e_canvas):
        e_T = self.edge_T(e_canvas, side_vals=e_side)
        return d_from_e(self.st.mask, e_side, e_T)

    def tau_side(self, d, cfl, tau_cap):
        return tau_max_from_d(self.st, d, cfl, tau_cap)

    def low_order(self, U, prec, d, alpha, tau, stage_U, stage_prec,
                  stage_weights):
        S = stage_U.shape[0] if stage_U is not None else 0
        st = self.st
        sU = stage_U[:, :, self.cells] if S else stage_U
        sP = stage_prec[:, :, self.cells] if S else stage_prec
        sUj = (jnp.stack([self.nbr(stage_U[s]) for s in range(S)])
               if S else None)
        sPj = (jnp.stack([self.nbr(stage_prec[s]) for s in range(S)])
               if S else None)
        return phase_low_order(
            self.eq, self.p, st, self.ctr(U), self.ctr(prec),
            self.nbr(U), self.nbr(prec), d, self.ctr(alpha),
            self.nbr(alpha), tau, sU, sP, sUj, sPj, stage_weights,
            self.ip, self.ip_j,
        )

    def p_l1(self, U, prec, d, alpha, tau, F, m_lumped, U_low_side,
             bounds_side, stage_U, stage_prec, stage_weights):
        S = stage_U.shape[0] if stage_U is not None else 0
        sU = stage_U[:, :, self.cells] if S else stage_U
        sP = stage_prec[:, :, self.cells] if S else stage_prec
        sUj = (jnp.stack([self.nbr(stage_U[s]) for s in range(S)])
               if S else None)
        sPj = (jnp.stack([self.nbr(stage_prec[s]) for s in range(S)])
               if S else None)
        return phase_p_l1(
            self.eq, self.p, self.st, self.ctr(U), self.ctr(prec),
            self.nbr(U), self.nbr(prec), d, self.ctr(alpha),
            self.nbr(alpha), tau, self.ctr(F), self.nbr(F),
            self.nbr(m_lumped), U_low_side, bounds_side,
            sU, sP, sUj, sPj, stage_weights, self.ip, self.ip_j,
        )

    def update(self, U_side, bounds_side, P_side, l_side, l_canvas, last):
        l_T = self.edge_T(l_canvas, side_vals=l_side)
        return phase_update(
            self.eq, self.p, self.st, U_side, bounds_side, P_side,
            l_side, l_T, last, mask_lT=True,
        )


def tau_max_from_d(sa, d, cfl, tau_cap):
    """Step 3: tau_max = min_i cfl m_i / (-2 d_ii)  (reference :494-564)."""
    dtype = d.dtype
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
    d_sum = -jnp.sum(d, axis=0)
    d_sum = jnp.minimum(d_sum, -1.0e6 * tiny)  # (reference :545-546)
    tau_i = cfl * sa.m_lumped / (-2.0 * d_sum)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    tau_max = jnp.min(jnp.where(sa.node_mask > 0, tau_i, big))
    return jnp.minimum(tau_max, tau_cap)


def _expand_edges(flux):
    """Insert a broadcast edge axis before the node axis."""
    return jax.tree.map(lambda x: jnp.expand_dims(x, x.ndim - 1), flux)


def _fluxes(eq, sa, prec, init_prec, U, U_j, prec_j, init_prec_j):
    """Edge and diagonal flux divergences (+ the raw flux contributions).

    flux contributions are opaque pytrees (a flux tensor for Euler, a
    (U, Z) tuple for shallow water); evaluating them on the gathered
    neighbor states equals gathering the nodal contributions since they
    are pointwise in (precomputed, initial_precomputed, U).
    """
    flux_i = eq.flux_contribution(prec, init_prec, U)
    flux_j = eq.flux_contribution(prec_j, init_prec_j, U_j)
    flux_i_e = _expand_edges(flux_i)
    flux_ij = eq.flux_divergence(flux_i_e, flux_j, sa.cij)
    flux_ii = eq.flux_divergence(flux_i, flux_i, sa.cii)
    return flux_i, flux_i_e, flux_j, flux_ij, flux_ii


def _graph_dU(eq, U, U_j, flux_i_e, flux_j):
    """The d_ij (U_j - U_i) difference; shallow water replaces the states
    with the hydrostatically reconstructed (equilibrated) states
    (hyperbolic_module.template.h:781-795)."""
    if getattr(eq, "have_equilibrated_states", False):
        U_star_ij, U_star_ji = eq.equilibrated_states(flux_i_e, flux_j)
        return U_star_ji - U_star_ij
    return U_j - U[:, None]


def _hof_divergence(eq, flux_a, flux_b, c):
    if getattr(eq, "have_high_order_flux", False):
        return eq.high_order_flux_divergence(flux_a, flux_b, c)
    return eq.flux_divergence(flux_a, flux_b, c)


def _stage_terms(eq, sa, m, stage_U, stage_prec, stage_U_j, stage_prec_j,
                 stage_weights, init_prec, init_prec_j, tau, want_P):
    """Accumulated stage contributions via lax.cond slots.

    Returns (F_increment [C, n], P_increment [C, K, n] or scalar 0).
    """
    S = stage_U.shape[0] if stage_U is not None else 0
    F_acc = None
    P_acc = None
    for s in range(S):
        w_s = stage_weights[s]

        def _compute(_, s=s, w_s=w_s):
            flux_s_i = eq.flux_contribution(
                stage_prec[s], init_prec, stage_U[s]
            )
            flux_s_j = eq.flux_contribution(
                stage_prec_j[s], init_prec_j, stage_U_j[s]
            )
            hof_s = _hof_divergence(
                eq, _expand_edges(flux_s_i), flux_s_j, sa.cij,
            )
            hof_s_ii = _hof_divergence(eq, flux_s_i, flux_s_i, sa.cii)
            F_inc = jnp.sum(hof_s * m, axis=1) + hof_s_ii
            P_inc = hof_s
            if getattr(eq, "have_source_terms", False):
                S_js = eq.nodal_source(stage_prec_j[s], stage_U_j[s], tau)
                S_is = eq.nodal_source(stage_prec[s], stage_U[s], tau)
                m_ii = sa.m_lumped - jnp.sum(sa.mij * sa.mask, axis=0)
                F_inc = (
                    F_inc
                    + jnp.sum(sa.mij[None] * S_js * m, axis=1)
                    + m_ii[None] * S_is
                )
                P_inc = P_inc + sa.mij[None] * S_js
            if not want_P:
                P_inc = jnp.zeros((), F_inc.dtype)
            return w_s * F_inc, w_s * P_inc

        def _zero(_, s=s):
            shape_P = (
                stage_U[s].shape[:1] + sa.mask.shape
                if want_P
                else ()
            )
            return (
                jnp.zeros_like(stage_U[s]),
                jnp.zeros(shape_P, stage_U.dtype),
            )

        F_inc, P_inc = jax.lax.cond(w_s != 0.0, _compute, _zero, None)
        F_acc = F_inc if F_acc is None else F_acc + F_inc
        if want_P:
            P_acc = P_inc if P_acc is None else P_acc + P_inc
    return F_acc, P_acc


def _stage_source_sum(eq, stage_prec, stage_U, stage_weights, tau):
    """sum_s w_s S(U_s) for the nodal source accumulation S_iH."""
    S = stage_U.shape[0] if stage_U is not None else 0
    acc = None
    for s in range(S):
        w_s = stage_weights[s]
        inc = jax.lax.cond(
            w_s != 0.0,
            lambda _, s=s, w_s=w_s: w_s * eq.nodal_source(
                stage_prec[s], stage_U[s], tau
            ),
            lambda _, s=s: jnp.zeros_like(stage_U[s]),
            None,
        )
        acc = inc if acc is None else acc + inc
    return acc


def _affine_shift(eq, sa, flux_i, flux_i_e, flux_j, d, tau, S_i):
    """Shallow-water affine shift accumulated over the stencil incl. the
    diagonal (hyperbolic_module.template.h:692-721)."""
    shift = 0.0
    if getattr(eq, "have_equilibrated_states", False):
        B = eq.affine_shift(flux_i_e, flux_j, sa.cij, d)
        d_ii = -jnp.sum(d, axis=0)
        B_ii = eq.affine_shift(flux_i, flux_i, sa.cii, d_ii)
        shift = (
            jnp.sum(B * sa.mask[None], axis=1) + B_ii
        ) * (tau * sa.m_lumped_inv)[None]
    if getattr(eq, "have_source_terms", False):
        shift = shift + tau * S_i
    return shift


def phase_low_order(eq, p, sa, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
                    stage_U, stage_prec, stage_U_j, stage_prec_j,
                    stage_weights, init_prec, init_prec_j):
    """Step 4: low-order update, high-order RHS F_i, limiter bounds.

    Returns (U_low [C, n], F [C, n], bounds [B, n]).
    """
    dtype = U.dtype
    S = stage_U.shape[0] if stage_U is not None else 0
    weight = 1.0 - (jnp.sum(stage_weights) if S else 0.0)

    factor = 0.5 * (alpha[None] + alpha_j)
    if getattr(sa, "incidence", None) is not None:
        # dG: force low-order dissipation across element interfaces
        # (hyperbolic_module.template.h:733-737):
        factor = jnp.maximum(factor, sa.incidence)
    d_H = d * factor
    regularization = jnp.asarray(
        100.0 * np.finfo(np.dtype(dtype)).tiny, dtype
    )
    scaled_c_ij = sa.cij / jnp.maximum(d, regularization)[None]

    flux_i, flux_i_e, flux_j, flux_ij, flux_ii = _fluxes(
        eq, sa, prec, init_prec, U, U_j, prec_j, init_prec_j
    )
    dU = _graph_dU(eq, U, U_j, flux_i_e, flux_j)
    m = sa.mask[None]

    have_src = getattr(eq, "have_source_terms", False)
    S_i = eq.nodal_source(prec, U, tau) if have_src else None
    S_j = eq.nodal_source(prec_j, U_j, tau) if have_src else None

    U_low = U + (tau * sa.m_lumped_inv)[None] * (
        jnp.sum((flux_ij + d[None] * dU) * m, axis=1) + flux_ii
    )
    if have_src:
        U_low = U_low + tau * S_i

    if getattr(eq, "have_high_order_flux", False):
        hof_ij = eq.high_order_flux_divergence(flux_i_e, flux_j, sa.cij)
        hof_ii = eq.high_order_flux_divergence(flux_i, flux_i, sa.cii)
    else:
        hof_ij, hof_ii = flux_ij, flux_ii

    F = (
        jnp.sum((d_H[None] * dU + weight * hof_ij) * m, axis=1)
        + weight * hof_ii
    )
    if have_src:
        # The reference accumulates F += m_i S_iH then F -= m_ij S_iH over
        # the whole row (hyperbolic_module.template.h:686, :816-820); with
        # m_i = sum_j m_ij (incl. diagonal) these cancel exactly, leaving
        # only the neighbor-source part weight sum_j m_ij S_j + stages:
        m_ii = sa.m_lumped - jnp.sum(sa.mij * sa.mask, axis=0)
        F = F + weight * (
            jnp.sum(sa.mij[None] * S_j * m, axis=1) + m_ii[None] * S_i
        )
    if S:
        F_inc, _ = _stage_terms(
            eq, sa, m, stage_U, stage_prec, stage_U_j, stage_prec_j,
            stage_weights, init_prec, init_prec_j, tau, want_P=False,
        )
        F = F + F_inc

    hd_i = sa.m_lumped * sa.measure_inv
    if getattr(eq, "limiter_needs_fluxes", False):
        shift = _affine_shift(eq, sa, flux_i, flux_i_e, flux_j, d, tau, S_i)
        bounds = eq.limiter_bounds(
            U, prec, U_j, prec_j, scaled_c_ij, sa.mask, hd_i,
            relaxation_factor=p.limiter_relaxation_factor,
            flux_i=flux_i_e, flux_j=flux_j, affine_shift=shift,
        )
    else:
        bounds = eq.limiter_bounds(
            U, prec, U_j, prec_j, scaled_c_ij, sa.mask, hd_i,
            relaxation_factor=p.limiter_relaxation_factor,
        )
    return U_low, F, bounds


def phase_p_l1(eq, p, sa, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
               F, F_j, m_j, U_low, bounds,
               stage_U, stage_prec, stage_U_j, stage_prec_j, stage_weights,
               init_prec, init_prec_j):
    """Step 5: P_ij with mass-matrix correction + first limiter pass.

    Returns (P [C, K, n], l [K, n], success [K, n]).
    """
    S = stage_U.shape[0] if stage_U is not None else 0
    weight = 1.0 - (jnp.sum(stage_weights) if S else 0.0)

    factor = 0.5 * (alpha[None] + alpha_j)
    if getattr(sa, "incidence", None) is not None:
        # dG: force low-order dissipation across element interfaces
        # (hyperbolic_module.template.h:733-737):
        factor = jnp.maximum(factor, sa.incidence)
    d_H = d * factor
    flux_i, flux_i_e, flux_j, flux_ij, _ = _fluxes(
        eq, sa, prec, init_prec, U, U_j, prec_j, init_prec_j
    )
    dU = _graph_dU(eq, U, U_j, flux_i_e, flux_j)

    if getattr(eq, "have_high_order_flux", False):
        hof_ij = eq.high_order_flux_divergence(flux_i_e, flux_j, sa.cij)
    else:
        hof_ij = flux_ij

    P = -flux_ij + weight * hof_ij + (d_H - d)[None] * dU
    have_src = getattr(eq, "have_source_terms", False)
    if have_src:
        S_i = eq.nodal_source(prec, U, tau)
        S_j = eq.nodal_source(prec_j, U_j, tau)
        P = P - sa.mij[None] * S_i[:, None] + weight * sa.mij[None] * S_j
    if S:
        m = sa.mask[None]
        _, P_inc = _stage_terms(
            eq, sa, m, stage_U, stage_prec, stage_U_j, stage_prec_j,
            stage_weights, init_prec, init_prec_j, tau, want_P=True,
        )
        P = P + P_inc

    # The diagonal P_ii entry is never applied: the reference's steps 5
    # and 6 skip the diagonal column (hyperbolic_module.template.h:963,
    # :1090 "Skip diagonal").
    b_ij = -sa.mij / m_j  # kronecker term vanishes off-diagonal
    b_ji = -sa.mij * sa.m_lumped_inv[None]
    P = P + b_ij[None] * F_j - b_ji[None] * F[:, None]
    P = P * (tau * sa.m_lumped_inv * sa.n_nbrs)[None, None]

    psi0 = (
        eq.limiter_psi0(bounds[:, None], U_low[:, None])
        if hasattr(eq, "limiter_psi0") else None
    )
    l, success = eq.limiter_limit(
        bounds[:, None],
        U_low[:, None],
        P,
        newton_iterations=p.limiter_newton_max_iterations,
        newton_tol=p.limiter_newton_tolerance,
        **({"psi0": psi0} if psi0 is not None else {}),
    )
    return P, l, success


def phase_update(eq, p, sa, U_cur, bounds, P, l, l_T, last: bool,
                 mask_lT: bool = False):
    """Steps 6/7: symmetrized limited high-order update.

    The diagonal column is skipped, matching the reference
    (hyperbolic_module.template.h:1090).  l_T is the transposed-edge
    gather of l (caller-provided).  When not `last`, also returns the
    next-pass l' = (1 - l_sym) l2 implementing the reference shortcut
    (hyperbolic_module.template.h:1163-1170).

    mask_lT: where()-select the transposed read at masked slots.  Needed
    when the canvas has rows whose inputs are never refreshed (multi-
    block ghost rings, slab ghost bands, extraordinary-vertex rows):
    their garbage can be NaN, and NaN * 0 == NaN would poison the update
    through the masked slot.  Plain single-block canvases hold masked
    rows at finite safe values, so they skip the extra select (it costs
    a full [K, n] pass per limiter iteration).
    """
    if mask_lT:
        l_sym = jnp.where(
            sa.mask > 0, jnp.minimum(l, l_T), jnp.zeros_like(l)
        )
    else:
        l_sym = jnp.minimum(l, l_T)
    lam_i = (1.0 / sa.n_nbrs)[None]
    U_next = U_cur + lam_i * jnp.sum(l_sym[None] * P * sa.mask[None], axis=1)
    if last:
        return U_next, None
    psi0 = (
        eq.limiter_psi0(bounds[:, None], U_next[:, None])
        if hasattr(eq, "limiter_psi0") else None
    )
    l2, _ = eq.limiter_limit(
        bounds[:, None],
        U_next[:, None],
        (1.0 - l_sym)[None] * P,
        newton_iterations=p.limiter_newton_max_iterations,
        newton_tol=p.limiter_newton_tolerance,
        **({"psi0": psi0} if psi0 is not None else {}),
    )
    return U_next, (1.0 - l_sym) * l2


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    """One group of boundary nodes sharing a Boundary id (static arrays)."""

    bc_id: int
    index: np.ndarray  # [k] node ids
    normal: np.ndarray  # [dim, k]
    position: np.ndarray  # [dim, k]


@dataclasses.dataclass(frozen=True)
class HyperbolicModuleParams:
    """Limiter / indicator / riemann solver parameters.

    Mirrors IndicatorParameters, LimiterParameters, RiemannSolverParameters
    (euler/indicator.h:21-38, euler/limiter.h:19-61, euler/riemann_solver.h:19-47).
    """

    evc_factor: float = 1.0
    limiter_iterations: int = 2
    limiter_newton_max_iterations: int = 2
    limiter_newton_tolerance: float = 1.0e-10
    limiter_relaxation_factor: float = 1.0
    riemann_newton_max_iterations: int = 0
    riemann_newton_tolerance: float = 1.0e-10


class HyperbolicModule:
    """Owns the stencil + boundary data and provides prepare/step.

    `initial_state_fn(positions [dim, ...], t) -> states [C, ...]` supplies
    Dirichlet data (the analog of InitialValues::initial_state,
    /root/reference/source/initial_values.h:94-125).
    """

    def __init__(
        self,
        equation,
        ell,
        initial_state_fn: Callable,
        params: HyperbolicModuleParams = HyperbolicModuleParams(),
        dtype=jnp.float64,
        initial_precomputed: Optional[jax.Array] = None,
    ):
        self.eq = equation
        self.params = params
        self.dtype = dtype
        if isinstance(ell, StructuredData):
            self.stencil = StructuredStencil.from_data(ell, dtype)
        else:
            self.stencil = _stencil_from_ell(ell, dtype)
        self.initial_state_fn = initial_state_fn
        self.n_pad = ell.n_pad
        if initial_precomputed is None:
            initial_precomputed = jnp.zeros(
                (equation.n_initial_precomputed, ell.n_pad), dtype=dtype
            )
        self.initial_precomputed = initial_precomputed

        # extraordinary-vertex side rows (multi-block canvases with
        # valence != 4 block corners, offline/multiblock.py ev_side):
        self._sideband = None
        if getattr(ell, "ev_side", None) is not None:
            self._sideband = Sideband(
                equation, params, ell, dtype,
                initial_precomputed=self.initial_precomputed,
            )

        # Flatten boundary rounds into a static list.  Indices are sorted
        # so the per-substep BC scatters can claim sorted+unique:
        self.boundary: List[BoundaryCondition] = []
        for rnd in ell.boundary_rounds:
            for bc_id in sorted(rnd.keys()):
                g = rnd[bc_id]
                o = np.argsort(np.asarray(g.index), kind="stable")
                self.boundary.append(
                    BoundaryCondition(
                        bc_id=int(bc_id),
                        index=np.asarray(g.index)[o],
                        normal=g.normal.T[:, o],
                        position=g.position.T[:, o],
                    )
                )

        # Dense BC application for canvas stencils: static per-(round, id)
        # masks + a normal canvas; apply_boundary_conditions is pointwise
        # in (U, normal, dirichlet), so evaluating it on the full canvas
        # and where-selecting the group rows is bitwise-identical to the
        # gather/transform/scatter route (the ELL layout keeps it).  The
        # scatter route costs per boundary row, the dense route a few
        # full-canvas passes per group: a 2D mesh (1D boundary) keeps the
        # scatter, a 3D box (2D surface) goes dense.  The n_pad // 32
        # cutoff is not measured on the H100 yet.
        n_bc_rows = sum(
            len(g.index)
            for rnd in ell.boundary_rounds
            for bc_id, g in rnd.items()
            if bc_id != Boundary.do_nothing
        )
        _dense_env = _os.environ.get("RYUJIN_DENSE_BC")  # force for tests
        self._bc_dense = None
        if isinstance(self.stencil, StructuredStencil) and (
            _dense_env == "1"
            or (_dense_env != "0" and n_bc_rows > ell.n_pad // 32)
        ):
            rounds = []
            needs_dirichlet = False
            for rnd in ell.boundary_rounds:
                groups = []
                for bc_id in sorted(rnd.keys()):
                    if bc_id == Boundary.do_nothing:
                        continue
                    g = rnd[bc_id]
                    idx = np.asarray(g.index)
                    m = np.zeros(ell.n_pad, dtype)
                    m[idx] = 1.0
                    nrm = np.zeros((g.normal.shape[1], ell.n_pad))
                    nrm[:, idx] = g.normal.T
                    groups.append((
                        int(bc_id),
                        jnp.asarray(m, dtype),
                        jnp.asarray(nrm, dtype),
                    ))
                    if bc_id in (Boundary.dirichlet, Boundary.dynamic,
                                 Boundary.dirichlet_momentum):
                        needs_dirichlet = True
                if groups:
                    rounds.append(groups)
            if rounds:
                self._bc_dense = rounds
                self._bc_needs_dirichlet = needs_dirichlet
                self._positions = jnp.asarray(
                    np.asarray(ell.positions).T, dtype
                )

        # symmetric-Riemann setup: the list of directed slots whose
        # c_ji != -c_ij (coupling boundary pairs) needing the reference's
        # two-direction fixup (hyperbolic_module.template.h:461-490).
        # Only the lattice stencil guarantees the k <-> K-1-k transposed
        # slot pairing d_from_lambda relies on; the generic ELL transpose
        # is an arbitrary permutation, so ELL keeps the two-direction
        # evaluation.  Multi-block canvases (offline/multiblock.py) break
        # the pairing at the O(interface) directed edges that cross a
        # block interface; those are corrected by `_interface_fixup`
        # (sd.sym_fixup, evaluated two-directionally in XLA) while the
        # block interiors keep the half-slot evaluation:
        # Multi-block half-slot evaluation is OFF by default (opt in with
        # RYUJIN_SYM_MB=1; tests/test_multiblock.py runs both paths):
        # whether halving the Riemann solves pays for the half refresh +
        # interface fixup glue is not measured on the H100.
        sym_mb_enabled = _os.environ.get("RYUJIN_SYM_MB") == "1"
        sym = bool(getattr(equation, "riemann_symmetric", False))
        is_canvas = isinstance(self.stencil, StructuredStencil)
        multiblock = is_canvas and (
            self.stencil.gmap_edge is not None
            or self.stencil.gmap_edge_z is not None
        )
        sym_fix = getattr(ell, "sym_fixup", None)
        self._sym_riemann = sym and is_canvas and not multiblock
        self._sym_mb = (
            sym and multiblock and sym_fix is not None and sym_mb_enabled
        )
        self._bp = (
            _boundary_pair_data(self.stencil, dtype)
            if (self._sym_riemann or self._sym_mb)
            else None
        )
        # The boundary-pair fixup is a gather/scatter over the coupling
        # set, so a LARGE set (a 3D box's whole 2D surface) can cost more
        # than the half-Riemann shortcut saves.  Evaluate both directions
        # instead when the set exceeds ~n/16 slot pairs — a 2D mesh (1D
        # boundary, O(sqrt n) pairs) keeps the shortcut.  The cutoff is
        # not measured on the H100 yet.
        if (
            self._sym_riemann
            and self._bp is not None
            and int(self._bp["k"].shape[0]) > max(1024, ell.n_pad // 16)
        ):
            self._sym_riemann = False
            self._bp = None
        self._if = None
        self._gmap_half = None
        if self._sym_mb:
            tiny = float(np.finfo(np.dtype(dtype)).tiny)
            c_f = np.asarray(sym_fix["c_f"], np.dtype(dtype))
            c_r = np.asarray(sym_fix["c_r"], np.dtype(dtype))
            nf = np.sqrt(np.sum(c_f * c_f, axis=1))
            nr = np.sqrt(np.sum(c_r * c_r, axis=1))
            icm = np.asarray(sym_fix["inv_cmax"], np.dtype(dtype))
            # the scatter value is cmax-normalized so the downstream
            # d = lam_entry * cmax reconstruction recovers the exact
            # two-direction max(lam |c_f|, lam |c_r|):
            self._if = {
                "dst": jnp.asarray(sym_fix["dst"], jnp.int32),
                "i": jnp.asarray(sym_fix["i"], jnp.int32),
                "j": jnp.asarray(sym_fix["j"], jnp.int32),
                "n_f": jnp.asarray(
                    (c_f / np.maximum(nf, tiny)[:, None]).T, dtype
                ),
                "n_r": jnp.asarray(
                    (c_r / np.maximum(nr, tiny)[:, None]).T, dtype
                ),
                "w_f": jnp.asarray(nf * icm, dtype),
                "w_r": jnp.asarray(nr * icm, dtype),
            }
            # half-canvas ghost refresh: gmap_edge entries whose dst AND
            # src slots are < K/2 (the flat k * n + cell indices are the
            # same in the [K/2, n] layout); entries with an uncomputed
            # source slot are exactly the broken routes the fixup covers
            dst, src = (np.asarray(a) for a in self.stencil.gmap_edge)
            n_flat = ell.n_pad
            K2n = (self.stencil.K // 2) * n_flat
            keep = (dst < K2n) & (src < K2n)
            hd, hs = dst[keep], src[keep]
            o = np.argsort(hd, kind="stable")
            self._gmap_half = (
                jnp.asarray(hd[o], jnp.int32), jnp.asarray(hs[o], jnp.int32)
            )

    def _lambda_fixup(self, lam, Up, prec):
        """Correct the half-slot lambda at coupling boundary pairs:
        set lam_hat = max(lam_fwd |c_ij|, lam_rev |c_ji|) / cmax so that
        d = lam_hat * cmax equals the reference's max(d_ij, d_ji)."""
        bp = self._bp
        if bp is None:
            return lam
        eq = self.eq
        p = self.params
        shape = lam.shape
        lam_f = lam.reshape(shape[0], -1)
        U_i = Up[:, bp["i"]]
        U_j = Up[:, bp["j"]]
        prec_i = prec[:, bp["i"]]
        prec_j = prec[:, bp["j"]]
        kw = {}
        if hasattr(eq, "riemann_precompute"):
            kw["pa_i"] = eq.riemann_precompute(U_j)
            kw["pa_j"] = eq.riemann_precompute(U_i)
        lam_rev = eq.riemann_lambda_max(
            U_j, U_i, bp["n_T"], prec_i=prec_j, prec_j=prec_i,
            newton_iterations=p.riemann_newton_max_iterations,
            newton_tol=p.riemann_newton_tolerance, **kw,
        )
        cur = lam_f[bp["k"], bp["i"]]
        val = jnp.maximum(cur * bp["w_fwd"], lam_rev * bp["w_rev"])
        lam_f = lam_f.at[bp["k"], bp["i"]].set(val)
        return lam_f.reshape(shape)

    def _refresh_half(self, lam):
        """Ghost refresh of the HALF lambda canvas [K/2, n]: the
        gmap_edge entries whose destination and source slots both live in
        the computed half (multi-block canvases); sorted unique scatter."""
        if self._gmap_half is None:
            return lam
        dst, src = self._gmap_half
        shape = lam.shape
        lam_f = lam.reshape(-1)
        return lam_f.at[dst].set(
            lam_f[src], unique_indices=True, indices_are_sorted=True
        ).reshape(shape)

    def _interface_fixup(self, lam_half, Up, prec):
        """Evaluate the O(interface) multi-block fixup edges in both
        directions and scatter the cmax-normalized result
        max(lam_f |c_f|, lam_r |c_r|) / cmax into the HALF lambda canvas
        at each broken route's read entry (offline/multiblock.py
        sym_fixup).  The downstream d = lam * cmax reconstruction
        (transpose rolls) then recovers
        the reference's two-direction d_ij = max(d_ij, d_ji)
        (hyperbolic_module.template.h:461-490) at exactly those slots
        while block interiors keep the one-solve-per-undirected-edge
        evaluation."""
        f = self._if
        if f is None or f["dst"].shape[0] == 0:
            return lam_half
        eq, p = self.eq, self.params
        shape = lam_half.shape
        lam_flat = lam_half.reshape(-1)
        U_i, U_j = Up[:, f["i"]], Up[:, f["j"]]
        prec_i, prec_j = prec[:, f["i"]], prec[:, f["j"]]
        kw = {}
        if hasattr(eq, "riemann_precompute"):
            pa_i = eq.riemann_precompute(U_i)
            pa_j = eq.riemann_precompute(U_j)
            kw = {"pa_i": pa_i, "pa_j": pa_j}
        lam_f = eq.riemann_lambda_max(
            U_i, U_j, f["n_f"], prec_i=prec_i, prec_j=prec_j,
            newton_iterations=p.riemann_newton_max_iterations,
            newton_tol=p.riemann_newton_tolerance, **kw,
        )
        if kw:
            kw = {"pa_i": kw["pa_j"], "pa_j": kw["pa_i"]}
        lam_r = eq.riemann_lambda_max(
            U_j, U_i, f["n_r"], prec_i=prec_j, prec_j=prec_i,
            newton_iterations=p.riemann_newton_max_iterations,
            newton_tol=p.riemann_newton_tolerance, **kw,
        )
        val = jnp.maximum(lam_f * f["w_f"], lam_r * f["w_r"])
        return lam_flat.at[f["dst"]].set(
            val, unique_indices=True, indices_are_sorted=True
        ).reshape(shape)

    # ------------------------------------------------------------------
    # Step 1: boundary conditions + precomputation
    # (hyperbolic_module.template.h:96-193)
    # ------------------------------------------------------------------
    def prepare_state_vector(self, U: jax.Array, t,
                             stencil=None) -> Tuple[jax.Array, jax.Array]:
        eq = self.eq
        if stencil is None:
            stencil = self.stencil
        if self._bc_dense is not None:
            dirichlet_full = (
                self.initial_state_fn(self._positions, t)
                if self._bc_needs_dirichlet
                else None
            )
            for groups in self._bc_dense:
                for bc_id, mask, normal in groups:
                    U_b = eq.apply_boundary_conditions(
                        bc_id, U, normal, dirichlet_full
                    )
                    U = jnp.where(mask[None] > 0, U_b, U)
        else:
            for bc in self.boundary:
                if bc.bc_id == Boundary.do_nothing:
                    continue
                idx = jnp.asarray(bc.index)
                normal = _f(bc.normal, self.dtype)
                U_b = U[:, idx]
                dirichlet = None
                if bc.bc_id in (
                    Boundary.dirichlet,
                    Boundary.dynamic,
                    Boundary.dirichlet_momentum,
                ):
                    pos = _f(bc.position, self.dtype)
                    dirichlet = self.initial_state_fn(pos, t)
                U_b = eq.apply_boundary_conditions(
                    bc.bc_id, U_b, normal, dirichlet
                )
                U = U.at[:, idx].set(
                    U_b, unique_indices=True, indices_are_sorted=True
                )

        import inspect

        sig = inspect.signature(eq.precompute).parameters
        prec = None
        for cycle in range(eq.n_precomputation_cycles):
            kwargs = {}
            if "prev" in sig:
                kwargs["prev"] = prec
            if "stencil" in sig:
                kwargs["stencil"] = stencil
            prec = eq.precompute(
                U, self.initial_precomputed, cycle=cycle, **kwargs
            )
        return U, prec

    # ------------------------------------------------------------------
    # Steps 2-7
    # ------------------------------------------------------------------
    def step(
        self,
        U_old: jax.Array,
        prec_old: jax.Array,
        stage_U: jax.Array,
        stage_prec: jax.Array,
        stage_weights: jax.Array,
        tau,
        cfl,
        tau_cap,
        compute_tau=True,
        stencil=None,
    ):
        """One forward-Euler IDP substep.

        Args:
          U_old, prec_old: prepared state (BCs applied, precomputed filled).
          stage_U, stage_prec: stacked high-order stage states [S, C, n] /
            [S, P, n]; S is static, weights select active slots.  A slot
            with weight 0 is skipped at runtime via lax.cond, so one
            compiled substep serves every stage of a Runge-Kutta scheme
            (the reference instead instantiates step<stages> per stage
            count, hyperbolic_module.h:208-223).
          stage_weights: traced [S] stage weights.
          tau: step size (ignored when compute_tau).
          cfl: relative CFL number (traced scalar ok).
          tau_cap: upper bound for the computed tau (t_final - t etc.).
          compute_tau: traced bool; when set, use the computed tau_max
            instead of `tau` (a capped tau_max may legitimately be zero,
            so a tau==0 sentinel cannot express this).
          stencil: the (traced) stencil pytree; defaults to self.stencil.
            Passing it as an argument avoids embedding the mesh arrays as
            jit constants (XLA would constant-fold over the whole mesh at
            compile time).

        Returns (U_new, tau_used, ok).
        """
        eq = self.eq
        st = stencil if stencil is not None else self.stencil
        p = self.params

        U_j = st.nbr(U_old)  # [C, K, n]
        prec_j = st.nbr(prec_old)  # [P, K, n]
        init_prec_j = (
            st.nbr(self.initial_precomputed)
            if self.initial_precomputed.shape[0]
            else jnp.zeros((0,) + st.mask.shape, self.dtype)
        )
        S = stage_U.shape[0] if stage_U is not None else 0
        stage_U_j = (
            jnp.stack([st.nbr(stage_U[s]) for s in range(S)])
            if S else stage_U
        )
        stage_prec_j = (
            jnp.stack([st.nbr(stage_prec[s]) for s in range(S)])
            if S else stage_prec
        )

        # ---- steps 2/3: d_ij (forward + transposed max), alpha, tau_max --
        if self._sym_mb:
            # multi-block half-slot evaluation: interiors pair via the
            # canvas transpose; interface-crossing broken routes read the
            # two-direction fixup values scattered into the half canvas
            # (ghost entries with exactly one consumer each), so the
            # transpose-roll d reconstruction below needs no other change
            lam, alpha = phase_e_alpha(
                eq, p, st, U_old, prec_old, U_j, prec_j, half=True
            )
            lam = self._lambda_fixup(lam, U_old, prec_old)
            lam = self._refresh_half(lam)
            lam = self._interface_fixup(lam, U_old, prec_old)
            K = st.mask.shape[0]
            K2 = K // 2
            # refresh-free transpose rolls (the half canvas's ghost
            # entries are already valid after _refresh_half + fixup):
            lam_c = lam.reshape((K2,) + st.shape)
            lam_T = jnp.stack([
                st._shift(lam_c[K - 1 - k], off)
                for k, off in list(enumerate(st.offsets))[K2:]
            ]).reshape((K - K2,) + lam.shape[1:])
            lam_full = jnp.concatenate([lam, lam_T], axis=0)
            norm = jnp.sqrt(jnp.sum(st.cij * st.cij, axis=0))
            cmax = jnp.maximum(norm, st.transpose_edge(norm))
            d = jnp.where(
                st.mask > 0, lam_full * cmax, jnp.zeros_like(lam_full)
            )
        elif self._sym_riemann:
            lam, alpha = phase_e_alpha(
                eq, p, st, U_old, prec_old, U_j, prec_j, half=True
            )
            lam = self._lambda_fixup(lam, U_old, prec_old)
            d = d_from_lambda(st, lam, st.mask)
        else:
            e, alpha = phase_e_alpha(eq, p, st, U_old, prec_old, U_j, prec_j)
            if self._sideband is not None:
                # extraordinary-vertex rows: full side evaluation, values
                # scattered where readers' transpose routes expect them
                sb = self._sideband
                e_s, alpha_s = sb.e_alpha(U_old, prec_old)
                e = sb.scatter_edge(e, e_s)
                alpha = alpha.at[sb.cells].set(alpha_s)
            d = d_from_e(st.mask, e, st.transpose_edge(e))
        tau_max = tau_max_from_d(st, d, cfl, tau_cap)
        if self._sideband is not None:
            # canvas d_ii at EV rows misses the unembedded edges (tau too
            # large there); the side rows contribute the exact minimum
            d_s = sb.d_side(e_s, e)
            tau_max = jnp.minimum(
                tau_max, sb.tau_side(d_s, cfl, tau_cap)
            )
        tau = jnp.where(compute_tau, tau_max, tau)

        # ---- step 4: low-order update, bounds, F_i ----------------------
        alpha_j = st.nbr(alpha)
        U_low, F, bounds = phase_low_order(
            eq, p, st, U_old, prec_old, U_j, prec_j, d, alpha, alpha_j, tau,
            stage_U, stage_prec, stage_U_j, stage_prec_j, stage_weights,
            self.initial_precomputed, init_prec_j,
        )
        if self._sideband is not None:
            Ul_s, F_s, b_s = sb.low_order(
                U_old, prec_old, d_s, alpha, tau, stage_U, stage_prec,
                stage_weights,
            )
            U_low = U_low.at[:, sb.cells].set(Ul_s)
            F = F.at[:, sb.cells].set(F_s)
            bounds = bounds.at[:, sb.cells].set(b_s)

        if p.limiter_iterations == 0:
            # With zero limiter iterations the reference performs the pure
            # low-order update (step 5 and the 6/7 loop are skipped,
            # hyperbolic_module.template.h:892,1054).
            return U_low, tau, jnp.asarray(True)

        # ---- step 5: mass-matrix correction + first limiter pass --------
        F_j = st.nbr(F)
        m_j = st.nbr(st.m_lumped)
        P, l_ij, success = phase_p_l1(
            eq, p, st, U_old, prec_old, U_j, prec_j, d, alpha, alpha_j, tau,
            F, F_j, m_j, U_low, bounds,
            stage_U, stage_prec, stage_U_j, stage_prec_j, stage_weights,
            self.initial_precomputed, init_prec_j,
        )
        if self._sideband is not None:
            P_s, l_s, succ_s = sb.p_l1(
                U_old, prec_old, d_s, alpha, tau, F, st.m_lumped,
                Ul_s, b_s, stage_U, stage_prec, stage_weights,
            )
            l_ij = sb.scatter_edge(l_ij, l_s)
            # EV rows' partial canvas success is meaningless — the side
            # success replaces it:
            success = success.at[:, sb.cells].set(True)
        ok = jnp.all(
            (success | (st.mask == 0.0)) | (st.node_mask[None] == 0.0)
        )
        if self._sideband is not None:
            ok = ok & jnp.all(succ_s | (sb.st.mask == 0.0))

        # ---- steps 6/7: symmetrize l, high-order update ------------------
        U_new = U_low
        U_side = Ul_s if self._sideband is not None else None
        n_iter = p.limiter_iterations
        for it in range(n_iter):
            last = it + 1 == n_iter
            U_next, l_next = phase_update(
                eq, p, st, U_new, bounds, P, l_ij,
                st.transpose_edge(l_ij), last,
                mask_lT=(getattr(st, "gmap_edge", None) is not None
                         or getattr(st, "gmap_edge_z", None) is not None
                         or getattr(st, "slab_spec", None) is not None
                         or self._sideband is not None),
            )
            if self._sideband is not None:
                # side pass reads the SAME-pass canvas l (transpose):
                U_side, l_s_next = sb.update(
                    U_side, b_s, P_s, l_s, l_ij, last
                )
                U_next = U_next.at[:, sb.cells].set(U_side)
                if not last:
                    l_next = sb.scatter_edge(l_next, l_s_next)
                    l_s = l_s_next
            U_new, l_ij = U_next, l_next

        return U_new, tau, ok

