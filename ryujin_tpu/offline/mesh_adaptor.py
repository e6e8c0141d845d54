"""AMR driver: adaptation / marking / time-point selection strategies.

The analog of the reference's MeshAdaptor
(/root/reference/source/mesh_adaptor.h:22-160, mesh_adaptor.template.h) and
of the TimeLoop's adapt_mesh_and_transfer_state_vector
(time_loop.template.h:616-689).  Here mesh adaptation is a host-side
event: the mesh is locally refined (offline/mesh.py refine_local, which
enforces 2:1 balance and records hanging-node constraints), offline data is
re-assembled and re-packed, the solution is transferred through the Q1
embedding, and the solver modules are rebuilt (a re-jit with the new static
shapes).

Strategies (mesh_adaptor.h:22-60):
  * adaptation: "global refinement" | "random adaptation" (testing only)
  * marking: "fixed number" (refine the top `refinement_fraction` of
    cells by indicator AND coarsen the bottom `coarsening_fraction` —
    both halves of the reference's fixed-number marking,
    mesh_adaptor.h:133-149; coarsening merges complete sibling quartets
    back into their parent, offline/mesh.py coarsen_local)
  * time point selection: "fixed adaptation time points"
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .mesh import Mesh, coarsen_local, refine_local


class MeshAdaptor:
    """Decides when and where to adapt the mesh.

    Mirrors MeshAdaptor::{prepare, analyze,
    mark_cells_for_coarsening_and_refinement} (mesh_adaptor.h:127-150).
    """

    def __init__(
        self,
        adaptation_strategy: str = "global refinement",
        marking_strategy: str = "fixed number",
        time_point_selection_strategy: str = "fixed adaptation time points",
        adaptation_time_points: Sequence[float] = (),
        refinement_fraction: float = 0.3,
        coarsening_fraction: float = 0.3,
        random_seed: int = 42,
    ):
        if adaptation_strategy not in (
            "global refinement", "random adaptation"
        ):
            raise ValueError(
                f"unknown adaptation strategy '{adaptation_strategy}'"
            )
        if marking_strategy != "fixed number":
            raise ValueError(f"unknown marking strategy '{marking_strategy}'")
        if time_point_selection_strategy != "fixed adaptation time points":
            raise ValueError(
                "unknown time point selection strategy "
                f"'{time_point_selection_strategy}'"
            )
        self.adaptation_strategy = adaptation_strategy
        self.marking_strategy = marking_strategy
        self.time_point_selection_strategy = time_point_selection_strategy
        self.adaptation_time_points: List[float] = list(
            adaptation_time_points
        )
        self.refinement_fraction = refinement_fraction
        self.coarsening_fraction = coarsening_fraction
        # deterministic Mersenne Twister, like the reference's
        # random_adaptation_mersenne_twister_seed_ (mesh_adaptor.h:159):
        self._rng = np.random.Generator(np.random.MT19937(random_seed))
        self.need_mesh_adaptation = False

    def prepare(self, t: float) -> None:
        """Drop outdated time points; reset the adaptation flag."""
        self.adaptation_time_points = [
            tp for tp in self.adaptation_time_points if t <= tp
        ]
        self.need_mesh_adaptation = False

    def analyze(self, state_vector, t: float, cycle: int) -> None:
        """Pop passed adaptation time points and raise the flag."""
        del state_vector, cycle
        remaining = []
        for tp in self.adaptation_time_points:
            if t < tp:
                remaining.append(tp)
            else:
                self.need_mesh_adaptation = True
        self.adaptation_time_points = remaining

    def mark_cells(self, mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
        """Return (refine, coarsen) flags [n_cells] per the strategies.

        Fixed-number marking refines the top `refinement_fraction` of
        cells by indicator and coarsens the bottom `coarsening_fraction`
        (mesh_adaptor.h:133-149, dealii refine_and_coarsen_fixed_number).
        """
        nc = mesh.n_cells
        if self.adaptation_strategy == "global refinement":
            return np.ones(nc, bool), np.zeros(nc, bool)
        # random adaptation (mesh_adaptor.template.h:166-173):
        indicators = self._rng.uniform(0.0, 10.0, nc)
        n_ref = int(round(self.refinement_fraction * nc))
        n_coarse = int(round(self.coarsening_fraction * nc))
        refine = np.zeros(nc, bool)
        coarsen = np.zeros(nc, bool)
        order = np.argsort(indicators)
        if n_ref:
            refine[order[::-1][:n_ref]] = True
        if n_coarse:
            coarsen[order[:n_coarse]] = True
        coarsen &= ~refine
        return refine, coarsen

    def adapt(self, mesh: Mesh):
        """Mark + coarsen + refine; returns (new_mesh, transfer CSR).

        The analog of dealii execute_coarsening_and_refinement +
        SolutionTransfer (time_loop.template.h:616-689): coarsening marks
        are applied first (complete flagged sibling quartets merge), then
        refinement marks — carried across the coarsening's cell
        renumbering — are applied with 2:1 closure; the two transfer
        matrices compose.
        """
        refine, coarsen = self.mark_cells(mesh)
        m1, t1, cell_map = coarsen_local(mesh, coarsen)
        r1 = np.zeros(m1.n_cells, bool)
        keep = cell_map >= 0
        r1[cell_map[keep]] = refine[keep]
        m2, t2 = refine_local(m1, r1)
        return m2, t2 @ t1


def transfer_state(
    U_packed: np.ndarray,
    old_packed,
    old_mesh: Mesh,
    transfer,
    new_mesh: Mesh,
    new_packed,
) -> np.ndarray:
    """Interpolate a packed state vector onto an adapted mesh.

    The analog of dealii SolutionTransfer::interpolate
    (time_loop.template.h:649-689): packed node values -> raw vertex values
    (reconstructing hanging nodes from their parents) -> Q1 embedding via the
    `transfer` CSR matrix from refine_local -> re-pack on the new node
    numbering.  U_packed is [..., n_pad_old]; returns [..., n_pad_new].
    """
    U = np.asarray(U_packed)
    lead = U.shape[:-1]
    raw = U[..., old_packed.vertex_to_node]  # [..., n_raw_old]
    if old_mesh.hanging is not None and len(old_mesh.hanging):
        h, a, b = (old_mesh.hanging[:, k] for k in range(3))
        raw[..., h] = 0.5 * (raw[..., a] + raw[..., b])
    flat = raw.reshape(-1, raw.shape[-1])  # [k, n_raw_old]
    new_raw = (transfer @ flat.T).T.reshape(lead + (transfer.shape[0],))
    # scatter through node_to_vertex: works for the padded-ELL layout
    # (real rows first) AND canvas layouts (real rows at lattice cells);
    # padded/masked cells receive a safe uniform state, not zeros, so
    # masked-row garbage stays finite (interpolate_nodal semantics):
    out = np.empty(lead + (new_packed.n_pad,), U.dtype)
    out[...] = new_raw[..., :1]
    ntv = np.asarray(new_packed.node_to_vertex)
    sel = np.flatnonzero(ntv >= 0)
    out[..., sel] = new_raw[..., ntv[sel]]
    return out
