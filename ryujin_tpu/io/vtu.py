"""Minimal VTU (VTK XML unstructured grid) writer.

Analog of /root/reference/source/vtu_output.template.h: writes
the conserved components, primitive components, selected precomputed
fields, the indicator alpha, and postprocessor fields as point data over
the Q1 mesh.  Pure-python ascii/base64 writer — no VTK dependency.
"""

from __future__ import annotations

import base64
import struct
from typing import Dict, Optional, Sequence

import numpy as np

_VTK_CELL = {1: 3, 2: 9, 3: 12}  # line, quad, hexahedron
# deal.II vertex ordering -> VTK ordering per cell type:
_VTK_PERM = {
    1: [0, 1],
    2: [0, 1, 3, 2],
    3: [0, 1, 3, 2, 4, 5, 7, 6],
}


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode("ascii")


def write_vtu(
    filename: str,
    mesh,
    point_data: Dict[str, np.ndarray],
    cell_mask: Optional[np.ndarray] = None,
) -> None:
    """Write mesh + nodal fields (values per raw mesh vertex) to `filename`.

    cell_mask: optional bool [n_cells]; only selected cells (and the
    vertices they reference) are written — the analog of deal.II's
    DataOut::set_cell_selection used for the reference's level-set
    restricted output (vtu_output.template.h:156-199)."""
    dim = mesh.dim
    sel_cells = mesh.cells if cell_mask is None else mesh.cells[cell_mask]
    used = np.unique(sel_cells.ravel())
    remap = -np.ones(mesh.n_vertices, np.int64)
    remap[used] = np.arange(len(used))
    pts = np.zeros((len(used), 3), dtype=np.float32)
    pts[:, :dim] = mesh.vertices[used]
    point_data = {k: np.asarray(v)[used] for k, v in point_data.items()}
    cells = remap[sel_cells][:, _VTK_PERM[dim]].astype(np.int64)
    n_cells, nv = cells.shape

    connectivity = cells.ravel()
    offsets = np.arange(1, n_cells + 1, dtype=np.int64) * nv
    types = np.full(n_cells, _VTK_CELL[dim], dtype=np.uint8)

    with open(filename, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n'
        )
        f.write("  <UnstructuredGrid>\n")
        f.write(
            f'    <Piece NumberOfPoints="{len(pts)}" '
            f'NumberOfCells="{n_cells}">\n'
        )
        f.write("      <Points>\n")
        f.write(
            '        <DataArray type="Float32" NumberOfComponents="3" '
            'format="binary">\n'
        )
        f.write(_b64(pts) + "\n")
        f.write("        </DataArray>\n      </Points>\n")
        f.write("      <Cells>\n")
        f.write(
            '        <DataArray type="Int64" Name="connectivity" '
            'format="binary">\n' + _b64(connectivity) + "\n        "
            "</DataArray>\n"
        )
        f.write(
            '        <DataArray type="Int64" Name="offsets" '
            'format="binary">\n' + _b64(offsets) + "\n        </DataArray>\n"
        )
        f.write(
            '        <DataArray type="UInt8" Name="types" '
            'format="binary">\n' + _b64(types) + "\n        </DataArray>\n"
        )
        f.write("      </Cells>\n")
        f.write("      <PointData>\n")
        for name, values in point_data.items():
            v = np.asarray(values, dtype=np.float32).ravel()
            assert v.shape[0] == len(pts), (name, v.shape, len(pts))
            f.write(
                f'        <DataArray type="Float32" Name="{name}" '
                'format="binary">\n' + _b64(v) + "\n        </DataArray>\n"
            )
        f.write("      </PointData>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


class VTUOutput:
    """Schedules VTU output of solution fields (vtu_output.h:29-120)."""

    def __init__(self, eq, mesh, packed, postprocessor=None,
                 use_primitive: bool = True,
                 manifolds: Sequence[str] = (),
                 vtu_output_quantities: Sequence[str] = ()):
        self.eq = eq
        self.mesh = mesh
        self.packed = packed
        self.postprocessor = postprocessor
        self.use_primitive = use_primitive
        self.vtu_output_quantities = tuple(vtu_output_quantities)
        # level-set expressions restricting the companion "-levelsets" file
        # to cut cells (vtu_output.template.h:47-51, 156-199):
        self.manifolds = tuple(manifolds)
        self._levelset_mask = None
        if self.manifolds:
            v = mesh.vertices
            env = {"__builtins__": {}, "np": np, "x": v[:, 0],
                   "pi": np.pi}
            if mesh.dim >= 2:
                env["y"] = v[:, 1]
            if mesh.dim >= 3:
                env["z"] = v[:, 2]
            env.update({k: getattr(np, k) for k in
                        ("sin", "cos", "exp", "sqrt", "abs")})
            mask = np.zeros(mesh.n_cells, bool)
            eps = 100.0 * np.finfo(np.float64).eps
            for expr in self.manifolds:
                lvl = np.broadcast_to(
                    np.asarray(eval(expr, dict(env))),  # noqa: S307 (config)
                    (mesh.n_vertices,),
                )
                cl = lvl[mesh.cells]  # [nc, nv]
                above = (cl >= -eps).any(axis=1)
                below = (cl <= eps).any(axis=1)
                mask |= above & below
            self._levelset_mask = mask

    def _vertex_values(self, x: np.ndarray) -> np.ndarray:
        """Packed nodal values [n_pad] -> mesh vertex values [n_vertices].

        cG spaces read the vertex dofs directly; dG spaces average the
        co-located corner dofs of all adjacent cells (the standard
        projection deal.II's DataOut applies to discontinuous fields)."""
        nv = self.mesh.n_vertices
        v2n = self.packed.vertex_to_node
        ansatz = getattr(self.packed, "ansatz", "cG Q1")
        if ansatz.startswith("cG"):
            return x[v2n[:nv]]
        if not hasattr(self, "_dg_corners"):
            from ..offline.ansatz import build_dof_map, parse_ansatz

            _, p = parse_ansatz(ansatz)
            dm = build_dof_map(self.mesh, ansatz)
            n1 = p + 1
            if self.mesh.dim == 1:
                slots = [0, p]
            else:
                slots = [0, p, p * n1, p * n1 + p]
            self._dg_corners = (
                self.mesh.cells.ravel(),
                v2n[dm.cell_dofs[:, slots].ravel()],
            )
        verts, nodes = self._dg_corners
        acc = np.zeros(nv)
        cnt = np.zeros(nv)
        np.add.at(acc, verts, x[nodes])
        np.add.at(cnt, verts, 1.0)
        return acc / np.maximum(cnt, 1.0)

    def schedule_output(self, filename: str, U, alpha=None) -> None:
        import jax.numpy as jnp

        U_np = np.asarray(U)
        data: Dict[str, np.ndarray] = {}
        for k, name in enumerate(self.eq.component_names):
            data[name] = self._vertex_values(U_np[k])
        if self.use_primitive:
            prim = np.asarray(self.eq.to_primitive_state(jnp.asarray(U_np)))
            for k, name in enumerate(self.eq.primitive_component_names):
                if name not in data:
                    data[name] = self._vertex_values(prim[k])
        if alpha is not None:
            data["alpha"] = self._vertex_values(np.asarray(alpha))
        if self.postprocessor is not None:
            fields = self.postprocessor.compute(jnp.asarray(U_np))
            for name, f in zip(self.postprocessor.component_names, fields):
                data[name] = self._vertex_values(np.asarray(f))
        if self.vtu_output_quantities:
            # selected_components_extractor analog: validate + filter
            unknown = set(self.vtu_output_quantities) - set(data)
            if unknown:
                raise ValueError(
                    f"unknown vtu output quantities: {sorted(unknown)}"
                )
            data = {k: data[k] for k in self.vtu_output_quantities}
        write_vtu(filename, self.mesh, data)
        if self._levelset_mask is not None and self._levelset_mask.any():
            stem = filename[:-4] if filename.endswith(".vtu") else filename
            write_vtu(stem + "-levelsets.vtu", self.mesh, data,
                      cell_mask=self._levelset_mask)
