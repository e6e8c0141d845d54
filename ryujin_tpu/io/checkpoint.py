"""Checkpoint / resume.

Analog of TimeLoop::write_checkpoint / read_checkpoint
(/root/reference/source/time_loop.template.h:440-611): the reference
serializes each state component through SolutionTransfer attached to the
p4est triangulation plus a boost metadata archive AND saves the
triangulation itself (`triangulation.save(name + "-checkpoint.mesh")`,
time_loop.template.h:537-611) so a run with mesh adaptation can resume.
Here the packed nodal state, (t, cycle) metadata, and the full mesh arrays
land in a single .npz.  On resume the mesh is reconstructed from the
checkpoint (manifold callables — which only matter for *further*
refinement — are re-attached from the config-built template mesh), so
AMR and checkpointing compose.  Previous files rotate to `~` backups
exactly like the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Tuple

import numpy as np


def mesh_fingerprint(mesh) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.vertices).tobytes())
    h.update(np.ascontiguousarray(mesh.cells).tobytes())
    return h.hexdigest()[:16]


# Optional Mesh array fields serialized verbatim (offline/mesh.py Mesh);
# the callables (manifolds, edge_manifold_selectors) are re-attached from
# the config-built template mesh on resume.
_MESH_OPT = (
    "face_manifold_ids",
    "periodic_pairs",
    "structured_index",
    "hanging",
    "cell_levels",
    "cell_origin",
)


def _mesh_arrays(mesh) -> dict:
    out = {
        "m_dim": np.int64(mesh.dim),
        "m_vertices": np.ascontiguousarray(mesh.vertices),
        "m_cells": np.ascontiguousarray(mesh.cells),
        "m_boundary_faces": np.ascontiguousarray(mesh.boundary_faces),
        "m_boundary_ids": np.ascontiguousarray(mesh.boundary_ids),
    }
    if mesh.structured_shape is not None:
        out["m_structured_shape"] = np.asarray(
            mesh.structured_shape, np.int64
        )
    for name in _MESH_OPT:
        v = getattr(mesh, name)
        if v is not None:
            out[f"m_{name}"] = np.ascontiguousarray(v)
    return out


def restore_mesh(z, template_mesh):
    """Rebuild a Mesh from checkpoint arrays `z` (a dict-like of the
    m_* keys), re-attaching the template's manifold callables."""
    kw = dict(
        dim=int(z["m_dim"]),
        vertices=np.asarray(z["m_vertices"]),
        cells=np.asarray(z["m_cells"]),
        boundary_faces=np.asarray(z["m_boundary_faces"]),
        boundary_ids=np.asarray(z["m_boundary_ids"]),
        structured_shape=(
            tuple(int(s) for s in z["m_structured_shape"])
            if "m_structured_shape" in z
            else None
        ),
    )
    for name in _MESH_OPT:
        key = f"m_{name}"
        kw[name] = np.asarray(z[key]) if key in z else None
    return dataclasses.replace(
        template_mesh,
        manifolds=template_mesh.manifolds,
        edge_manifold_selectors=template_mesh.edge_manifold_selectors,
        **kw,
    )


def write_checkpoint(basename: str, mesh, U, t: float, cycle: int,
                     extra: Optional[dict] = None) -> str:
    """Write `basename-checkpoint.npz` (rotating an existing file to ~).

    extra: additional named arrays serialized alongside the state — the
    driver passes the quantities time-average accumulators so statistics
    survive a resume (the reference serializes the full state vector +
    metadata, time_loop.template.h:537-611)."""
    name = f"{basename}-checkpoint.npz"
    if os.path.exists(name):
        os.replace(name, name + "~")
    np.savez_compressed(
        name,
        U=np.asarray(U),
        t=float(t),
        cycle=int(cycle),
        fingerprint=mesh_fingerprint(mesh),
        **_mesh_arrays(mesh),
        **{f"x_{k}": np.asarray(v) for k, v in (extra or {}).items()},
    )
    return name


def read_checkpoint(
    basename: str, mesh
) -> Tuple[np.ndarray, float, int, dict, Optional[object]]:
    """Load `basename-checkpoint.npz`.

    Returns (U, t, cycle, extra, restored_mesh) where restored_mesh is
    None when the checkpoint matches the config-built `mesh` (resume in
    place) and a reconstructed Mesh when the checkpoint was written on an
    adapted mesh (the caller must rebuild its compute kernels on it —
    the analog of read_checkpoint's load-mesh-then-prepare sequence,
    time_loop.template.h:440-533)."""
    name = f"{basename}-checkpoint.npz"
    with np.load(name, allow_pickle=False) as z:
        fp = str(z["fingerprint"])
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
        restored = None
        if fp != mesh_fingerprint(mesh):
            if "m_vertices" not in z.files:
                raise ValueError(
                    "checkpoint does not match the current discretization "
                    "and stores no mesh (written by an older version)"
                )
            restored = restore_mesh(z, mesh)
        return z["U"], float(z["t"]), int(z["cycle"]), extra, restored
