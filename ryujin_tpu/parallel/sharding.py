"""Multi-chip SPMD partitioning of the node graph.

The analog of the reference's MPI domain decomposition
(/root/reference/source/offline_data.h:136-169 and the SparseMatrixSIMD
ghost-row exchange, sparse_matrix_simd.h:299-420): instead of explicit
ghost layers and MPI_Isend/Irecv target lists, the node axis of the state
and of all stencil arrays is sharded over a 1D jax.sharding.Mesh and XLA
GSPMD inserts the halo collectives (collective-permute for the structured
shift stencil, all-gathers for ELL gathers) automatically.

Usage:
    mesh = make_device_mesh()                       # all local devices
    hm.stencil = shard_stencil(hm.stencil, mesh, packed.n_pad)
    U = shard_state(U, mesh)
    with mesh:
        U, tau, ok = time_integrator.step(U, t)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

NODE_AXIS = "nodes"


def make_device_mesh(n_devices: Optional[int] = None, axis_name=NODE_AXIS):
    """1D device mesh over the first n (default: all) local devices."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices() if n_devices is None else jax.devices()[:n_devices]
    return Mesh(np.array(devices), axis_names=(axis_name,))


def node_sharding(device_mesh, ndim: int, axis_name=NODE_AXIS):
    """NamedSharding partitioning the LAST axis (the node axis)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(
        device_mesh, P(*([None] * (ndim - 1) + [axis_name]))
    )


def shard_state(X, device_mesh, axis_name=NODE_AXIS):
    """Place a state array [..., n_pad] with its node axis sharded."""
    import jax

    return jax.device_put(X, node_sharding(device_mesh, X.ndim, axis_name))


def shard_stencil(stencil, device_mesh, n_pad: int, axis_name=NODE_AXIS):
    """Shard every stencil array whose trailing axis is the node axis.

    Works for both the ELL `Stencil` and the `StructuredStencil` (their
    static meta fields are left untouched).  Scalars and arrays without a
    trailing node axis (e.g. measure_inv) are replicated.
    """
    import jax

    def place(x):
        if (
            hasattr(x, "ndim")
            and x.ndim >= 1
            and x.shape[-1] == n_pad
        ):
            return jax.device_put(
                x, node_sharding(device_mesh, x.ndim, axis_name)
            )
        return x

    updates = {}
    for f in dataclasses.fields(stencil):
        v = getattr(stencil, f.name)
        if isinstance(v, (tuple, int, float, type(None))):
            continue  # static metadata (shape, offsets, ...)
        updates[f.name] = place(v)
    return dataclasses.replace(stencil, **updates)
