"""ryujin_tpu: a JAX framework for hyperbolic systems of conservation
laws with the capabilities of conservation-laws/ryujin.

Compute path: JAX/XLA over padded ELL stencils or structured lattice
canvases (2D/3D, periodic via ghost bands).  Several devices: the node
axis of the state and of every stencil array is sharded over a
jax.sharding.Mesh and GSPMD inserts the halo exchange
(parallel/sharding.py).
"""

__version__ = "0.1.0"
