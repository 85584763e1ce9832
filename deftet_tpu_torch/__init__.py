"""deftet_tpu_torch — the PyTorch/CUDA port of deftet_tpu for NVIDIA Hopper.

Same system as ``deftet_tpu`` (deformable tetrahedral mesh reconstruction,
DefTet), written in PyTorch; the three Pallas TPU kernels of the JAX
package are hand-written CUDA C++ kernels for ``sm_90a`` here
(``csrc/``), each with a plain PyTorch version beside it.

Sub-packages mirror the JAX package:

* ``tetgrid`` — numpy grid / lattice-face builders (own copies).
* ``data``    — procedural shapes and the occupancy texture (own copies).
* ``ops``     — geometry, voxelization and the three kernels: the lattice
  stencil (``ops.stencil``), nearest neighbour (``ops.nearest``) and
  triangle argmin (``ops.tri_distance``).
* ``nn``      — PVCNN encoders, GCN position decoder, occupancy MLP.
* ``losses``  — SoA tet regularizers and the compacted surface losses.
* ``evals``   — the occupancy IoU used by the train step.
* ``train``   — statics, ``forward_losses``, the optimizer and ``Engine``.
* ``convert`` — flax ``{"params", "batch_stats"}`` to a torch state dict.

Importing the package compiles nothing and does not touch CUDA; kernels
are built from ``csrc/`` with ``nvcc`` at their first launch.
"""

__version__ = "0.1.0"
