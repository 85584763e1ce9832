"""deftet_tpu_torch — the PyTorch/CUDA port of deftet_tpu for NVIDIA Hopper.

Same system as ``deftet_tpu`` (deformable tetrahedral mesh reconstruction,
DefTet), written in PyTorch; the three Pallas TPU kernels of the JAX
package, and the rasterizer's hit pass, are hand-written CUDA C++ kernels
for ``sm_90a`` here (``csrc/``), each with a plain PyTorch version beside
it.

Sub-packages mirror the JAX package:

* ``tetgrid`` — numpy grid / lattice-face builders (own copies).
* ``native``  — the same topology builders in C++ (``native/topology.cpp``,
  compiled by g++ at first use, loaded with ctypes).
* ``data``    — procedural shapes, the occupancy texture, the synthetic
  dataset, mesh-directory ingestion (watertight remesh) and the DISN
  images (own copies).
* ``ops``     — geometry, voxelization, ray-parity occupancy, point-in-tet,
  the PointNet sampling ops, and the three kernels: the lattice stencil
  (``ops.stencil``), nearest neighbour (``ops.nearest``) and triangle
  argmin (``ops.tri_distance``).
* ``nn``      — PVCNN encoders (optional squeeze-excitation), GCN position decoder (and its lap
  refinement head), occupancy MLP, the DISN image branch and its offline
  VGG-16 loader.
* ``losses``  — SoA tet regularizers and the compacted surface losses.
* ``evals``   — the metrics and the full-inference evaluation.
* ``train``   — statics, ``forward_losses``, the optimizer, the train and
  validation steps, checkpoints and ``Engine``.
* ``render``  — the 2D-supervision stack: camera, the depth-peeled
  rasterizer (hit kernel ``raster_hit``), compositing, full frames, the
  optimizable tet scene and the staged carve/subdivide optimizer.
* ``parallel`` — data parallelism over ``torch.distributed``: the world,
  the divisor clamp, row sharding and the step's collectives.
* ``remat``   — rematerialization that keeps named no-grad results.
* ``utils``   — OBJ IO and named timers.
* ``cli``     — ``python -m deftet_tpu_torch.cli
  train|eval|preprocess|render``.
* ``convert`` — flax ``{"params", "batch_stats"}`` to a torch state dict.
* ``dryrun``  — the flagship forward (``entry``) and a data-parallel
  step on n ranks (``dryrun_multidevice``).

Importing the package compiles nothing and does not touch CUDA; kernels
are built from ``csrc/`` with ``nvcc`` at their first launch, the native
builders with ``g++`` at their first call.
"""

__version__ = "0.1.0"
