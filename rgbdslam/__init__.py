"""rgbdslam — an RGB-D SLAM framework on JAX (XLA + Pallas GPU kernels).

A brand-new implementation of the full feature-based RGB-D SLAM pipeline of
the C++ reference (toniortiz/rgbd-slam) re-designed as array programs for an
accelerator:

- SLAM state lives in fixed-shape device arrays (pytrees) instead of a
  mutex-guarded object graph (reference: ~20 mutexes, 3 threads).
- Per-frame work (feature detection, description, matching, robust
  registration, ICP refinement) is a pure jit-compiled array program.
- RANSAC is batched hypothesis evaluation (vmapped Kabsch + Mahalanobis
  scoring) instead of a sequential early-exit loop
  (reference: Solver/SolverSE3.cpp:54-103).
- The g2o pose-graph backend (reference: Solver/PoseGraph.cpp) is replaced by
  an SE(3) Gauss-Newton/LM solver on tangent-space increments with a dense /
  Schur-complement linear solve, shardable across a device mesh.
- DBoW3 loop detection (reference: PlaceRecognition/LoopDetector.cpp) is
  replaced by an on-device binary codebook + dense inverted-file scoring.

Subpackages:
  geometry  SE(3)/quaternion math, pinhole RGB-D camera model
  ops       device kernels (XLA + Pallas/Triton): image, FAST, ORB, Hamming
  frontend  feature extraction + matching with fixed feature budgets
  solvers   batched RANSAC SE3, ICP/GICP, PnP, pose-graph, local BA
  loop      binary BoW codebook + loop detection
  mapping   keyframe / landmark stores, point-cloud + occupancy mapping
  slam      host-side orchestration (tracking state machine, system)
  io        TUM/ICL/CORBS dataset parsing, synthetic RGB-D sequences
  eval      ATE/RPE trajectory evaluation
  parallel  mesh/shard_map distributed bundle adjustment
  utils     profiling, serialization, misc
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/solver math (SE(3) composition, 3x3 covariance algebra, 6x6
# Gauss-Newton solves) needs true f32 matmuls. On Hopper, XLA may run an f32
# matmul in TF32 (about three decimal digits), which is enough error to break
# pose estimation; this pins every matmul to full f32. The hot integer and
# elementwise work (Hamming, FAST, reductions) does not pay for it; a call
# site that wants tensor-core throughput asks for it explicitly via
# `preferred_element_type` / `precision=`.
_jax.config.update("jax_default_matmul_precision", "float32")
