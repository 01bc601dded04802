"""LINEMOD 6D pose-estimation framework (JAX / XLA, one Pallas-Triton kernel).

A from-scratch re-design of the capabilities of
birlrobotics/linemod_pose_estimation (OpenCV ``cv::linemod`` + ORK renderer +
PCL + ROS) as batched device compute, run on an NVIDIA GPU (tested on CPU):

- ``utils``    — geometry, STL meshes, OpenCV-YAML bank I/O, point clouds.
- ``ops``      — device compute: quantized modalities, orientation spreading,
                 response LUTs, the batched template-scoring engine, ICP,
                 voxel ops.  Pure JAX plus one Pallas-Triton kernel,
                 jit-friendly (static shapes, ``lax`` control flow);
                 ``ops.backend`` picks the implementation per platform.
- ``models``   — Detector (add_template / match / read / write), the offline
                 view-sphere trainer, the JAX STL rasterizer, and the full
                 detection cascade (voting → NMS → pose → ICP → HV).
- ``parallel`` — device-mesh sharding of the template bank + frame batch
                 (`jax.sharding` / shard_map, collectives for top-k).
- ``api``      — host service surface preserving the reference's
                 ``/linemod_object_pose`` request/response semantics and the
                 robot-frame transform chain.

Reference layer map: see SURVEY.md sections 1-2.
"""

__version__ = "0.1.0"

import jax as _jax

# f32 matmuls may default to reduced precision on accelerators (TF32 on an
# NVIDIA GPU, ~10-bit mantissa).  For this framework that default is a
# CORRECTNESS hazard, not a perf knob: the geometry pipeline (renderer
# vertex transform, ICP correspondence + Kabsch, voxel centroids,
# SHOT/LRF, pose geodesics) computes mm-scale quantities from m-scale
# coordinates, and reduced-precision rounding there walked a
# 0.2-degree-correct ICP seed to ~90 degrees (CPU f32 never shows it).
# Raise the DEFAULT to float32.  The int8 scoring GEMMs are integer ops
# and unaffected.
_jax.config.update("jax_default_matmul_precision", "float32")
