"""slam_eds_tpu — an event-aided direct sparse odometry framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
uzh-rpg/slam-eds (EDS, CVPR'22): event-to-model photometric tracking, a
DSO-style frame front-end, and sliding-window photometric bundle adjustment
with Schur-complement point marginalization — built batched, masked, and
jit-compiled for an accelerator (an NVIDIA GPU), with device-mesh sharding
for the distributed BA.

Layering (mirrors SURVEY.md §1, redesigned for batched arrays):
  utils/     math core: Lie groups, cameras, interpolation, images, stats
  ops/       compute kernels: residuals, trackers, BA solver, depth filter
  models/    state pytrees: keyframes, event frames, the sliding window
  parallel/  mesh sharding for the distributed Schur reduction
  io/        calibration YAML, datasets, checkpointing, recording
"""

__version__ = "0.1.0"

from .config import EDSConfig, load_config  # noqa: F401
