"""Regression for the round-4 640x480 window-full collapse.

Root causes found round 5 (deterministic repro on the CPU backend):
1. Affine-prior anchoring: the per-frame (a, b) priors pulled toward the
   INHERITED tracked affine instead of absolute zero (FrameHessian::
   getPrior / getPriorZero semantics), so the tracker's per-generation
   affine wander compounded (b: 3 -> 35 over six keyframe generations on a
   constant-brightness scene) and BA energy ballooned.
2. Host concentration: without DSO's residual permanence (OOB residuals
   dropped for good -> point turnover), the bootstrap keyframe kept
   hosting ~70% of the active map; its marginalization deleted most of the
   map in one step (1809 -> 48 in the round-4 logs). Fixed by OOB
   permanence + same-keyframe refill after a gutting marginalization.

This test runs the frame pipeline at a reduced-but-representative
operating point through MULTIPLE frame marginalizations (including the
bootstrap keyframe's) and asserts the active map and tracking survive.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from slam_eds_tpu.config import load_config
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models.pipeline import FrameOnlyPipeline
from slam_eds_tpu.models import ba_state as bs
from slam_eds_tpu.utils.cameras import Pinhole


def test_survives_first_marginalization_generations():
    W, H = 320, 240
    cam = Pinhole(jnp.float32(200.0), jnp.float32(200.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    seq = SyntheticSequence(cam, num_frames=40, events_per_packet=1024,
                            motion_scale=0.22, micro_steps=1)
    cfg = load_config({
        "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
                 "max_window_frames": 8},
        "bundles": {"window_size": 7, "min_frames": 4},
        "coarse": {"pyr_levels": 4},
        "selector": {"desired_immature_density": 500.0,
                     "desired_point_density": 450.0}})
    pipe = FrameOnlyPipeline(cam, cfg)
    min_active_after_marg = []
    margs_seen = 0
    for k in range(seq.num_frames):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
        m = pipe.window.marg_count
        if m > margs_seen:
            margs_seen = m
            n_act = int((np.asarray(pipe.window.state.p_status)
                         == bs.PT_ACTIVE).sum())
            min_active_after_marg.append(n_act)
        if margs_seen >= 3:
            break

    assert margs_seen >= 3, \
        f"only {margs_seen} frame marginalizations in {seq.num_frames} frames"
    assert pipe._resets == 0, "window lifecycle triggered a full reset"
    # acceptance: healthy point survival across the first
    # three marginalizations — the active map never collapses. The dying
    # frame's own points legitimately leave the active set (they are
    # absorbed into the HM/bM prior), so survival is measured against the
    # point budget after the same-keyframe refill.
    budget = cfg.caps.max_points_per_kf
    for n in min_active_after_marg[:3]:
        assert n >= 0.5 * budget, \
            f"active map collapsed to {n}/{budget} after a marginalization"
    # tracking never got lost through the transitions
    assert not pipe._lost
    assert np.isfinite(pipe.positions()).all()
