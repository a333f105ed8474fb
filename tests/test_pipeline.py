"""Integration: the frame-only DSO slice (BASELINE config 1) on a synthetic
sequence — bootstrap, track, keyframe, BA, marginalize — with an ATE bound,
and the EDS event loop smoke test (config 2/3 slice)."""
import numpy as np
import jax.numpy as jnp
import pytest

from slam_eds_tpu.config import EDSConfig, load_config
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models.pipeline import FrameOnlyPipeline, EDSPipeline
from slam_eds_tpu.utils.alignment import ate_rmse
from slam_eds_tpu.utils.cameras import Pinhole

W, H = 128, 96
CAM = Pinhole(jnp.float32(110.0), jnp.float32(110.0), jnp.float32(W / 2 - 0.5),
              jnp.float32(H / 2 - 0.5), W, H)


def small_config():
    return load_config({
        "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
                 "max_window_frames": 6, "max_events": 8192},
        "bundles": {"window_size": 4, "min_frames": 3},
        "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
        "selector": {"desired_immature_density": 400.0,
                     "desired_point_density": 300.0},
        "event_frame": {"num_levels": 2, "events_per_frame": 8192},
        "tracker": {"max_iterations": [15, 10]},
    })


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(CAM, num_frames=14, events_per_packet=8192,
                             motion_scale=0.35)


def test_frame_only_pipeline_ate(seq):
    pipe = FrameOnlyPipeline(CAM, small_config())
    for k in range(seq.num_frames):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
    assert pipe._initialized, "bootstrap failed"
    est = pipe.positions()
    gt = seq.gt_positions()[: len(est)]
    assert len(est) == seq.num_frames
    err = float(ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    # scene scale ~2m, motion ~0.3; demand cm-level after Umeyama alignment
    assert err < 0.05, err
    # telemetry recorded BA runs
    assert pipe.telemetry.counters["ba_runs"] >= 1


def test_eds_pipeline_smoke(seq):
    cfg = small_config()
    pipe = EDSPipeline(CAM, cfg)
    poses = []
    for k in range(8):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
        if k >= 1 and pipe.kf is not None:
            packet = seq.events_between(k - 1, k)
            T = pipe.process_events(packet)
            if T is not None:
                poses.append(np.asarray(T.t))
    assert pipe.frame_pipe._initialized
    assert len(poses) >= 3
    assert np.isfinite(np.stack(poses)).all()
    assert pipe.telemetry.counters["event_solves"] >= 3


def test_eds_pipeline_full_loop(seq):
    """The complete EDS cycle (SURVEY §3.1/§3.2): event solves between
    frames, keyframe promotion from the flow/point-loss criteria (consumed
    at the next frame), depth seeded forward; event trajectory accurate."""
    cfg = load_config({
        "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
                 "max_window_frames": 6, "max_events": 8192},
        "bundles": {"window_size": 4, "min_frames": 3},
        "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
        "selector": {"desired_immature_density": 400.0,
                     "desired_point_density": 300.0},
        "event_frame": {"num_levels": 2, "events_per_frame": 8192},
        # low flow threshold so the promotion path actually runs here
        "tracker": {"max_iterations": [15, 10], "kf_flow_threshold": 1.0},
    })
    pipe = EDSPipeline(CAM, cfg)
    ev_pos, ev_gt = [], []
    for k in range(seq.num_frames):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
        if k + 1 < seq.num_frames and pipe.kf is not None:
            packet = seq.events_between(k, k + 1)
            T = pipe.process_events(packet)
            if T is not None:
                ev_pos.append(np.asarray(T.inverse().t))
                # packet timestamp ~ median event time ~ midpoint
                ev_gt.append(np.asarray(
                    seq.pose_at(k + 0.5).inverse().t))
    assert pipe.num_event_kfs >= 2, \
        f"keyframe promotion never fired ({pipe.num_event_kfs} KFs)"
    # the round-5 affine-prior fix removed a defect that inflated the
    # frame-KF score (drifting |a| boosted the affine term), so KF cadence
    # — and with it the warm-packet count at this tiny scale — dropped;
    # 640x480 usability is 100% (benchmarks/bench_event_usability.py)
    assert len(ev_pos) >= 4
    err = float(ate_rmse(jnp.asarray(np.stack(ev_pos)),
                         jnp.asarray(np.stack(ev_gt))))
    assert err < 0.12, err


def test_midas_depth_bootstrap(seq):
    """Reference bootstrap path C (MiDAS selector, tracking/Config.hpp:39):
    an external depth map seeds the first keyframe's structure directly —
    no two-view parallax needed. GT depth stands in for the net output."""
    import dataclasses
    cfg = small_config()
    cfg = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, bootstrap="midas"))
    pipe = FrameOnlyPipeline(CAM, cfg)
    t0, img0, depth0 = seq.frame(0)
    pipe.process_frame(img0, t0, depth_map=depth0)
    assert pipe._initialized, "depth-map bootstrap failed"
    # initialized from ONE frame (unlike two-view paths)
    assert len(pipe.poses) == 1 and pipe.times == [t0]
    for k in range(1, 10):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
    est = pipe.positions()
    gt = seq.gt_positions()[: len(est)]
    assert len(est) == 10
    err = float(ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    # cm-level on a ~2m scene; the tail of the bound absorbs f32
    # reduction-order sensitivity of the gauge-heavy bootstrap window
    assert err < 0.08, err


def test_new_keyframe_extends_residuals(seq):
    """Active points must observe keyframes inserted AFTER their activation
    (FullSystem::makeKeyFrame adds residuals from old points to the new KF)."""
    from slam_eds_tpu.models import ba_state as bs
    pipe = FrameOnlyPipeline(CAM, small_config())
    for k in range(seq.num_frames):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
    assert pipe._initialized
    st = pipe.window.state
    active = np.asarray(st.p_status) == bs.PT_ACTIVE
    newest = pipe.window.newest_slot
    hosted_elsewhere = active & (np.asarray(st.p_host) != newest)
    assert hosted_elsewhere.sum() > 0
    # structurally active toward the newest slot for non-hosted points
    frac = np.asarray(st.r_active)[hosted_elsewhere, newest].mean()
    assert frac > 0.9, frac


def test_tracking_failure_holds_motion_and_defers_kf(seq):
    """On total tracking failure the pipeline must hold the constant-velocity
    model (not collapse _motion to identity) and defer keyframe insertion
    until a verified track (round-2 advisor findings)."""
    pipe = FrameOnlyPipeline(CAM, small_config())
    for k in range(6):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
    assert pipe._initialized and not pipe._lost
    motion_before = np.asarray(pipe._motion.log())
    kfs_before = pipe.window.next_id
    n_before = len(pipe.poses)
    # feed garbage frames: tracking cannot succeed on white noise
    rng = np.random.default_rng(0)
    for j in range(3):
        noise = rng.uniform(0, 255, (H, W)).astype(np.float32)
        pipe.process_frame(noise, 0.5 + 0.01 * j)
    assert pipe._lost, "garbage frames should trip the lost state"
    # motion hypothesis preserved exactly (constant-velocity hold)
    assert np.allclose(np.asarray(pipe._motion.log()), motion_before)
    # no keyframe was inserted while lost
    assert pipe.window.next_id == kfs_before
    # poses still appended (held prediction), timestamps recorded
    assert len(pipe.poses) == n_before + 3
    assert len(pipe.times) == len(pipe.poses)
    # recovery: real frames again -> lost clears once a track verifies
    for k in range(6, 9):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
    assert not pipe._lost


def test_eds_pipeline_with_track_refinement(seq):
    """Config-gated refinement (Tracker.cpp:378-553 wiring): the event loop
    runs with model_klt refinement enabled and stays accurate."""
    import dataclasses
    cfg = small_config()
    cfg = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker,
                                         track_refinement="model_klt"))
    pipe = EDSPipeline(CAM, cfg)
    ev_pos, ev_gt = [], []
    for k in range(10):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, t)
        if k + 1 < seq.num_frames and pipe.kf is not None:
            packet = seq.events_between(k, k + 1)
            T = pipe.process_events(packet)
            if T is not None:
                ev_pos.append(np.asarray(T.inverse().t))
                ev_gt.append(np.asarray(seq.pose_at(k + 0.5).inverse().t))
    # see test_eds_pipeline_full_loop: the round-5 affine-prior fix
    # lowered KF cadence and the warm-packet count at this scale
    assert len(ev_pos) >= 3
    err = float(ate_rmse(jnp.asarray(np.stack(ev_pos)),
                         jnp.asarray(np.stack(ev_gt))))
    assert err < 0.12, err


def test_long_deferred_bootstrap_bookkeeping(seq):
    """A long-deferred bootstrap (static camera -> the
    parallax gate holds the anchor) must keep the trajectory/timestamp
    bookkeeping consistent and still initialize once motion appears."""
    pipe = FrameOnlyPipeline(CAM, small_config())
    t0, img0, _ = seq.frame(0)
    # 6 static frames: zero parallax, the eight-point gate must defer
    for j in range(6):
        pipe.process_frame(img0, 0.01 * j)
        assert not pipe._initialized
    # motion resumes: bootstrap against the held anchor
    boot_at = None
    for k in range(1, 10):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, 1.0 + t)
        if boot_at is None and pipe._initialized:
            boot_at = k
    assert pipe._initialized, "never bootstrapped after motion resumed"
    assert boot_at is not None and boot_at >= 1
    # bookkeeping: parallel lists stay aligned, timestamps monotonic
    assert len(pipe.times) == len(pipe.poses) == len(pipe.trajectory)
    assert all(b >= a for a, b in zip(pipe.times, pipe.times[1:]))
    est = pipe.positions()
    assert np.isfinite(est).all()
