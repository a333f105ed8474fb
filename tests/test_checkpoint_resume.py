"""Checkpoint/resume of the full pipeline (SURVEY §5: the reference has no
checkpointing; long-running deployments require restartability). A resumed
pipeline must continue deterministically: feeding the same tail of a
sequence to (a) the uninterrupted pipeline and (b) a snapshot-restored one
must produce identical trajectories."""
import numpy as np
import jax.numpy as jnp

from slam_eds_tpu import checkpoint
from slam_eds_tpu.config import load_config
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models.pipeline import EDSPipeline
from slam_eds_tpu.utils.cameras import Pinhole

W, H = 128, 96
CAM = Pinhole(jnp.float32(110.0), jnp.float32(110.0), jnp.float32(W / 2 - 0.5),
              jnp.float32(H / 2 - 0.5), W, H)


def _cfg():
    return load_config({
        "caps": {"max_points_per_kf": 256, "max_immature_per_kf": 256,
                 "max_window_frames": 6, "max_events": 4096},
        "bundles": {"window_size": 4, "min_frames": 3},
        "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
        "selector": {"desired_immature_density": 300.0,
                     "desired_point_density": 200.0},
        "event_frame": {"num_levels": 2, "events_per_frame": 4096},
        "tracker": {"max_iterations": [12, 8]},
    })


def _feed(pipe, seq, k0, k1):
    for k in range(k0, k1):
        t, img, _ = seq.frame(k)
        pipe.process_frame(np.asarray(img, np.float32), float(t))
        if k + 1 < seq.num_frames:
            p = seq.events_between(k, k + 1)
            if int(p.n_valid) >= 64:
                pipe.process_events(p)


def test_pipeline_resume_deterministic(tmp_path):
    seq = SyntheticSequence(CAM, num_frames=12, events_per_packet=4096,
                            motion_scale=0.3)
    split = 7

    # uninterrupted run
    ref = EDSPipeline(CAM, _cfg())
    _feed(ref, seq, 0, seq.num_frames)

    # run to the split, snapshot, restore, continue
    a = EDSPipeline(CAM, _cfg())
    _feed(a, seq, 0, split)
    assert a.frame_pipe._initialized
    loc = checkpoint.save_pipeline(str(tmp_path / "snap"), a)

    b = checkpoint.restore_pipeline(loc, CAM, _cfg())
    # restored state must match the snapshot bit-for-bit
    assert np.array_equal(np.asarray(b.frame_pipe.window.state.p_idepth),
                          np.asarray(a.frame_pipe.window.state.p_idepth))
    assert np.array_equal(np.asarray(b.tracker_state.vx),
                          np.asarray(a.tracker_state.vx))
    assert len(b.frame_pipe.poses) == len(a.frame_pipe.poses)

    _feed(a, seq, split, seq.num_frames)
    _feed(b, seq, split, seq.num_frames)

    traj_a = np.stack(a.frame_pipe.trajectory)
    traj_b = np.stack(b.frame_pipe.trajectory)
    assert traj_a.shape == traj_b.shape
    assert np.allclose(traj_a, traj_b, atol=1e-5), \
        np.abs(traj_a - traj_b).max()
    # the continued run also matches the uninterrupted one
    traj_ref = np.stack(ref.frame_pipe.trajectory)
    assert traj_ref.shape == traj_a.shape
    assert np.allclose(traj_ref, traj_a, atol=1e-4), \
        np.abs(traj_ref - traj_a).max()
    if a.event_poses:
        assert len(b.event_poses) == len(a.event_poses)
        assert np.allclose(np.stack(a.event_poses), np.stack(b.event_poses),
                           atol=1e-4)
