"""On-disk end-to-end path: SyntheticSequence.write_dataset
materializes the external task's data contract (images/*.png + images.txt +
events.txt + calib.yaml + groundtruth.txt) and runner.run_sequence drives
the FULL L7 stack over it — frame loader, streaming event reader/ring,
pipeline, recorder, ATE/RPE scoring. The 104-frame 640x480 evidence run
lives in E2E_DISK_r05.json (benchmarks-scale); this test keeps the code
path green at suite scale, including at least one reset-free window
marginalization generation.
"""
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp

from slam_eds_tpu.config import load_config
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.runner import run_sequence
from slam_eds_tpu.utils.cameras import Pinhole


@pytest.fixture(scope="module")
def disk_seq(tmp_path_factory):
    W, H = 128, 96
    cam = Pinhole(jnp.float32(80.0), jnp.float32(80.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    seq = SyntheticSequence(cam, num_frames=26, events_per_packet=8192,
                            micro_steps=2, motion_scale=0.7)
    d = str(tmp_path_factory.mktemp("seq") / "synthetic")
    seq.write_dataset(d)
    return d, seq


def test_dataset_layout(disk_seq):
    d, seq = disk_seq
    for name in ("images.txt", "events.txt", "calib.yaml",
                 "groundtruth.txt"):
        assert os.path.exists(os.path.join(d, name)), name
    imgs = open(os.path.join(d, "images.txt")).read().strip().splitlines()
    assert len(imgs) == 26
    t0, name0 = imgs[0].split()
    assert os.path.exists(os.path.join(d, name0))
    ev = np.loadtxt(os.path.join(d, "events.txt"), comments="#",
                    max_rows=1000)
    assert ev.shape[1] == 4
    assert (np.diff(np.loadtxt(os.path.join(d, "events.txt"), comments="#",
                               usecols=0)) >= 0).all()   # monotonic time
    gt = np.loadtxt(os.path.join(d, "groundtruth.txt"), comments="#")
    assert gt.shape == (26, 8)


def test_runner_full_stack_off_disk(disk_seq):
    d, seq = disk_seq
    cfg = load_config({
        "caps": {"max_points_per_kf": 384, "max_immature_per_kf": 384,
                 "max_window_frames": 5, "max_events": 8192},
        "bundles": {"window_size": 4, "min_frames": 2},
        "coarse": {"pyr_levels": 3, "max_iterations": [8, 10, 10]},
        "selector": {"desired_immature_density": 300.0,
                     "desired_point_density": 250.0},
        "event_frame": {"num_levels": 2, "events_per_frame": 8192},
        "tracker": {"max_iterations": [10, 8]},
    })
    res = run_sequence(d, cfg, frame_only=False, verbose=False)
    assert res["frames"] == 26
    assert res["packets"] > 0
    assert np.isfinite(res["positions"]).all()
    # the window must have cycled (frame marginalizations) without a reset
    assert res["marginalizations"] >= 2
    assert res["resets"] == 0
    # bounded trajectory error vs the written ground truth
    assert "ate_rmse" in res
    gt = np.loadtxt(os.path.join(d, "groundtruth.txt"), comments="#")
    extent = np.linalg.norm(gt[:, 1:4] - gt[:, 1:4].mean(0), axis=1).max()
    # divergence guard only: 128x96 with 8k-event packets tracks
    # coarsely, and this test's purpose is the on-disk code path (loader,
    # event ring, recorder, counters). The 640x480 end-to-end run with
    # its ATE bound is chip_smoke.py's last phase
    assert res["ate_rmse"] < 0.8 * float(extent + 1e-6)
