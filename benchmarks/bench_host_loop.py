"""Host-orchestration cost of the pipeline loop, per stage.

The per-keyframe host overhead (slot bookkeeping + kernel dispatches) must
be measured, not assumed. This
driver runs the full EDS pipeline on a synthetic sequence and wraps every
WindowManager stage (trace / activate / optimize / marginalize / template
rebuild), the per-frame coarse track, and the per-packet fused event step
with wall-clock timers, then reports medians.

Usage: python benchmarks/bench_host_loop.py [--width 640 --height 480]
       [--frames 16]
Defaults to the test scale (128x96); pass 640x480 for the reference
operating point (first run pays compiles; medians skip the first third).
"""
import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from slam_eds_tpu.compile_cache import setup_cache  # noqa: E402

setup_cache()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--small-config", action="store_true",
                    help="use the reduced test config instead of defaults")
    args = ap.parse_args()

    from slam_eds_tpu.config import EDSConfig, load_config
    from slam_eds_tpu.io.dataset import SyntheticSequence
    from slam_eds_tpu.models.pipeline import EDSPipeline
    from slam_eds_tpu.utils.cameras import Pinhole

    W, H = args.width, args.height
    f = 110.0 * W / 128.0
    cam = Pinhole(jnp.float32(f), jnp.float32(f), jnp.float32(W / 2 - 0.5),
                  jnp.float32(H / 2 - 0.5), W, H)
    seq = SyntheticSequence(cam, num_frames=args.frames,
                            events_per_packet=16384, motion_scale=0.25,
                            micro_steps=2)
    if args.small_config or W <= 256:
        cfg = load_config({
            "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
                     "max_window_frames": 6, "max_events": 16384},
            "bundles": {"window_size": 4, "min_frames": 3},
            "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
            "selector": {"desired_immature_density": 400.0,
                         "desired_point_density": 300.0},
            "event_frame": {"num_levels": 2, "events_per_frame": 16384},
            "tracker": {"max_iterations": [15, 10]},
        })
    else:
        cfg = EDSConfig()
    pipe = EDSPipeline(cam, cfg)
    w = pipe.frame_pipe.window

    stages = defaultdict(list)

    def wrap(obj, name):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            jax.block_until_ready(
                jax.tree_util.tree_leaves(w.state)[:1])
            stages[name].append(time.perf_counter() - t0)
            return out

        setattr(obj, name, timed)

    for name in ("trace_all", "activate_points", "optimize",
                 "flag_and_marginalize", "rebuild_coarse_template",
                 "insert_frame", "track_frame"):
        wrap(w, name)

    frames = [seq.frame(k) for k in range(args.frames)]
    packets = [seq.events_between(k, k + 1)
               for k in range(args.frames - 1)]

    frame_wall, packet_wall = [], []
    for k in range(args.frames):
        t, img, _ = frames[k]
        t0 = time.perf_counter()
        pipe.process_frame(img, t)
        frame_wall.append(time.perf_counter() - t0)
        if k < args.frames - 1 and pipe.kf is not None:
            t0 = time.perf_counter()
            pipe.process_events(packets[k])
            packet_wall.append(time.perf_counter() - t0)

    def med(xs):
        xs = xs[max(1, len(xs) // 3):]    # skip compile-heavy prefix
        return 1e3 * float(np.median(xs)) if xs else float("nan")

    out = {"image": f"{W}x{H}",
           "frame_ms": round(med(frame_wall), 2),
           "event_packet_ms": round(med(packet_wall), 2)}
    for name, xs in stages.items():
        out[f"{name}_ms"] = round(med(xs), 2)
    # per-keyframe host cost = sum of the KF-only stages
    kf_stages = ("insert_frame", "trace_all", "activate_points",
                 "optimize", "flag_and_marginalize",
                 "rebuild_coarse_template")
    out["per_keyframe_ms"] = round(
        sum(out.get(f"{s}_ms", 0.0) or 0.0 for s in kf_stages), 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
