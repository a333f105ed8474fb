"""Event-solve usability study at the 640x480 / 64k-packet operating point:
sweep the event-frame cost basin — accumulation density
(events per packet), blur kernel, per-level iteration caps (the
tracking/Config.hpp:45 per-level list analog) — across seeds, and report
the usable-packet fraction of the full EDSPipeline gate
(models/pipeline._event_packet_fused, Tracker.cpp:217-240 semantics).

Run:  python benchmarks/bench_event_usability.py [--seeds 3] [--frames 14]
Emits one JSON line per config; finishes with a "best" summary line.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from slam_eds_tpu.compile_cache import setup_cache  # noqa: E402

setup_cache(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from slam_eds_tpu.config import EDSConfig  # noqa: E402
from slam_eds_tpu.io.dataset import SyntheticSequence  # noqa: E402
from slam_eds_tpu.models.pipeline import EDSPipeline  # noqa: E402
from slam_eds_tpu.utils.cameras import Pinhole  # noqa: E402


def run_config(name, cap, blur, iters, seeds, frames, budget_s=1800.0):
    W, H = 640, 480
    cam = Pinhole(jnp.float32(400.0), jnp.float32(400.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    t_start = time.time()
    total, usable = 0, 0
    per_seed = []
    for seed in seeds:
        seq = SyntheticSequence(cam, num_frames=frames,
                                events_per_packet=cap, motion_scale=0.22,
                                micro_steps=2, seed=seed)
        cfg = EDSConfig()
        cfg = dataclasses.replace(
            cfg,
            caps=dataclasses.replace(cfg.caps, max_events=cap),
            event_frame=dataclasses.replace(
                cfg.event_frame, events_per_frame=cap, gaussian_blur_ksize=blur),
            tracker=dataclasses.replace(cfg.tracker, max_iterations=iters))
        pipe = EDSPipeline(cam, cfg)
        s_tot, s_use = 0, 0
        for k in range(frames):
            t, img, _ = seq.frame(k)
            pipe.process_frame(img, t)
            if k + 1 < frames and pipe.kf is not None:
                T = pipe.process_events(seq.events_between(k, k + 1))
                s_tot += 1
                if T is not None:
                    s_use += 1
            if time.time() - t_start > budget_s:
                break
        per_seed.append((s_use, s_tot))
        total += s_tot
        usable += s_use
    out = {"config": name, "events_per_packet": cap, "blur_ksize": blur,
           "iters_per_level": list(iters),
           "usable": usable, "packets": total,
           "usable_frac": round(usable / max(total, 1), 3),
           "per_seed": per_seed,
           "wall_s": round(time.time() - t_start, 1)}
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--quick", action="store_true",
                    help="2 configs x 2 seeds smoke variant")
    args = ap.parse_args()
    seeds = list(range(1, args.seeds + 1))
    # all configs share the 64k packet shape so the jitted packet program
    # compiles once; blur ksize and iteration caps are static args with
    # small recompiles
    grid = [
        ("base_64k", 65536, 0, (20, 15, 10)),
        ("blur3", 65536, 3, (20, 15, 10)),
        ("blur5", 65536, 5, (20, 15, 10)),
        ("more_iters", 65536, 0, (40, 30, 20)),
        ("blur3_more_iters", 65536, 3, (40, 30, 20)),
    ]
    if args.quick:
        grid = grid[:2]
        seeds = seeds[:2]
    results = [run_config(n, c, b, i, seeds, args.frames)
               for (n, c, b, i) in grid]
    best = max(results, key=lambda r: r["usable_frac"])
    print(json.dumps({"best": best["config"],
                      "best_usable_frac": best["usable_frac"]}), flush=True)


if __name__ == "__main__":
    main()
