"""Batched multi-sequence evaluation (BASELINE config 4).

The reference ecosystem evaluates EDS by replaying each CVPR'22 sequence
through the external orogen task and scoring ATE against ground truth on the
project site — one sequence at a time, one process each. Here instead:

* run every sequence in ONE process so each jitted kernel compiles once and
  is reused across sequences (``evaluate_sequences``), and
* expose a genuinely batched solve surface: ``batched_event_solves`` vmaps
  the full event-to-model LM solver (ops/event_tracker.optimize) over a
  batch of (event frame, keyframe tensor) problems, so B sequences' packets
  at the same cadence run as one batched program — the per-device
  throughput surface for fleet-scale evaluation/replay.

CLI:
    python -m slam_eds_tpu.eval <seq_dir> [<seq_dir> ...] [--report r.json]
        [--frames N] [--frame-only]
A single argument that is a directory of sequence subdirectories (each with
an ``images.txt``) is expanded automatically.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .config import EDSConfig
from .ops import event_tracker as et
from .utils.cameras import Pinhole


# ---------------------------------------------------------------------------
# Batched solver surface
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_iterations", "loss_kind",
                                   "norm_event"))
def batched_event_solves(states: et.TrackerState, event_frames, cam: Pinhole,
                         norm_coord, grad, idp, weights, mask,
                         max_iterations: int = 20, loss_kind: str = "huber",
                         loss_scale=0.2, norm_event: bool = False):
    """vmap of the event-to-model LM solve over a leading batch axis B.

    states: TrackerState with fields batched [B, ...]; event_frames [B,H,W];
    keyframe tensors batched [B,P,...]; loss_scale [B]. Returns a batched
    TrackerResult. Each lane runs its own LM trajectory (accept/reject and
    early-exit are per-lane via the masked while_loop semantics of vmap).
    """
    def one(state, ef, nc, g, d, w, m, ls):
        return et.optimize(state, ef, cam, nc, g, d, w, m,
                           max_iterations=max_iterations,
                           loss_kind=loss_kind, loss_scale=ls,
                           norm_event=norm_event)

    # a scalar loss_scale (the documented default) applies to every lane:
    # broadcast it to [B] so vmap's in_axes=0 sees a mappable axis
    ls = jnp.asarray(loss_scale, jnp.float32)
    if ls.ndim == 0:
        ls = jnp.broadcast_to(ls, event_frames.shape[:1])
    return jax.vmap(one)(states, event_frames, norm_coord, grad, idp,
                         weights, mask, ls)


@partial(jax.jit, static_argnames=("height", "width", "iterations",
                                   "orth_from_iteration"))
def batched_ba_windows(states, target_images, height: int, width: int,
                       iterations: int = 6, orth_from_iteration: int = 2):
    """vmap of the full keyframe-BA GN loop (ops/energy.ba_iterate) over a
    leading batch axis B — B independent sliding windows (e.g. one per
    replayed sequence) advance in one batched program.

    states: BAState with every leaf batched [B, ...]; target_images
    [B, F, H, W, 3]. Returns (batched BAState, energies [B]).
    """
    from .ops import energy

    def one(st, im):
        st2, e, _ = energy.ba_iterate(st, im, height, width,
                                      iterations=iterations,
                                      orth_from_iteration=orth_from_iteration)
        return st2, e

    return jax.vmap(one)(states, target_images)


# ---------------------------------------------------------------------------
# Multi-sequence driver
# ---------------------------------------------------------------------------

def _expand_sequence_dirs(paths: List[str]) -> List[str]:
    if len(paths) == 1 and os.path.isdir(paths[0]) and not os.path.exists(
            os.path.join(paths[0], "images.txt")):
        subs = sorted(
            os.path.join(paths[0], d) for d in os.listdir(paths[0])
            if os.path.exists(os.path.join(paths[0], d, "images.txt")))
        if subs:
            return subs
    return paths


def evaluate_sequences(seq_dirs: List[str], cfg: Optional[EDSConfig] = None,
                       max_frames: Optional[int] = None,
                       frame_only: bool = False, verbose: bool = True):
    """Run every sequence through the full pipeline in one process and
    report per-sequence ATE-RMSE / RPE / rates plus aggregates."""
    from .runner import run_sequence

    seq_dirs = _expand_sequence_dirs(list(seq_dirs))
    per_seq = {}
    t0 = time.perf_counter()
    for d in seq_dirs:
        name = os.path.basename(os.path.normpath(d))
        if verbose:
            print(f"[eval] sequence {name}")
        res = run_sequence(d, cfg, max_frames=max_frames,
                           frame_only=frame_only, verbose=False)
        per_seq[name] = {k: v for k, v in res.items() if k != "positions"}
    wall = time.perf_counter() - t0

    ates = [v["ate_rmse"] for v in per_seq.values() if "ate_rmse" in v]
    report = {
        "sequences": per_seq,
        "num_sequences": len(per_seq),
        "wall_s": wall,
        "mean_ate_rmse": float(np.mean(ates)) if ates else None,
        "median_ate_rmse": float(np.median(ates)) if ates else None,
        "total_frames_per_s": sum(v["frames"] for v in per_seq.values())
        / max(wall, 1e-9),
    }
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sequences", nargs="+")
    ap.add_argument("--report", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--frame-only", action="store_true")
    ap.add_argument("--config", default=None)
    args = ap.parse_args()
    cfg = None
    if args.config:
        from .config import load_config
        cfg = load_config(args.config)
    report = evaluate_sequences(args.sequences, cfg, max_frames=args.frames,
                                frame_only=args.frame_only)
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
