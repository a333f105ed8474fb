"""Event-to-model alignment throughput on JAX's default device.

Measures the fused coarse-to-fine pyramid solve (ops/event_tracker.
optimize_pyramid — one dispatch per packet) at the reference operating
point: 2048 active points, 3 event-frame levels, [20, 15, 10] LM
iterations, 480x640 frames. Also reports the event-frame build (raster,
blur, levels, normalization) of a 64k-event packet. Each JSON line names
its device.

Usage:  python benchmarks/bench_event_solve.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from slam_eds_tpu.compile_cache import setup_cache  # noqa: E402

setup_cache()


def _median_s(fn, n=5):
    """Median wall time in s of calls ended by block_until_ready (the
    first, compiling call is not counted)."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    from slam_eds_tpu.ops import event_tracker as et
    from slam_eds_tpu.utils.cameras import Pinhole
    from slam_eds_tpu.utils import events as ev

    H, W, P, L = 480, 640, 2048, 3
    cam = Pinhole(jnp.float32(400.0), jnp.float32(400.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    rng = np.random.default_rng(0)
    efs = jnp.asarray(rng.normal(size=(L, H, W)) * 0.01, jnp.float32)
    nc = jnp.asarray(np.stack(
        [(rng.uniform(10, W - 10, P) - (W / 2 - 0.5)) / 400.0,
         (rng.uniform(10, H - 10, P) - (H / 2 - 0.5)) / 400.0], -1),
        jnp.float32)
    grad = jnp.asarray(rng.normal(size=(P, 2)) * 20, jnp.float32)
    idp = jnp.asarray(rng.uniform(0.3, 1.0, P), jnp.float32)
    w = jnp.ones((P,), jnp.float32)
    m = jnp.ones((P,), bool)
    st = et.initial_tracker_state()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def solve():
        return et.optimize_pyramid(st, efs, cam, nc, grad, idp, w, m,
                                   iterations_per_level=[20, 15, 10]).state

    dt = _median_s(solve)
    print(json.dumps({"metric": "event_pyramid_solves_per_s",
                      "value": 1.0 / dt, "unit": "solves/s",
                      "ms_per_solve": dt * 1e3, "device": device}))

    N = 1 << 16
    xs = jnp.asarray(rng.uniform(0, W - 1, N), jnp.float32)
    ys = jnp.asarray(rng.uniform(0, H - 1, N), jnp.float32)
    pol = jnp.asarray(np.where(rng.random(N) > 0.5, 1.0, -1.0), jnp.float32)
    nv = jnp.asarray(N)
    raster = jax.jit(lambda x, y, p, n: ev.build_event_frame(
        x, y, p, n, H, W))

    dt = _median_s(lambda: raster(xs, ys, pol, nv))
    print(json.dumps({"metric": "event_frame_64k_packets_per_s",
                      "value": 1.0 / dt, "unit": "packets/s",
                      "ms_per_packet": dt * 1e3, "device": device}))


if __name__ == "__main__":
    main()
