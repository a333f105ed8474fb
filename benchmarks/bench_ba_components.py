"""Per-component + sustained timing of the keyframe-BA backend on JAX's
default device.

Prints one JSON line per measurement, each naming its device. The sustained
number is what ``bench.py`` at the repo root reports; this script
additionally splits the GN iteration into its stages (each stage jitted
separately, which forces device-memory materialization between stages — the
fused full step is faster than the sum of its parts, which is the point of
keeping it one program).

Usage:  python benchmarks/bench_ba_components.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from slam_eds_tpu.compile_cache import setup_cache  # noqa: E402

setup_cache()


def _median_ms(f, *args, n=5):
    """Median wall time in ms of calls ended by block_until_ready (the
    first, compiling call is not counted)."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    from slam_eds_tpu.models.ba_state import synthetic_window
    from slam_eds_tpu.ops import energy

    state, images = synthetic_window()
    H, W = images.shape[1:3]
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    lin_j = jax.jit(lambda st, im: energy.linearize(st, im, H, W))
    lin = lin_j(state, images)
    asm_j = jax.jit(lambda st, ln: energy.assemble(st, ln))
    asm = asm_j(state, lin)
    sol_j = jax.jit(lambda st, a: energy.solve_delta(st, a))
    sol = sol_j(state, asm)
    app_j = jax.jit(lambda st, s: energy.apply_step(st, s))

    for name, ms in [
        ("ba_linearize_ms", _median_ms(lin_j, state, images)),
        ("ba_assemble_ms", _median_ms(asm_j, state, lin)),
        ("ba_solve_ms", _median_ms(sol_j, state, asm)),
        ("ba_apply_ms", _median_ms(app_j, state, sol)),
    ]:
        print(json.dumps({"metric": name, "value": ms, "unit": "ms",
                          "device": device}))

    for iters in (6, 48):
        f = jax.jit(lambda st, im, it=iters: energy.ba_iterate(
            st, im, H, W, iterations=it)[0])
        ms = _median_ms(f, state, images)
        print(json.dumps({
            "metric": f"ba_gn_{iters}_iters_one_dispatch_ms",
            "value": ms, "unit": "ms",
            "iters_per_s": iters / (ms / 1e3), "device": device}))


if __name__ == "__main__":
    main()
