"""Smoke test of the EDS pipeline on one NVIDIA GPU.

Everything runs in this one process, in four phases; the first failure ends
the run with a traceback and a non-zero exit code:

1. device: JAX's default device must be a GPU (there is no CPU fallback);
   prints the card's name and power limit.
2. golden parity: the BA and event cases of tests/test_golden_parity.py
   with the JAX side on the card, against native/dso_golden.cpp (double
   precision, built here with g++), at the test's tolerances.
3. kernels at real widths against plain references: the BA tap sampler and
   the event raster against float64 numpy, one 6-iteration
   ``energy.ba_iterate`` call and one ``event_tracker.optimize`` solve on
   the card against the same jitted functions on this process's CPU.
4. end to end: ``runner.run_sequence`` on a seeded synthetic dataset at the
   reference operating point (640x480, 2048 points, window 7+1, 6 GN
   iterations, 64k-event packets).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

    python chip_smoke.py
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# ATE-RMSE bound of the end-to-end phase at the operating point below: five
# times the 0.0030 of a CPU run of the same seed and config. Runs on an H100
# gave 0.0043-0.0045; the scatter-add and reduction orders differ from the CPU
# and from run to run, so the bound leaves that room, while a lost track
# scores near the trajectory's RMS spread about its mean (0.051).
ATE_BOUND = 0.015

# The reference operating point (src/utils/settings.cpp:72-82 of
# uzh-rpg/slam-eds) on a seeded synthetic sequence.
FULL = dict(width=640, height=480, num_frames=24, events=65536,
            motion_scale=0.22, micro_steps=2, config={})


class Check(NamedTuple):
    name: str
    worst: float
    tol: float

    @property
    def ok(self) -> bool:
        return bool(self.worst <= self.tol)   # NaN fails


def _report(phase: str, checks) -> None:
    for c in checks:
        print(f"[{phase}] {c.name}: worst {c.worst:.3e} tol {c.tol:.3e} "
              f"{'ok' if c.ok else 'FAIL'}", flush=True)
    bad = [c.name for c in checks if not c.ok]
    if bad:
        raise AssertionError(f"{phase}: {', '.join(bad)} out of tolerance")


def _ratio(a, b, rtol: float, atol: float) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 where
    ``np.testing.assert_allclose(a, b, rtol, atol)`` passes."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b)),
                        initial=0.0))


def _max_abs(a, b, mask=None) -> float:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    if mask is not None:
        d = d[mask]
    return float(np.nanmax(d, initial=0.0)) if np.all(np.isfinite(d)) \
        else float("nan")


# ---------------------------------------------------------------------------
# phase 1
def device_phase():
    """Require a GPU as JAX's default backend; print what it is."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU, JAX's default device is "
                         f"{dev.platform} ({dev.device_kind})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {smi} | platform={dev.platform} "
          f"device_kind={dev.device_kind} count={len(jax.devices())}",
          flush=True)
    return dev, smi


# ---------------------------------------------------------------------------
# phase 2
def golden_phase(work_dir: str):
    """tests/test_golden_parity.py's BA and event cases on the default
    device, at the test's own tolerances (its assertions run here)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_golden_parity as tg

    exe = tg.build_golden(work_dir)
    case = tg.golden_case(exe)
    for test in (tg.test_golden_residual_states_match,
                 tg.test_golden_linearization_matches,
                 tg.test_golden_assembled_system_matches,
                 tg.test_golden_solve_matches):
        test(case)
    tg.test_golden_outlier_gating_matches(exe)
    for norm_event in (False, True):
        tg.test_golden_event_cost_matches(exe, norm_event)
    state, g, lin, asm, sol = case
    m = np.asarray(lin.valid)
    d = tg._dscale()
    x_ref = g["x"] * d
    checks = [
        Check("golden BA residuals max |err|/(2e-3 + 2e-3|ref|)",
              _ratio(np.asarray(lin.res)[m], g["resF"][m], 2e-3, 2e-3), 1.0),
        Check("golden BA H scaled rel err",
              float(tg._rel_h(np.asarray(asm.H), g["HA"] / np.outer(d, d))),
              5e-4),
        Check("golden BA step max |err|/(5e-4 max|ref| + 5e-3|ref|)",
              _ratio(sol.x, x_ref, 5e-3, 5e-4 * np.max(np.abs(x_ref))), 1.0),
    ]
    for norm_event in (False, True):
        r, r_g = tg.golden_event_case(exe, norm_event)
        checks.append(Check(
            f"golden event residuals norm_event={norm_event} "
            f"max |err|/(2e-4 + 2e-3|ref|)", _ratio(r, r_g, 2e-3, 2e-4), 1.0))
    _report("golden", checks)


# ---------------------------------------------------------------------------
# phase 3
def sampler_reference(planes, u, v):
    """float64 numpy bilinear (value, gx, gy) with central-difference
    gradient planes, and the in-image mask: the contract of
    ``interp.pattern_tile_sample``."""
    planes = np.asarray(planes, np.float64)
    F, H, W = planes.shape
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    uc = np.clip(np.nan_to_num(u, nan=-8.0), -8.0, W + 8.0)
    vc = np.clip(np.nan_to_num(v, nan=-8.0), -8.0, H + 8.0)
    ok = (uc >= 1.0) & (uc < W - 2.0) & (vc >= 1.0) & (vc < H - 2.0)
    gxp = np.zeros_like(planes)
    gyp = np.zeros_like(planes)
    gxp[:, :, 1:-1] = 0.5 * (planes[:, :, 2:] - planes[:, :, :-2])
    gyp[:, 1:-1, :] = 0.5 * (planes[:, 2:, :] - planes[:, :-2, :])
    x0 = np.clip(np.floor(uc).astype(np.int64), 0, W - 2)
    y0 = np.clip(np.floor(vc).astype(np.int64), 0, H - 2)
    fx = uc - x0
    fy = vc - y0
    f = np.broadcast_to(np.arange(F)[None, :, None], u.shape)

    def bil(p):
        return ((1 - fx) * (1 - fy) * p[f, y0, x0] + fx * (1 - fy)
                * p[f, y0, x0 + 1] + (1 - fx) * fy * p[f, y0 + 1, x0]
                + fx * fy * p[f, y0 + 1, x0 + 1])
    return bil(planes), bil(gxp), bil(gyp), ok


def check_sampler(device, height: int, width: int, points: int,
                  frames: int = 8, taps: int = 8, seed: int = 0):
    """The BA tap sampler on ``device`` against ``sampler_reference``."""
    import jax
    from slam_eds_tpu.utils.interp import pattern_tile_sample
    rng = np.random.default_rng(seed)
    planes = rng.uniform(0, 255, (frames, height, width)).astype(np.float32)
    # taps over the whole image and a margin, so the mask is exercised
    u = rng.uniform(-3, width + 3, (points, frames, taps)).astype(np.float32)
    v = rng.uniform(-3, height + 3, (points, frames, taps)).astype(np.float32)
    args = jax.device_put((planes, u, v), device)
    I, gx, gy, ok = jax.jit(pattern_tile_sample)(*args)
    rI, rgx, rgy, rok = sampler_reference(planes, u, v)
    shape = f"{width}x{height} P={points} F={frames} K={taps}"
    # float32 weights and sums of values up to 255: a few ulp of 255
    return [
        Check(f"sampler {shape} mask mismatches", float(np.sum(
            np.asarray(ok) != rok)), 0.0),
        Check(f"sampler {shape} value max |err|",
              _max_abs(I, rI, rok), 2e-3),
        Check(f"sampler {shape} gx max |err|", _max_abs(gx, rgx, rok), 2e-3),
        Check(f"sampler {shape} gy max |err|", _max_abs(gy, rgy, rok), 2e-3),
    ]


def raster_reference(xs, ys, vals, height: int, width: int):
    """np.add.at bilinear 4-tap splat with out-of-image taps dropped;
    returns (image, per-pixel sum of |contribution|, per-pixel count)."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    vals = np.asarray(vals, np.float64)
    img = np.zeros((height, width))
    mag = np.zeros((height, width))
    cnt = np.zeros((height, width))
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx, fy = xs - x0, ys - y0
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, (1 - fx) * fy),
                      (1, 0, fx * (1 - fy)), (1, 1, fx * fy)):
        ix, iy = x0 + dx, y0 + dy
        m = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        np.add.at(img, (iy[m], ix[m]), (w * vals)[m])
        np.add.at(mag, (iy[m], ix[m]), np.abs(w * vals)[m])
        np.add.at(cnt, (iy[m], ix[m]), 1.0)
    return img, mag, cnt


def check_raster(device, height: int, width: int, events: int,
                 seed: int = 0):
    """``events.scatter_accumulate`` on ``device`` against np.add.at. One
    eighth of the packet lands on a 3x3 hot spot, so many adds meet on one
    pixel. The sum order of those adds is not fixed, so the tolerance is
    the first-order float32 bound for forming (4 roundings per term) and
    summing n terms in any order: (n + 4) * eps * sum|terms| per pixel."""
    import jax
    from slam_eds_tpu.utils.events import scatter_accumulate
    rng = np.random.default_rng(seed)
    n_hot = events // 8
    xs = np.concatenate([rng.uniform(-2, width + 1, events - n_hot),
                         rng.uniform(width / 2, width / 2 + 2, n_hot)])
    ys = np.concatenate([rng.uniform(-2, height + 1, events - n_hot),
                         rng.uniform(height / 2, height / 2 + 2, n_hot)])
    vals = rng.choice([-1.0, 1.0], events) * rng.uniform(0.2, 1.0, events)
    xs, ys, vals = (a.astype(np.float32) for a in (xs, ys, vals))
    f = jax.jit(lambda x, y, w: scatter_accumulate(x, y, w, height, width))
    img = np.asarray(f(*jax.device_put((xs, ys, vals), device)),
                     np.float64)
    ref, mag, cnt = raster_reference(xs, ys, vals, height, width)
    eps = float(np.finfo(np.float32).eps)
    ratio = np.abs(img - ref) / ((cnt + 4) * eps * mag + 1e-30)
    return [Check(f"raster {width}x{height} N={events} "
                  f"max |err| / ((n+4)*eps*sum|x|) (max |err| "
                  f"{_max_abs(img, ref):.3e})", float(np.max(ratio)), 1.0)]


def _on(device, tree):
    import jax
    return jax.device_put(tree, device)


def check_ba(device, ref_device, height: int, width: int, points: int,
             frames: int = 8):
    """One 6-iteration ``energy.ba_iterate`` call on ``device`` against the
    same jitted function on ``ref_device``. Both run float32 with other
    reduction orders, and six GN steps on a window with a 1e8 gauge prior
    carry that rounding into the state, so the comparison is relative to
    each quantity's scale. A point's idepth step is (V.x - bd) / Hdd: for
    the few weakly observed points (small Hdd) it magnifies rounding in the
    frame step x, so the worst idepth gets a looser bound (5e-2; 1.05e-2
    seen on an H100 against its host CPU) than the mean (1e-3)."""
    import jax
    from slam_eds_tpu.models.ba_state import synthetic_window
    from slam_eds_tpu.ops import energy
    state, images = synthetic_window(frames, points, height, width)
    f = jax.jit(lambda st, im: energy.ba_iterate(st, im, height, width,
                                                 iterations=6)[:2])
    st_d, e_d = f(*_on(device, (state, images)))
    st_r, e_r = f(*_on(ref_device, (state, images)))
    e_r = float(e_r)
    d_r = np.asarray(st_r.delta)
    i_r = np.asarray(st_r.p_idepth)
    shape = f"{width}x{height} P={points} F={frames}"
    # the 68x68 LU of the reduced system and the 7x7 Cholesky of the gauge
    # projection feed every output below
    outs = (e_d, st_d.delta, st_d.p_idepth, st_d.c_delta)
    return [
        Check(f"ba_iterate {shape} non-finite outputs", float(sum(
            np.sum(~np.isfinite(np.asarray(o))) for o in outs)), 0.0),
        Check(f"ba_iterate {shape} energy rel err",
              abs(float(e_d) - e_r) / max(abs(e_r), 1e-12), 1e-3),
        Check(f"ba_iterate {shape} delta max |err| / max|delta|",
              _max_abs(st_d.delta, d_r) / (np.max(np.abs(d_r)) + 1e-12),
              1e-2),
        Check(f"ba_iterate {shape} p_idepth max |err| / max|idepth|",
              _max_abs(st_d.p_idepth, i_r) / np.max(np.abs(i_r)), 5e-2),
        Check(f"ba_iterate {shape} p_idepth mean |err| / max|idepth|",
              float(np.mean(np.abs(np.asarray(st_d.p_idepth, np.float64)
                                   - i_r))) / np.max(np.abs(i_r)), 1e-3),
    ]


def check_event_solve(device, ref_device, height: int, width: int,
                      points: int):
    """``__graft_entry__.entry()``'s ``event_tracker.optimize`` solve on
    ``device`` against ``ref_device`` (float32 on both; the LM accepts or
    rejects each step by comparing energies, so rounding can move the end
    point a little)."""
    import jax
    sys.path.insert(0, ROOT)
    import __graft_entry__
    fn, args = __graft_entry__.entry(height, width, points)
    f = jax.jit(fn)
    (st_d, e_d, _), (st_r, e_r, _) = (f(*_on(device, args)),
                                      f(*_on(ref_device, args)))
    e_r = float(e_r)
    pose_d = np.concatenate([np.asarray(st_d.px), np.asarray(st_d.qx)])
    pose_r = np.concatenate([np.asarray(st_r.px), np.asarray(st_r.qx)])
    shape = f"{width}x{height} P={points}"
    return [
        Check(f"event optimize {shape} energy rel err",
              abs(float(e_d) - e_r) / max(abs(e_r), 1e-12), 1e-3),
        Check(f"event optimize {shape} (px, q) max |err|",
              _max_abs(pose_d, pose_r), 1e-3),
    ]


def kernel_phase(device, ref_device, width: int, height: int, points: int,
                 events: int):
    """Phase 3: every check at the given widths."""
    checks = check_sampler(device, height, width, points)
    checks += check_raster(device, height, width, events)
    checks += check_ba(device, ref_device, height, width, points)
    checks += check_event_solve(device, ref_device, height, width, points)
    _report("kernels", checks)


# ---------------------------------------------------------------------------
# phase 4
def e2e_phase(work_dir: str, width: int, height: int, num_frames: int,
              events: int, motion_scale: float, micro_steps: int,
              config: dict, ate_bound: float, seed: int = 7,
              label: str = ""):
    """Write a seeded synthetic dataset and run it through
    ``runner.run_sequence``. ``config`` overrides the defaults (the
    reference operating point); packet capacities are set to ``events``.
    ``label`` (the card's name and power limit) starts the printed line."""
    import jax.numpy as jnp
    from slam_eds_tpu.config import load_config
    from slam_eds_tpu.io import event_buffer, frame_loader
    from slam_eds_tpu.io.dataset import SyntheticSequence
    from slam_eds_tpu.runner import run_sequence
    from slam_eds_tpu.utils.cameras import Pinhole

    f = 400.0 * width / 640.0
    cam = Pinhole(jnp.float32(f), jnp.float32(f), jnp.float32(width / 2 - 0.5),
                  jnp.float32(height / 2 - 0.5), width, height)
    t0 = time.perf_counter()
    seq = SyntheticSequence(cam, num_frames=num_frames,
                            events_per_packet=events, seed=seed,
                            motion_scale=motion_scale,
                            micro_steps=micro_steps)
    data_dir = seq.write_dataset(os.path.join(work_dir, "sequence"))
    t_data = time.perf_counter() - t0
    cfg = dict(config)
    cfg["caps"] = {**cfg.get("caps", {}), "max_events": events}
    cfg["event_frame"] = {**cfg.get("event_frame", {}),
                          "events_per_frame": events}
    cfg = load_config(cfg)
    res = run_sequence(data_dir, cfg, verbose=False)
    print(f"[e2e] {label} | {width}x{height} "
          f"points={cfg.caps.max_points_per_kf} "
          f"events/packet={events}: frames={res['frames']} "
          f"packets={res['packets']} tracked={res['packets_tracked']} "
          f"keyframes={res['keyframes']} resets={res['resets']} "
          f"frames_per_s={res['frames_per_s']:.3f} "
          f"ate_rmse={res.get('ate_rmse', float('nan')):.5f} "
          f"(bound {ate_bound}) wall_s={res['wall_s']:.1f} "
          f"dataset_s={t_data:.1f} native_ring={event_buffer.available()} "
          f"native_loader={frame_loader.available()}", flush=True)
    pos = np.asarray(res["positions"])
    if not (len(pos) and np.all(np.isfinite(pos))):
        raise AssertionError("e2e: non-finite or missing poses")
    if res["keyframes"] <= 1:
        raise AssertionError(f"e2e: {res['keyframes']} keyframes")
    if res["packets_tracked"] < 1:
        raise AssertionError("e2e: no event packet tracked")
    if not res.get("ate_rmse", math.inf) < ate_bound:
        raise AssertionError(f"e2e: ATE-RMSE {res.get('ate_rmse')} not "
                             f"below {ate_bound}")
    return res


# ---------------------------------------------------------------------------
def main():
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        # the CPU backend is the reference of phase 3
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax
    dev, smi = device_phase()
    sys.path.insert(0, ROOT)
    from slam_eds_tpu.compile_cache import setup_cache
    setup_cache(ROOT)
    cpu = jax.devices("cpu")[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        t = time.perf_counter()
        golden_phase(work)
        print(f"[golden] passed in {time.perf_counter() - t:.1f} s",
              flush=True)
        t = time.perf_counter()
        kernel_phase(dev, cpu, FULL["width"], FULL["height"], 2048,
                     FULL["events"])
        print(f"[kernels] passed in {time.perf_counter() - t:.1f} s",
              flush=True)
        t = time.perf_counter()
        e2e_phase(work, ate_bound=ATE_BOUND, label=smi, **FULL)
        print(f"[e2e] passed in {time.perf_counter() - t:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
