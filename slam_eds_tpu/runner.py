"""Sequence runner — the user-facing driver the reference keeps external.

The reference library is driven by a Rock/orogen task (SURVEY §0 L7) that
owns dataset IO, event/frame interleaving, and output recording. This module
is that driver as a CLI: it streams a standard event-camera text dataset

    <dir>/events.txt        # "t x y p" lines ('#' comments)
    <dir>/images.txt        # "t filename" lines
    <dir>/images/*.png      # grayscale frames (any PNG the codec reads)
    <dir>/calib.yaml        # calib schema of utils/calib.py  (optional)
    <dir>/groundtruth.txt   # "t x y z qx qy qz qw"           (optional)

through the native event ring into ``EDSPipeline`` (or the frame-only
slice), records poses/velos via the recorder, and reports ATE-RMSE against
ground truth when present.

    python -m slam_eds_tpu.runner <dataset_dir> [--config cfg.yaml]
        [--frames N] [--frame-only] [--output out_dir]
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import jax.numpy as jnp

from .config import EDSConfig, load_config
from .io import event_buffer as eb
from .io.image_rw import read_png
from .models.pipeline import EDSPipeline, FrameOnlyPipeline
from .utils.alignment import ate_rmse
from .utils.cameras import Pinhole


def _load_images_index(path: str):
    times, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            times.append(float(parts[0]))
            names.append(parts[1])
    return np.asarray(times), names


def _load_groundtruth(path: str):
    """TUM-format ground truth: ``t x y z [qx qy qz qw]``. Returns
    (times, positions, quats_or_None) — quats in [w,x,y,z] order."""
    rows = np.loadtxt(path, comments="#")
    quats = None
    if rows.shape[1] >= 8:
        quats = rows[:, [7, 4, 5, 6]]    # xyzw -> wxyz
    return rows[:, 0], rows[:, 1:4], quats


def _camera_from_dataset(d: str, first_img):
    """Resolve the dataset's camera setup. Returns a dict:
      cam           — the working Pinhole geometry
      frame_maps    — optional (map_x, map_y) to remap frames into `cam`
      event_fwd     — optional (fwd_x, fwd_y) per-event undistortion tables
      photometric   — optional PhotometricCalib (gamma/vignette)

    Three situations, mirroring the reference's calib stack
    (src/utils/Calib.cpp):
    * dual rig (`cam0` + `cam1` blocks): both sensors are rectified into the
      common-view geometry (setNewCamera/getMapping) — frames are remapped,
      events go through the forward maps;
    * mono calib (`cam0` only): distortion becomes an image remap + event
      forward maps into the undistorted pinhole;
    * no calib: a 90-deg-FOV pinhole fallback.
    DSO photometric files (`pcalib.txt` gamma, `vignette.png`) are applied
    to frames when present (PhotometricUndistorter, Undistort.h:40-64)."""
    import numpy as _np
    from .utils import calib as cal
    from .utils.cameras import undistortion_maps, forward_maps

    H, W = first_img.shape[:2]
    out = {"cam": None, "frame_maps": None, "event_fwd": None,
           "photometric": None}
    calib_path = os.path.join(d, "calib.yaml")
    if os.path.exists(calib_path):
        from .io import yaml_subset
        data = yaml_subset.load(calib_path) or {}
        if "cam0" in data and "cam1" in data:
            dual = cal.read_dual_calibration(data)
            maps = cal.dual_mappings(dual)
            out["cam"] = maps["out"]
            out["frame_maps"] = (maps["frame_map_x"], maps["frame_map_y"])
            out["event_fwd"] = (maps["event_fwd_x"], maps["event_fwd_y"])
        else:
            info = cal.read_camera_calib(data)
            model = info.to_model()
            if info.distortion_model not in ("none", ""):
                pin = model.pinhole
                out["cam"] = pin
                out["frame_maps"] = undistortion_maps(model)
                out["event_fwd"] = forward_maps(model)
            else:
                fx, fy, cx, cy = info.intrinsics
                out["cam"] = Pinhole(jnp.float32(fx), jnp.float32(fy),
                                     jnp.float32(cx), jnp.float32(cy), W, H)
    if out["cam"] is None:
        # no calib shipped: assume a 90-deg FOV pinhole (documented fallback)
        f = 0.5 * W
        out["cam"] = Pinhole(jnp.float32(f), jnp.float32(f),
                             jnp.float32(W / 2 - 0.5),
                             jnp.float32(H / 2 - 0.5), W, H)
    pcal = os.path.join(d, "pcalib.txt")
    if os.path.exists(pcal):
        gamma = _np.loadtxt(pcal)
        vig = None
        vpath = os.path.join(d, "vignette.png")
        if os.path.exists(vpath):
            vig = read_png(vpath)
        out["photometric"] = cal.PhotometricCalib.from_files(gamma, vig)
    return out


def run_sequence(dataset_dir: str, cfg: Optional[EDSConfig] = None,
                 max_frames: Optional[int] = None, frame_only: bool = False,
                 verbose: bool = True):
    """Run the pipeline over one on-disk sequence. Returns a dict of
    results (poses, event poses, ATE when ground truth exists, rates)."""
    cfg = cfg or EDSConfig()
    img_times, img_names = _load_images_index(
        os.path.join(dataset_dir, "images.txt"))
    if max_frames:
        img_times, img_names = img_times[:max_frames], img_names[:max_frames]
    first = read_png(os.path.join(dataset_dir, img_names[0]))
    setup = _camera_from_dataset(dataset_dir, first)
    cam = setup["cam"]
    photometric = setup["photometric"]
    frame_maps = setup["frame_maps"]
    fwd_maps = setup["event_fwd"]
    if frame_maps is not None:
        from .utils.cameras import remap as _remap
        import jax as _jax
        _remap_j = _jax.jit(lambda im: _remap(im, frame_maps[0],
                                              frame_maps[1]))

    def _prep_frame(raw):
        img = raw
        if photometric is not None:
            img = np.asarray(photometric.correct(raw.astype(np.int32)))
        img = np.asarray(img, np.float32)
        if frame_maps is not None:
            img = np.asarray(_remap_j(jnp.asarray(img)))
        return img

    pipe = (FrameOnlyPipeline if frame_only else EDSPipeline)(
        cam, cfg, photometric=photometric)

    ring = None
    events_path = os.path.join(dataset_dir, "events.txt")
    if not frame_only and os.path.exists(events_path):
        ring = eb.EventRing(1 << 22) if eb.available() \
            else eb.PurePythonRing(1 << 22)
        # streaming reader either way: the pure-Python fallback reads the
        # text file incrementally (O(chunk) memory for multi-GB files)
        reader = (eb.EventFileReader if eb.available()
                  else eb.PurePythonReader)(events_path)

    from .io import frame_loader as fl
    from .io.dataset import EventPacket
    cap = cfg.event_frame.events_per_frame
    use_native = fl.available()
    loader = fl.FrameLoader(
        [os.path.join(dataset_dir, n) for n in img_names],
        n_threads=2, depth=4) if use_native else None

    def _frame(k):
        # prefetched native decode when available (decode overlaps compute)
        if loader is not None:
            return _prep_frame(loader.next())
        return _prep_frame(read_png(os.path.join(dataset_dir, img_names[k])))

    def _events(xs, ys, ts, ps, n, med):
        nonlocal n_packets
        packet = EventPacket(xs, ys, ts.astype(np.float32), ps, n)
        T = pipe.process_events(packet, fwd_maps=fwd_maps)
        n_packets += 1
        if T is not None:
            ev_times.append(med)

    t_start = time.perf_counter()
    n_packets = 0
    ev_times = []
    if use_native and isinstance(ring, eb.EventRing):
        # native dataflow: the C++ SequenceScheduler owns the frame/packet
        # interleave and tops the ring up from the reader itself
        sched = fl.SequenceScheduler(ring, reader, img_times, cap,
                                     min_events=64)
        while True:
            kind, payload = sched.next()
            if kind == fl.DONE:
                break
            if kind == fl.FRAME:
                k = payload
                pipe.process_frame(_frame(k), float(img_times[k]))
                if verbose and k % 10 == 0:
                    print(f"[runner] frame {k}/{len(img_names)} "
                          f"packets={n_packets}")
            else:
                _events(*payload)
    else:
        for k, t_img in enumerate(img_times):
            pipe.process_frame(_frame(k), float(t_img))
            if ring is None:
                continue
            if k + 1 >= len(img_times):
                continue
            # time-sliced packets: all events up to the next frame, in
            # chunks of at most events_per_frame (the reference driver's
            # packetization — events between consecutive frames tracked
            # against the last KF). The reader tops the ring up between
            # pops so ring capacity bounds memory, not file size.
            t_next = float(img_times[k + 1])
            while True:
                if reader is not None:
                    reader.pump(ring, 1 << 16)
                xs, ys, ts, ps, n, med = ring.pop_until(t_next, cap)
                if n < 64:   # too thin to rasterize a usable event frame
                    break
                _events(xs, ys, ts, ps, n, med)
                if n < cap:  # interval drained
                    break
            if verbose and k % 10 == 0:
                print(f"[runner] frame {k}/{len(img_names)} "
                      f"packets={n_packets}")
    wall = time.perf_counter() - t_start

    out = {
        "frames": len(img_names),
        "packets": n_packets,
        "packets_tracked": len(ev_times),
        "wall_s": wall,
        "frames_per_s": len(img_names) / wall,
    }
    fp = pipe if frame_only else pipe.frame_pipe
    out["resets"] = fp._resets
    out["marginalizations"] = fp.window.marg_count
    out["keyframes"] = fp.window.next_id
    est = np.stack(fp.trajectory) if fp.trajectory else np.zeros((0, 3))
    out["positions"] = est
    gt_path = os.path.join(dataset_dir, "groundtruth.txt")
    if os.path.exists(gt_path) and len(est) > 4:
        gt_t, gt_xyz, gt_q = _load_groundtruth(gt_path)
        # associate by the timestamps recorded with each trajectory entry —
        # the bootstrap can consume several frames while appending only two
        # entries, so img_times[:len(est)] would be shifted by the bootstrap
        # length (round-2 advisor finding)
        est_t = np.asarray(fp.times[: len(est)], np.float64)
        idx = np.searchsorted(gt_t, est_t)
        idx = np.clip(idx, 0, len(gt_t) - 1)
        out["ate_rmse"] = float(ate_rmse(jnp.asarray(est),
                                         jnp.asarray(gt_xyz[idx])))
        if gt_q is not None and fp.poses and len(fp.poses) == len(est):
            # RPE needs full poses: est world_T_cam from the pipeline,
            # ground truth from the TUM quaternions. The monocular scale is
            # a gauge freedom — correct it with the Umeyama scale (relative
            # translations scale linearly under a global Sim3).
            from .utils.alignment import rpe, umeyama
            from .utils.lie import SE3, quat_to_mat
            import jax
            est_wc = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *[p.inverse() for p in fp.poses])
            s_fit, _, _ = umeyama(jnp.asarray(est),
                                  jnp.asarray(gt_xyz[idx], jnp.float32))
            est_wc = SE3(est_wc.R, s_fit * est_wc.t)
            R_gt = jax.vmap(quat_to_mat)(
                jnp.asarray(gt_q[idx], jnp.float32))
            gt_wc = SE3(R_gt, jnp.asarray(gt_xyz[idx], jnp.float32))
            t_err, r_err = rpe(est_wc, gt_wc, delta=1)
            out["rpe_trans"] = float(t_err)
            out["rpe_rot_rad"] = float(r_err)
    if not frame_only and pipe.recorder is not None:
        pipe.recorder.flush()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_dir")
    ap.add_argument("--config", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--frame-only", action="store_true")
    ap.add_argument("--output", default=None)
    args = ap.parse_args()
    cfg = load_config(args.config) if args.config else EDSConfig()
    if args.output:
        cfg = replace(cfg, recorder=replace(cfg.recorder, enabled=True,
                                            output_folder=args.output))
    res = run_sequence(args.dataset_dir, cfg, max_frames=args.frames,
                       frame_only=args.frame_only)
    print({k: v for k, v in res.items() if k != "positions"})


if __name__ == "__main__":
    main()
