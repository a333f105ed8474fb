"""Sequence sources: synthetic scene simulator + generic array-based loader.

The reference consumes Rock/orogen streams of events + grayscale frames
(driver external to the repo, SURVEY §0/L7). Here:

* ``SyntheticSequence`` — an ESIM-style simulator: a textured non-planar
  world surface rendered along a smooth trajectory; events generated per
  pixel from log-intensity crossings between micro-steps (the standard
  event-camera contrast-threshold model). Gives ground truth for ATE and
  deterministic benchmarks without dataset downloads (the EDS CVPR'22
  sequences live at rpg.ifi.uzh.ch/eds; loaders for their format plug in
  through ``ArraySequence``).
* ``ArraySequence`` — wraps pre-loaded numpy arrays (timestamps, images,
  event packets) in the same iterator interface.

Event packets are fixed-capacity (pad/truncate) for static-shape jit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.cameras import Pinhole
from ..utils.interp import bilinear
from ..utils.lie import SE3
from ..utils.precision import full_f32


class EventPacket(NamedTuple):
    xs: np.ndarray      # [cap] float32
    ys: np.ndarray
    ts: np.ndarray
    polarity: np.ndarray
    n_valid: int


def pack_events(xs, ys, ts, pol, capacity: int) -> EventPacket:
    n = min(len(xs), capacity)
    out = []
    for a in (xs, ys, ts, pol):
        buf = np.zeros(capacity, np.float32)
        buf[:n] = a[:n]
        out.append(buf)
    return EventPacket(*out, n_valid=n)


class SyntheticSequence:
    """Deterministic synthetic event+frame sequence with ground truth."""

    def __init__(self, cam: Pinhole, num_frames: int = 30,
                 events_per_packet: int = 16384, seed: int = 7,
                 contrast_threshold: float = 0.08,
                 micro_steps: int = 4, motion_scale: float = 1.0):
        self.cam = cam
        self.num_frames = num_frames
        self.capacity = events_per_packet
        self.ct = contrast_threshold
        self.micro_steps = micro_steps
        rng = np.random.default_rng(seed)

        # textured world (log-intensity field over the surface plane)
        ys, xs = np.mgrid[0:512, 0:512]
        tex = (np.sin(xs * 0.11) * np.cos(ys * 0.13)
               + 0.7 * np.sin(xs * 0.031 + ys * 0.047)
               + 0.5 * np.cos(xs * 0.23) * np.sin(ys * 0.19)
               + 0.15 * rng.standard_normal((512, 512)))
        tex = (tex - tex.min()) / (tex.max() - tex.min()) * 220.0 + 20.0
        # wrap-pad one row/col so sampling with modulo coordinates
        # interpolates across the seam: the world surface is then textured
        # everywhere a long trajectory can look (a clamped border would be
        # gradient-free and starve the trackers — observed in burn-in runs)
        self.tex = jnp.asarray(np.pad(tex, ((0, 1), (0, 1)), mode="wrap"),
                               jnp.float32)
        self._tex_size = 512.0

        # smooth trajectory: sum of low-frequency sinusoids in the tangent
        t = np.linspace(0, 1, num_frames)
        amp = motion_scale * np.array([0.25, 0.18, 0.12, 0.05, 0.06, 0.08])
        phase = rng.uniform(0, 2 * np.pi, 6)
        freq = rng.uniform(0.8, 1.6, 6)
        self.taus = np.stack([
            amp[i] * np.sin(2 * np.pi * freq[i] * t + phase[i])
            - amp[i] * np.sin(phase[i])
            for i in range(6)], axis=-1).astype(np.float32)
        self.times = t.astype(np.float32)

        self._render = jax.jit(self._render_impl)

    def pose(self, k: int) -> SE3:
        """Ground-truth worldToCam pose of frame k."""
        return SE3.exp(jnp.asarray(self.taus[k]))

    def pose_at(self, alpha: float) -> SE3:
        """Interpolated pose at fractional frame index."""
        k0 = int(np.clip(np.floor(alpha), 0, self.num_frames - 1))
        k1 = min(k0 + 1, self.num_frames - 1)
        w = alpha - k0
        tau = (1 - w) * self.taus[k0] + w * self.taus[k1]
        return SE3.exp(jnp.asarray(tau))

    def _surface_z(self, X, Y):
        return 2.0 + 0.3 * jnp.sin(1.1 * X) * jnp.cos(0.9 * Y) + 0.15 * X

    @full_f32
    def _render_impl(self, tau):
        cam = self.cam
        T_wc = SE3.exp(tau)
        T_cw = T_wc.inverse()
        H, W = cam.height, cam.width
        ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                              jnp.arange(W, dtype=jnp.float32), indexing="ij")
        p = jnp.stack([(xs.ravel() - cam.cx) / cam.fx,
                       (ys.ravel() - cam.cy) / cam.fy,
                       jnp.ones(H * W, jnp.float32)], -1)
        dirs = p @ T_cw.R.T
        lam = (2.0 - T_cw.t[2]) / dirs[:, 2]
        for _ in range(6):
            Xw = T_cw.t[None, :] + dirs * lam[:, None]
            lam = (self._surface_z(Xw[:, 0], Xw[:, 1]) - T_cw.t[2]) / dirs[:, 2]
        Xw = T_cw.t[None, :] + dirs * lam[:, None]
        u = (Xw[:, 0] * 110.0 + 256.0) % self._tex_size
        v = (Xw[:, 1] * 110.0 + 256.0) % self._tex_size
        img = bilinear(self.tex, u, v).reshape(H, W)
        depth = (lam * dirs[:, 2]).reshape(H, W)   # camera-frame z
        return img, depth

    def frame(self, k: int):
        """(time, image [H, W] float32 0..255, gt depth [H, W])."""
        img, depth = self._render(jnp.asarray(self.taus[k]))
        return float(self.times[k]), np.asarray(img), np.asarray(depth)

    def events_between(self, k0: int, k1: int) -> EventPacket:
        """Contrast-threshold events between frames k0 -> k1 (micro-stepped
        log-intensity crossings; timestamps linearly interpolated)."""
        t0, t1 = self.times[k0], self.times[k1]
        xs_all, ys_all, ts_all, ps_all = [], [], [], []
        prev_log = None
        for s in range(self.micro_steps + 1):
            a = k0 + (k1 - k0) * s / self.micro_steps
            tau = ((1 - s / self.micro_steps) * self.taus[k0]
                   + (s / self.micro_steps) * self.taus[k1])
            img, _ = self._render(jnp.asarray(tau))
            log_img = np.log(np.asarray(img) + 20.0)
            if prev_log is not None:
                d = log_img - prev_log
                n_events = np.floor(np.abs(d) / self.ct).astype(np.int32)
                ys_i, xs_i = np.nonzero(n_events)
                reps = n_events[ys_i, xs_i]
                xs_r = np.repeat(xs_i, reps).astype(np.float32)
                ys_r = np.repeat(ys_i, reps).astype(np.float32)
                pol = np.repeat(np.sign(d[ys_i, xs_i]), reps).astype(np.float32)
                tt = np.full(xs_r.shape,
                             t0 + (t1 - t0) * (s - 0.5) / self.micro_steps,
                             np.float32)
                xs_all.append(xs_r)
                ys_all.append(ys_r)
                ts_all.append(tt)
                ps_all.append(pol)
            prev_log = log_img
        if xs_all:
            xs_c = np.concatenate(xs_all)
            ys_c = np.concatenate(ys_all)
            ts_c = np.concatenate(ts_all)
            ps_c = np.concatenate(ps_all)
            order = np.argsort(ts_c, kind="stable")
            # subsample uniformly if over capacity (keeps time order)
            if len(order) > self.capacity:
                sel = np.linspace(0, len(order) - 1, self.capacity).astype(int)
                order = order[sel]
            return pack_events(xs_c[order], ys_c[order], ts_c[order],
                               ps_c[order], self.capacity)
        return pack_events(np.zeros(0), np.zeros(0), np.zeros(0),
                           np.zeros(0), self.capacity)

    def write_dataset(self, out_dir: str, events: bool = True,
                      progress: bool = False) -> str:
        """Materialize this sequence as an on-disk dataset in the layout
        `runner.run_sequence` consumes (the external orogen task's data
        contract, SURVEY §0 L7): images/*.png (8-bit gray), images.txt
        ("t name"), events.txt ("t x y p"), calib.yaml (kalibr-style cam0
        block) and groundtruth.txt (TUM "t x y z qx qy qz qw", camToWorld).
        Returns out_dir."""
        import os as _os
        from .image_rw import write_png
        from ..utils.lie import mat_to_quat
        _os.makedirs(_os.path.join(out_dir, "images"), exist_ok=True)
        lines = []
        for k in range(self.num_frames):
            t, img, _ = self.frame(k)
            name = f"images/frame_{k:06d}.png"
            u8 = np.clip(np.rint(np.asarray(img)), 0, 255).astype(np.uint8)
            write_png(_os.path.join(out_dir, name), u8)
            lines.append(f"{t:.9f} {name}")
            if progress and k % 20 == 0:
                print(f"[write_dataset] frame {k}/{self.num_frames}",
                      flush=True)
        with open(_os.path.join(out_dir, "images.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if events:
            with open(_os.path.join(out_dir, "events.txt"), "w") as f:
                f.write("# t x y p\n")
                for k in range(self.num_frames - 1):
                    pk = self.events_between(k, k + 1)
                    n = int(pk.n_valid)
                    rows = np.column_stack([
                        np.asarray(pk.ts[:n], np.float64),
                        np.asarray(pk.xs[:n], np.float64),
                        np.asarray(pk.ys[:n], np.float64),
                        (np.asarray(pk.polarity[:n]) > 0).astype(np.float64)])
                    np.savetxt(f, rows, fmt="%.9f %.0f %.0f %.0f")
        cam = self.cam
        with open(_os.path.join(out_dir, "calib.yaml"), "w") as f:
            f.write("cam0:\n"
                    f"  resolution: [{int(cam.width)}, {int(cam.height)}]\n"
                    f"  intrinsics: [{float(cam.fx)}, {float(cam.fy)}, "
                    f"{float(cam.cx)}, {float(cam.cy)}]\n"
                    "  distortion_model: none\n")
        with open(_os.path.join(out_dir, "groundtruth.txt"), "w") as f:
            f.write("# t x y z qx qy qz qw\n")
            for k in range(self.num_frames):
                T = SE3.exp(jnp.asarray(self.taus[k])).inverse()  # camToWorld
                x, y, z = [float(v) for v in np.asarray(T.t)]
                qw, qx, qy, qz = [float(v) for v in
                                  np.asarray(mat_to_quat(T.R))]
                f.write(f"{self.times[k]:.9f} {x:.9f} {y:.9f} {z:.9f} "
                        f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")
        return out_dir

    def gt_positions(self):
        """[N, 3] ground-truth camera positions (camToWorld translations)."""
        out = []
        for k in range(self.num_frames):
            T = SE3.exp(jnp.asarray(self.taus[k]))
            out.append(np.asarray(T.inverse().t))
        return np.stack(out)


class ArraySequence:
    """Wrap preloaded arrays (times [N], images [N, H, W], optional event
    packets) in the sequence interface used by the pipeline."""

    def __init__(self, times, images, packets: Optional[list] = None,
                 gt_positions=None):
        self.times = np.asarray(times)
        self.images = np.asarray(images)
        self.packets = packets
        self._gt = gt_positions
        self.num_frames = len(self.times)

    def frame(self, k: int):
        return float(self.times[k]), self.images[k], None

    def events_between(self, k0: int, k1: int):
        if self.packets is None:
            return None
        return self.packets[k0]

    def gt_positions(self):
        return self._gt
