"""World-frame pointcloud export from the BA window state.

Counterpart of the reference's backend map exporter (reference
src/io/OutputMaps.{h,cpp} — `dso::io::getMap(fh, hcalib, color)` exports
FrameHessian active/marginalized/immature points as world pointclouds with
idepth-variance filtering, OutputMaps.h:49-52) and of the keyframe map
export `KeyFrame::getMap` (reference src/tracking/KeyFrame.cpp:1239-1300,
colored pointcloud with per-point color source selection).

Points live in fixed-capacity masked arrays (BAState), so "export" is one
vectorized backproject + rigid transform plus a validity mask; the caller
gets numpy arrays ready for PLY/NPZ dumping.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..models import ba_state as bs
from ..utils.lie import SE3


class PointCloud(NamedTuple):
    xyz: np.ndarray      # [N, 3] world coordinates
    color: np.ndarray    # [N, 3] uint8
    valid: np.ndarray    # [N] bool


@jax.jit
def _backproject_window(state: bs.BAState, min_rel_var: float = 0.001):
    """World xyz for every point slot + a variance/validity mask.

    Mirrors the reference's export filter (OutputMaps.cpp: points are kept
    when `idepth_var * idepth^4 < relVarTh` — variance relative to depth^4
    keeps the threshold scale-invariant; we use the idepth prior weight as
    the inverse-variance proxy since BAState keeps no explicit variance).
    """
    calib = state.current_calib()
    fx, fy, cx, cy = calib[0], calib[1], calib[2], calib[3]
    idp = jnp.maximum(state.p_idepth, 1e-8)
    x = (state.p_uv[:, 0] - cx) / fx / idp
    y = (state.p_uv[:, 1] - cy) / fy / idp
    z = 1.0 / idp
    X_host = jnp.stack([x, y, z], -1)                       # [P, 3] in host cam

    poses = state.current_poses()                           # worldToCam per slot
    R_wc = jnp.swapaxes(poses.R, -1, -2)                    # camToWorld rotation
    t_wc = -jnp.einsum("fij,fj->fi", R_wc, poses.t)
    Rh = R_wc[state.p_host]                                 # [P, 3, 3]
    th = t_wc[state.p_host]                                 # [P, 3]
    xyz_w = jnp.einsum("pij,pj->pi", Rh, X_host) + th

    valid = ((state.p_status == bs.PT_ACTIVE)
             | (state.p_status == bs.PT_MARGINALIZE))
    valid &= state.frame_valid[state.p_host]
    valid &= state.p_idepth > 1e-6
    return xyz_w, valid


def get_map(state: bs.BAState, images: Optional[np.ndarray] = None,
            color_mode: str = "image", sor=None) -> PointCloud:
    """Export the BA window as a colored world pointcloud.

    color_mode: 'image' samples the host keyframe intensity at the point
    pixel (reference KeyFrame::getMap MODE_IMAGE); 'depth' colors by
    inverse depth (MODE_DEPTH); 'residual' would need the last linearize —
    callers overlay that via utils.viz instead.
    sor: optional (nb_points, radius) enabling radius outlier removal on
    the exported cloud (MappingConfig.sor_*).
    """
    xyz, valid = _backproject_window(state)
    if sor is not None:
        valid = radius_outlier_removal(xyz, valid, int(sor[0]),
                                       float(sor[1]))
    xyz = np.asarray(xyz)
    valid = np.asarray(valid)
    P = xyz.shape[0]
    color = np.full((P, 3), 200, np.uint8)
    if color_mode == "image" and images is not None:
        imgs = np.asarray(images)
        host = np.asarray(state.p_host)
        uv = np.asarray(state.p_uv)
        H, W = imgs.shape[1], imgs.shape[2]
        u = np.clip(np.round(uv[:, 0]).astype(np.int64), 0, W - 1)
        v = np.clip(np.round(uv[:, 1]).astype(np.int64), 0, H - 1)
        inten = imgs[host, v, u]
        if inten.ndim == 2:          # [P, C] image with channels (I, dx, dy)
            inten = inten[:, 0]
        g = np.clip(inten, 0, 255).astype(np.uint8)
        color = np.stack([g, g, g], -1)
    elif color_mode == "depth":
        from ..utils.viz import apply_colormap, JET
        idp = np.asarray(state.p_idepth)
        sel = idp[valid] if valid.any() else idp
        color = apply_colormap(idp, JET, vmin=float(sel.min()),
                               vmax=float(sel.max()))
    return PointCloud(xyz=xyz, color=color, valid=valid)


@jax.jit
def radius_outlier_removal(xyz, valid, nb_points: int = 8,
                           radius: float = 0.1):
    """Radius outlier removal on the exported cloud: keep points with at
    least ``nb_points`` neighbors within ``radius`` — the reference's PCL
    SOR pass on the map output (``sor_active/nb_points/radius`` in
    src/mapping/Config.hpp:29-61). Brute-force [N, N] distance matrix: at
    map capacities (<= a few thousand points) one matmul-shaped reduction
    replaces a tree walk. Returns the tightened validity mask."""
    x = jnp.asarray(xyz, jnp.float32)
    sq = jnp.sum(x * x, axis=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    near = (d2 <= radius * radius) & valid[None, :] & valid[:, None]
    count = jnp.sum(near, axis=1) - 1          # exclude self
    return valid & (count >= nb_points)


def write_ply(path: str, cloud: PointCloud) -> int:
    """ASCII PLY dump of the valid points; returns the point count."""
    xyz = cloud.xyz[cloud.valid]
    rgb = cloud.color[cloud.valid]
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
    return n


def write_trajectory_tum(path: str, times, poses: SE3) -> int:
    """TUM-format trajectory dump (`t x y z qx qy qz qw`), the format the
    reference's recorder writes for evo evaluation (recorder::Config,
    reference src/utils/Config.hpp:27-54)."""
    from ..utils.lie import mat_to_quat
    R = np.asarray(poses.R)
    t = np.asarray(poses.t)
    times = np.asarray(times)
    n = len(times)
    with open(path, "w") as f:
        for k in range(n):
            # stored worldToCam; export camToWorld like the reference
            Rwc = R[k].T
            twc = -Rwc @ t[k]
            q = np.asarray(mat_to_quat(jnp.asarray(Rwc)))  # [w, x, y, z]
            f.write(f"{times[k]:.9f} {twc[0]:.6f} {twc[1]:.6f} {twc[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")
    return n
