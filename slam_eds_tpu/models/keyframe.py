"""EDS KeyFrame — the event-side reference frame with its active point set.

Array-based redesign of ``eds::tracking::KeyFrame`` (reference
src/tracking/KeyFrame.{hpp,cpp}): one pytree of fixed-capacity parallel
arrays with a validity mask replaces the 10 grow/erase std::vectors
(coord, norm_coord, grad, patches, residuals, weights, tracks, flow,
inv_depth — KeyFrame.hpp:76-96, erasePoint KeyFrame.cpp:1060-1106).

Creation pipeline (KeyFrame.cpp:333-463):
  min-max normalize -> log image log(I + 0.2) -> Sobel gradients ->
  candidate selection on |grad| (patch-grid MAX/MEDIAN) -> normalized
  coords -> per-point gradient sampling -> depth init from a sparse map
  (NN + distance weights, setDepthMap :1137-1198) or constant.

Point lifecycle becomes mask updates: ``clean_points`` (weight threshold,
:1566-1587), ``points_refinement`` (drop points without nearby event
activity, :1031-1058), ``erase`` (out-of-frame, Tracker::getCoord).
The generative model ``sparse_model``/``model_image`` mirrors
getSparseModel/getModel (:1358-1423).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils import image as image_ops
from ..utils.cameras import Pinhole
from ..utils.events import scatter_accumulate
from ..utils.interp import bilinear
from ..utils.lie import SE3
from ..ops.pixel_selector import candidate_points_grid
from ..ops.event_tracker import compute_flow


class KeyFrame(NamedTuple):
    # images
    img: jax.Array        # [H, W] min-max normalized intensity
    log_img: jax.Array    # [H, W] log(I + log_eps)
    grad_img: jax.Array   # [H, W, 2] Sobel gradients of the log image
    # active points (capacity P, masked)
    uv: jax.Array         # [P, 2] pixel coords
    norm_coord: jax.Array  # [P, 2] normalized camera coords
    grad: jax.Array       # [P, 2] log-image gradient at the point
    idepth: jax.Array     # [P] inverse depth (filter mean)
    weight: jax.Array     # [P] point weight in [0, 1]
    residual: jax.Array   # [P] last tracker residuals
    track: jax.Array      # [P, 2] accumulated track vector (event frame)
    mask: jax.Array       # [P] point alive
    n_initial: jax.Array  # number of points at creation (KF-need percent)
    # pose
    T_w_kf_R: jax.Array   # [3, 3]
    T_w_kf_t: jax.Array   # [3]
    time: jax.Array       # scalar timestamp

    @property
    def pose(self) -> SE3:
        return SE3(self.T_w_kf_R, self.T_w_kf_t)


def nn_depth_lookup(uv, map_uv, map_idp, map_mask):
    """Brute-force nearest-neighbor inverse-depth association + distance
    weights (setDepthMap, KeyFrame.cpp:1137-1198; the reference's KDTree is
    a CPU-side optimization — here the dense [P, M] distance matrix is a
    single matmul-shaped reduction).

    Returns (idepth [P], weight [P]): weight = 1 - minmax-normalized NN
    distance (all-ones when distances are constant)."""
    d2 = jnp.sum((uv[:, None, :] - map_uv[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(map_mask[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1)
    dist = jnp.sqrt(jnp.take_along_axis(d2, idx[:, None], 1)[:, 0])
    idp = map_idp[idx]
    dmin = jnp.min(dist)
    dmax = jnp.max(dist)
    w = jnp.where(dmax > dmin, 1.0 - (dist - dmin) / (dmax - dmin + 1e-12),
                  jnp.ones_like(dist))
    return idp, w


def idepth_map_from_depth_image(depth, stride: int = 4,
                                min_depth: float = 1e-3,
                                max_depth: float = jnp.inf):
    """Sparse IDepthMap (uv [M,2], idepth [M], mask [M]) from a dense depth
    image — ``eds::mapping::IDepthMap`` from-depth-image conversion
    (reference src/mapping/Types.hpp:109-276). Subsamples on a regular
    ``stride`` grid (fixed shape for jit); non-finite / out-of-range depths
    are masked. A range/"DistanceImage" input is the same thing with range
    treated as z."""
    d = jnp.asarray(depth, jnp.float32)
    H, W = d.shape
    ys, xs = jnp.meshgrid(jnp.arange(0, H, stride, dtype=jnp.float32),
                          jnp.arange(0, W, stride, dtype=jnp.float32),
                          indexing="ij")
    z = d[::stride, ::stride]
    mask = jnp.isfinite(z) & (z > min_depth) & (z < max_depth)
    uv = jnp.stack([xs.ravel(), ys.ravel()], -1)
    idp = 1.0 / jnp.maximum(z.ravel(), min_depth)
    return uv, idp, mask.ravel()


def idepth_map_from_pointcloud(Xw, T_cw: SE3, cam: Pinhole, mask=None):
    """Sparse IDepthMap from a world-frame pointcloud [M, 3] projected into
    the camera at worldToCam ``T_cw`` — the IDepthMap-from-pointcloud path
    of reference src/mapping/Types.hpp:109-276. Returns (uv, idepth, mask);
    points behind the camera or outside the image are masked."""
    Xc = T_cw.apply(jnp.asarray(Xw, jnp.float32))
    z = Xc[:, 2]
    zs = jnp.maximum(z, 1e-6)
    u = cam.fx * Xc[:, 0] / zs + cam.cx
    v = cam.fy * Xc[:, 1] / zs + cam.cy
    ok = (z > 1e-6) & (u >= 0) & (v >= 0) \
        & (u <= cam.width - 1) & (v <= cam.height - 1)
    if mask is not None:
        ok = ok & mask
    return jnp.stack([u, v], -1), 1.0 / zs, ok


def create_keyframe(raw_img, cam: Pinhole, capacity: int,
                    percent_points: float = 0.4,
                    patch: int = 8, selection_mode: str = "max",
                    log_eps: float = 0.2, sobel_ksize: int = 3,
                    depth_map=None, init_depth: float = 1.0,
                    T_w_kf: Optional[SE3] = None,
                    time=0.0) -> KeyFrame:
    """Build a KeyFrame from a raw intensity image (already undistorted /
    rescaled host-side as needed; cf. KeyFrame.cpp:174-210).

    depth_map: optional (map_uv [M, 2], map_idp [M], map_mask [M]) sparse
    inverse-depth map for NN seeding (the MiDaS / event-map path); otherwise
    constant ``init_depth`` with unit weights.
    """
    dtype = jnp.float32
    img = image_ops.minmax_normalize(jnp.asarray(raw_img, dtype))
    log_img = image_ops.log_image(img, log_eps)
    gx, gy = image_ops.sobel(log_img, sobel_ksize)
    grad_img = jnp.stack([gx, gy], axis=-1)
    gmag = image_ops.gradient_magnitude(gx, gy)

    uv, mask = candidate_points_grid(gmag, patch=patch, capacity=capacity,
                                     mode=selection_mode)
    # percent_points thinning: keep the top fraction by |grad|
    n_target = jnp.asarray(percent_points * jnp.sum(mask), jnp.int32)
    keep = jnp.arange(capacity) < n_target   # top_k output is score-ordered
    mask = mask & keep

    nc = jnp.stack([(uv[:, 0] - cam.cx) / cam.fx,
                    (uv[:, 1] - cam.cy) / cam.fy], axis=-1)
    g_pt = jnp.stack([bilinear(gx, uv[:, 0], uv[:, 1]),
                      bilinear(gy, uv[:, 0], uv[:, 1])], axis=-1)

    if depth_map is not None:
        idp, w = nn_depth_lookup(uv, *depth_map)
    else:
        idp = jnp.full((capacity,), 1.0 / init_depth, dtype)
        w = jnp.ones((capacity,), dtype)

    if T_w_kf is None:
        T_w_kf = SE3.identity(dtype)

    return KeyFrame(
        img=img, log_img=log_img, grad_img=grad_img,
        uv=uv, norm_coord=nc, grad=g_pt,
        idepth=idp, weight=jnp.where(mask, w, 0.0),
        residual=jnp.zeros((capacity,), dtype),
        track=jnp.zeros((capacity, 2), dtype),
        mask=mask, n_initial=jnp.sum(mask),
        T_w_kf_R=T_w_kf.R, T_w_kf_t=T_w_kf.t,
        time=jnp.asarray(time, dtype))


def clean_points(kf: KeyFrame, weight_threshold: float = 0.7) -> KeyFrame:
    """Mask off low-weight points (cleanPoints, KeyFrame.cpp:1566-1587)."""
    return kf._replace(mask=kf.mask & (kf.weight >= weight_threshold))


def points_refinement(kf: KeyFrame, event_frame, radius: int = 2,
                      activity_threshold: float = 1e-4) -> KeyFrame:
    """Drop points without nearby event activity (pointsRefinement,
    KeyFrame.cpp:1031-1058): sample |event frame| in a small neighborhood;
    points in event-free regions are masked off."""
    offs = jnp.arange(-radius, radius + 1, dtype=kf.uv.dtype)
    dy, dx = jnp.meshgrid(offs, offs, indexing="ij")
    xs = kf.uv[:, 0:1] + dx.ravel()[None, :]
    ys = kf.uv[:, 1:2] + dy.ravel()[None, :]
    act = jnp.max(jnp.abs(bilinear(event_frame, xs, ys)), axis=-1)
    return kf._replace(mask=kf.mask & (act > activity_threshold))


def erase_out_of_frame(kf: KeyFrame, uv_warped, cam: Pinhole) -> KeyFrame:
    """Mask points whose warp left the event frame (Tracker::getCoord
    delete_out branch)."""
    alive = (uv_warped[:, 0] >= 0) & (uv_warped[:, 0] <= cam.width - 1) \
        & (uv_warped[:, 1] >= 0) & (uv_warped[:, 1] <= cam.height - 1)
    return kf._replace(mask=kf.mask & alive)


def need_new_kf(kf: KeyFrame, percent_loss: float = 0.3):
    """Point-loss criterion (needNewKF, KeyFrame.cpp:1552-1557): a new KF is
    needed when more than percent_loss of the initial points died."""
    alive = jnp.sum(kf.mask)
    return alive < (1.0 - percent_loss) * kf.n_initial


def kf_selection_occlusion(delta_pose: SE3, median_depth,
                           threshold: float = 0.20):
    """Occlusion criterion (keyframe_selection_occlusion,
    src/utils/Utils.hpp:292-299): parallax ratio ||t|| / median_depth >
    threshold."""
    return jnp.linalg.norm(delta_pose.t) / median_depth > threshold


def kf_selection_rotation(delta_pose: SE3,
                          threshold: float = 0.174533 / 3.0):
    """Rotation criterion (keyframe_selection_rotation,
    src/utils/Utils.hpp:301-308): rotation angle of the delta pose >
    threshold (default 5 deg / 3)."""
    tau = delta_pose.log()
    return jnp.linalg.norm(tau[3:]) > threshold


def kf_selection_translation(delta_pose: SE3, threshold: float = 0.05):
    """Translation criterion (keyframe_selection_translation,
    src/utils/Utils.hpp:310-315): ||t|| > threshold (default 5 cm)."""
    return jnp.linalg.norm(delta_pose.t) > threshold


def sparse_model(kf: KeyFrame, vx, norm_eps: float = 1e-3):
    """Normalized brightness-change model per point:
    model_i = -(grad_i . flow_i) / ||model||  (getSparseModel,
    KeyFrame.cpp:1358-1403). vx: 6-dof [linear, angular] velocity."""
    flow = compute_flow(kf.norm_coord, vx, kf.idepth)
    model = -(kf.grad[:, 0] * flow[:, 0] + kf.grad[:, 1] * flow[:, 1])
    model = jnp.where(kf.mask, model, 0.0)
    norm = jnp.sqrt(norm_eps + jnp.sum(model * model))
    return model / norm


def model_image(kf: KeyFrame, vx, height: int, width: int,
                method: str = "bilinear"):
    """Rasterized model image (getModel, KeyFrame.cpp:1405-1423)."""
    m = sparse_model(kf, vx)
    return scatter_accumulate(kf.uv[:, 0], kf.uv[:, 1], m, height, width,
                              mask=kf.mask, method=method)


def export_map(kf: KeyFrame, cam: Pinhole):
    """World-frame pointcloud of the active points with intensity colors
    (getMap, KeyFrame.cpp:1239-1300). Returns (xyz [P, 3], color [P],
    mask [P])."""
    z = 1.0 / jnp.maximum(kf.idepth, 1e-6)
    X = jnp.stack([kf.norm_coord[:, 0] * z, kf.norm_coord[:, 1] * z, z],
                  axis=-1)
    Xw = kf.pose.apply(X)
    color = bilinear(kf.img, kf.uv[:, 0], kf.uv[:, 1])
    return Xw, color, kf.mask
