"""Camera models, distortion and undistortion-map precompute.

Array-based replacement for the reference's calibration stack:
* ``src/utils/Calib.{hpp,cpp}`` — CameraInfo/DualCamera/Camera with OpenCV
  undistortion maps (readCameraCalib / setNewCamera / getMapping).
* ``src/utils/Undistort.{h,cpp}`` — DSO geometric undistorters
  (RadTan / Equidistant(KB) / FOV / Pinhole) and the photometric undistorter
  (gamma response + vignette).

Design: everything is a pure function over a small ``Pinhole`` pytree.
Distortion inversion (needed to build forward maps: distorted pixel ->
undistorted ray) is a fixed-iteration Newton/fixed-point loop (jit-friendly;
the reference relies on OpenCV's iterative ``cv::undistortPoints`` which does
the same with 5 iterations). Map *precompute* happens once per sequence on
host; per-event lookup then is a gather — see ``slam_eds_tpu.utils.events``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from typing import NamedTuple, Optional


class Pinhole(NamedTuple):
    """Intrinsics K = [[fx,0,cx],[0,fy,cy],[0,0,1]] plus image size."""
    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    width: int
    height: int

    @property
    def K(self):
        fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        return jnp.stack([
            jnp.stack([fx, z, cx]),
            jnp.stack([z, fy, cy]),
            jnp.stack([z, z, o]),
        ])

    def scaled(self, out_w: int, out_h: int) -> "Pinhole":
        """Rescale intrinsics the way the reference rescales K on image resize
        (src/tracking/KeyFrame.cpp:192-210: fx*sx, fy*sy, (cx+0.5)*sx-0.5)."""
        sx = out_w / self.width
        sy = out_h / self.height
        return Pinhole(self.fx * sx, self.fy * sy,
                       (self.cx + 0.5) * sx - 0.5, (self.cy + 0.5) * sy - 0.5,
                       out_w, out_h)

    def pyramid_level(self, lvl: int) -> "Pinhole":
        """Half-resolution intrinsics per pyramid level (DSO convention,
        src/utils/globalCalib.cpp: fx*0.5^l, cx = (cx+0.5)/2^l - 0.5)."""
        s = 0.5 ** lvl
        return Pinhole(self.fx * s, self.fy * s,
                       (self.cx + 0.5) * s - 0.5, (self.cy + 0.5) * s - 0.5,
                       self.width >> lvl, self.height >> lvl)


def project(cam: Pinhole, xyz):
    """3D points [...,3] -> pixels [...,2] (no distortion)."""
    z = xyz[..., 2]
    inv_z = 1.0 / z
    u = cam.fx * xyz[..., 0] * inv_z + cam.cx
    v = cam.fy * xyz[..., 1] * inv_z + cam.cy
    return jnp.stack([u, v], axis=-1)


def backproject(cam: Pinhole, uv, inv_depth):
    """Pixels [...,2] + inverse depth [...] -> 3D points [...,3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    z = 1.0 / (inv_depth + 1e-12)
    return jnp.stack([x * z, y * z, z], axis=-1)


def normalized_coords(cam: Pinhole, uv):
    """Pixels -> normalized image coords [(u-cx)/fx, (v-cy)/fy]
    (reference src/tracking/KeyFrame.cpp:270-280)."""
    return jnp.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], axis=-1)


# ---------------------------------------------------------------------------
# Distortion models. D layouts follow the reference YAML conventions
# (src/utils/Calib.cpp:65-169): radtan [k1,k2,p1,p2(,k3)], equidistant/KB
# [k1,k2,k3,k4].
# ---------------------------------------------------------------------------

def distort_radtan(xy, D):
    """Normalized coords -> distorted normalized coords (Brown-Conrady)."""
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.shape[0] > 4 else jnp.zeros_like(k1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_radtan(xyd, D, iters: int = 8):
    """Iterative inverse of radtan distortion (mirrors cv::undistortPoints'
    fixed-point scheme; the reference builds its maps through OpenCV)."""
    def body(_, xy):
        k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
        k3 = D[4] if D.shape[0] > 4 else jnp.zeros_like(k1)
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x_new = (xyd[..., 0] - dx) / radial
        y_new = (xyd[..., 1] - dy) / radial
        return jnp.stack([x_new, y_new], axis=-1)
    return jax.lax.fori_loop(0, iters, body, xyd)


def distort_equidistant(xy, D):
    """Equidistant / Kannala-Brandt fisheye.

    The reference ships these as two undistorter classes but the math is
    identical: UndistortEquidistant computes
    ``thetad = theta*(1 + k1*t2 + k2*t4 + k3*t6 + k4*t8)``
    (src/utils/Undistort.cpp:1077-1118) and UndistortKB computes
    ``r = theta + k0*t3 + k1*t5 + k2*t7 + k3*t9``
    (src/utils/Undistort.cpp:1136-1183) — the same polynomial with the same
    four coefficients; the classes differ only in the calib-file prefix
    ("Equidistant" vs "KannalaBrandt", Undistort.h:130-160). Both names
    resolve here (model aliases 'equidistant' and 'kb'); this closes the
    reference's five-model set {FOV, RadTan, Equidistant, Pinhole, KB}
    (Undistort.h:67-160) with four distinct math kernels."""
    k1, k2, k3, k4 = D[0], D[1], D[2], D[3]
    x, y = xy[..., 0], xy[..., 1]
    r = jnp.sqrt(x * x + y * y) + 1e-12
    theta = jnp.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    s = theta_d / r
    return jnp.stack([x * s, y * s], axis=-1)


def undistort_equidistant(xyd, D, iters: int = 8):
    k1, k2, k3, k4 = D[0], D[1], D[2], D[3]
    xd, yd = xyd[..., 0], xyd[..., 1]
    theta_d = jnp.sqrt(xd * xd + yd * yd) + 1e-12

    def body(_, theta):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        return theta - f / df

    theta = jax.lax.fori_loop(0, iters, body, theta_d)
    s = jnp.tan(theta) / theta_d
    return jnp.stack([xd * s, yd * s], axis=-1)


def distort_fov(xy, D):
    """FOV model (Devernay/Faugeras), reference src/utils/Undistort.h:67-87."""
    w = D[0]
    x, y = xy[..., 0], xy[..., 1]
    r = jnp.sqrt(x * x + y * y) + 1e-12
    rd = jnp.arctan(2.0 * r * jnp.tan(0.5 * w)) / w
    s = rd / r
    return jnp.stack([x * s, y * s], axis=-1)


def undistort_fov(xyd, D, iters: int = 0):
    w = D[0]
    xd, yd = xyd[..., 0], xyd[..., 1]
    rd = jnp.sqrt(xd * xd + yd * yd) + 1e-12
    r = jnp.tan(rd * w) / (2.0 * jnp.tan(0.5 * w))
    s = r / rd
    return jnp.stack([xd * s, yd * s], axis=-1)


_DISTORT = {"none": None, "radtan": distort_radtan,
            "equidistant": distort_equidistant, "kb": distort_equidistant,
            "fov": distort_fov}
_UNDISTORT = {"none": None, "radtan": undistort_radtan,
              "equidistant": undistort_equidistant, "kb": undistort_equidistant,
              "fov": undistort_fov}


class CameraModel(NamedTuple):
    """Full camera = pinhole intrinsics + distortion. ``model`` is static."""
    pinhole: Pinhole
    D: jax.Array        # distortion coefficients (layout per model)
    model: str = "none"  # static: none|radtan|equidistant|kb|fov


def undistortion_maps(cam: CameraModel, out: Optional[Pinhole] = None):
    """Precompute the *inverse* maps (for remap-style undistortion of images):
    for each output (undistorted) pixel, the source (distorted) pixel.

    Returns (map_x, map_y), each [H_out, W_out] float32. Mirrors what
    ``cv::initUndistortRectifyMap`` produces for the reference
    (src/utils/Calib.cpp getMapping).
    """
    out = out or cam.pinhole
    vs, us = jnp.meshgrid(jnp.arange(out.height, dtype=jnp.float32),
                          jnp.arange(out.width, dtype=jnp.float32), indexing="ij")
    x = (us - out.cx) / out.fx
    y = (vs - out.cy) / out.fy
    xy = jnp.stack([x, y], axis=-1)
    if cam.model != "none":
        xy = _DISTORT[cam.model](xy, cam.D)
    pin = cam.pinhole
    return pin.fx * xy[..., 0] + pin.cx, pin.fy * xy[..., 1] + pin.cy


def forward_maps(cam: CameraModel, out: Optional[Pinhole] = None):
    """Precompute the *forward* maps (distorted pixel -> undistorted pixel),
    used for per-event undistortion by table lookup (the reference precomputes
    ``fwd_mapx/fwd_mapy`` and indexes them per event,
    src/tracking/EventFrame.cpp:53-81,316-317).

    Returns (fwd_x, fwd_y), each [H_in, W_in] float32.
    """
    out = out or cam.pinhole
    pin = cam.pinhole
    vs, us = jnp.meshgrid(jnp.arange(pin.height, dtype=jnp.float32),
                          jnp.arange(pin.width, dtype=jnp.float32), indexing="ij")
    x = (us - pin.cx) / pin.fx
    y = (vs - pin.cy) / pin.fy
    xy = jnp.stack([x, y], axis=-1)
    if cam.model != "none":
        xy = _UNDISTORT[cam.model](xy, cam.D)
    return out.fx * xy[..., 0] + out.cx, out.fy * xy[..., 1] + out.cy


def remap(img, map_x, map_y):
    """Bilinear image remap: out[v, u] = img(map_x[v,u], map_y[v,u]) —
    the ``cv::remap`` consumer of undistortion_maps (undistortion /
    rectification into a new geometry, src/utils/Calib.cpp getMapping use).
    Out-of-source samples clamp to the border."""
    from .interp import bilinear
    H, W = map_x.shape
    return bilinear(jnp.asarray(img, jnp.float32),
                    map_x.ravel(), map_y.ravel()).reshape(H, W)


def gamma_inverse_table(gamma_values):
    """Build the inverse response table Binv[256] from a response G[256]
    (photometric undistorter, reference src/utils/Undistort.h:40-64 and
    CalibHessian's B/Binv tables src/tracking/HessianBlocks.h:299-399).

    ``gamma_values``: [256] monotonically increasing irradiance response,
    rescaled to [0, 255]. Returns (B, Binv) each [256] float32.
    """
    g = jnp.asarray(gamma_values, jnp.float32)
    g = (g - g[0]) / (g[-1] - g[0]) * 255.0
    xs = jnp.arange(256, dtype=jnp.float32)
    # Binv[i] = value x such that B(x) = i (piecewise-linear inversion)
    binv = jnp.interp(xs, g, xs)
    return g, binv


def optimal_k_crop(cam: CameraModel, out_w: int, out_h: int) -> Pinhole:
    """Largest axis-aligned undistorted view fully covered by the input image
    (the 'crop' mode of the reference's geometric undistorters,
    src/utils/Undistort.{h,cpp} makeOptimalK_crop).

    The input image border is sampled densely, undistorted to normalized
    coords, and the output rectangle is shrunk to the inward-most border
    coordinate per side — every output pixel then remaps from inside the
    input (exact for monotone radial models; DSO's binary search converges
    to the same rectangle).
    """
    import numpy as np
    pin = cam.pinhole
    n = 512
    # border pixel samples, one array per side
    xs = np.linspace(0, pin.width - 1, n, dtype=np.float32)
    ys = np.linspace(0, pin.height - 1, n, dtype=np.float32)
    sides = {
        "left": np.stack([np.zeros(n, np.float32), ys], -1),
        "right": np.stack([np.full(n, pin.width - 1, np.float32), ys], -1),
        "top": np.stack([xs, np.zeros(n, np.float32)], -1),
        "bottom": np.stack([xs, np.full(n, pin.height - 1, np.float32)], -1),
    }

    def undist_norm(uv):
        x = (uv[:, 0] - float(pin.cx)) / float(pin.fx)
        y = (uv[:, 1] - float(pin.cy)) / float(pin.fy)
        xy = jnp.stack([jnp.asarray(x), jnp.asarray(y)], -1)
        if cam.model != "none":
            xy = _UNDISTORT[cam.model](xy, cam.D)
        return np.asarray(xy)

    b = {k: undist_norm(v) for k, v in sides.items()}
    min_x = float(b["left"][:, 0].max())
    max_x = float(b["right"][:, 0].min())
    min_y = float(b["top"][:, 1].max())
    max_y = float(b["bottom"][:, 1].min())

    fx = (out_w - 1) / (max_x - min_x)
    fy = (out_h - 1) / (max_y - min_y)
    cx = -min_x * fx
    cy = -min_y * fy
    return Pinhole(jnp.float32(fx), jnp.float32(fy), jnp.float32(cx),
                   jnp.float32(cy), out_w, out_h)
