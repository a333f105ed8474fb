"""Image-processing primitives: pyramids, gradients, blur, normalization.

Replaces the reference's image plumbing with XLA-friendly batched ops:
* DSO pyramid + gradients ``FrameHessian::makeImages``
  (src/tracking/HessianBlocks.cpp): half-res 2x2 averaging per level, central
  -difference gradients, squared-gradient magnitude.
* Keyframe preprocessing (src/tracking/KeyFrame.cpp:219-259): min-max
  normalization to [0,1], log image ``log(I + log_eps)``, Sobel gradients
  (OpenCV-compatible kernels for ksize 3 and 7), gradient magnitude.
* Event-frame smoothing (src/utils/Utils.cpp:114-121): Gaussian blur with
  OpenCV-compatible kernel construction.
* The DSO 8-pixel residual pattern (src/utils/settings.h:203-217).

Convolutions are expressed as depthwise ``lax.conv_general_dilated`` over
NHWC; reflect-101 padding matches OpenCV's
default border mode.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# DSO residual pattern: 8 offsets (dx, dy) — "residualPattern 8" in
# src/utils/settings.h:203-215 (pattern index 8, the spread-out 8-point disc).
PATTERN_DSO8 = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.int32)
PATTERN_NUM = 8
PATTERN_PAD = 2  # max |offset| of the pattern


def _reflect101_pad(img, ph, pw):
    return jnp.pad(img, ((ph, ph), (pw, pw)), mode="reflect")


def sep_filter2d(img, kx, ky):
    """Separable 2-D correlation with 1-D kernels kx (along x/cols) and ky
    (along y/rows), reflect-101 borders. img [H, W]."""
    kx = jnp.asarray(kx, img.dtype)
    ky = jnp.asarray(ky, img.dtype)
    rx = (kx.shape[0] - 1) // 2
    ry = (ky.shape[0] - 1) // 2
    p = _reflect101_pad(img, ry, rx)
    # correlate rows (x) then cols (y); correlation = conv with flipped kernel
    p = jax.vmap(lambda row: jnp.correlate(row, kx, mode="valid"))(p)
    p = jax.vmap(lambda col: jnp.correlate(col, ky, mode="valid"), in_axes=1,
                 out_axes=1)(p)
    return p


def _binom_row(n):
    row = np.array([1.0])
    for _ in range(n):
        row = np.convolve(row, [1.0, 1.0])
    return row


def sobel_kernels(ksize: int):
    """OpenCV-compatible (unnormalized) Sobel derivative/smoothing kernels.

    deriv = [-1, 1] * [1, 1]^(k-2), smooth = [1, 1]^(k-1); for ksize=3 this is
    [-1,0,1] / [1,2,1], for ksize=7 it is [-1,-4,-5,0,5,4,1] /
    [1,6,15,20,15,6,1] — exactly cv::getDerivKernels, which the reference uses
    through cv::Sobel (src/tracking/KeyFrame.cpp:239-240, 384-385).
    """
    deriv = np.convolve([-1.0, 1.0], _binom_row(ksize - 2))
    smooth = _binom_row(ksize - 1)
    return deriv, smooth


def sobel(img, ksize: int = 3):
    """Returns (gx, gy) image gradients with OpenCV Sobel semantics."""
    deriv, smooth = sobel_kernels(ksize)
    gx = sep_filter2d(img, deriv, smooth)
    gy = sep_filter2d(img, smooth, deriv)
    return gx, gy


def gaussian_kernel_1d(ksize: int, sigma: float = -1.0):
    """cv::getGaussianKernel semantics: if sigma <= 0, derive it from ksize."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def gaussian_blur(img, ksize: int = 3, sigma: float = -1.0):
    """Gaussian smoothing (reference smooths event frames with cv::GaussianBlur,
    src/utils/Utils.cpp:114-121)."""
    k = gaussian_kernel_1d(ksize, sigma)
    return sep_filter2d(img, k, k)


def minmax_normalize(img, eps: float = 1e-12):
    """Min-max normalize to [0, 1] (src/tracking/KeyFrame.cpp:219-221)."""
    lo = jnp.min(img)
    hi = jnp.max(img)
    return (img - lo) / (hi - lo + eps)


def log_image(img, log_eps: float = 0.2):
    """log(I + log_eps) (src/tracking/KeyFrame.cpp:227-230, log_eps default
    0.2 per KeyFrame.hpp:54)."""
    return jnp.log(img + log_eps)


def pyramid_down(img):
    """DSO half-resolution downsampling: plain 2x2 box average
    (FrameHessian::makeImages, src/tracking/HessianBlocks.cpp)."""
    H, W = img.shape
    return img[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))


def central_gradients(img):
    """DSO gradients: 0.5*(I[x+1]-I[x-1]) with clamped borders."""
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    left = jnp.concatenate([img[:, :1], img[:, :-1]], axis=1)
    down = jnp.concatenate([img[1:, :], img[-1:, :]], axis=0)
    up = jnp.concatenate([img[:1, :], img[:-1, :]], axis=0)
    gx = 0.5 * (right - left)
    gy = 0.5 * (down - up)
    return gx, gy


def build_pyramid(img, num_levels: int):
    """Returns list of per-level [H_l, W_l, 3] stacks [I, gx, gy] plus the
    squared-gradient images — the ``dIp``/``absSquaredGrad`` pyramids of
    FrameHessian (src/tracking/HessianBlocks.h:110-297).

    The list is Python-level (static shapes per level) which is exactly what
    the jitted per-level tracker kernels need.
    """
    levels = []
    abs_sq = []
    cur = img
    for lvl in range(num_levels):
        gx, gy = central_gradients(cur)
        levels.append(jnp.stack([cur, gx, gy], axis=-1))
        abs_sq.append(gx * gx + gy * gy)
        if lvl + 1 < num_levels:
            cur = pyramid_down(cur)
    return levels, abs_sq


def gradient_magnitude(gx, gy):
    """|∇I| via cartToPolar-style magnitude (src/tracking/KeyFrame.cpp:256-259)."""
    return jnp.sqrt(gx * gx + gy * gy)


def dilate3(img, iters: int = 1):
    """3x3 morphological dilation for float images (used for the multi-level
    event-frame variants via dilate+erode, src/tracking/EventFrame.cpp:253-260,
    and for idepth-map hole filling in makeCoarseDepthL0)."""
    def one(x):
        p = jnp.pad(x, 1, mode="edge")
        s = jnp.stack([p[dy:dy + x.shape[0], dx:dx + x.shape[1]]
                       for dy in range(3) for dx in range(3)])
        return jnp.max(s, axis=0)
    for _ in range(iters):
        img = one(img)
    return img


def erode3(img, iters: int = 1):
    def one(x):
        p = jnp.pad(x, 1, mode="edge")
        s = jnp.stack([p[dy:dy + x.shape[0], dx:dx + x.shape[1]]
                       for dy in range(3) for dx in range(3)])
        return jnp.min(s, axis=0)
    for _ in range(iters):
        img = one(img)
    return img


# ---------------------------------------------------------------------------
# Patch utilities (reference src/utils/Utils.cpp:608-734)
# ---------------------------------------------------------------------------

def split_image_in_patches(img, uv, patch_radius: int):
    """Per-point square patches around (sub-pixel) centers uv [N, 2] —
    ``eds::utils::splitImageInPatches`` (Utils.cpp:608-661). Returns
    ([N, S, S] patches, [N] in-bounds mask) with S = 2*patch_radius+1,
    bilinear-sampled so sub-pixel centers behave like the reference's
    cv::getRectSubPix. One fused gather instead of a per-point loop."""
    from .interp import bilinear
    S = 2 * patch_radius + 1
    d = jnp.arange(S, dtype=img.dtype) - patch_radius
    gx = uv[:, 0:1, None] + d[None, None, :]      # [N, 1, S]
    gy = uv[:, 1:2, None] + d[None, None, :]      # [N, 1, S]
    xs = jnp.broadcast_to(gx, (uv.shape[0], S, S))
    ys = jnp.broadcast_to(jnp.swapaxes(gy, 1, 2), (uv.shape[0], S, S))
    H, W = img.shape[:2]
    ok = (uv[:, 0] >= patch_radius) & (uv[:, 1] >= patch_radius) \
        & (uv[:, 0] <= W - 1 - patch_radius) \
        & (uv[:, 1] <= H - 1 - patch_radius)
    vals = bilinear(img, xs.reshape(-1), ys.reshape(-1)).reshape(
        uv.shape[0], S, S)
    return vals, ok


def pyramid_patches(pyr_levels, uv, patch_radius: int):
    """Patches of the same points across a pyramid — ``pyramidPatches``
    (Utils.cpp:662-674): level-l centers are uv / 2^l. Returns a list of
    ([N, S, S], [N]) per level."""
    out = []
    for l, img in enumerate(pyr_levels):
        out.append(split_image_in_patches(img, uv / (2.0 ** l), patch_radius))
    return out


def compute_bundle_patches(img, uv):
    """DSO 8-point residual-pattern samples per point —
    ``computeBundlePatches`` (Utils.cpp:675-734). Returns ([N, 8] colors,
    [N] mask)."""
    from .interp import bilinear
    offs = jnp.asarray(PATTERN_DSO8, img.dtype)
    xs = uv[:, 0:1] + offs[None, :, 0]
    ys = uv[:, 1:2] + offs[None, :, 1]
    H, W = img.shape[:2]
    ok = (uv[:, 0] >= PATTERN_PAD) & (uv[:, 1] >= PATTERN_PAD) \
        & (uv[:, 0] <= W - 1 - PATTERN_PAD) \
        & (uv[:, 1] <= H - 1 - PATTERN_PAD)
    vals = bilinear(img, xs.reshape(-1), ys.reshape(-1)).reshape(
        uv.shape[0], PATTERN_NUM)
    return vals, ok
