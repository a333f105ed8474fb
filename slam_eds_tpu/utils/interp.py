"""Batched image sampling: bilinear and bicubic (Catmull-Rom) interpolation.

Replaces the reference's samplers:
* ``getInterpolatedElement33`` / ``getInterpolatedElement31`` etc.
  (src/utils/globalFuncs.h) — bilinear taps on [I, dx, dy] images, the
  workhorse of the DSO residual loop (src/tracking/Residuals.cpp:184).
* ``ceres::BiCubicInterpolator<Grid2D>`` over the event frame
  (src/tracking/PhotometricError.hpp:109-112,170-173) — cubic convolution
  with Keys a=-0.5 coefficients and edge clamping; analytic derivatives come
  for free here via JAX autodiff, and ``bicubic_with_grad`` returns them in
  closed form for the hand-written Jacobian path.

All samplers take images [H, W] (or [H, W, C]) and query points as separate
x (column) / y (row) arrays of any batch shape; everything is gather-based and
vmap/jit friendly. Out-of-bounds queries clamp to the edge (matching
ceres::Grid2D's behavior); validity masking is the caller's job.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _gather2d(img, iy, ix):
    """img [H, W, ...], integer index arrays broadcastable to a common shape.
    Element gather, for access patterns that are not patches."""
    H, W = img.shape[0], img.shape[1]
    iy = jnp.clip(iy, 0, H - 1)
    ix = jnp.clip(ix, 0, W - 1)
    return img[iy, ix]


def _fetch_patches(img, iy0, ix0, size: int):
    """Fetch a (size x size) patch per query via vmapped dynamic_slice.

    XLA lowers this to one block gather: each query fetches size^2
    elements from ``size`` contiguous rows, instead of size^2 separate
    element-gather lookups, so every sampler here goes through patches.

    img: [H, W] or [H, W, C]. iy0/ix0: int32 arrays of identical batch
    shape, pre-clipped to [0, H-size] x [0, W-size]. Returns
    [..., size, size] (or [..., size, size, C]).
    """
    bshape = iy0.shape
    iyf = iy0.reshape(-1)
    ixf = ix0.reshape(-1)
    if img.ndim == 3:
        sl = (size, size, img.shape[2])
        fetch = lambda yy, xx: jax.lax.dynamic_slice(img, (yy, xx, 0), sl)
    else:
        fetch = lambda yy, xx: jax.lax.dynamic_slice(img, (yy, xx),
                                                     (size, size))
    patches = jax.vmap(fetch)(iyf, ixf)
    return patches.reshape(bshape + patches.shape[1:])


def _axis_weights(i0, taps_w, n_img, origin, size: int):
    """Map per-tap kernel weights onto patch bins with edge clamping.

    taps_w: tuple of T weight arrays for taps at offsets 0..T-1 from i0.
    Returns [..., size] combined weights: w[c] = sum_t w_t * (rel_t == c)
    where rel_t = clip(i0 + t, 0, n_img-1) - origin. Matches per-tap index
    clamping (ceres::Grid2D / the reference's getInterpolatedElement edge
    behavior) without any element gathers.
    """
    ar = jnp.arange(size, dtype=jnp.int32)
    out = 0.0
    for t, w in enumerate(taps_w):
        rel = jnp.clip(i0 + t, 0, n_img - 1) - origin
        out = out + w[..., None] * (rel[..., None] == ar)
    return out


def _clean_coords(x, hi):
    return jnp.clip(jnp.nan_to_num(jnp.asarray(x), nan=-4.0), -4.0, hi + 4.0)


def _poison_nonfinite(x, y, *vals):
    """Return vals with NaN wherever the query coords are not finite —
    callers gate bad warps (z<=0 projections etc.) with isfinite on the
    sampled value, a contract the index clipping above would silently
    break."""
    bad = ~(jnp.isfinite(jnp.asarray(x)) & jnp.isfinite(jnp.asarray(y)))
    out = []
    for v in vals:
        b = bad[..., None] if v.ndim == bad.ndim + 1 else bad
        out.append(jnp.where(b, jnp.nan, v))
    return out[0] if len(out) == 1 else tuple(out)


def bilinear(img, x, y):
    """Bilinear sample of img [H, W] (or [H, W, C]) at (x=col, y=row).

    Matches ``getInterpolatedElement`` (reference src/utils/globalFuncs.h):
    floor-based fractional weights, edge-clamped taps. Implemented as one
    2x2 patch block-gather per query (see _fetch_patches).
    """
    H, W = img.shape[0], img.shape[1]
    xc = _clean_coords(x, W)
    yc = _clean_coords(y, H)
    x0 = jnp.floor(xc)
    y0 = jnp.floor(yc)
    dx = xc - x0
    dy = yc - y0
    ix0 = x0.astype(jnp.int32)
    iy0 = y0.astype(jnp.int32)
    ox = jnp.clip(ix0, 0, W - 2)
    oy = jnp.clip(iy0, 0, H - 2)
    patch = _fetch_patches(img, oy, ox, 2)      # [..., 2, 2(, C)]
    colw = _axis_weights(ix0, (1.0 - dx, dx), W, ox, 2)   # [..., 2]
    roww = _axis_weights(iy0, (1.0 - dy, dy), H, oy, 2)
    if img.ndim == 3:
        rows = jnp.sum(patch * colw[..., None, :, None], axis=-2)  # [...,2,C]
        val = jnp.sum(rows * roww[..., :, None], axis=-2)
    else:
        rows = jnp.sum(patch * colw[..., None, :], axis=-1)        # [..., 2]
        val = jnp.sum(rows * roww, axis=-1)
    return _poison_nonfinite(x, y, val)


def bilinear_3(img3, x, y):
    """Bilinear sample of a 3-channel [H, W, 3] image ([I, gx, gy] stacks) —
    the ``getInterpolatedElement33`` equivalent."""
    return bilinear(img3, x, y)


def _cubic_weights(t):
    """Keys cubic-convolution weights, a = -0.5 (Catmull-Rom) — identical to
    the kernel ceres::BiCubicInterpolator uses. Returns 4 weights for taps at
    offsets [-1, 0, 1, 2] given fractional position t in [0,1)."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def _cubic_weights_d(t):
    """d/dt of the Keys weights (for analytic image-gradient sampling)."""
    t2 = t * t
    d0 = -1.5 * t2 + 2.0 * t - 0.5
    d1 = 4.5 * t2 - 5.0 * t
    d2 = -4.5 * t2 + 4.0 * t + 0.5
    d3 = 1.5 * t2 - t
    return d0, d1, d2, d3


def bicubic(img, x, y):
    """Bicubic (Catmull-Rom) sample of img [H, W] at (x=col, y=row)."""
    v, _, _ = bicubic_with_grad(img, x, y)
    return v


def bicubic_with_grad(img, x, y):
    """Bicubic sample + analytic spatial gradient (d/dx, d/dy).

    Mirrors ``BiCubicInterpolator::Evaluate(row, col, &f, &dfdr, &dfdc)``:
    separable Keys kernel, per-tap edge clamping. One 4x4 patch block-gather
    per query; the three outputs are bilinear forms roww^T P colw over the
    in-register patch (value/derivative weight vectors per axis).
    """
    H, W = img.shape[0], img.shape[1]
    xc = _clean_coords(x, W)
    yc = _clean_coords(y, H)
    x0 = jnp.floor(xc)
    y0 = jnp.floor(yc)
    tx = xc - x0
    ty = yc - y0
    ix = x0.astype(jnp.int32)
    iy = y0.astype(jnp.int32)
    ox = jnp.clip(ix - 1, 0, W - 4)
    oy = jnp.clip(iy - 1, 0, H - 4)
    patch = _fetch_patches(img, oy, ox, 4)          # [..., 4, 4]

    colw = _axis_weights(ix - 1, _cubic_weights(tx), W, ox, 4)
    colw_d = _axis_weights(ix - 1, _cubic_weights_d(tx), W, ox, 4)
    roww = _axis_weights(iy - 1, _cubic_weights(ty), H, oy, 4)
    roww_d = _axis_weights(iy - 1, _cubic_weights_d(ty), H, oy, 4)

    rows_v = jnp.sum(patch * colw[..., None, :], axis=-1)    # [..., 4]
    rows_dx = jnp.sum(patch * colw_d[..., None, :], axis=-1)
    f = jnp.sum(rows_v * roww, axis=-1)
    dfdx = jnp.sum(rows_dx * roww, axis=-1)
    dfdy = jnp.sum(rows_v * roww_d, axis=-1)
    return _poison_nonfinite(x, y, f, dfdx, dfdy)


def pattern_tile_sample(planes, u, v):
    """Bilinear (value, gx, gy) sampling of warped taps via per-tap 4x4
    patch fetches — the tap sampler of the BA residual loop.

    The DSO residual linearization (reference
    src/tracking/Residuals.cpp:174-236) needs P*F*K taps x 4 bilinear
    corners x 3 channels. Here each tap fetches one 4x4 intensity patch with
    a vmapped ``lax.dynamic_slice`` (one block-gather query per tap instead
    of 12 element queries) and evaluates value + central-difference
    gradients from the patch with static indexing.

    The gradients equal bilinear sampling of the precomputed central-
    difference planes of ``image.build_pyramid`` exactly for taps >= 1 px
    inside the image (the caller's OOB guards already enforce that; ``ok``
    re-checks it here).

    planes: [F, H, W] intensity. u, v: [P, F, K] tap pixel coords.
    Returns (I, gx, gy, ok), each [P, F, K].
    """
    F, H, W = planes.shape
    dtype = planes.dtype

    uc = jnp.clip(jnp.nan_to_num(u, nan=-8.0), -8.0, W + 8.0)
    vc = jnp.clip(jnp.nan_to_num(v, nan=-8.0), -8.0, H + 8.0)
    x0 = jnp.floor(uc).astype(jnp.int32)
    y0 = jnp.floor(vc).astype(jnp.int32)
    ok = (uc >= 1.0) & (uc < W - 2.0) & (vc >= 1.0) & (vc < H - 2.0)
    # patch origin (x0-1, y0-1); clamped so the slice stays in bounds (the
    # values of clamped taps are garbage and masked by ok)
    ox = jnp.clip(x0 - 1, 0, W - 4)
    oy = jnp.clip(y0 - 1, 0, H - 4)

    P, _, K = u.shape
    oyt = jnp.moveaxis(oy, 1, 0).reshape(F, P * K)
    oxt = jnp.moveaxis(ox, 1, 0).reshape(F, P * K)
    patch = jax.vmap(lambda pl, oyf, oxf: _fetch_patches(pl, oyf, oxf, 4))(
        planes, oyt, oxt)                               # [F, P*K, 4, 4]
    patch = jnp.moveaxis(patch.reshape(F, P, K, 4, 4), 0, 1)  # [P, F, K, 4, 4]

    fxp = uc - x0.astype(dtype)
    fyp = vc - y0.astype(dtype)
    w00 = (1 - fxp) * (1 - fyp)
    w01 = fxp * (1 - fyp)
    w10 = (1 - fxp) * fyp
    w11 = fxp * fyp

    def blend(a00, a01, a10, a11):
        return w00 * a00 + w01 * a01 + w10 * a10 + w11 * a11

    p = patch   # p[..., row, col]; the bilinear corners are rows/cols 1..2
    val = blend(p[..., 1, 1], p[..., 1, 2], p[..., 2, 1], p[..., 2, 2])
    gx = 0.5 * blend(p[..., 1, 2] - p[..., 1, 0], p[..., 1, 3] - p[..., 1, 1],
                     p[..., 2, 2] - p[..., 2, 0], p[..., 2, 3] - p[..., 2, 1])
    gy = 0.5 * blend(p[..., 2, 1] - p[..., 0, 1], p[..., 2, 2] - p[..., 0, 2],
                     p[..., 3, 1] - p[..., 1, 1], p[..., 3, 2] - p[..., 1, 2])
    return val, gx, gy, ok
