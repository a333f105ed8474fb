"""Event rasterization: packets of events -> brightness-increment frames.

Replacement for the reference's event accumulation:
* ``eds::utils::drawValuesPoints`` (src/utils/Utils.cpp:50-123): bilinear
  4-tap scatter-add of per-event polarity (+1/-1), optional Gaussian time
  weights, optional Gaussian blur.
* ``EventFrame`` creation (src/tracking/EventFrame.cpp:159-292): per-event
  undistortion by precomputed forward-map lookup, morphological "levels"
  (dilate+erode sums), Frobenius-norm normalization, median-event timestamp.

Design: a packet is a fixed-capacity [N, 4] array (x, y, t, polarity) with a
validity mask (real packets are padded/truncated to capacity — static shapes
for jit). The scatter is expressed as ``jax.ops.segment_sum`` over flattened
pixel ids, which XLA lowers to a one-pass scatter-add (atomic adds on a GPU);
each event contributes its 4 bilinear taps. This replaces the reference's
sequential per-event loop with one batched data-parallel op.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import image as image_ops


def event_time_weights(n_valid, capacity, dtype=jnp.float32):
    """Gaussian time-ordering weights over a packet: the reference weights
    event i by exp(-0.5*((i/N - 1/2)/(1/6))^2) — a bell centered mid-packet
    (``expWeight``, src/utils/Utils.hpp:542-546, applied in drawValuesPoints
    with use_exp_weights=true from EventFrame.cpp:262).
    """
    idx = jnp.arange(capacity, dtype=dtype)
    x = idx / jnp.maximum(n_valid.astype(dtype), 1.0)
    z = (x - 0.5) * 6.0
    return jnp.exp(-0.5 * z * z)


def scatter_accumulate(xs, ys, values, height: int, width: int,
                       mask=None, method: str = "bilinear"):
    """Accumulate per-event ``values`` into an [H, W] image.

    bilinear: 4-tap scatter with out-of-image taps zero-weighted (matching
    drawValuesPoints' per-tap bounds checks, Utils.cpp:92-106).
    nn: rounds to nearest pixel with clamping (Utils.cpp:74-81).

    Floating-point adds that land on one pixel are summed in an order the
    device chooses, so results can differ run to run in the last bits.
    """
    dtype = values.dtype
    if mask is not None:
        values = jnp.where(mask, values, jnp.zeros_like(values))

    if method == "nn":
        ix = jnp.clip(jnp.round(xs).astype(jnp.int32), 0, width - 1)
        iy = jnp.clip(jnp.round(ys).astype(jnp.int32), 0, height - 1)
        flat = iy * width + ix
        img = jax.ops.segment_sum(values, flat, num_segments=height * width)
        return img.reshape(height, width).astype(dtype)

    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx = xs - x0
    fy = ys - y0
    ix0 = x0.astype(jnp.int32)
    iy0 = y0.astype(jnp.int32)
    ix1 = ix0 + 1
    iy1 = iy0 + 1

    def in_bounds(ix, iy):
        return ((ix >= 0) & (ix < width) & (iy >= 0) & (iy < height))

    taps = [
        (ix0, iy0, (1 - fx) * (1 - fy)),
        (ix0, iy1, (1 - fx) * fy),
        (ix1, iy0, fx * (1 - fy)),
        (ix1, iy1, fx * fy),
    ]
    ids = []
    vals = []
    for ix, iy, w in taps:
        ok = in_bounds(ix, iy)
        flat = jnp.clip(iy, 0, height - 1) * width + jnp.clip(ix, 0, width - 1)
        ids.append(flat)
        vals.append(jnp.where(ok, w * values, jnp.zeros_like(values)))
    flat_all = jnp.concatenate(ids)
    val_all = jnp.concatenate(vals)
    img = jax.ops.segment_sum(val_all, flat_all, num_segments=height * width)
    return img.reshape(height, width).astype(dtype)


def undistort_events(xs, ys, fwd_map_x, fwd_map_y):
    """Per-event undistortion by integer lookup into precomputed forward maps
    (the reference rounds the raw event coordinate and reads fwd_mapx/y,
    src/tracking/EventFrame.cpp:316-317)."""
    H, W = fwd_map_x.shape
    ix = jnp.clip(jnp.round(xs).astype(jnp.int32), 0, W - 1)
    iy = jnp.clip(jnp.round(ys).astype(jnp.int32), 0, H - 1)
    return fwd_map_x[iy, ix], fwd_map_y[iy, ix]


def build_event_frame(xs, ys, polarities, n_valid, height: int, width: int,
                      num_levels: int = 1, use_time_weights: bool = True,
                      blur_sigma: float = 0.5, blur_ksize: int = 3,
                      norm_eps: float = 1e-12,
                      interpolation: str = "bilinear"):
    """Full EventFrame raster pipeline (EventFrame.cpp:262-292):

    1. bilinear scatter of ±1 polarities with Gaussian time weights
    2. 3x3 Gaussian blur (sigma 0.5; the reference's kernel size is fixed at
       3x3 from its 240x180 baseline, Utils.cpp:114-121)
    3. morphological levels: level l>=1 is dilate_(2l+1) + erode_(2l+1) of
       level 0 (EventFrame.cpp:350-357) — all levels full resolution
    4. per-level Frobenius-norm normalization (EventFrame.cpp:262-286); the
       norms are returned so the un-normalized frame is recoverable.

    Returns (frames [L, H, W], norms [L]).
    """
    capacity = xs.shape[0]
    mask = jnp.arange(capacity) < n_valid
    values = polarities.astype(jnp.float32)
    if use_time_weights:
        values = values * event_time_weights(n_valid, capacity)
    img = scatter_accumulate(xs, ys, values, height, width, mask=mask,
                             method=interpolation)
    if blur_sigma > 0 and blur_ksize > 0:   # ksize 0 disables (config)
        img = image_ops.gaussian_blur(img, blur_ksize, blur_sigma)

    frames = [img]
    for lvl in range(1, num_levels):
        k = lvl  # structuring radius: ksize 2*lvl+1
        frames.append(image_ops.dilate3(img, iters=k) + image_ops.erode3(img, iters=k))
    stacked = jnp.stack(frames)
    norms = jnp.sqrt(jnp.sum(stacked * stacked, axis=(1, 2))) + norm_eps
    return stacked / norms[:, None, None], norms


def median_event_time(ts, n_valid):
    """Packet timestamp = time of the middle event (EventFrame.cpp:210-212).
    Assumes events are time-ordered within the packet (the reference throws on
    non-monotonic timestamps; host-side loaders enforce this)."""
    return ts[jnp.maximum(n_valid // 2, 0)]
