"""Coarse distance map for spatially-distributed point activation.

Array-based replacement for DSO's ``CoarseDistanceMap`` (reference
src/tracking/CoarseTracker.h:123-166 + CoarseTracker.cpp:703+): the reference
BFS-floods an L1-resolution grid outward from the projections of all active
points, then point activation keeps only candidates whose distance exceeds an
adaptive threshold (FullSystem::activatePointsMT semantics).

The BFS becomes ``K`` iterations of a min-plus dilation over the
4-neighborhood — a fixed-shape ``lax.fori_loop`` of vectorized shifts, which
XLA fuses into a handful of VPU passes (K bounds the max representable
distance, exactly like the reference's bounded BFS queue rounds).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("height", "width", "max_dist"))
def coarse_distance_map(uv, mask, height: int, width: int,
                        max_dist: int = 40):
    """L1 distance-to-nearest-point map.

    uv: [N, 2] point pixels at THIS map's resolution (the reference builds
    the map at pyramid level 1 — pass uv/2); mask: [N] valid points.
    Returns [height, width] float32 distances clamped to ``max_dist``.
    """
    fill = jnp.float32(max_dist)
    ix = jnp.round(uv[:, 0]).astype(jnp.int32)
    iy = jnp.round(uv[:, 1]).astype(jnp.int32)
    ok = mask & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    flat = jnp.where(ok, iy * width + ix, height * width)
    seed = jnp.full(height * width + 1, fill, jnp.float32).at[flat].min(
        jnp.where(ok, 0.0, fill))
    d = seed[:height * width].reshape(height, width)

    big = fill

    def body(_, d):
        up = jnp.concatenate([d[1:], jnp.full((1, width), big)], 0)
        dn = jnp.concatenate([jnp.full((1, width), big), d[:-1]], 0)
        lf = jnp.concatenate([d[:, 1:], jnp.full((height, 1), big)], 1)
        rt = jnp.concatenate([jnp.full((height, 1), big), d[:, :-1]], 1)
        n = jnp.minimum(jnp.minimum(up, dn), jnp.minimum(lf, rt))
        return jnp.minimum(d, n + 1.0)

    d = jax.lax.fori_loop(0, max_dist, body, d)
    return d


def sample_distance(dist_map, uv):
    """Nearest-pixel lookup of the distance map at (same-resolution) uv."""
    h, w = dist_map.shape
    ix = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, h - 1)
    return dist_map[iy, ix]
