"""Mask-aware robust statistics.

The reference computes robust-loss scales from residual statistics:
* mean/std over a vector (``mean_std_vector``, src/utils/Utils.hpp:272-287)
* n-th quantile via nth_element (``n_quantile_vector``, src/utils/Utils.hpp:
  289-320)
* MAD-based Huber/Cauchy scale: 1.4826 * median(|r - median(r)|), tau =
  1.345 * MAD (``Tracker::getLossParams`` src/tracking/Tracker.cpp:281-317).

Here the point set has fixed capacity with a validity mask, so every
statistic here is masked: invalid lanes are excluded exactly (median/quantile
by sorting invalid lanes to +inf and indexing by the valid count, moments by
weighted sums). All ops are jit-safe with static shapes.
"""
from __future__ import annotations

import jax.numpy as jnp

MAD_SCALE = 1.4826   # consistency constant for Gaussian MAD
HUBER_K = 1.345      # reference tau = 1.345 * MAD (Tracker.cpp:308)


def masked_mean(x, mask):
    m = mask.astype(x.dtype)
    n = jnp.sum(m)
    return jnp.sum(x * m) / jnp.maximum(n, 1.0)


def masked_mean_std(x, mask):
    m = mask.astype(x.dtype)
    n = jnp.maximum(jnp.sum(m), 1.0)
    mu = jnp.sum(x * m) / n
    var = jnp.sum(m * (x - mu) ** 2) / n
    return mu, jnp.sqrt(var)


def masked_quantile_index(x, mask, k):
    """Value at sorted index k among the valid lanes (nth_element semantics,
    matching ``n_quantile_vector``). k may be a traced integer."""
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    xs = jnp.sort(jnp.where(mask, x, big))
    n = jnp.sum(mask.astype(jnp.int32))
    k = jnp.clip(k, 0, jnp.maximum(n - 1, 0))
    # empty mask -> 0, so downstream MAD/median stay finite
    return jnp.where(n > 0, xs[k], jnp.zeros((), x.dtype))


def masked_median(x, mask):
    """Median over valid lanes (index n//2, matching the reference's
    nth_element-based median)."""
    n = jnp.sum(mask.astype(jnp.int32))
    return masked_quantile_index(x, mask, n // 2)


def masked_mad(x, mask):
    """1.4826 * median(|x - median(x)|) over valid lanes."""
    med = masked_median(x, mask)
    return MAD_SCALE * masked_median(jnp.abs(x - med), mask), med


def huber_scale_mad(residuals, mask):
    """Robust Huber threshold from MAD: tau = 1.345 * (1.4826 * MAD)
    (Tracker::getLossParams MAD branch, src/tracking/Tracker.cpp:281-317)."""
    mad, _ = masked_mad(residuals, mask)
    return HUBER_K * mad


def huber_scale_std(residuals, mask):
    """STD variant of getLossParams: tau = 1.345 * std."""
    _, std = masked_mean_std(residuals, mask)
    return HUBER_K * std


def huber_weight(r, k):
    """Huber IRLS weight: 1 if |r|<k else k/|r| (DSO convention,
    src/tracking/Residuals.cpp:199)."""
    a = jnp.abs(r)
    return jnp.where(a < k, jnp.ones_like(a), k / jnp.maximum(a, 1e-12))


def huber_energy(r, k):
    """DSO's expanded Huber energy hw*r^2*(2-hw)."""
    hw = huber_weight(r, k)
    return hw * r * r * (2.0 - hw)


def cauchy_weight(r, k):
    """Cauchy IRLS weight 1/(1+(r/k)^2) (loss option 'CAUCHY' in
    src/tracking/Config.hpp:41-44)."""
    return 1.0 / (1.0 + (r / jnp.maximum(k, 1e-12)) ** 2)
