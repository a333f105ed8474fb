"""Probabilistic inverse-depth filtering (Vogiatzis/SVO Beta-Gaussian).

Vectorized rewrite of ``eds::mapping::DepthPoints`` (reference
src/mapping/DepthPoints.{hpp,cpp}): per-point state [mu, sigma2, a, b],
two-view linear triangulation for the depth measurement, geometric
measurement variance from a 1-pixel error angle, and the Vogiatzis Bayesian
update with divergence guards — all as masked element-wise math over the
fixed-capacity point set (the reference loops point-by-point).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.lie import SE3
from ..utils.cameras import Pinhole


class DepthFilterState(NamedTuple):
    mu: jax.Array      # [P] inverse depth mean
    sigma2: jax.Array  # [P] variance
    a: jax.Array       # [P] Beta inlier count
    b: jax.Array       # [P] Beta outlier count


def angle_error(px_noise: float, fx, fy):
    """px_error_angle (DepthPoints.hpp:151-154)."""
    return jnp.arctan(px_noise / (2.0 * fx)) + jnp.arctan(px_noise / (2.0 * fy))


def init_uniform(num_points: int, min_depth: float, max_depth: float,
                 init_a: float = 2.0, init_b: float = 5.0,
                 dtype=jnp.float32) -> DepthFilterState:
    """Uniform init: mu = 1/mean-depth, sigma2 = range^2
    (DepthPoints::init, DepthPoints.cpp:52-68)."""
    rng = max_depth - min_depth
    mu0 = 1.0 / ((max_depth - min_depth) / 2.0)
    return DepthFilterState(
        mu=jnp.full((num_points,), mu0, dtype),
        sigma2=jnp.full((num_points,), rng * rng, dtype),
        a=jnp.full((num_points,), init_a, dtype),
        b=jnp.full((num_points,), init_b, dtype))


def init_from_prior(inv_depth, min_depth: float, max_depth: float,
                    init_a: float = 2.0, init_b: float = 5.0) -> DepthFilterState:
    """Init from a prior depth map: sigma2 = range^2/36
    (DepthPoints.cpp:70-91)."""
    rng = max_depth - min_depth
    s2 = jnp.full_like(inv_depth, rng * rng / 36.0)
    return DepthFilterState(mu=inv_depth, sigma2=s2,
                            a=jnp.full_like(inv_depth, init_a),
                            b=jnp.full_like(inv_depth, init_b))


def triangulate_inv_depth(x_kf, x_ef, cam: Pinhole, T_kf_ef: SE3):
    """Two-view linear inverse-depth triangulation in the keyframe
    (invDepthTwoPointsEucl, DepthPoints.cpp:376-401).

    x_kf, x_ef: [P, 2] pixel coordinates in KF / event frame.
    P_kf = K [I | 0], P_ef = K [R | t] with [R|t] = T_ef_kf.
    """
    K = cam.K
    T_ef_kf = T_kf_ef.inverse()
    M2 = K @ T_ef_kf.R
    e2 = K @ T_ef_kf.t            # epipole of camera-1 center in image 2
    Kinv = jnp.linalg.inv(K)

    ones = jnp.ones_like(x_kf[:, :1])
    x1 = jnp.concatenate([x_kf, ones], axis=-1)
    x2 = jnp.concatenate([x_ef, ones], axis=-1)
    x1p = x1 @ (M2 @ Kinv).T       # projection of x1 at infinity into img 2
    aux1 = jnp.cross(x1p, x2)      # m_l' x m_r
    aux2 = jnp.cross(x2, jnp.broadcast_to(e2, x2.shape))  # m_r x e_r
    denom = jnp.sum(aux2 * aux2, axis=-1)
    return jnp.sum(aux1 * aux2, axis=-1) / jnp.maximum(denom, 1e-20)


def compute_tau(T_kf_ef: SE3, x_norm_ef, z, px_error_angle):
    """Depth std from triangulation geometry (computeTau,
    DepthPoints.hpp:157-174): law of sines on the (t, bearing) triangle with
    the bearing perturbed by the pixel error angle."""
    t = T_kf_ef.t
    bearing = jnp.concatenate([x_norm_ef, jnp.ones_like(x_norm_ef[:, :1])],
                              axis=-1)
    bearing = bearing / jnp.linalg.norm(bearing, axis=-1, keepdims=True)
    a_vec = bearing * z[:, None] - t[None, :]
    t_norm = jnp.maximum(jnp.linalg.norm(t), 1e-12)
    a_norm = jnp.maximum(jnp.linalg.norm(a_vec, axis=-1), 1e-12)
    alpha = jnp.arccos(jnp.clip(bearing @ t / t_norm, -1.0, 1.0))
    beta = jnp.arccos(jnp.clip(jnp.sum(a_vec * (-t)[None, :], axis=-1)
                               / (t_norm * a_norm), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma_plus = jnp.pi - alpha - beta_plus
    z_plus = t_norm * jnp.sin(beta_plus) / jnp.maximum(
        jnp.abs(jnp.sin(gamma_plus)), 1e-12)
    return z_plus - z


def sigma2_from_depth_sigma(depth, depth_sigma):
    """Inverse-depth variance from a depth std (getSigma2FromDepthSigma)."""
    s = 0.5 * (1.0 / jnp.maximum(1e-12, depth - depth_sigma)
               - 1.0 / (depth + depth_sigma))
    return s * s


def norm_pdf(x, mu, sigma):
    z = (x - mu) / sigma
    return jnp.exp(-0.5 * z * z) / (sigma * jnp.sqrt(2.0 * jnp.pi))


def vogiatzis_update(state: DepthFilterState, z, tau2, mu_range: float,
                     mask) -> DepthFilterState:
    """Masked Vogiatzis Bayesian update (filterVogiatzis,
    DepthPoints.cpp:180-228) with the reference's guards: NaN norm-scale
    skips, negative sigma2 keeps the old value, negative mu resets to 1."""
    mu, s2, a, b = state.mu, state.sigma2, state.a, state.b
    norm_scale = jnp.sqrt(s2 + tau2)
    ok = mask & jnp.isfinite(norm_scale) & (norm_scale > 1e-12) \
        & jnp.isfinite(z) & jnp.isfinite(tau2)
    z = jnp.where(ok, z, 1.0)
    tau2 = jnp.where(ok, tau2, 1.0)
    ns = jnp.where(ok, norm_scale, 1.0)

    s2_new_meas = 1.0 / (1.0 / jnp.maximum(s2, 1e-20) + 1.0 / jnp.maximum(tau2, 1e-20))
    m = s2_new_meas * (mu / jnp.maximum(s2, 1e-20) + z / jnp.maximum(tau2, 1e-20))
    uniform_x = 1.0 / mu_range

    C1 = a / (a + b) * norm_pdf(z, mu, ns)
    C2 = b / (a + b) * uniform_x
    norm_c = jnp.maximum(C1 + C2, 1e-30)
    C1 = C1 / norm_c
    C2 = C2 / norm_c
    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0)) \
        + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0))

    mu_new = C1 * m + C2 * mu
    s2_new = C1 * (s2_new_meas + m * m) + C2 * (s2 + mu * mu) - mu_new * mu_new
    # the denominator f - e/f is legitimately negative here; only guard the
    # magnitude (a sign-destroying clamp would flip a/b catastrophically)
    denom = f - e / jnp.maximum(f, 1e-20)
    denom = jnp.where(jnp.abs(denom) < 1e-20,
                      jnp.where(denom < 0, -1e-20, 1e-20), denom)
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / jnp.maximum(f, 1e-20)

    # guards
    s2_new = jnp.where(s2_new < 0.0, s2, s2_new)
    diverged = mu_new < 0.0
    mu_new = jnp.where(diverged, 1.0, mu_new)

    upd = lambda new, old: jnp.where(ok, new, old)
    return DepthFilterState(mu=upd(mu_new, mu), sigma2=upd(s2_new, s2),
                            a=upd(a_new, a), b=upd(b_new, b))


def update(state: DepthFilterState, T_kf_ef: SE3, kf_coord, tracks,
           cam: Pinhole, mu_range: float, px_noise: float = 3.0,
           mask=None) -> DepthFilterState:
    """Full measurement update from point tracks (DepthPoints::update,
    DepthPoints.cpp:137-178): event-frame correspondence = kf pixel + track,
    triangulate, tau from geometry, Vogiatzis filter."""
    if mask is None:
        mask = jnp.ones(kf_coord.shape[0], bool)
    x_ef = kf_coord + tracks
    inv_depth = triangulate_inv_depth(kf_coord, x_ef, cam, T_kf_ef)
    pos = inv_depth > 1e-12
    depth = 1.0 / jnp.where(pos, inv_depth, 1.0)
    x_norm = jnp.stack([(x_ef[:, 0] - cam.cx) / cam.fx,
                        (x_ef[:, 1] - cam.cy) / cam.fy], axis=-1)
    ang = angle_error(px_noise, cam.fx, cam.fy)
    tau = compute_tau(T_kf_ef, x_norm, depth, ang)
    tau2 = sigma2_from_depth_sigma(depth, tau)
    return vogiatzis_update(state, inv_depth, tau2, mu_range, mask & pos)


def converged(state: DepthFilterState, mu_range: float, thresh: float):
    """sigma2 < (range/thresh)^2 (DepthPoints.hpp:183-191)."""
    t = mu_range / thresh
    return state.sigma2 < t * t
