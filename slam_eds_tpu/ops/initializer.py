"""Monocular bootstrap: two-view initial structure.

Array-based replacement for ``KeyFrame::initialStructure`` (reference
src/tracking/KeyFrame.cpp:825-935 — ORB + FLANN + Lowe ratio + essential
matrix + recoverPose, success if >12 inliers) and the entry point for the
MiDaS/depth-map seeding path (tracking/Config.hpp:39). Feature matching is
replaced by KLT tracks of the keyframe's gradient points (the reference
also ships KLT tracking for this purpose, Tracker.cpp:378-488); the robust
essential-matrix estimation is a *batched* RANSAC: all hypotheses are
solved and scored in parallel (8-point via batched SVD, Sampson-distance
inlier scoring), then the best is re-fit on its inliers, where the
reference loops hypothesis-by-hypothesis inside OpenCV.

Also provides cheirality-checked pose recovery (the four-fold E
decomposition) and two-view midpoint triangulation for the initial depths.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.lie import SE3
from ..utils.cameras import Pinhole


def _normalize_pts(x):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    mu = jnp.mean(x, axis=0)
    d = jnp.mean(jnp.linalg.norm(x - mu, axis=1))
    s = jnp.sqrt(2.0) / jnp.maximum(d, 1e-12)
    T = jnp.array([[s, 0, -s * mu[0]], [0, s, -s * mu[1]], [0, 0, 1.0]],
                  x.dtype)
    xh = jnp.concatenate([x, jnp.ones_like(x[:, :1])], -1) @ T.T
    return xh, T


def eight_point(x1, x2):
    """Essential/fundamental matrix from >= 8 normalized-camera
    correspondences x1, x2 [N, 2] (least squares + rank-2 projection)."""
    x1h, T1 = _normalize_pts(x1)
    x2h, T2 = _normalize_pts(x2)
    A = jnp.stack([
        x2h[:, 0] * x1h[:, 0], x2h[:, 0] * x1h[:, 1], x2h[:, 0],
        x2h[:, 1] * x1h[:, 0], x2h[:, 1] * x1h[:, 1], x2h[:, 1],
        x1h[:, 0], x1h[:, 1], jnp.ones_like(x1h[:, 0])], axis=-1)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[-1].reshape(3, 3)
    U, S, Vt2 = jnp.linalg.svd(F)
    # essential constraint: two equal singular values, third zero
    S = jnp.array([1.0, 1.0, 0.0], F.dtype) * (S[0] + S[1]) * 0.5
    F = U @ jnp.diag(S) @ Vt2
    E = T2.T @ F @ T1
    return E / jnp.maximum(jnp.linalg.norm(E), 1e-12)


def sampson_distance(E, x1, x2):
    """Squared Sampson distance of correspondences to E."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], -1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[:, :1])], -1)
    Ex1 = x1h @ E.T
    Etx2 = x2h @ E
    num = jnp.sum(x2h * Ex1, -1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


@partial(jax.jit, static_argnames=("num_hypotheses",))
def ransac_essential(x1, x2, mask, seed: jax.Array,
                     num_hypotheses: int = 128, threshold: float = 1e-4):
    """Batched RANSAC: sample num_hypotheses 8-tuples, solve all E in
    parallel, score Sampson inliers, re-fit on the best inlier set.

    x1, x2: [N, 2] normalized camera coords; mask: valid correspondences.
    Returns (E, inlier_mask, n_inliers)."""
    N = x1.shape[0]
    key = jax.random.PRNGKey(seed) if jnp.ndim(seed) == 0 else seed
    # sample with probability proportional to validity
    logits = jnp.where(mask, 0.0, -1e9)
    picks = jax.random.categorical(
        key, logits[None, :].repeat(num_hypotheses * 8, 0), axis=-1)
    picks = picks.reshape(num_hypotheses, 8)

    def solve_one(idx):
        return eight_point(x1[idx], x2[idx])

    Es = jax.vmap(solve_one)(picks)                 # [Hyp, 3, 3]
    d = jax.vmap(lambda E: sampson_distance(E, x1, x2))(Es)   # [Hyp, N]
    inl = (d < threshold) & mask[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    best_inl = inl[best]

    # re-fit on inliers (weighted: zero-out outliers by collapsing them to
    # the centroid so they do not constrain the solution)
    w = best_inl.astype(x1.dtype)[:, None]
    c1 = jnp.sum(x1 * w, 0) / jnp.maximum(jnp.sum(w), 1.0)
    c2 = jnp.sum(x2 * w, 0) / jnp.maximum(jnp.sum(w), 1.0)
    x1f = jnp.where(best_inl[:, None], x1, c1)
    x2f = jnp.where(best_inl[:, None], x2, c2)
    E = eight_point(x1f, x2f)
    d_final = sampson_distance(E, x1, x2)
    inl_final = (d_final < threshold) & mask
    return E, inl_final, jnp.sum(inl_final)


def triangulate_midpoint(x1, x2, T_21: SE3):
    """Midpoint triangulation of normalized-camera rays. Returns (X1 [N, 3]
    points in camera 1, depth-positive mask)."""
    d1 = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], -1)
    d2c1 = jnp.concatenate([x2, jnp.ones_like(x2[:, :1])], -1) @ T_21.R
    # camera 2 center in camera-1 coords
    c2 = -(T_21.R.T @ T_21.t)
    # solve [d1, -d2] [s; t] = c2 in least squares per point
    a11 = jnp.sum(d1 * d1, -1)
    a12 = -jnp.sum(d1 * d2c1, -1)
    a22 = jnp.sum(d2c1 * d2c1, -1)
    b1 = jnp.sum(d1 * c2[None, :], -1)
    b2 = -jnp.sum(d2c1 * c2[None, :], -1)
    det = a11 * a22 - a12 * a12
    s = (a22 * b1 - a12 * b2) / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    t = (a11 * b2 - a12 * b1) / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    X1 = 0.5 * (d1 * s[:, None] + (d2c1 * t[:, None] + c2[None, :]))
    ok = (s > 1e-6) & (t > 1e-6)
    return X1, ok


def recover_pose(E, x1, x2, mask):
    """Cheirality-checked decomposition of E into (R, t) with |t| = 1
    (cv::recoverPose equivalent): test the 4 candidates, pick the one with
    the most points in front of both cameras.

    Returns (T_21 [transform camera1 -> camera2], points_in_front)."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    Wm = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                   E.dtype)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t = U[:, 2]

    def count(R, tt):
        T = SE3(R, tt)
        _, ok = triangulate_midpoint(x1, x2, T)
        return jnp.sum(ok & mask)

    cands_R = jnp.stack([R1, R1, R2, R2])
    cands_t = jnp.stack([t, -t, t, -t])
    counts = jax.vmap(count)(cands_R, cands_t)
    best = jnp.argmax(counts)
    T_21 = SE3(cands_R[best], cands_t[best])
    return T_21, counts[best]


class BootstrapResult(NamedTuple):
    T_21: SE3             # first -> second camera
    idepth: jax.Array     # [N] inverse depths in camera 1 (unit baseline)
    inliers: jax.Array    # [N] bool
    success: jax.Array    # bool (> min_inliers, ref: 12)


def bootstrap_eight_point(nc1, nc2, mask, seed=0, num_hypotheses: int = 128,
                          threshold: float = 1e-4,
                          min_inliers: int = 12) -> BootstrapResult:
    """Full two-view bootstrap from tracked normalized coords
    (initialStructure: E-RANSAC -> recoverPose -> triangulation; success
    if more than 12 inliers, KeyFrame.cpp:930-934)."""
    E, inl, n_inl = ransac_essential(nc1, nc2, mask, jnp.asarray(seed),
                                     num_hypotheses=num_hypotheses,
                                     threshold=threshold)
    T_21, n_front = recover_pose(E, nc1, nc2, inl)
    X1, ok = triangulate_midpoint(nc1, nc2, T_21)
    idepth = jnp.where(ok, 1.0 / jnp.maximum(X1[:, 2], 1e-6), 0.0)
    good = inl & ok
    # gauge fix: rescale so the mean inverse depth of the inlier set is 1
    # (DSO's rescaleFactor in initializeFromInitializer; the eight-point
    # recoverPose otherwise leaves |t| = 1 with arbitrary scene depth,
    # which breaks every config depth range / parallax threshold downstream)
    s = jnp.sum(jnp.where(good, idepth, 0.0)) \
        / jnp.maximum(jnp.sum(good.astype(idepth.dtype)), 1.0)
    s = jnp.where(s > 1e-8, s, 1.0)
    idepth = idepth / s
    T_21 = SE3(T_21.R, T_21.t * s)
    return BootstrapResult(T_21=T_21, idepth=idepth, inliers=good,
                           success=n_inl > min_inliers)
