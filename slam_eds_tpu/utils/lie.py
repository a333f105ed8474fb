"""Lie-group math for SO(3)/SE(3) — the JAX replacement for the vendored
Sophus headers in the reference (``src/sophus/se3.hpp``, ``src/sophus/so3.hpp``).

Conventions (matching Sophus, which the reference uses via
``src/utils/NumType.h:49-51``):

* SE(3) tangent vectors are ordered ``[upsilon(3), omega(3)]`` = [trans, rot].
* Quaternions are stored ``[w, x, y, z]`` (Hamilton, unit norm).
* ``exp``/``log`` use the exact closed forms with Taylor fallbacks near zero so
  everything is jit/grad-safe (no data-dependent branching — ``jnp.where`` on
  both branches with safe denominators).

All functions are shape-polymorphic over leading batch dimensions via vmap; the
non-batched forms here operate on single elements and are written to be cheap
under vmap/jit (pure VPU element-wise work, no matmul bottlenecks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from typing import NamedTuple

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: 3-vector -> 3x3 skew matrix."""
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy]),
        jnp.stack([wz, z, -wx]),
        jnp.stack([-wy, wx, z]),
    ])


def vee(W):
    """Inverse of hat: 3x3 skew matrix -> 3-vector."""
    return jnp.stack([W[2, 1], W[0, 2], W[1, 0]])


def so3_exp(w):
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix.

    Replaces ``Sophus::SO3::exp`` (reference src/sophus/so3.hpp).
    """
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor guards
    small = theta2 < _EPS
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    W = hat(w)
    return jnp.eye(3, dtype=w.dtype) + A * W + B * (W @ W)


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector (principal branch).

    Routed through the unit quaternion (branch-free Shepperd extraction +
    quaternion log), which is numerically stable for all angles including
    theta ~ pi where the classic vee(R - R^T) formula degenerates.
    """
    q = mat_to_quat(R)
    # principal branch: force qw >= 0 so theta in [0, pi]
    q = jnp.where(q[0] < 0, -q, q)
    qw = q[0]
    qv = q[1:]
    n = jnp.linalg.norm(qv)
    theta = 2.0 * jnp.arctan2(n, qw)
    small = n < 1e-6
    scale = jnp.where(small, 2.0 / jnp.clip(qw, 0.5, None), theta / (n + _EPS * _EPS))
    return scale * qv


def _so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3): exp((J_l w) ^) relates translations."""
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / (theta2 * theta + _EPS * _EPS))
    W = hat(w)
    return jnp.eye(3, dtype=w.dtype) + B * W + C * (W @ W)


def _so3_left_jacobian_inv(w):
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    half = jnp.asarray(0.5, w.dtype)
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * theta * jnp.cos(0.5 * theta) / (jnp.sin(0.5 * theta) + _EPS * _EPS))
        / (theta2 + _EPS * _EPS),
    )
    W = hat(w)
    return jnp.eye(3, dtype=w.dtype) - half * W + cot_term * (W @ W)


class SE3(NamedTuple):
    """Rigid transform: ``x_out = R @ x + t``.

    A minimal pytree (pair of arrays) so it flows through jit/vmap/scan freely.
    Batched SE3s are just SE3(R=[...,3,3], t=[...,3]) and most methods below
    broadcast; the exp/log/adjoint closed forms are per-element (vmap them).
    """
    R: jax.Array  # [..., 3, 3]
    t: jax.Array  # [..., 3]

    @staticmethod
    def identity(dtype=jnp.float32):
        return SE3(jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype))

    @staticmethod
    def exp(tau):
        """Tangent [upsilon, omega] -> SE3 (Sophus convention)."""
        v, w = tau[:3], tau[3:6]
        R = so3_exp(w)
        t = _so3_left_jacobian(w) @ v
        return SE3(R, t)

    def log(self):
        w = so3_log(self.R)
        v = _so3_left_jacobian_inv(w) @ self.t
        return jnp.concatenate([v, w])

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return SE3(self.R @ other.R, (self.R @ other.t[..., None])[..., 0] + self.t)
        raise TypeError(type(other))

    def compose(self, other: "SE3") -> "SE3":
        return SE3(self.R @ other.R,
                   jnp.einsum("...ij,...j->...i", self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rt = jnp.swapaxes(self.R, -1, -2)
        return SE3(Rt, -jnp.einsum("...ij,...j->...i", Rt, self.t))

    def apply(self, x):
        """Transform points x [..., 3]."""
        return jnp.einsum("...ij,...j->...i", self.R, x) + self.t

    def adjoint(self):
        """6x6 adjoint in [trans, rot] tangent ordering (matches Sophus Adj,
        used by the BA adjoint transport, reference
        src/bundles/EnergyFunctional.cpp:46-106)."""
        A = jnp.zeros((6, 6), dtype=self.R.dtype)
        A = A.at[:3, :3].set(self.R)
        A = A.at[:3, 3:].set(hat(self.t) @ self.R)
        A = A.at[3:, 3:].set(self.R)
        return A

    def matrix(self):
        M = jnp.zeros(self.R.shape[:-2] + (4, 4), dtype=self.R.dtype)
        M = M.at[..., :3, :3].set(self.R)
        M = M.at[..., :3, 3].set(self.t)
        M = M.at[..., 3, 3].set(1.0)
        return M

    @staticmethod
    def from_matrix(M):
        return SE3(M[..., :3, :3], M[..., :3, 3])


# ---------------------------------------------------------------------------
# Quaternions [w, x, y, z] — used by the event tracker state (reference keeps a
# Ceres EigenQuaternionParameterization, src/tracking/Tracker.cpp:111-114).
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q):
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack([
        jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
        jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
        jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
    ], axis=-2)
    return r


def mat_to_quat(R):
    """Rotation matrix -> unit quaternion [w,x,y,z] (branch-free Shepperd)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def case_w():
        s = jnp.sqrt(jnp.clip(tr + 1.0, _EPS, None)) * 2.0
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])

    def case_x():
        s = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, _EPS, None)) * 2.0
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])

    def case_y():
        s = jnp.sqrt(jnp.clip(1.0 + m11 - m00 - m22, _EPS, None)) * 2.0
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])

    def case_z():
        s = jnp.sqrt(jnp.clip(1.0 + m22 - m00 - m11, _EPS, None)) * 2.0
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])

    qs = jnp.stack([case_w(), case_x(), case_y(), case_z()])
    diag = jnp.stack([tr, m00, m11, m22])
    idx = jnp.argmax(diag)
    q = qs[idx]
    return quat_normalize(q)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q without forming the matrix."""
    qv = q[..., 1:]
    uv = jnp.cross(qv, v)
    uuv = jnp.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_exp(w):
    """so(3) axis-angle -> unit quaternion."""
    theta2 = jnp.dot(w, w)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    half = 0.5 * theta
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    return jnp.concatenate([jnp.cos(half)[None], k * w])


def se3_mean(taus, weights=None):
    """Weighted mean of SE3 tangent vectors — the pose-window Lie mean filter
    (reference ``SE3MW`` src/tracking/Types.hpp:81-147 and
    ``Tracker::getFilteredPose`` src/tracking/Tracker.cpp:594-648 take the
    tangent-space mean of a ring buffer of poses)."""
    if weights is None:
        return jnp.mean(taus, axis=0)
    w = weights / (jnp.sum(weights) + _EPS)
    return jnp.sum(taus * w[:, None], axis=0)
