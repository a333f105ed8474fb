"""Event-to-model alignment — the EDS pose tracker.

Array-based redesign of ``eds::tracking::Tracker`` + ``PhotometricError``
(reference src/tracking/Tracker.cpp, src/tracking/PhotometricError.hpp):

Residual per active point i (PhotometricError::operator(), :124-182):
    model_i = -(gx_i * flow_x + gy_i * flow_y)
    r_i     = w_i * (model_i / ||model|| - E(pi(R X_i + t)))
with the interaction-matrix flow (compute_flow, :114-122), ||model|| the
l2-norm over the whole point set (+1e-3 guard like :132; the reference
normalizes per Ceres thread-chunk — SURVEY §7 flags that the norm then
depends on num_threads, so we use one global normalization), and E the
Frobenius-normalized event frame sampled bicubically (:170-173).

State: translation px (3), unit quaternion qx (4), unit-norm 6-dof velocity
vx (Tracker.hpp:47-49). Local parameterization matches the reference:
quaternion via exp-map increment (EigenQuaternionParameterization) and
velocity via normalized addition (UnitNormVectorAddition,
PhotometricError.hpp:32-54).

Solver: LM over the 12-dof local increment. Where the reference leans on
Ceres autodiff, we use jax.jacfwd of the full residual vector — exact
derivatives including the global-normalization coupling and the bicubic
sampling gradient, at ~12x the residual cost in forward mode (the reference
pays 2 Evaluate passes per point chunk per iteration). Robust scale is
re-estimated from the final residuals via MAD (getLossParams, :281-317).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import lie
from ..utils.lie import SE3
from ..utils.cameras import Pinhole
from ..utils.interp import bicubic, bicubic_with_grad
from ..utils.precision import full_f32
from ..utils.stats import (huber_weight, cauchy_weight, masked_mad,
                           masked_mean_std, HUBER_K)


class TrackerState(NamedTuple):
    px: jax.Array    # [3] translation of T_ef_kf
    qx: jax.Array    # [4] quaternion [w,x,y,z] of T_ef_kf
    vx: jax.Array    # [6] unit-norm [linear(3), angular(3)] velocity


class TrackerResult(NamedTuple):
    state: TrackerState
    residuals: jax.Array    # [P] final weighted residuals
    energy: jax.Array       # scalar robust energy
    n_iter: jax.Array
    loss_scale: jax.Array   # MAD-updated Huber scale for the next solve


def initial_tracker_state(dtype=jnp.float32) -> TrackerState:
    """Reference init: zero pose, velocity (0.1,...)/|..| (Tracker.cpp:40-47)."""
    v = jnp.full((6,), 0.1, dtype)
    return TrackerState(px=jnp.zeros(3, dtype), qx=lie.quat_identity(dtype),
                        vx=v / jnp.linalg.norm(v))


def compute_flow(norm_coord, vx, idp):
    """Interaction-matrix optical flow at normalized coords [P, 2] with
    inverse depths [P] (compute_flow, PhotometricError.hpp:114-122)."""
    x = norm_coord[:, 0]
    y = norm_coord[:, 1]
    v0, v1, v2, w0, w1, w2 = (vx[0], vx[1], vx[2], vx[3], vx[4], vx[5])
    fx = -idp * v0 + x * idp * v2 + x * y * w0 - (1.0 + x * x) * w1 + y * w2
    fy = -idp * v1 + y * idp * v2 + (1.0 + y * y) * w0 - x * y * w1 - x * w2
    return jnp.stack([fx, fy], axis=-1)


@full_f32
def event_residuals(state: TrackerState, event_frame, cam: Pinhole,
                    norm_coord, grad, idp, weights, mask,
                    norm_eps: float = 1e-3, norm_event: bool = False):
    """The full residual vector [P] (masked lanes -> 0).

    norm_event=False: PhotometricError — ``event_frame`` is pre-normalized
    (Frobenius) and sampled directly.
    norm_event=True: PhotometricErrorNC (src/tracking/PhotometricErrorNC.hpp
    :151-186) — ``event_frame`` is the RAW accumulation and the sampled
    values are normalized by their own l2 norm, mirroring the model side.
    """
    flow = compute_flow(norm_coord, state.vx, idp)
    model = -(grad[:, 0] * flow[:, 0] + grad[:, 1] * flow[:, 1])
    model = jnp.where(mask, model, 0.0)
    model_norm = jnp.sqrt(norm_eps + jnp.sum(model * model))

    # 3D points from normalized coords + inverse depth (eps guard :100)
    z = 1.0 / (idp + 1e-5)
    X = jnp.stack([norm_coord[:, 0] * z, norm_coord[:, 1] * z, z], axis=-1)
    R = lie.quat_to_mat(state.qx)
    p = X @ R.T + state.px[None, :]
    xp = cam.fx * (p[:, 0] / p[:, 2]) + cam.cx
    yp = cam.fy * (p[:, 1] / p[:, 2]) + cam.cy
    ev = bicubic(event_frame, xp, yp)
    if norm_event:
        ev = jnp.where(mask, ev, 0.0)
        ev = ev / jnp.sqrt(norm_eps + jnp.sum(ev * ev))
    r = weights * (model / model_norm - ev)
    return jnp.where(mask, r, 0.0)


def interaction_matrix(norm_coord, idp):
    """L [P, 2, 6] with flow = L @ v (compute_flow is linear in the 6-dof
    velocity; PhotometricError.hpp:114-122 rows written out)."""
    x = norm_coord[:, 0]
    y = norm_coord[:, 1]
    z = jnp.zeros_like(x)
    row_x = jnp.stack([-idp, z, x * idp, x * y, -(1.0 + x * x), y], axis=-1)
    row_y = jnp.stack([z, -idp, y * idp, (1.0 + y * y), -x * y, -x], axis=-1)
    return jnp.stack([row_x, row_y], axis=-2)


@full_f32
def event_residuals_and_jac(state: TrackerState, event_frame, cam: Pinhole,
                            norm_coord, grad, idp, weights, mask,
                            norm_eps: float = 1e-3,
                            axis_name: str | None = None,
                            norm_event: bool = False):
    """Residuals [P] + analytic Jacobian [P, 12] wrt the local increment
    (translation additive, quaternion left exp-map, velocity normalized
    addition) — the hand-derived replacement for forward-mode autodiff
    (SURVEY §7 "the hard parts": the model/||model|| normalization couples
    all residuals; its Jacobian is the rank-1-corrected A/||m|| term below).

    r_i = w_i * (m_i/||m|| - E(pi(R X_i + px)))  with  m = A v,
    A_i = -(L_i^T g_i) from the interaction matrix (linear in v), and
    ||m|| = sqrt(eps + m.m):

    * d(m/||m||)/dv  = (A - (m/||m||) (m^T A)/||m||) / ||m||, then projected
      through the unit-norm retraction (I - v v^T) (UnitNormVectorAddition's
      tangent at delta=0).
    * d r/d(px, q)   = -w * grad(E) . dpi . d(R X + px)/d(delta) with
      d/dpx = I, d/d(dq) = -[R X]_x (left perturbation), and grad(E) the
      analytic bicubic spatial gradient.
    """
    P = norm_coord.shape[0]
    dtype = norm_coord.dtype
    maskf = mask.astype(dtype)

    # ---- model branch (velocity block)
    L = interaction_matrix(norm_coord, idp)                  # [P, 2, 6]
    A = -jnp.einsum("pgx,pg->px", L, grad)                   # [P, 6]
    A = A * maskf[:, None]
    v = state.vx
    m = A @ v                                                # [P]
    # the norm and m^T A couple ALL residuals: under a sharded point axis
    # they are the two global reductions (one psum each)
    m2 = jnp.sum(m * m)
    mTA = m @ A                                              # [6]
    if axis_name is not None:
        m2 = jax.lax.psum(m2, axis_name)
        mTA = jax.lax.psum(mTA, axis_name)
    norm = jnp.sqrt(norm_eps + m2)
    mh = m / norm
    Jv = (A - mh[:, None] * (mTA / norm)[None, :]) / norm
    Jv = Jv @ (jnp.eye(6, dtype=dtype) - jnp.outer(v, v))

    # ---- event-frame branch (pose block)
    z = 1.0 / (idp + 1e-5)
    X = jnp.stack([norm_coord[:, 0] * z, norm_coord[:, 1] * z, z], axis=-1)
    R = lie.quat_to_mat(state.qx)
    RX = X @ R.T                                             # [P, 3]
    p = RX + state.px[None, :]
    inv_z = 1.0 / p[:, 2]
    xp = cam.fx * (p[:, 0] * inv_z) + cam.cx
    yp = cam.fy * (p[:, 1] * inv_z) + cam.cy
    ev, dEdx, dEdy = bicubic_with_grad(event_frame, xp, yp)

    # dpi/dp [P, 2, 3]
    du = jnp.stack([cam.fx * inv_z, jnp.zeros_like(inv_z),
                    -cam.fx * p[:, 0] * inv_z * inv_z], axis=-1)
    dv_ = jnp.stack([jnp.zeros_like(inv_z), cam.fy * inv_z,
                     -cam.fy * p[:, 1] * inv_z * inv_z], axis=-1)
    gE = dEdx[:, None] * du + dEdy[:, None] * dv_            # [P, 3] dE/dp
    # translation block: -w * gE ; rotation block: -w * gE @ (-[RX]_x)
    def skew(a):
        zz = jnp.zeros_like(a[:, 0])
        return jnp.stack([
            jnp.stack([zz, -a[:, 2], a[:, 1]], -1),
            jnp.stack([a[:, 2], zz, -a[:, 0]], -1),
            jnp.stack([-a[:, 1], a[:, 0], zz], -1)], axis=-2)

    # dev/d(t, dq) [P, 6]
    D = jnp.concatenate([gE, -jnp.einsum("pi,pij->pj", gE, skew(RX))],
                        axis=-1) * maskf[:, None]

    if norm_event:
        # NC variant: E-side normalization adds its own rank-1 coupling,
        # d(ev/||ev||)/dth = D/||ev|| - (ev/||ev||) (ev^T D)/||ev||^2
        ev = ev * maskf
        e2 = jnp.sum(ev * ev)
        s = ev @ D                                            # [6] global
        if axis_name is not None:
            e2 = jax.lax.psum(e2, axis_name)
            s = jax.lax.psum(s, axis_name)
        en = jnp.sqrt(norm_eps + e2)
        eh = ev / en
        Jpose = -(D / en - eh[:, None] * (s / (en * en))[None, :])
        ev_term = eh
    else:
        Jpose = -D
        ev_term = ev

    w = weights * maskf
    r = w * (mh - ev_term)
    J = jnp.concatenate([w[:, None] * Jpose, w[:, None] * Jv], axis=-1)
    return jnp.where(mask, r, 0.0), jnp.where(mask[:, None], J, 0.0)


def _apply_local(state: TrackerState, delta):
    """12-dof local update: translation additive, quaternion exp-map,
    velocity normalized addition."""
    px = state.px + delta[0:3]
    qx = lie.quat_normalize(lie.quat_mul(lie.quat_exp(delta[3:6]), state.qx))
    v = state.vx + delta[6:12]
    vx = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
    return TrackerState(px=px, qx=qx, vx=vx)


class _Carry(NamedTuple):
    state: TrackerState
    lam: jax.Array
    energy: jax.Array
    it: jax.Array
    done: jax.Array


@full_f32
def _lm_solve(state: TrackerState, event_frame, cam: Pinhole,
              norm_coord, grad, idp, weights, mask,
              max_iterations, loss_kind: str,
              loss_scale, function_tolerance: float,
              norm_event: bool) -> TrackerResult:
    """LM loop shared by ``optimize`` (one level, static iteration cap) and
    ``optimize_pyramid`` (fused scan over levels, traced caps).
    ``max_iterations`` and ``loss_scale`` may be traced values."""
    dtype = norm_coord.dtype
    loss_scale = jnp.asarray(loss_scale, dtype)

    def res_of_delta(delta, st):
        return event_residuals(_apply_local(st, delta), event_frame, cam,
                               norm_coord, grad, idp, weights, mask,
                               norm_event=norm_event)

    def robust_weights(r):
        if loss_kind == "huber":
            return huber_weight(r, loss_scale)
        if loss_kind == "cauchy":
            return cauchy_weight(r, loss_scale)
        return jnp.ones_like(r)

    def energy_of(r):
        w = robust_weights(r)
        return jnp.sum(w * r * r)

    zero = jnp.zeros(12, dtype)

    def body(c: _Carry):
        # analytic residual+Jacobian (event_residuals_and_jac docstring);
        # forward-mode autodiff of the residual vector is kept as the test
        # oracle but is ~12x the work
        r, J = event_residuals_and_jac(c.state, event_frame, cam,
                                       norm_coord, grad, idp, weights, mask,
                                       norm_event=norm_event)
        w = jax.lax.stop_gradient(robust_weights(r)) * mask
        H = (J * w[:, None]).T @ J
        g = (J * w[:, None]).T @ r
        Hl = H + c.lam * jnp.diag(jnp.diagonal(H)) \
            + 1e-10 * jnp.eye(12, dtype=dtype)
        delta = -jnp.linalg.solve(Hl, g)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        new_state = _apply_local(c.state, delta)
        e_new = energy_of(res_of_delta(zero, new_state))
        accept = e_new < c.energy
        st = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), new_state, c.state)
        lam = jnp.where(accept, c.lam * 0.5, c.lam * 4.0)
        lam = jnp.clip(lam, 1e-7, 1e5)
        energy = jnp.where(accept, e_new, c.energy)
        rel = jnp.abs(c.energy - energy) / jnp.maximum(c.energy, 1e-12)
        done = accept & (rel < function_tolerance)
        return _Carry(st, lam, energy, c.it + 1, done)

    e0 = energy_of(res_of_delta(zero, state))
    init = _Carry(state, jnp.asarray(1e-4, dtype), e0, jnp.asarray(0),
                  jnp.asarray(False))
    out = jax.lax.while_loop(
        lambda c: (c.it < max_iterations) & ~c.done, body, init)

    r_final = res_of_delta(zero, out.state)
    # MAD re-estimation of the robust scale for the next solve
    mad, _ = masked_mad(r_final, mask)
    new_scale = jnp.maximum(HUBER_K * mad, 1e-6)
    return TrackerResult(state=out.state, residuals=r_final,
                         energy=out.energy, n_iter=out.it,
                         loss_scale=new_scale)


@partial(jax.jit, static_argnames=("max_iterations", "loss_kind",
                                   "norm_event"))
def optimize(state: TrackerState, event_frame, cam: Pinhole,
             norm_coord, grad, idp, weights, mask,
             max_iterations: int = 20, loss_kind: str = "huber",
             loss_scale=0.2, function_tolerance: float = 1e-6,
             norm_event: bool = False) -> TrackerResult:
    """One pyramid-level solve (Tracker::optimize). Returns the optimized
    state, final residuals, and the MAD-refreshed loss scale.
    norm_event selects the PhotometricErrorNC cost (see event_residuals)."""
    return _lm_solve(state, event_frame, cam, norm_coord, grad, idp,
                     weights, mask, max_iterations, loss_kind, loss_scale,
                     function_tolerance, norm_event)


@partial(jax.jit, static_argnames=("loss_kind", "norm_event"))
def _pyramid_fused(state: TrackerState, event_frames, cam: Pinhole,
                   norm_coord, grad, idp, weights, mask,
                   iters_per_level, loss_kind: str, loss_scale,
                   norm_event: bool) -> TrackerResult:
    """Coarse-to-fine solve over all levels in ONE dispatch: a lax.scan
    whose carry chains (pose state, MAD loss scale) through the levels.
    ``iters_per_level`` [L] is data, so changing the iteration schedule
    does not recompile, and a packet costs one dispatch instead of one per
    level."""
    def step(carry, inp):
        st, scale = carry
        ef_l, iters = inp
        res = _lm_solve(st, ef_l, cam, norm_coord, grad, idp, weights,
                        mask, iters, loss_kind, scale, 1e-6, norm_event)
        return (res.state, res.loss_scale), res

    # scan runs coarse -> fine (levels are stored fine-first)
    (_, _), results = jax.lax.scan(
        step, (state, jnp.asarray(loss_scale, norm_coord.dtype)),
        (event_frames[::-1], iters_per_level[::-1]))
    return jax.tree_util.tree_map(lambda x: x[-1], results)


def optimize_pyramid(state: TrackerState, event_frames, cam: Pinhole,
                     norm_coord, grad, idp, weights, mask,
                     iterations_per_level, loss_kind: str = "huber",
                     loss_scale=0.2, norm_event: bool = False):
    """Coarse-to-fine over the event-frame morphological levels (the
    reference's per-level max_num_iterations list; all levels share the
    full camera resolution, EventFrame levels are blur variants)."""
    n_levels = event_frames.shape[0]
    its = jnp.asarray(
        [iterations_per_level[min(lvl, len(iterations_per_level) - 1)]
         for lvl in range(n_levels)], jnp.int32)
    return _pyramid_fused(state, event_frames, cam, norm_coord, grad, idp,
                          weights, mask, its, loss_kind, loss_scale,
                          norm_event)


def pose_kf_ef(state: TrackerState) -> SE3:
    """T_kf_ef = (T_ef_kf)^-1 (Tracker.cpp:217-221)."""
    R = lie.quat_to_mat(state.qx)
    return SE3(R, state.px).inverse()


@full_f32
def warp_coords(state: TrackerState, cam: Pinhole, norm_coord, idp, mask):
    """Project active points into the event frame; returns (uv_ef [P, 2],
    alive mask) and the per-point track vectors relative to the KF pixel
    (Tracker::getCoord, :319-376): out-of-frame points are flagged dead."""
    z = 1.0 / (idp + 1e-5)
    X = jnp.stack([norm_coord[:, 0] * z, norm_coord[:, 1] * z, z], axis=-1)
    R = lie.quat_to_mat(state.qx)
    p = X @ R.T + state.px[None, :]
    xp = cam.fx * (p[:, 0] / p[:, 2]) + cam.cx
    yp = cam.fy * (p[:, 1] / p[:, 2]) + cam.cy
    alive = mask & (p[:, 2] > 1e-6) & (xp >= 0) & (xp <= cam.width - 1) \
        & (yp >= 0) & (yp <= cam.height - 1)
    uv = jnp.stack([xp, yp], axis=-1)
    return uv, alive


def mean_flow_magnitude(uv_ef, uv_kf, mask):
    """Mean squared per-point displacement — the KF trigger statistic
    (needNewKeyframe, Tracker.cpp:650-654)."""
    d = uv_ef - uv_kf
    d2 = jnp.sum(d * d, axis=-1)
    m = mask.astype(d2.dtype)
    return jnp.sum(d2 * m) / jnp.maximum(jnp.sum(m), 1.0)


class PoseFilter(NamedTuple):
    """Ring buffer of recent pose tangents for the Lie-mean smoother
    (SE3MW, src/tracking/Types.hpp:81-147 / getFilteredPose)."""
    taus: jax.Array   # [W, 6]
    count: jax.Array  # number of valid entries
    head: jax.Array


def pose_filter_init(window: int, dtype=jnp.float32) -> PoseFilter:
    return PoseFilter(jnp.zeros((window, 6), dtype), jnp.asarray(0),
                      jnp.asarray(0))


def pose_filter_push(f: PoseFilter, T: SE3) -> PoseFilter:
    W = f.taus.shape[0]
    taus = f.taus.at[f.head].set(T.log())
    return PoseFilter(taus, jnp.minimum(f.count + 1, W), (f.head + 1) % W)


def pose_filter_mean(f: PoseFilter) -> SE3:
    W = f.taus.shape[0]
    m = (jnp.arange(W) < f.count).astype(f.taus.dtype)
    mean = jnp.sum(f.taus * m[:, None], axis=0) / jnp.maximum(
        jnp.sum(m), 1.0)
    return SE3.exp(mean)


# ---------------------------------------------------------------------------
# Track refinement (Tracker::trackPoints / trackPointsPyr /
# trackPointsAlongEpiline, src/tracking/Tracker.cpp:378-553): refine the
# warp-predicted tracks against the current event frame before they feed
# DepthPoints::update. All three reference variants, batched over points.
# ---------------------------------------------------------------------------

def _splat_gradient_images(uv, grad, mask, height: int, width: int):
    """Rasterize the per-point KF gradient values at the warped coordinates
    (KeyFrame::getGradient_x/y, KeyFrame.cpp:1319-1351: drawValuesPoints of
    grad.x / grad.y at ``coord``). Returns (gx_img, gy_img)."""
    from ..utils.events import scatter_accumulate
    gx = scatter_accumulate(uv[:, 0], uv[:, 1], grad[:, 0], height, width,
                            mask=mask, method="bilinear")
    gy = scatter_accumulate(uv[:, 0], uv[:, 1], grad[:, 1], height, width,
                            mask=mask, method="bilinear")
    return gx, gy


def _klt_flow_from_patches(gx_p, gy_p, ev_p, min_strength: float = 1e-6,
                           rank_ratio: float = 1e-3):
    """One Lucas-Kanade normal-equation solve per point treating the event
    frame as the temporal derivative (eds::utils::kltTracker,
    Utils.cpp:735-759): f = -M^+ b with M = [sum IxIx, sum IxIy; ., sum
    IyIy], b = [sum Ix It, sum Iy It]. Patch axes: [P, K].

    Solved with the 2x2 symmetric PSEUDO-inverse rather than the
    reference's M.inverse(): a patch containing a single splatted point
    has gx_p exactly proportional to gy_p (rank-1 structure tensor, the
    aperture problem) which the hard inverse turns into inf/garbage; the
    pseudo-inverse yields the minimal-norm solution — the NORMAL flow
    along the gradient, the only component the event actually observes."""
    Mxx = jnp.sum(gx_p * gx_p, -1)
    Mxy = jnp.sum(gx_p * gy_p, -1)
    Myy = jnp.sum(gy_p * gy_p, -1)
    bx = jnp.sum(gx_p * ev_p, -1)
    by = jnp.sum(gy_p * ev_p, -1)
    # eigendecomposition of the symmetric PSD 2x2 M
    tr = Mxx + Myy
    disc = jnp.sqrt(jnp.maximum((Mxx - Myy) ** 2 + 4.0 * Mxy * Mxy, 0.0))
    lam1 = 0.5 * (tr + disc)                    # principal eigenvalue
    lam2 = jnp.maximum(0.5 * (tr - disc), 0.0)
    # principal eigenvector (choose the better-conditioned formula)
    v1a = jnp.stack([lam1 - Myy, Mxy], -1)
    v1b = jnp.stack([Mxy, lam1 - Mxx], -1)
    use_a = jnp.abs(lam1 - Myy) >= jnp.abs(lam1 - Mxx)
    v1 = jnp.where(use_a[:, None], v1a, v1b)
    v1 = v1 / jnp.maximum(jnp.linalg.norm(v1, axis=-1, keepdims=True), 1e-20)
    v2 = jnp.stack([-v1[:, 1], v1[:, 0]], -1)
    b = jnp.stack([bx, by], -1)
    ok = lam1 > min_strength
    c1 = jnp.where(ok, jnp.sum(v1 * b, -1) / jnp.maximum(lam1, 1e-20), 0.0)
    full_rank = lam2 > rank_ratio * lam1
    c2 = jnp.where(full_rank,
                   jnp.sum(v2 * b, -1) / jnp.maximum(lam2, 1e-20), 0.0)
    f = -(c1[:, None] * v1 + c2[:, None] * v2)
    return f, ok


def refine_tracks_klt(event_frame, uv_warped, grad, mask,
                      patch_radius: int = 3, num_levels: int = 1):
    """Refine warped tracks by per-point event-based KLT
    (Tracker::trackPoints, Tracker.cpp:378-434; pyramidal variant
    trackPointsPyr, :436-488 when num_levels > 1).

    The KF's per-point gradients are splatted at the warped coordinates
    into sparse gradient images; a patch of those and of the event frame
    around each warped point feeds one LK normal-equation solve whose flow
    increment f is ADDED to the track (``kf->tracks[idx] += f``). The
    pyramidal variant accumulates f over per-patch pyramids coarse->fine
    with the reference's 1/scale^2 weighting
    (``f += (1.0/scale) * kltTracker(...)/scale``, Tracker.cpp:476).

    Returns (delta [P, 2] track increment, ok [P] solvable-system mask).
    ok=False points get delta 0 (the reference keeps them too: its outlier
    erase is disabled, Tracker.cpp:417 ``bool oulier = false``).
    """
    from ..utils.klt import _patch_grid
    from ..utils.interp import bilinear
    H, W = event_frame.shape
    gx_img, gy_img = _splat_gradient_images(uv_warped, grad, mask, H, W)

    delta = jnp.zeros_like(uv_warped)
    ok_all = jnp.zeros(uv_warped.shape[0], bool)
    for lvl in range(num_levels - 1, -1, -1):
        scale = float(2 ** lvl)
        # downsampled patch of the full-res images at fixed center
        # (pyramidPatches downsamples the extracted patch; sampling the
        # full-res image with 2^l spacing is the alias-free equivalent)
        dx, dy = _patch_grid(patch_radius, uv_warped.dtype)
        xs = uv_warped[:, 0:1] + scale * dx[None, :]
        ys = uv_warped[:, 1:2] + scale * dy[None, :]
        gx_p = bilinear(gx_img, xs, ys)
        gy_p = bilinear(gy_img, xs, ys)
        ev_p = bilinear(event_frame, xs, ys)
        f, ok = _klt_flow_from_patches(gx_p, gy_p, ev_p)
        delta = delta + f / (scale * scale)
        ok_all = ok_all | ok
    # bound the increment: one LK step on a sparse splat can shoot far on
    # near-degenerate systems; the event displacement per packet is small
    delta = jnp.clip(delta, -2.0 * patch_radius, 2.0 * patch_radius)
    return jnp.where((mask & ok_all)[:, None], delta, 0.0), mask & ok_all


def refine_tracks_model_klt(event_frame, uv_warped, model, mask,
                            patch_radius: int = 3, iterations: int = 4,
                            max_delta: float = 3.0):
    """Scale-correct track refinement: inverse-compositional LK between the
    rasterized brightness-change MODEL image and the event frame.

    The reference's trackPoints correlates the raw KF gradient splat with
    the raw event frame (Tracker.cpp:378-434), which makes the recovered
    flow proportional to the event frame's arbitrary Frobenius
    normalization (a gain the reference never compensates). Rasterizing
    the normalized model at the warped positions instead gives a template
    in the SAME units as the normalized event frame — E(x+f) ~ m(x) — so
    the LK solution is the geometric offset in pixels, independent of
    either normalization. This is the recommended refinement mode.

    model: [P] normalized sparse model values (keyframe.sparse_model at
    the solver's velocity). Returns (delta [P, 2], ok [P]).
    """
    from ..utils import klt as kltmod
    from ..utils.events import scatter_accumulate
    H, W = event_frame.shape
    model_img = scatter_accumulate(uv_warped[:, 0], uv_warped[:, 1], model,
                                   H, W, mask=mask, method="bilinear")
    uv_new, ok, _ = kltmod.klt_track(model_img, event_frame, uv_warped,
                                     radius=patch_radius,
                                     iterations=iterations)
    delta = jnp.clip(uv_new - uv_warped, -max_delta, max_delta)
    ok = ok & mask
    return jnp.where(ok[:, None], delta, 0.0), ok


def refine_tracks_epiline(event_frame, kf_uv, uv_warped, model, mask,
                          T_kf_ef: SE3, cam: Pinhole,
                          patch_radius: int = 3, search_range: float = 6.0,
                          num_steps: int = 25,
                          consistency_px: float = 5.0):
    """Epipolar template search (Tracker::trackPointsAlongEpiline,
    Tracker.cpp:490-553): the rasterized brightness-change model patch of
    each point is searched along its epipolar line in the event frame with
    TWO similarity measures; points where the two matchers disagree by more
    than ``consistency_px`` are flagged dead (the reference erases them).

    model: [P] normalized sparse model values (keyframe.sparse_model).
    Returns (uv_refined [P, 2], alive [P]).
    """
    from ..utils import klt as kltmod
    from ..utils.events import scatter_accumulate
    H, W = event_frame.shape
    model_img = scatter_accumulate(kf_uv[:, 0], kf_uv[:, 1], model, H, W,
                                   mask=mask, method="bilinear")
    # epipolar directions in the event frame from the current relative pose
    F = kltmod.fundamental_from_pose(T_kf_ef.inverse(), cam.K)
    d = kltmod.epiline_directions(F, kf_uv)
    uv_ssd, s_ssd = kltmod.search_along_epiline(
        model_img, event_frame, uv_warped, d, search_range,
        radius=patch_radius, num_steps=num_steps, measure="zssd",
        uv_tpl=kf_uv)
    uv_ncc, s_ncc = kltmod.search_along_epiline(
        model_img, event_frame, uv_warped, d, search_range,
        radius=patch_radius, num_steps=num_steps, measure="zncc",
        uv_tpl=kf_uv)
    # consistency gate: |  |p_ssd| - |p_ncc| | > threshold -> erase
    # (Tracker.cpp:538-543 gates on the norm difference of the two matches)
    dis = jnp.abs(jnp.linalg.norm(uv_ssd, axis=-1)
                  - jnp.linalg.norm(uv_ncc, axis=-1))
    alive = mask & (dis <= consistency_px)
    return jnp.where(alive[:, None], uv_ssd, uv_warped), alive
