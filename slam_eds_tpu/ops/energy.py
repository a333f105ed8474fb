"""Sliding-window photometric bundle adjustment — the JAX rewrite of
DSO's ``EnergyFunctional`` stack (reference src/bundles/EnergyFunctional.cpp,
AccumulatedTopHessian.cpp, AccumulatedSCHessian.cpp, MatrixAccumulators.h and
src/tracking/Residuals.cpp).

Redesign (SURVEY §7): the SSE rank-update accumulators, per-pair block
stitching and thread-pool reductions become a handful of dense einsums on
fixed-capacity masked tensors:

* ``linearize``     — batched residual/Jacobian evaluation over the
  (point, target, pattern) tensor: FEJ geometric Jacobians (evaluated at the
  first-estimate poses/idepths like Residuals.cpp:94-161) + current-state
  photometric residuals with gradient-and-Huber weighting (:174-236).
* ``assemble``      — global H/b + per-point Schur vectors via block einsums;
  the reduced camera system is only [4+8F]^2 (<= 68x68 at F=8), so the Schur
  complement is two tall-skinny matmuls (V^T diag(1/Hdd) V) instead of
  AccumulatedSCHessian's pair/triple block bookkeeping.
* ``solve_delta``   — scaled LDLT of the damped reduced system with gauge
  nullspace orthogonalization (EnergyFunctional.cpp:718-913) and per-point
  idepth back-substitution (:263-317).
* ``marginalize_points`` / ``marginalize_frame`` — first-estimate-Jacobian
  Schur updates of the HM/bM prior (:498-676), at fixed slot layout (no
  block reordering: eliminate the slot in place and zero it).

Every function that forms or solves the normal equations runs under
``utils.precision.full_f32`` (full float32 dots on every backend).

Adjoint transport (setAdjointsF, :46-106): residual Jacobians are computed in
relative (host->target) coordinates and mapped to per-frame state blocks with
AH = [-Adj(T_th_0) | affine rows], AT = [I | affine rows]; the affine rows use
the FEJ relative gain a_rel0 exactly as the reference (AH/AT diag entries
a_rel, a_rel / -a_rel, -1).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..models.ba_state import BAState, CPARS, PT_ACTIVE, PT_MARGINALIZE
from ..utils.lie import SE3
from ..utils.image import PATTERN_DSO8
from ..utils.interp import pattern_tile_sample
from ..utils.precision import full_f32


def _host_select(oh, table):
    """Per-point host lookup table[host], written as a one-hot dot.

    Equal to ``table[p_host]`` (each one-hot row selects exactly one table
    row). oh: [P, F] one-hot of p_host. table: [F, ...] or [F, F, ...]
    (host-major pair tables, which select to [P, F, ...]).
    """
    flat = table.reshape(table.shape[0], -1)
    out = jnp.einsum("ph,hx->px", oh, flat.astype(oh.dtype))
    return out.reshape((oh.shape[0],) + table.shape[1:])


class Linearization(NamedTuple):
    """Per-(point, target, pattern) factored Jacobians and residuals."""
    res: jax.Array       # [P, F, K] weighted residuals (resF)
    JIdx: jax.Array      # [P, F, K, 2] weighted image gradients
    Jab: jax.Array       # [P, F, K, 2] weighted affine jacobian (drdA*hw, hw)
    Jpdxi: jax.Array     # [P, F, 2, 6] FEJ pose jacobian of projection
    Jpdc: jax.Array      # [P, F, 2, 4] FEJ calib jacobian
    Jpdd: jax.Array      # [P, F, 2] FEJ idepth jacobian
    valid: jax.Array     # [P, F] residual usable (active & in-frame & inlier)
    oob: jax.Array       # [P, F] projection left the frame (for flagging)
    energy: jax.Array    # [P, F] per-residual robust energy


def relative_affine(state: BAState, use_zero: bool):
    """a_rel[h, t], b_rel[h, t] (AffLight::fromToVecExposure batched)."""
    aff = state.aff_eval if use_zero else state.current_aff()
    a = aff[:, 0]
    b = aff[:, 1]
    e = state.exposure
    a_rel = jnp.exp(a[None, :] - a[:, None]) * (e[None, :] / e[:, None])
    b_rel = b[None, :] - a_rel * b[:, None]
    return a_rel, b_rel


def pair_adjoints(state: BAState):
    """AH/AT [F, F, 8, 8] mapping relative 8-dof jacobians to host/target
    state blocks, at the FEJ linearization point (setAdjointsF)."""
    F = state.num_frames
    T0 = state.T_eval

    def rel(h, t):
        Th = SE3(T0.R[h], T0.t[h])
        Tt = SE3(T0.R[t], T0.t[t])
        return Tt.compose(Th.inverse())

    idx = jnp.arange(F)
    hh, tt = jnp.meshgrid(idx, idx, indexing="ij")

    def one(h, t):
        T_th = rel(h, t)
        AH = jnp.zeros((8, 8), state.delta.dtype)
        AT = jnp.zeros((8, 8), state.delta.dtype)
        AH = AH.at[:6, :6].set(-T_th.adjoint())
        AT = AT.at[:6, :6].set(jnp.eye(6, dtype=state.delta.dtype))
        return AH, AT

    AH, AT = jax.vmap(jax.vmap(one))(hh, tt)
    a_rel0, _ = relative_affine(state, use_zero=True)
    AH = AH.at[:, :, 6, 6].set(a_rel0)
    AH = AH.at[:, :, 7, 7].set(a_rel0)
    AT = AT.at[:, :, 6, 6].set(-a_rel0)
    AT = AT.at[:, :, 7, 7].set(-1.0)
    return AH, AT


def _relative_poses(state: BAState, current: bool):
    """T_th [F, F] as stacked (R, t)."""
    T = state.current_poses() if current else state.T_eval

    def one(h, t):
        Th = SE3(T.R[h], T.t[h])
        Tt = SE3(T.R[t], T.t[t])
        T_th = Tt.compose(Th.inverse())
        return T_th.R, T_th.t

    F = state.num_frames
    idx = jnp.arange(F)
    hh, tt = jnp.meshgrid(idx, idx, indexing="ij")
    R, t = jax.vmap(jax.vmap(one))(hh, tt)
    return R, t


@partial(jax.jit, static_argnames=("height", "width"))
@full_f32
def linearize(state: BAState, target_images, height: int, width: int,
              huber_th: float = 9.0, outlier_th: float = 144.0,
              outlier_th_sum: float = 2500.0) -> Linearization:
    """Batched PointFrameResidual::linearize over all (point, target) pairs.

    target_images: [F, H, W, 3] stacks (I, gx, gy) of every window frame.
    """
    P = state.num_points
    F = state.num_frames
    K = PATTERN_DSO8.shape[0]
    dtype = state.p_uv.dtype

    fx, fy, cx, cy = [state.current_calib()[i] for i in range(4)]
    R0, t0 = _relative_poses(state, current=False)   # FEJ
    Rc, tc = _relative_poses(state, current=True)    # current
    a_rel, b_rel = relative_affine(state, use_zero=False)
    b0_host = state.aff_eval[:, 1]                   # FEJ host b (PRE_b0_mode)

    host = state.p_host                              # [P]
    oh = jax.nn.one_hot(host, F, dtype=dtype)        # [P, F_h]
    R0_p = _host_select(oh, R0)      # [P, F, 3, 3]
    t0_p = _host_select(oh, t0)
    Rc_p = _host_select(oh, Rc)
    tc_p = _host_select(oh, tc)
    a_rel_p = _host_select(oh, a_rel)   # [P, F]
    b_rel_p = _host_select(oh, b_rel)
    b0_p = oh @ b0_host                 # [P]

    u_pt = state.p_uv[:, 0]
    v_pt = state.p_uv[:, 1]
    KliP = jnp.stack([(u_pt - cx) / fx, (v_pt - cy) / fy,
                      jnp.ones_like(u_pt)], axis=-1)   # [P, 3]

    # ---- FEJ center projection + geometric jacobians (Residuals.cpp:94-161)
    ptp0 = jnp.einsum("pfij,pj->pfi", R0_p, KliP) \
        + t0_p * state.p_idepth_zero[:, None, None]
    drescale = 1.0 / jnp.maximum(ptp0[..., 2], 1e-12)
    pos_z0 = ptp0[..., 2] > 1e-6
    u = ptp0[..., 0] * drescale
    v = ptp0[..., 1] * drescale
    Ku0 = u * fx + cx
    Kv0 = v * fy + cy
    new_idepth = state.p_idepth_zero[:, None] * drescale
    center_ok = pos_z0 & (Ku0 > 1.1) & (Kv0 > 1.1) \
        & (Ku0 < width - 3) & (Kv0 < height - 3)

    d_d_x = drescale * (t0_p[..., 0] - t0_p[..., 2] * u) * fx
    d_d_y = drescale * (t0_p[..., 1] - t0_p[..., 2] * v) * fy
    Jpdd = jnp.stack([d_d_x, d_d_y], axis=-1)  # [P, F, 2]

    R00 = R0_p[..., 0, 0]; R01 = R0_p[..., 0, 1]
    R10 = R0_p[..., 1, 0]; R11 = R0_p[..., 1, 1]
    R20 = R0_p[..., 2, 0]; R21 = R0_p[..., 2, 1]
    dcx2 = drescale * (R20 * u - R00)
    dcx3 = fx * drescale * (R21 * u - R01) / fy
    dcy2 = fy * drescale * (R20 * v - R10) / fx
    dcy3 = drescale * (R21 * v - R11)
    Jpdc = jnp.stack([
        jnp.stack([KliP[:, None, 0] * dcx2 + u, KliP[:, None, 1] * dcx3,
                   dcx2 + 1.0, dcx3], axis=-1),
        jnp.stack([KliP[:, None, 0] * dcy2, KliP[:, None, 1] * dcy3 + v,
                   dcy2, dcy3 + 1.0], axis=-1),
    ], axis=-2)  # [P, F, 2, 4]

    zero = jnp.zeros_like(u)
    Jpdxi = jnp.stack([
        jnp.stack([new_idepth * fx, zero, -new_idepth * u * fx,
                   -u * v * fx, (1 + u * u) * fx, -v * fx], axis=-1),
        jnp.stack([zero, new_idepth * fy, -new_idepth * v * fy,
                   -(1 + v * v) * fy, u * v * fy, u * fy], axis=-1),
    ], axis=-2)  # [P, F, 2, 6]

    # ---- pattern projection at the current state (Residuals.cpp:174-236)
    offs = jnp.asarray(PATTERN_DSO8, dtype)   # [K, 2]
    pat = jnp.stack([(u_pt[:, None] + offs[None, :, 0] - cx) / fx,
                     (v_pt[:, None] + offs[None, :, 1] - cy) / fy,
                     jnp.ones((P, K), dtype)], axis=-1)    # [P, K, 3]
    ptp = jnp.einsum("pfij,pkj->pfki", Rc_p, pat) \
        + tc_p[:, :, None, :] * state.p_idepth[:, None, None, None]
    inv_z = 1.0 / jnp.maximum(ptp[..., 2], 1e-12)
    Ku = ptp[..., 0] * inv_z * fx + cx
    Kv = ptp[..., 1] * inv_z * fy + cy
    pat_ok = (ptp[..., 2] > 1e-6) & (Ku > 1.1) & (Kv > 1.1) \
        & (Ku < width - 3) & (Kv < height - 3)

    # sample every target frame at its pattern taps: one 4x4 patch gather
    # per tap gives the bilinear value and central-difference gradients
    I_t, gx, gy, in_tile = pattern_tile_sample(target_images[..., 0], Ku, Kv)

    color = state.p_color[:, None, :]      # [P, 1, K]
    residual = I_t - (a_rel_p[..., None] * color + b_rel_p[..., None])
    finite = in_tile & jnp.isfinite(I_t)
    drdA = color - b0_p[:, None, None]
    w_grad = jnp.sqrt(outlier_th_sum / (outlier_th_sum + gx * gx + gy * gy))
    w = 0.5 * (w_grad + state.p_weight[:, None, :])
    abs_r = jnp.abs(residual)
    hw_e = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
    energy_k = w * w * hw_e * residual * residual * (2.0 - hw_e)
    hw = jnp.where(hw_e < 1.0, jnp.sqrt(hw_e), hw_e) * w
    # IRLS: the robust/gradient weights are frozen at the current iterate —
    # they are not differentiated through (matches the reference's GN, and
    # makes autodiff of 0.5*sum(resF^2) equal the assembled J^T W r exactly)
    hw = jax.lax.stop_gradient(hw)

    resF = residual * hw
    JIdx = jnp.stack([gx * hw, gy * hw], axis=-1)
    Jab = jnp.stack([drdA * hw, hw], axis=-1)

    # ---- validity & outlier gating
    struct = state.r_active & (state.p_status[:, None] != 0) \
        & state.frame_valid[None, :] & (jnp.arange(F)[None, :] != host[:, None])
    oob = struct & (~center_ok | ~jnp.all(pat_ok & finite, axis=-1))
    usable = struct & ~oob

    energy = jnp.sum(jnp.where(pat_ok & finite, energy_k, 0.0), axis=-1)
    wJI2 = jnp.sum(hw * hw * (gx * gx + gy * gy)
                   * (pat_ok & finite).astype(dtype), axis=-1)
    th = jnp.maximum((oh @ state.frame_energy_th)[:, None],
                     state.frame_energy_th[None, :])
    outlier = usable & ((energy > th) | (wJI2 < 2.0))
    valid = usable & ~outlier

    vz = valid[..., None]
    return Linearization(
        res=jnp.where(vz, resF, 0.0),
        JIdx=jnp.where(vz[..., None], JIdx, 0.0),
        Jab=jnp.where(vz[..., None], Jab, 0.0),
        Jpdxi=jnp.where(vz[..., None], Jpdxi, 0.0),
        Jpdc=jnp.where(vz[..., None], Jpdc, 0.0),
        Jpdd=jnp.where(vz, Jpdd, 0.0),
        valid=valid, oob=oob,
        energy=jnp.where(usable, energy, 0.0))


class Assembled(NamedTuple):
    H: jax.Array      # [D, D] top system (without point Schur)
    b: jax.Array      # [D]
    Hdd: jax.Array    # [P] point idepth hessians (incl. prior)
    bd: jax.Array     # [P]
    V: jax.Array      # [P, D] point-camera cross blocks


@full_f32
def assemble(state: BAState, lin: Linearization,
             point_mask=None, residual_override=None) -> Assembled:
    """Accumulate the global system from a linearization.

    point_mask: restrict to a subset of points (used by marginalize_points).
    residual_override: replacement for lin.res (FEJ-recentered residuals).

    Structure (round-5): the pattern axis K is contracted FIRST into a
    per-(point, frame) 14x14 Gram block Q = q^T q with
    q = [Jrel(8) | Jcalib(4) | Jd(1) | res(1)] per pattern pixel; every
    output (frame/calib blocks, b, point-Schur vectors) is then a small
    bilinear transform of Q by the pair adjoints. Mathematically
    identical to contracting the full [P, F, K, ...] factors (bilinear
    forms distribute over the K-sum) but the big tensors are read once:
    ~25 MB/iteration of [P,F,K,8]-shaped intermediates become one
    [P,F,14,14] block tensor.
    """
    P, F = lin.valid.shape
    D = state.dim
    dtype = lin.res.dtype
    res = lin.res if residual_override is None else residual_override
    if point_mask is not None:
        pm = point_mask[:, None]
        res = jnp.where(pm[..., None], res, 0.0)
        vmask = lin.valid & pm
    else:
        vmask = lin.valid

    AH, AT = pair_adjoints(state)
    host = state.p_host
    oh = jax.nn.one_hot(host, F, dtype=dtype)      # [P, F_h]

    # per-pixel factor q = [Jrel(8) | Jcalib(4) | Jd(1) | res(1)]
    Jrel_pose = jnp.einsum("pfkg,pfgx->pfkx", lin.JIdx, lin.Jpdxi)
    calib4 = jnp.einsum("pfkg,pfgc->pfkc", lin.JIdx, lin.Jpdc)
    Jd = jnp.einsum("pfkg,pfg->pfk", lin.JIdx, lin.Jpdd)
    q = jnp.concatenate([Jrel_pose, lin.Jab, calib4,
                         Jd[..., None], res[..., None]], axis=-1)
    q = q * vmask[:, :, None, None].astype(dtype)
    Q = jnp.einsum("pfka,pfkb->pfab", q, q)        # [P, F, 14, 14]

    J, C, d, r = slice(0, 8), slice(8, 12), 12, 13

    # ---- host-grouped pair blocks (round-5): the adjoint transform of a
    # residual's Gram block depends only on its (host, target) pair, so
    # sum blocks into QH[h, f] FIRST (one reduction over the point axis)
    # and apply AH/AT on the tiny [F, F, 14, 14] result. This replaces
    # six [P, F, 8, 8]-shaped einsums + two adjoint-select tensors
    # (~200 MB of memory traffic per GN iteration) with one reduction and
    # small [F, F] algebra — the stitch loop of
    # AccumulatedTopHessianSSE::stitchDouble at grouped granularity.
    QH = jnp.einsum("pfab,ph->hfab", Q, oh)        # [F_h, F_t, 14, 14]
    GJJ = QH[..., J, J]
    GCJ = QH[..., C, J]
    GJr = QH[..., J, r]

    # frame-frame blocks [F, F, 8, 8]
    Hff = jnp.zeros((F, F, 8, 8), dtype)
    H_hh = jnp.einsum("hfxa,hfxy,hfyb->hab", AH, GJJ, AH)
    H_tt = jnp.einsum("hfxa,hfxy,hfyb->fab", AT, GJJ, AT)
    H_ht = jnp.einsum("hfxa,hfxy,hfyb->hfab", AH, GJJ, AT)
    diag = jnp.arange(F)
    Hff = Hff.at[diag, diag].add(H_hh + H_tt)
    Hff = Hff + H_ht + jnp.swapaxes(H_ht, 0, 1).transpose(0, 1, 3, 2)

    # calib blocks
    H_cc = jnp.einsum("hfab->ab", QH[..., C, C])
    H_ch = jnp.einsum("hfax,hfxb->hab", GCJ, AH)   # [F, 4, 8]
    H_ct = jnp.einsum("hfax,hfxb->fab", GCJ, AT)
    H_cf = H_ch + H_ct

    # b
    b_c = jnp.einsum("hfa->a", QH[..., C, r])
    b_h = jnp.einsum("hfx,hfxa->ha", GJr, AH)
    b_t = jnp.einsum("hfx,hfxa->fa", GJr, AT)
    b_f = b_h + b_t

    H = jnp.zeros((D, D), dtype)
    H = H.at[:CPARS, :CPARS].set(H_cc)
    H = H.at[:CPARS, CPARS:].set(
        H_cf.transpose(1, 0, 2).reshape(CPARS, 8 * F))
    H = H.at[CPARS:, :CPARS].set(
        H_cf.transpose(1, 0, 2).reshape(CPARS, 8 * F).T)
    H = H.at[CPARS:, CPARS:].set(
        Hff.transpose(0, 2, 1, 3).reshape(8 * F, 8 * F))
    b = jnp.concatenate([b_c, b_f.reshape(8 * F)])

    # ---- point Schur pieces (per point; adjoints folded via one-hot)
    QJd = Q[..., J, d]
    Hdd = jnp.sum(Q[..., d, d], axis=1)
    bd = jnp.sum(Q[..., d, r], axis=1)
    V_c = jnp.einsum("pfa->pa", Q[..., C, d])
    V_h = jnp.einsum("pfx,ph,hfxa->pa", QJd, oh, AH)   # host col per point
    V_t = jnp.einsum("pfx,ph,hfxa->pfa", QJd, oh, AT)  # [P, F, 8]
    V_f = V_t + V_h[:, None, :] * oh[:, :, None]
    V = jnp.concatenate([V_c, V_f.reshape(P, 8 * F)], axis=-1)

    # point idepth prior (EFPoint::priorF)
    dF = state.p_idepth - state.p_idepth_zero
    Hdd = Hdd + state.p_prior
    bd = bd + state.p_prior * dF
    return Assembled(H, b, Hdd, bd, V)


def stitched_delta(state: BAState):
    """[c_delta | per-frame deltas] (getStitchedDeltaF)."""
    return jnp.concatenate([state.c_delta, state.delta.reshape(-1)])


def nullspaces(state: BAState):
    """Gauge nullspace matrix N [D, 7]: 6 global rigid motions + scale
    (lastNullspaces_pose/scale; computed analytically instead of DSO's
    finite differencing). Columns are zero on calib/affine rows."""
    F = state.num_frames
    D = state.dim
    T = state.current_poses()

    def per_frame(R, t, valid):
        A = SE3(R, t).adjoint()            # worldToCam adjoint
        pose_cols = -A                     # [6, 6]: d delta / d global g
        scale_col = jnp.concatenate([t, jnp.zeros(3, t.dtype)])
        cols = jnp.concatenate([pose_cols, scale_col[:, None]], axis=1)  # 6x7
        return jnp.where(valid, cols, 0.0)

    cols = jax.vmap(per_frame)(T.R, T.t, state.frame_valid)   # [F, 6, 7]
    N = jnp.zeros((D, 7), state.delta.dtype)
    for f in range(F):
        N = N.at[CPARS + 8 * f: CPARS + 8 * f + 6, :].set(cols[f])
    norms = jnp.linalg.norm(N, axis=0)
    return N / jnp.maximum(norms, 1e-12)[None, :]


def orthogonalize(x, N):
    """Project x off span(N) (EnergyFunctional::orthogonalize).

    The reference forms the SVD pseudo-inverse with a relative singular-
    value cutoff; the columns of N here are unit-normalized (see
    ``nullspaces``) and at most rank-deficient by degenerate window
    geometry, so the equivalent Gram-matrix projection
    x - N (N^T N + eps I)^-1 N^T x (a 7x7 Cholesky) is used instead of an
    SVD per GN iteration. eps plays the reference's cutoff role:
    near-zero modes of N contribute ~0 to the projector instead of
    blowing up."""
    G = N.T @ N + 1e-10 * jnp.eye(N.shape[1], dtype=x.dtype)
    c = jax.scipy.linalg.cho_factor(G)
    return x - N @ jax.scipy.linalg.cho_solve(c, N.T @ x)


class SolveResult(NamedTuple):
    x: jax.Array          # [D] solution of H x = b (frame step = -x)
    point_step: jax.Array  # [P] idepth steps
    H_final: jax.Array
    b_final: jax.Array


@full_f32
def solve_delta(state: BAState, asm: Assembled, lam: float = 1e-5,
                use_orth: bool = True, axis_name: str | None = None
                ) -> SolveResult:
    """Damped Schur solve of the assembled system + marginalization prior +
    frame/calib priors; back-substitute point idepth steps.
    (solveSystemF + resubstituteF, with the FIX_LAMBDA default.)

    axis_name: when running under shard_map with the POINT axis sharded,
    the per-shard partial H/b/Schur terms are psum-reduced over this mesh
    axis (the distributed reduction of SURVEY §2.5/§7: each shard owns a
    block of points; the reduced [4+8F] camera system rides the ICI
    collectives while the solve itself is replicated). Frame state and
    priors must be replicated across the axis.
    """
    D = state.dim
    F = state.num_frames
    dtype = asm.H.dtype

    # reduce the point-partial top system across shards
    H = asm.H
    b = asm.b
    if axis_name is not None:
        H = jax.lax.psum(H, axis_name)
        b = jax.lax.psum(b, axis_name)
    c_prior = jnp.full((CPARS,), 5e9, dtype) * jnp.asarray(
        state.c_zero > 0, dtype)  # calib prior (setting_initialCalibHessian)
    H = H + jnp.diag(jnp.concatenate([c_prior, jnp.zeros(8 * F, dtype)]))
    b = b.at[:CPARS].add(c_prior * state.c_delta)

    fp = state.frame_prior * state.frame_valid[:, None].astype(dtype)
    H = H + jnp.diag(jnp.concatenate([jnp.zeros(CPARS, dtype),
                                      fp.reshape(-1)]))
    dp = state.delta - state.frame_prior_delta0
    b = b.at[CPARS:].add((fp * dp).reshape(-1))

    # marginalization prior with FEJ delta (bM_top = bM + HM*delta)
    H = H + state.HM
    b = b + state.bM + state.HM @ stitched_delta(state)

    # damping + Schur complement
    active_pt = (state.p_status == PT_ACTIVE) & (asm.Hdd > 1e-10)
    Hdd_l = jnp.where(active_pt, asm.Hdd * (1.0 + lam), 1.0)
    Vw = asm.V * (active_pt.astype(dtype) / Hdd_l)[:, None]
    H_sc = Vw.T @ asm.V
    b_sc = Vw.T @ asm.bd
    if axis_name is not None:
        H_sc = jax.lax.psum(H_sc, axis_name)
        b_sc = jax.lax.psum(b_sc, axis_name)

    H_f = H + lam * jnp.diag(jnp.diagonal(H)) - H_sc
    b_f = b - b_sc

    # inactive frame slots + fixed-affine guards: identity rows
    slot_active = jnp.concatenate([
        jnp.ones(CPARS, bool),
        jnp.repeat(state.frame_valid, 8)])
    diag_ok = jnp.abs(jnp.diagonal(H_f)) > 1e-10
    act = slot_active & diag_ok
    H_f = jnp.where(act[:, None] & act[None, :], H_f, 0.0)
    H_f = H_f + jnp.diag(jnp.where(act, 0.0, 1.0))

    # scaled solve (SVecI preconditioning, EnergyFunctional.cpp:888-893).
    # The reference LDLT-solves the scaled system. LU with partial
    # pivoting (jnp.linalg.solve) rather than Cholesky: near the bootstrap
    # the reduced system (Schur complement minus priors of up to 1e10) is
    # only positive semi-definite up to float32 rounding, and a scaled
    # diagonal can round marginally negative. Cholesky then takes the
    # square root of a negative pivot and returns NaN, which poisons every
    # later keyframe; LU needs no definiteness and returns finite steps
    # for any non-singular system.
    svec_i = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(H_f)) + 10.0)
    Hs = H_f * svec_i[:, None] * svec_i[None, :]
    bs = b_f * svec_i
    x = svec_i * jnp.linalg.solve(Hs + 1e-10 * jnp.eye(D, dtype=dtype), bs)
    x = jnp.where(act, x, 0.0)

    # gauge projection; use_orth may be a traced bool (ORTHOGONALIZE_X_LATER
    # turns it on from iteration 2) — N is [D, 7], negligible.
    N = nullspaces(state)
    x = jnp.where(jnp.asarray(use_orth), orthogonalize(x, N), x)

    # back-substitution: delta_d = (V.x - bd)/Hdd_lambda
    step_d = jnp.where(active_pt, (asm.V @ x - asm.bd) / Hdd_l, 0.0)
    return SolveResult(x=x, point_step=step_d, H_final=H_f, b_final=b_f)


def apply_step(state: BAState, sol: SolveResult,
               step_scale: float = 1.0) -> BAState:
    """Frame/calib/point updates: frame step = -x (H x = b with b = J^T r).
    Idepth steps clamped to keep idepth positive."""
    F = state.num_frames
    xc = -sol.x[:CPARS] * step_scale
    xf = -sol.x[CPARS:].reshape(F, 8) * step_scale
    new_delta = state.delta + xf * state.frame_valid[:, None].astype(xf.dtype)
    new_cdelta = state.c_delta + xc
    new_idepth = state.p_idepth + sol.point_step * step_scale
    new_idepth = jnp.maximum(new_idepth, 1e-5)
    return state._replace(delta=new_delta, c_delta=new_cdelta,
                          p_idepth=new_idepth)


@partial(jax.jit, static_argnames=("height", "width", "iterations",
                                   "orth_from_iteration",
                                   "min_iterations", "break_tol",
                                   "final_linearize"))
def ba_iterate(state: BAState, target_images, height: int, width: int,
               iterations: int = 6, lam: float = 1e-5,
               huber_th: float = 9.0, outlier_th_sum: float = 2500.0,
               orth_from_iteration: int = 2,
               min_iterations: int = 1, break_tol: float = 0.0,
               final_linearize: bool = True):
    """Run GN iterations (setting_maxOptIterations=6 /
    setting_minOptIterations=1, settings.cpp:81-82; FIX_LAMBDA +
    forceAcceptStep — no step rejection in the reference's default solver
    mode). Returns (state, final_energy, lin).

    break_tol > 0 enables the driver-level early termination between
    min_iterations and iterations: stop when the relative energy
    improvement of an iteration falls below break_tol (the reference's
    external driver breaks its optimize loop the same way; with the
    default 0.0 the loop runs all `iterations`, preserving fixed-count
    comparisons).

    The iteration is a lax.while_loop so the (large) GN body compiles
    once; the late-start nullspace orthogonalization
    (ORTHOGONALIZE_X_LATER) becomes a traced select on the iteration
    index.

    final_linearize=False skips the post-loop linearization pass and
    returns (state, last pre-step energy, None). The reference's
    6-iteration budget (settings.cpp:81) is 6 linearize+solve passes —
    residual bookkeeping after the loop reuses the LAST iteration's
    cached jacobians (applyRes, Residuals.cpp:298-320) rather than
    relinearizing — so callers that do their own point management
    (and the production-shape benchmark) use False and call
    ``linearize`` themselves only when they need post-step residuals.
    """
    def gn(it, st):
        lin = linearize(st, target_images, height, width,
                        huber_th=huber_th, outlier_th_sum=outlier_th_sum)
        asm = assemble(st, lin)
        sol = solve_delta(st, asm, lam=lam,
                          use_orth=(it >= orth_from_iteration))
        e = jnp.sum(lin.energy)
        return apply_step(st, sol), e

    if break_tol <= 0.0:
        def body(it, carry):
            st, _ = carry
            st, e = gn(it, st)
            return st, e
        state, e_last = jax.lax.fori_loop(
            0, iterations, body, (state, jnp.asarray(jnp.inf)))
    else:
        def cond(c):
            st, it, e_prev, done = c
            return (it < iterations) & ~done
        def body(c):
            st, it, e_prev, _ = c
            st, e = gn(it, st)
            rel = jnp.abs(e_prev - e) / jnp.maximum(e_prev, 1e-12)
            done = (it + 1 >= min_iterations) & (rel < break_tol) \
                & jnp.isfinite(e)
            return (st, it + 1, e, done)
        state, _, e_last, _ = jax.lax.while_loop(
            cond, body, (state, jnp.asarray(0), jnp.asarray(jnp.inf),
                         jnp.asarray(False)))

    if not final_linearize:
        return state, e_last, None
    lin = linearize(state, target_images, height, width, huber_th=huber_th,
                    outlier_th_sum=outlier_th_sum)
    energy = jnp.sum(lin.energy)
    return state, energy, lin


@full_f32
def fej_recentered_residuals(state: BAState, lin: Linearization):
    """res_toZero = resF - JI.(Jp*delta) - Jab.delta_ab — transport residuals
    to the FEJ point for marginalization (EFResidual::fixLinearizationF)."""
    F = state.num_frames
    AH, AT = pair_adjoints(state)
    host = state.p_host
    oh = jax.nn.one_hot(host, F, dtype=state.delta.dtype)
    dh = oh @ state.delta            # [P, 8]
    AH_p = _host_select(oh, AH)
    AT_p = _host_select(oh, AT)
    # dp = delta_h^T AH + delta_t^T AT  (adHTdeltaF)
    dp = jnp.einsum("px,pfxy->pfy", dh, AH_p) \
        + jnp.einsum("fx,pfxy->pfy", state.delta, AT_p)
    dd = (state.p_idepth - state.p_idepth_zero)[:, None]
    Jp_delta = jnp.einsum("pfgx,pfx->pfg", lin.Jpdxi, dp[..., :6]) \
        + jnp.einsum("pfgc,c->pfg", lin.Jpdc, state.c_delta) \
        + lin.Jpdd * dd[..., None]
    corr = jnp.einsum("pfkg,pfg->pfk", lin.JIdx, Jp_delta) \
        + lin.Jab[..., 0] * dp[..., None, 6] \
        + lin.Jab[..., 1] * dp[..., None, 7]
    return lin.res - corr


@full_f32
def marginalize_points(state: BAState, lin: Linearization,
                       marg_weight: float = 0.25,
                       idepth_prior_marg_fac: float = 360000.0,
                       axis_name: str | None = None) -> BAState:
    """Schur-marginalize all PT_MARGINALIZE points into HM/bM
    (marginalizePointsF): HM += w*(M - Msc) with FEJ-recentered residuals;
    afterwards the slots are freed."""
    marg = state.p_status == PT_MARGINALIZE
    res0 = fej_recentered_residuals(state, lin)
    # priorF *= idepthFixPriorMargFac for marginalized points (ref :630)
    state_m = state._replace(p_prior=jnp.where(
        marg, state.p_prior * idepth_prior_marg_fac, state.p_prior))
    asm = assemble(state_m, lin, point_mask=marg, residual_override=res0)
    ok = marg & (asm.Hdd > 1e-10)
    Hdd_i = jnp.where(ok, 1.0 / jnp.where(ok, asm.Hdd, 1.0), 0.0)
    Vw = asm.V * Hdd_i[:, None]
    M_sc = Vw.T @ asm.V
    b_sc = Vw.T @ asm.bd
    H_top, b_top = asm.H, asm.b
    if axis_name is not None:
        # single deterministic reduce keeps HM/bM identical on all shards
        # (SURVEY §5 marginalization-consistency requirement)
        H_top = jax.lax.psum(H_top, axis_name)
        b_top = jax.lax.psum(b_top, axis_name)
        M_sc = jax.lax.psum(M_sc, axis_name)
        b_sc = jax.lax.psum(b_sc, axis_name)
    HM = state.HM + marg_weight * (H_top - M_sc)
    bM = state.bM + marg_weight * (b_top - b_sc)
    HM = 0.5 * (HM + HM.T)
    new_status = jnp.where(marg, 0, state.p_status)
    new_ract = state.r_active & ~marg[:, None]
    return state._replace(HM=HM, bM=bM, p_status=new_status,
                          r_active=new_ract)


@full_f32
def marginalize_frame(state: BAState, slot: int) -> BAState:
    """Schur-eliminate a frame slot from HM/bM (marginalizeFrame): add the
    frame's prior, scale-stabilized 8x8 inversion, in-place elimination, then
    zero the slot. The caller must have marginalized/dropped the frame's
    points first (the reference asserts the same)."""
    D = state.dim
    dtype = state.HM.dtype
    i0 = CPARS + 8 * slot
    idx = jnp.arange(D)
    in_blk = (idx >= i0) & (idx < i0 + 8)

    HM = state.HM
    bM = state.bM
    # add the frame prior at its anchor
    pr = state.frame_prior[slot]
    dpr = state.delta[slot] - state.frame_prior_delta0[slot]
    HM = HM.at[i0:i0 + 8, i0:i0 + 8].add(jnp.diag(pr))
    bM = bM.at[i0:i0 + 8].add(pr * dpr)

    svec = jnp.sqrt(jnp.abs(jnp.diagonal(HM)) + 10.0)
    svec_i = 1.0 / svec
    Hs = HM * svec_i[:, None] * svec_i[None, :]
    bs = bM * svec_i

    Hbb = Hs[i0:i0 + 8, i0:i0 + 8]
    Hbb = 0.5 * (Hbb + Hbb.T)
    Hbb_inv = jnp.linalg.inv(Hbb + 1e-8 * jnp.eye(8, dtype=dtype))
    Hxb = Hs[:, i0:i0 + 8]
    Hs_new = Hs - Hxb @ Hbb_inv @ Hxb.T
    bs_new = bs - Hxb @ (Hbb_inv @ bs[i0:i0 + 8])

    HM_new = Hs_new * svec[:, None] * svec[None, :]
    bM_new = bs_new * svec
    # zero the eliminated slot rows/cols
    keep = ~in_blk
    HM_new = jnp.where(keep[:, None] & keep[None, :], HM_new, 0.0)
    bM_new = jnp.where(keep, bM_new, 0.0)
    HM_new = 0.5 * (HM_new + HM_new.T)

    fv = state.frame_valid.at[slot].set(False)
    # drop residuals targeting the dead frame; re-host nothing (caller's job)
    ract = state.r_active.at[:, slot].set(False)
    return state._replace(HM=HM_new, bM=bM_new, frame_valid=fv,
                          r_active=ract)
