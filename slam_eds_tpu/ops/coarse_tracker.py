"""Coarse-to-fine direct image alignment (frame -> newest keyframe).

Array-based redesign of DSO's ``CoarseTracker`` (reference
src/tracking/CoarseTracker.{h,cpp}):
* semi-dense tracking templates from splatted active points with hole
  dilation and weighted pyramid-down (``makeCoarseDepthL0``,
  CoarseTracker.cpp:126-283),
* per-level residual evaluation with Huber weighting and cutoff saturation
  (``calcRes``, :349-498),
* the 8x8 (pose+affine) Gauss-Newton system (``calcGSSSE``, :287-344 — the
  SSE ``Accumulator9`` becomes one masked einsum),
* the per-level LM loop with lambda extrapolation and early abort
  (``trackNewestCoarse``, :520-701) as a ``lax.while_loop``.

State layout: templates are fixed-capacity per-level SoA arrays with validity
masks (the reference's ``pc_*`` buffers, but statically sized). The increment
convention matches DSO: tangent [trans, rot], pose update
``exp(inc) * refToNew``, affine update additive.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from ..utils.lie import SE3
from ..utils.cameras import Pinhole
from ..utils.interp import bilinear_3
from ..utils.stats import huber_weight
from ..utils.precision import full_f32


class LevelTemplate(NamedTuple):
    """Semi-dense template at one pyramid level (fixed capacity)."""
    u: jax.Array        # [N] pixel x
    v: jax.Array        # [N] pixel y
    idepth: jax.Array   # [N]
    color: jax.Array    # [N] reference intensity
    mask: jax.Array     # [N] bool


class TrackResult(NamedTuple):
    pose: SE3           # refToNew
    aff: jax.Array      # [2] (a, b)
    ok: jax.Array       # bool
    residuals: jax.Array       # [L] per-level final RMS residual
    flow_indicators: jax.Array  # [3] (shiftT, shiftR, shiftRT), finest level


def aff_from_to(exp_a, aff_a, exp_b, aff_b):
    """AffLight::fromToVecExposure: brightness transfer (a, b) such that
    I_b ~ a * I_a + b, given per-frame exposures and affine params
    (reference src/utils/NumType.h AffLight)."""
    a = jnp.exp(aff_b[0] - aff_a[0]) * (exp_b / exp_a)
    b = aff_b[1] - a * aff_a[1]
    return jnp.stack([a, b])


def _fill_holes(idepth, wsum, diagonal: bool):
    """One hole-dilation pass: empty pixels take the mean of their populated
    (diagonal or axis) neighbors (CoarseTracker.cpp:180-233)."""
    H, W = idepth.shape
    if diagonal:
        offs = [(-1, -1), (1, 1), (1, -1), (-1, 1)]
    else:
        offs = [(0, 1), (0, -1), (1, 0), (-1, 0)]

    def shift(a, dy, dx):
        return jnp.roll(a, (dy, dx), axis=(0, 1))

    num = jnp.zeros_like(idepth)
    sum_id = jnp.zeros_like(idepth)
    sum_w = jnp.zeros_like(wsum)
    for dy, dx in offs:
        nb_w = shift(wsum, dy, dx)
        nb_id = shift(idepth, dy, dx)
        has = (nb_w > 0).astype(idepth.dtype)
        num += has
        sum_id += jnp.where(nb_w > 0, nb_id, 0.0)
        sum_w += jnp.where(nb_w > 0, nb_w, 0.0)
    empty = wsum <= 0
    fill = (num > 0) & empty
    idepth = jnp.where(fill, sum_id / jnp.maximum(num, 1.0), idepth)
    wsum = jnp.where(fill, sum_w / jnp.maximum(num, 1.0), wsum)
    return idepth, wsum


def splat_idepth(uv, idepth, weight, mask, height: int, width: int):
    """Weighted scatter of active-point idepths into an L0 grid
    (CoarseTracker.cpp:132-149: nearest pixel += idepth*w / w)."""
    ix = jnp.clip((uv[:, 0] + 0.5).astype(jnp.int32), 0, width - 1)
    iy = jnp.clip((uv[:, 1] + 0.5).astype(jnp.int32), 0, height - 1)
    flat = iy * width + ix
    w = jnp.where(mask, weight, 0.0)
    idw = jax.ops.segment_sum(idepth * w, flat, num_segments=height * width)
    ws = jax.ops.segment_sum(w, flat, num_segments=height * width)
    return idw.reshape(height, width), ws.reshape(height, width)


def build_template(uv, idepth, weight, mask, kf_pyr: Sequence[jax.Array],
                   caps: Sequence[int]):
    """Build per-level templates (``makeCoarseDepthL0`` equivalent).

    uv/idepth/weight/mask: active points projected into the reference KF.
    kf_pyr: list of per-level [H, W, 3] reference-image stacks.
    caps: per-level template capacities.

    Returns list of LevelTemplate. Valid pixels are packed to capacity by
    top-k on a validity score (deterministic; overflow drops arbitrarily-late
    raster positions like the reference's linear scan drops none — caps are
    sized to exceed realistic point counts).
    """
    n_levels = len(kf_pyr)
    H0, W0 = kf_pyr[0].shape[:2]
    id_maps = []
    w_maps = []
    id0, w0 = splat_idepth(uv, idepth, weight, mask, H0, W0)
    id_maps.append(id0)
    w_maps.append(w0)
    for lvl in range(1, n_levels):
        prev_id, prev_w = id_maps[-1], w_maps[-1]
        Hl, Wl = kf_pyr[lvl].shape[:2]
        sid = prev_id[: 2 * Hl, : 2 * Wl].reshape(Hl, 2, Wl, 2).sum(axis=(1, 3))
        sw = prev_w[: 2 * Hl, : 2 * Wl].reshape(Hl, 2, Wl, 2).sum(axis=(1, 3))
        id_maps.append(sid)
        w_maps.append(sw)

    templates = []
    for lvl in range(n_levels):
        idm, wm = id_maps[lvl], w_maps[lvl]
        idm, wm = _fill_holes(idm, wm, diagonal=(lvl < 2))
        Hl, Wl = wm.shape
        ys, xs = jnp.meshgrid(jnp.arange(Hl), jnp.arange(Wl), indexing="ij")
        interior = (xs >= 2) & (xs < Wl - 2) & (ys >= 2) & (ys < Hl - 2)
        idn = jnp.where(wm > 0, idm / jnp.maximum(wm, 1e-12), -1.0)
        color = kf_pyr[lvl][..., 0]
        valid = (wm > 0) & interior & (idn > 0) & jnp.isfinite(color)
        score = jnp.where(valid, 1.0, -jnp.inf).ravel()
        cap = min(caps[lvl], Hl * Wl)
        vals, idx = jax.lax.top_k(score, cap)
        msk = jnp.isfinite(vals)
        templates.append(LevelTemplate(
            u=(idx % Wl).astype(jnp.float32),
            v=(idx // Wl).astype(jnp.float32),
            idepth=idn.ravel()[idx],
            color=color.ravel()[idx],
            mask=msk,
        ))
    return templates


def _warp(tpl: LevelTemplate, dI, cam: Pinhole, pose: SE3):
    """Project template pixels into the new frame. Returns per-point
    (u_n, v_n normalized coords, Ku, Kv pixels, new_idepth, valid)."""
    Ki_p = jnp.stack([(tpl.u - cam.cx) / cam.fx,
                      (tpl.v - cam.cy) / cam.fy,
                      jnp.ones_like(tpl.u)], axis=-1)
    pt = Ki_p @ pose.R.T + pose.t * tpl.idepth[:, None]
    u = pt[:, 0] / pt[:, 2]
    v = pt[:, 1] / pt[:, 2]
    Ku = cam.fx * u + cam.cx
    Kv = cam.fy * v + cam.cy
    new_id = tpl.idepth / pt[:, 2]
    H, W = dI.shape[:2]
    valid = (tpl.mask & (Ku > 2) & (Kv > 2) & (Ku < W - 3) & (Kv < H - 3)
             & (new_id > 0))
    return u, v, Ku, Kv, new_id, valid


def calc_res(tpl: LevelTemplate, dI, cam: Pinhole, pose: SE3, aff_rel,
             huber_th: float, cutoff_th):
    """Residual pass (``calcRes``): masked warp + bilinear sample + Huber
    energy with cutoff saturation. Returns (E, n_terms, saturated_frac,
    buffers) where buffers feed calc_gs.
    """
    u, v, Ku, Kv, new_id, valid = _warp(tpl, dI, cam, pose)
    hit = bilinear_3(dI, Ku, Kv)   # [N, 3] = (I, gx, gy)
    residual = hit[:, 0] - (aff_rel[0] * tpl.color + aff_rel[1])
    finite = jnp.isfinite(hit[:, 0])
    valid = valid & finite

    hw = huber_weight(residual, huber_th)
    saturated = jnp.abs(residual) > cutoff_th
    max_energy = 2.0 * huber_th * cutoff_th - huber_th * huber_th

    in_e = valid
    in_gn = valid & ~saturated
    E = jnp.sum(jnp.where(in_gn, hw * residual * residual * (2.0 - hw), 0.0)) \
        + jnp.sum(jnp.where(valid & saturated, max_energy, 0.0))
    n_terms = jnp.sum(in_e)
    n_sat = jnp.sum(valid & saturated)

    buffers = dict(u=u, v=v, idepth=new_id,
                   dx=hit[:, 1], dy=hit[:, 2],
                   residual=residual, weight=hw,
                   ref_color=tpl.color,
                   mask=in_gn)
    sat_frac = n_sat.astype(jnp.float32) / jnp.maximum(
        n_terms.astype(jnp.float32), 1.0)
    return E, n_terms, sat_frac, buffers


def flow_indicators(tpl: LevelTemplate, cam: Pinhole, pose: SE3):
    """Mean squared pixel shift under translation-only / full motion — DSO's
    KF-need statistics (CoarseTracker.cpp:404-435, sampled every 32nd point
    there; computed over all valid points here). Returns (shiftT, shiftRT)."""
    def proj(R, t_sign):
        Ki_p = jnp.stack([(tpl.u - cam.cx) / cam.fx,
                          (tpl.v - cam.cy) / cam.fy,
                          jnp.ones_like(tpl.u)], axis=-1)
        pt = Ki_p @ R.T + t_sign * pose.t * tpl.idepth[:, None]
        Ku = cam.fx * pt[:, 0] / pt[:, 2] + cam.cx
        Kv = cam.fy * pt[:, 1] / pt[:, 2] + cam.cy
        return Ku, Kv

    I3 = jnp.eye(3, dtype=pose.R.dtype)
    m = tpl.mask.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(m), 1.0)

    def mean_shift(R, t_sign):
        Ku, Kv = proj(R, t_sign)
        d2 = (Ku - tpl.u) ** 2 + (Kv - tpl.v) ** 2
        d2 = jnp.where(jnp.isfinite(d2), d2, 0.0)
        return jnp.sum(m * d2) / n

    shiftT = mean_shift(I3, 1.0) + mean_shift(I3, -1.0)
    # rotation-only indicator: the reference leaves flowVecs[1] at 0 (its
    # setting_maxShiftWeightR multiplies a hardcoded zero); we compute it so
    # the max_shift_weight_r knob is functional. Doubled to match the +/-
    # two-sample convention of the other two indicators.
    shiftR = 2.0 * mean_shift(pose.R, 0.0)
    shiftRT = mean_shift(pose.R, 1.0) + mean_shift(pose.R, -1.0)
    return shiftT, shiftR, shiftRT


def calc_gs(buffers, cam: Pinhole, aff_rel, b0_ref):
    """Build the 8x8 GN system from the residual buffers (``calcGSSSE``).

    Jacobian row per point (tangent order [trans(3), rot(3), a, b], matching
    exp(inc)*refToNew):
      [ id*dx, id*dy, -id*(u*dx + v*dy),
        -(u*v*dx + (1+v^2)*dy), (1+u^2)*dx + u*v*dy, u*dy - v*dx,
        a_rel*(b0 - refColor), -1 ]
    with dx, dy the image gradients scaled by fx, fy. H = J^T W J / n,
    b = J^T W r / n (the reference normalizes by the buffer count).
    """
    u = buffers["u"]
    v = buffers["v"]
    idp = buffers["idepth"]
    dx = buffers["dx"] * cam.fx
    dy = buffers["dy"] * cam.fy
    r = buffers["residual"]
    w = jnp.where(buffers["mask"], buffers["weight"], 0.0)

    J = jnp.stack([
        idp * dx,
        idp * dy,
        -idp * (u * dx + v * dy),
        -(u * v * dx + (1.0 + v * v) * dy),
        (1.0 + u * u) * dx + u * v * dy,
        u * dy - v * dx,
        aff_rel[0] * (b0_ref - buffers["ref_color"]),
        -jnp.ones_like(u),
    ], axis=-1)  # [N, 8]

    n = jnp.maximum(jnp.sum(buffers["mask"].astype(jnp.float32)), 1.0)
    Jw = J * w[:, None]
    H = (Jw.T @ J) / n
    b = (Jw.T @ r) / n
    return H, b


class _LevelCarry(NamedTuple):
    pose: SE3
    aff: jax.Array
    lam: jax.Array
    res_old: jax.Array   # (E, n)
    H: jax.Array
    b: jax.Array
    it: jax.Array
    done: jax.Array


@full_f32
def track_level(tpl: LevelTemplate, dI, cam: Pinhole, pose0: SE3, aff0,
                exposures, aff_ref, max_iterations: int, huber_th: float,
                cutoff_th: float, lambda_init: float = 0.01,
                lambda_extrap_limit: float = 0.001,
                fix_a: bool = False, fix_b: bool = False,
                scale_a: float = 1.0, scale_b: float = 1.0):
    """LM on one pyramid level. exposures = (exp_ref, exp_new);
    aff_ref = reference frame's (a, b). Returns (pose, aff, rms, sat_frac)."""
    exp_ref, exp_new = exposures
    b0_ref = aff_ref[1]

    def rel_aff(aff):
        return aff_from_to(exp_ref, aff_ref, exp_new, aff)

    # cutoff-repeat escalation: double the cutoff while >60% saturate
    # (CoarseTracker.cpp:550-557), bounded.
    def cutoff_cond(state):
        c, sat = state
        return (sat > 0.6) & (c < cutoff_th * 50.0)

    def cutoff_body(state):
        c, _ = state
        c = c * 2.0
        _, _, sat, _ = calc_res(tpl, dI, cam, pose0, rel_aff(aff0),
                                huber_th, c)
        return c, sat

    _, _, sat0, _ = calc_res(tpl, dI, cam, pose0, rel_aff(aff0), huber_th,
                             jnp.asarray(cutoff_th))
    cutoff, _ = jax.lax.while_loop(cutoff_cond, cutoff_body,
                                   (jnp.asarray(cutoff_th, jnp.float32), sat0))

    E0, n0, _, buf0 = calc_res(tpl, dI, cam, pose0, rel_aff(aff0), huber_th,
                               cutoff)
    H0, b0 = calc_gs(buf0, cam, rel_aff(aff0), b0_ref)

    def solve_inc(H, b, lam):
        # DSO damping: Hl(i,i) *= (1 + lambda)
        Hl = H + lam * jnp.diag(jnp.diagonal(H))
        # scaled a/b columns (SCALE_A/SCALE_B, all-ones for pose in EDS)
        S = jnp.array([1, 1, 1, 1, 1, 1, scale_a, scale_b], H.dtype)
        Hs = Hl * S[None, :] * S[:, None]
        bs = b * S
        if fix_a and fix_b:
            inc6 = jnp.linalg.solve(
                Hs[:6, :6] + 1e-12 * jnp.eye(6, dtype=H.dtype), -bs[:6])
            inc = jnp.concatenate([inc6, jnp.zeros(2, H.dtype)])
        else:
            inc = jnp.linalg.solve(Hs + 1e-12 * jnp.eye(8, dtype=H.dtype), -bs)
            if fix_a:
                inc = inc.at[6].set(0.0)
            if fix_b:
                inc = inc.at[7].set(0.0)
        return inc * S

    # visibility floor: a pose that warps (nearly) every template point
    # off-frame has a tiny term count, and its mean energy would look
    # spuriously good (observed: the LM diverging to |t|~1e5 poses that
    # "win" with 0 visible points — the reference avoids this because
    # 0/0 = nan rejects, but a small surviving handful still biases).
    n_tpl = jnp.sum(tpl.mask)
    n_floor = jnp.maximum(10, (0.2 * n_tpl.astype(jnp.float32))
                          ).astype(n_tpl.dtype)

    def mean_E(E, n):
        return jnp.where(n >= n_floor, E / jnp.maximum(n, 1), jnp.inf)

    def body(c: _LevelCarry):
        inc = solve_inc(c.H, c.b, c.lam)
        extrap = jnp.where(c.lam < lambda_extrap_limit,
                           jnp.sqrt(jnp.sqrt(lambda_extrap_limit / c.lam)),
                           1.0)
        inc = inc * extrap
        inc = jnp.where(jnp.isfinite(inc), inc, 0.0)
        pose_new = SE3.exp(inc[:6]).compose(c.pose)
        aff_new = c.aff + inc[6:8]
        E_new, n_new, _, buf = calc_res(tpl, dI, cam, pose_new,
                                        rel_aff(aff_new), huber_th, cutoff)
        accept = mean_E(E_new, n_new) \
            < mean_E(c.res_old[0], c.res_old[1].astype(n_new.dtype))
        H_new, b_new = calc_gs(buf, cam, rel_aff(aff_new), b0_ref)

        sel = lambda a, b_: jax.tree_util.tree_map(
            lambda x, y: jnp.where(accept, x, y), a, b_)
        pose = sel(pose_new, c.pose)
        aff = jnp.where(accept, aff_new, c.aff)
        H = jnp.where(accept, H_new, c.H)
        b = jnp.where(accept, b_new, c.b)
        res = jnp.where(accept, jnp.stack([E_new, n_new.astype(E_new.dtype)]),
                        c.res_old)
        lam = jnp.where(accept, c.lam * 0.5,
                        jnp.maximum(c.lam * 4.0, lambda_extrap_limit))
        done = jnp.linalg.norm(inc) <= 1e-3
        return _LevelCarry(pose, aff, lam, res, H, b, c.it + 1, done)

    def cond(c: _LevelCarry):
        return (c.it < max_iterations) & ~c.done

    init = _LevelCarry(pose0, aff0, jnp.asarray(lambda_init, jnp.float32),
                       jnp.stack([E0, n0.astype(E0.dtype)]), H0, b0,
                       jnp.asarray(0), jnp.asarray(False))
    out = jax.lax.while_loop(cond, body, init)
    rms = jnp.sqrt(out.res_old[0] / jnp.maximum(out.res_old[1], 1.0))
    _, n_fin, sat, _ = calc_res(tpl, dI, cam, out.pose, rel_aff(out.aff),
                                huber_th, cutoff)
    visible = n_fin >= n_floor
    return out.pose, out.aff, rms, sat, visible


@full_f32
def track_newest_coarse(templates: Sequence[LevelTemplate],
                        target_pyr: Sequence[jax.Array],
                        cams: Sequence[Pinhole],
                        pose_init: SE3, aff_init,
                        exposures, aff_ref,
                        min_res_for_abort,
                        max_iterations: Sequence[int],
                        huber_th: float = 9.0,
                        cutoff_th: float = 20.0,
                        n_levels: int | None = None):
    """Full coarse-to-fine tracking (``trackNewestCoarse``). Levels run
    coarsest -> finest (static Python loop, per-level static shapes); an
    abort at any level (residual > 1.5 * min_res_for_abort[lvl]) freezes the
    state and flags failure. Returns TrackResult.
    """
    n_levels = n_levels or len(templates)
    pose = pose_init
    aff = jnp.asarray(aff_init, jnp.float32)
    ok = jnp.asarray(True)
    per_level_rms = [jnp.asarray(0.0, jnp.float32)] * n_levels

    for lvl in range(n_levels - 1, -1, -1):
        p_new, a_new, rms, _, visible = track_level(
            templates[lvl], target_pyr[lvl], cams[lvl], pose, aff,
            exposures, aff_ref,
            max_iterations=max_iterations[min(lvl, len(max_iterations) - 1)],
            huber_th=huber_th, cutoff_th=cutoff_th)
        # freeze on earlier abort
        keep = ok
        pose = jax.tree_util.tree_map(
            lambda x, y: jnp.where(keep, x, y), p_new, pose)
        aff = jnp.where(keep, a_new, aff)
        per_level_rms[lvl] = jnp.where(keep, rms, per_level_rms[lvl])
        # a solve whose final pose sees (almost) no template points is a
        # failure no matter its residual (all-off-frame poses have
        # arbitrarily small energies)
        ok = ok & (rms <= 1.5 * min_res_for_abort[lvl]) & visible

    shiftT, shiftR, shiftRT = flow_indicators(templates[0], cams[0], pose)
    # affine sanity (CoarseTracker.cpp:685-698): the reference's mode>0
    # branch bounds the ABSOLUTE estimates; the relative-to-reference
    # bound (its mode==0 branch) additionally catches garbage frames whose
    # fit lands at a small absolute affine but a large relative one — keep
    # both (a diverged solve must not pass as ok)
    rel = aff_from_to(exposures[0], aff_ref, exposures[1], aff)
    ok = ok & (jnp.abs(aff[0]) < 1.2) & (jnp.abs(aff[1]) < 200.0) \
             & (jnp.abs(jnp.log(jnp.maximum(rel[0], 1e-12))) < 1.5) \
             & (jnp.abs(rel[1]) < 200.0)
    return TrackResult(pose=pose, aff=aff, ok=ok,
                       residuals=jnp.stack(per_level_rms),
                       flow_indicators=jnp.stack([shiftT, shiftR, shiftRT]))
