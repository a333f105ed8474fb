"""Immature-point depth tracing and activation.

Batched rewrite of DSO's ``ImmaturePoint`` (reference
src/tracking/ImmaturePoint.{h,cpp}): every candidate point carries an inverse
-depth interval [idepth_min, idepth_max]; each new frame

1. projects both interval endpoints, bounding the epipolar search segment
   (traceOn :149-226, capped at maxPixSearch = 0.027*(w+h)),
2. computes the expected localization error from the gradient structure
   tensor along/across the search direction (errorInPixel, :239-256),
3. runs a fixed-K discrete search along the segment with the host pattern
   rotated by the 2x2 of KRKi (:260-341; K = 100 steps, masked beyond the
   live count, best + best-outside-radius for the quality ratio :344-352),
4. refines with <=3 damped 1-D Gauss-Newton steps along the line (:355-417),
5. gates energy-based outliers and updates the idepth interval from the
   matched pixel +- errorInPixel (:420-466).

The per-point while-loops become masked fixed-shape tensor ops over
[N points x K steps x 8 pattern]; the status machine (IPS_*) is an int8
lattice updated with jnp.where.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.image import PATTERN_DSO8
from ..utils.interp import bilinear, bilinear_3
from ..utils.stats import huber_weight
from ..utils.precision import full_f32

# status codes (ImmaturePointStatus, ImmaturePoint.h:47-53)
IPS_UNINITIALIZED = 0
IPS_GOOD = 1
IPS_OOB = 2
IPS_OUTLIER = 3
IPS_SKIPPED = 4
IPS_BADCONDITION = 5

MAX_STEPS = 100


class ImmaturePoints(NamedTuple):
    """Fixed-capacity immature point set (host-frame pixels + idepth range)."""
    uv: jax.Array          # [N, 2]
    color: jax.Array       # [N, 8] pattern intensities in host
    weights: jax.Array     # [N, 8] gradient weights
    gradH: jax.Array       # [N, 2, 2] pattern gradient structure tensor
    idepth_min: jax.Array  # [N]
    idepth_max: jax.Array  # [N] (may be +inf before first trace)
    quality: jax.Array     # [N] best/second-best ratio
    status: jax.Array      # [N] int8 IPS_*
    mask: jax.Array        # [N] slot occupied


@full_f32
def make_immature(host_dI, uv, mask, outlier_th_sum: float = 2500.0,
                  idepth_init_min: float = 0.0,
                  idepth_init_max: float = jnp.inf):
    """Create immature points at pixels uv of the host image stack [H, W, 3]
    (ImmaturePoint ctor: pattern colors, gradient weights, gradH).

    The EDS variant that seeds from an external depth map (e.g. event-side
    depth filter or MiDaS, ImmaturePoint.cpp:68-114 — idepth +-10%) is
    available via per-point init arrays.
    """
    offs = jnp.asarray(PATTERN_DSO8, uv.dtype)
    xs = uv[:, 0:1] + offs[None, :, 0]
    ys = uv[:, 1:2] + offs[None, :, 1]
    hit = bilinear_3(host_dI, xs, ys)          # [N, 8, 3]
    color = hit[..., 0]
    g = hit[..., 1:3]
    weights = jnp.sqrt(outlier_th_sum
                       / (outlier_th_sum + jnp.sum(g * g, axis=-1)))
    gradH = jnp.einsum("nkg,nkh->ngh", g, g)
    n = uv.shape[0]
    imin = jnp.broadcast_to(jnp.asarray(idepth_init_min, uv.dtype), (n,))
    imax = jnp.broadcast_to(jnp.asarray(idepth_init_max, uv.dtype), (n,))
    return ImmaturePoints(
        uv=uv, color=color, weights=weights, gradH=gradH,
        idepth_min=imin, idepth_max=imax,
        quality=jnp.full((n,), 1e4, uv.dtype),
        status=jnp.full((n,), IPS_UNINITIALIZED, jnp.int8),
        mask=mask)


@partial(jax.jit, static_argnames=("width", "height"))
@full_f32
def trace_on(pts: ImmaturePoints, target_dI, KRKi, Kt, aff,
             width: int, height: int,
             huber_th: float = 9.0, energy_th: float = 1152.0,
             max_pix_search_frac: float = 0.027,
             slack_interval: float = 1.5,
             min_improvement_factor: float = 2.0,
             extra_slack: float = 1.2,
             gn_iterations: int = 3, gn_threshold: float = 0.1,
             test_radius: int = 2) -> ImmaturePoints:
    """One batched traceOn pass against a target frame.

    KRKi: [3,3] = K R K^-1 (host->target), Kt: [3] = K t, aff: [2] relative
    affine. energy_th = patternNum * setting_outlierTH (= 8*144).
    """
    N = pts.uv.shape[0]
    dtype = pts.uv.dtype
    max_pix_search = (width + height) * max_pix_search_frac

    was_oob = pts.status == IPS_OOB
    live = pts.mask & ~was_oob

    pr = jnp.concatenate([pts.uv, jnp.ones((N, 1), dtype)], -1) @ KRKi.T
    ptp_min = pr + Kt[None, :] * pts.idepth_min[:, None]
    uMin = ptp_min[:, 0] / ptp_min[:, 2]
    vMin = ptp_min[:, 1] / ptp_min[:, 2]
    inb = lambda x, y: (x > 4) & (y > 4) & (x < width - 5) & (y < height - 5)
    oob = ~inb(uMin, vMin)

    has_max = jnp.isfinite(pts.idepth_max)
    id_for_max = jnp.where(has_max, pts.idepth_max, 0.01)
    ptp_max = pr + Kt[None, :] * id_for_max[:, None]
    uMax0 = ptp_max[:, 0] / ptp_max[:, 2]
    vMax0 = ptp_max[:, 1] / ptp_max[:, 2]

    dist_f = jnp.sqrt((uMin - uMax0) ** 2 + (vMin - vMax0) ** 2)
    # infinite-range: direction only, length = maxPixSearch
    d_inv = 1.0 / jnp.maximum(dist_f, 1e-12)
    uMax_inf = uMin + max_pix_search * (uMax0 - uMin) * d_inv
    vMax_inf = vMin + max_pix_search * (vMax0 - vMin) * d_inv
    uMax = jnp.where(has_max, uMax0, uMax_inf)
    vMax = jnp.where(has_max, vMax0, vMax_inf)
    dist = jnp.where(has_max, dist_f, max_pix_search)
    oob = oob | ~inb(uMax, vMax)

    skipped = has_max & (dist_f < slack_interval) & ~oob

    # scale-change OOB (ptpMin z outside [0.75, 1.5]; :230)
    oob = oob | ~((pts.idepth_min < 0)
                  | ((ptp_min[:, 2] > 0.75) & (ptp_min[:, 2] < 1.5)))

    # error bound from the gradient structure tensor (:239-256)
    dxl = uMax - uMin
    dyl = vMax - vMin
    dvec = jnp.stack([dxl, dyl], -1)
    pvec = jnp.stack([dyl, -dxl], -1)
    a = jnp.einsum("ni,nij,nj->n", dvec, pts.gradH, dvec)
    b = jnp.einsum("ni,nij,nj->n", pvec, pts.gradH, pvec)
    error_px = 0.2 + 0.2 * (a + b) / jnp.maximum(a, 1e-10)
    bad_cond = (error_px * min_improvement_factor > dist) & has_max & ~oob \
        & ~skipped
    error_px = jnp.minimum(error_px, 10.0)

    # clamp to maxPixSearch, normalize direction
    dxn = dxl / jnp.maximum(dist, 1e-12)
    dyn = dyl / jnp.maximum(dist, 1e-12)
    over = dist > max_pix_search
    uMax = jnp.where(over, uMin + max_pix_search * dxn, uMax)
    vMax = jnp.where(over, vMin + max_pix_search * dyn, vMax)
    dist = jnp.minimum(dist, max_pix_search)
    n_steps = jnp.minimum((1.9999 + dist).astype(jnp.int32), MAX_STEPS - 1)

    # deterministic sub-pixel shift (:284)
    rand_shift = uMin * 1000.0 - jnp.floor(uMin * 1000.0)
    ptx0 = uMin - rand_shift * dxn
    pty0 = vMin - rand_shift * dyn

    Rplane = KRKi[:2, :2]
    pat = jnp.asarray(PATTERN_DSO8, dtype) @ Rplane.T   # [8, 2] rotated

    steps = jnp.arange(MAX_STEPS, dtype=dtype)
    sx = ptx0[:, None] + steps[None, :] * dxn[:, None]   # [N, K]
    sy = pty0[:, None] + steps[None, :] * dyn[:, None]
    px = sx[:, :, None] + pat[None, None, :, 0]          # [N, K, 8]
    py = sy[:, :, None] + pat[None, None, :, 1]
    hit = bilinear(target_dI[..., 0], px, py)
    residual = hit - (aff[0] * pts.color[:, None, :] + aff[1])
    hw = huber_weight(residual, huber_th)
    e_k = jnp.where(jnp.isfinite(hit), hw * residual * residual * (2 - hw),
                    1e5)
    energies = jnp.sum(e_k, axis=-1)                     # [N, K]
    step_live = steps[None, :] < n_steps[:, None].astype(dtype)
    energies = jnp.where(step_live, energies, 1e10)

    best_idx = jnp.argmin(energies, axis=-1)
    best_e = jnp.min(energies, axis=-1)
    bestU = ptx0 + best_idx.astype(dtype) * dxn
    bestV = pty0 + best_idx.astype(dtype) * dyn

    # second best outside +-test_radius
    far = jnp.abs(jnp.arange(MAX_STEPS)[None, :] - best_idx[:, None]) \
        > test_radius
    second = jnp.min(jnp.where(far, energies, 1e10), axis=-1)
    new_q = second / jnp.maximum(best_e, 1e-10)
    quality = jnp.where((new_q < pts.quality) | (n_steps > 10), new_q,
                        pts.quality)

    # ---- 1-D GN refinement along the line (:355-417)
    def gn_energy_Hb(bu, bv):
        gx = bu[:, None] + pat[None, :, 0]
        gy = bv[:, None] + pat[None, :, 1]
        h3 = bilinear_3(target_dI, gx, gy)              # [N, 8, 3]
        r = h3[..., 0] - (aff[0] * pts.color + aff[1])
        dres = dxn[:, None] * h3[..., 1] + dyn[:, None] * h3[..., 2]
        hw = huber_weight(r, huber_th)
        fin = jnp.isfinite(h3[..., 0])
        Hs = 1.0 + jnp.sum(jnp.where(fin, hw * dres * dres, 0.0), -1)
        bs = jnp.sum(jnp.where(fin, hw * r * dres, 0.0), -1)
        e = jnp.sum(jnp.where(fin, pts.weights ** 2 * hw * r * r * (2 - hw),
                              1e5), -1)
        return e, Hs, bs

    bu, bv = bestU, bestV
    ubak, vbak = bestU, bestV
    e_best = jnp.full((N,), 1e5, dtype)
    step_back = jnp.zeros((N,), dtype)
    for _ in range(gn_iterations):
        e, Hs, bs = gn_energy_Hb(bu, bv)
        worse = e > e_best
        # back-step for worse, GN step for better (:379-414)
        sb_new = jnp.where(worse, step_back * 0.5,
                           jnp.clip(-bs / Hs, -0.5, 0.5))
        sb_new = jnp.where(jnp.isfinite(sb_new), sb_new, 0.0)
        bu_next = jnp.where(worse, ubak + sb_new * dxn, bu + sb_new * dxn)
        bv_next = jnp.where(worse, vbak + sb_new * dyn, bv + sb_new * dyn)
        ubak = jnp.where(worse, ubak, bu)
        vbak = jnp.where(worse, vbak, bv)
        e_best = jnp.where(worse, e_best, e)
        conv = jnp.abs(step_back) < gn_threshold
        bu = jnp.where(conv, bu, bu_next)
        bv = jnp.where(conv, bv, bv_next)
        step_back = jnp.where(conv, step_back, sb_new)

    outlier = ~(e_best < energy_th * extra_slack)

    # ---- idepth interval update from matched pixel +- errorInPixel (:442-452)
    horiz = dxn * dxn > dyn * dyn

    def idepth_of(coord, axis):
        pr_a = jnp.where(axis == 0, pr[:, 0], pr[:, 1])
        kt_a = jnp.where(axis == 0, Kt[0], Kt[1])
        return (pr[:, 2] * coord - pr_a) / (kt_a - Kt[2] * coord)

    lo_c = jnp.where(horiz, bu - error_px * dxn, bv - error_px * dyn)
    hi_c = jnp.where(horiz, bu + error_px * dxn, bv + error_px * dyn)
    ax = jnp.where(horiz, 0, 1)
    id_lo = idepth_of(lo_c, ax)
    id_hi = idepth_of(hi_c, ax)
    id_min_new = jnp.minimum(id_lo, id_hi)
    id_max_new = jnp.maximum(id_lo, id_hi)
    bad_interval = ~jnp.isfinite(id_min_new) | ~jnp.isfinite(id_max_new) \
        | (id_max_new < 0)

    # ---- status lattice
    good = live & ~oob & ~skipped & ~bad_cond & ~outlier & ~bad_interval
    status = pts.status.astype(jnp.int32)
    new_status = jnp.where(oob, IPS_OOB, status)
    new_status = jnp.where(~oob & skipped, IPS_SKIPPED, new_status)
    new_status = jnp.where(~oob & ~skipped & bad_cond, IPS_BADCONDITION,
                           new_status)
    # repeated outlier -> OOB (:434-437)
    out_now = ~oob & ~skipped & ~bad_cond & (outlier | bad_interval)
    new_status = jnp.where(out_now & (status == IPS_OUTLIER), IPS_OOB,
                           jnp.where(out_now, IPS_OUTLIER, new_status))
    new_status = jnp.where(good, IPS_GOOD, new_status)
    new_status = jnp.where(live, new_status, status).astype(jnp.int8)

    upd = lambda new, old: jnp.where(good, new, old)
    return pts._replace(
        idepth_min=upd(id_min_new, pts.idepth_min),
        idepth_max=upd(id_max_new, pts.idepth_max),
        quality=jnp.where(live & ~oob & ~skipped, quality, pts.quality),
        status=new_status)


@full_f32
def activate_idepth(pts: ImmaturePoints, target_dIs, KRKis, Kts, affs,
                    target_mask, gn_iterations: int = 3,
                    huber_th: float = 9.0):
    """Idepth-only GN for point activation (ImmaturePoint::linearizeResidual
    / optimizeImmaturePoint): start at the interval midpoint and refine
    against all valid window frames. Returns (idepth [N], energy [N]).

    target_dIs: [F, H, W, 3]; KRKis [F, 3, 3]; Kts [F, 3]; affs [F, 2];
    target_mask [F].
    """
    N = pts.uv.shape[0]
    F = target_dIs.shape[0]
    dtype = pts.uv.dtype
    pat = jnp.asarray(PATTERN_DSO8, dtype)
    idepth = 0.5 * (pts.idepth_min + jnp.where(jnp.isfinite(pts.idepth_max),
                                               pts.idepth_max,
                                               pts.idepth_min + 1.0))
    idepth = jnp.maximum(idepth, 1e-3)

    pr_all = jnp.einsum("fij,nj->nfi",
                        KRKis, jnp.concatenate(
                            [pts.uv, jnp.ones((N, 1), dtype)], -1))

    def energy_Hb(idp):
        ptp = pr_all + Kts[None, :, :] * idp[:, None, None]
        inv_z = 1.0 / jnp.maximum(ptp[..., 2], 1e-9)
        Ku = ptp[..., 0] * inv_z
        Kv = ptp[..., 1] * inv_z
        # d(Ku)/d idepth = (Kt_x - Kt_z*Ku)/z etc.
        dKu = (Kts[None, :, 0] - Kts[None, :, 2] * Ku) * inv_z
        dKv = (Kts[None, :, 1] - Kts[None, :, 2] * Kv) * inv_z
        px = Ku[:, :, None] + pat[None, None, :, 0]
        py = Kv[:, :, None] + pat[None, None, :, 1]

        def samp(img, x, y):
            return bilinear_3(img, x, y)

        hit = jax.vmap(samp, in_axes=(0, 1, 1), out_axes=1)(
            target_dIs, px, py)                # [N, F, 8, 3]
        r = hit[..., 0] - (affs[None, :, None, 0] * pts.color[:, None, :]
                           + affs[None, :, None, 1])
        dres = hit[..., 1] * dKu[..., None] + hit[..., 2] * dKv[..., None]
        hw = huber_weight(r, huber_th)
        H_, Wd = target_dIs.shape[1], target_dIs.shape[2]
        ok = (ptp[..., 2:3] > 1e-6) & (px > 1) & (py > 1) & (px < Wd - 2) \
            & (py < H_ - 2) & jnp.isfinite(hit[..., 0])
        ok = ok & target_mask[None, :, None] & pts.mask[:, None, None]
        w = jnp.where(ok, hw, 0.0)
        Hs = jnp.sum(w * dres * dres, axis=(1, 2)) + 1e-6
        bs = jnp.sum(w * r * dres, axis=(1, 2))
        e = jnp.sum(jnp.where(ok, hw * r * r * (2 - hw), 0.0), axis=(1, 2))
        return e, Hs, bs

    for _ in range(gn_iterations):
        e, Hs, bs = energy_Hb(idepth)
        idepth = jnp.maximum(idepth - bs / Hs, 1e-5)
    e, _, _ = energy_Hb(idepth)
    return idepth, e
