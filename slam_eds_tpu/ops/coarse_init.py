"""Monocular bootstrap: joint pose + per-point inverse-depth initializer.

Array-based redesign of DSO's ``CoarseInitializer`` (reference
src/init/CoarseInitializer.{h,cpp}): the pyramid-coarse-to-fine LM that
jointly estimates the relative 8-dof state (pose + affine) of the second
frame and one inverse depth per selected first-frame point, with

* per-level point selection at DSO's densities (setFirst,
  CoarseInitializer.cpp:688-772; densities {0.03,0.05,0.15,0.5,1}*w*h),
* a fixed-degree neighbor graph for idepth smoothing (makeNN's nanoflann
  10-NN, CoarseInitializer.cpp:884+ — here a host-side brute-force KNN,
  computed once),
* the Schur-complement GN step: 8x8 reduced camera system accumulated as
  einsums, per-point idepth back-substitution (calcResAndGS,
  CoarseInitializer.cpp:265+ and its JbBuffer),
* neighbor-median idepth regularization (optReg, regWeight 0.8),
* the translation-"snap" detection with alpha energies (alphaK=2.5^2,
  alphaW=150^2, CoarseInitializer.cpp:83-86,204-205): until the camera has
  translated enough, idepths are pulled to 1 and the translation is
  regularized; once snapped, idepths couple to their neighbor medians
  instead (couplingWeight=1),
* idepth propagation across levels (propagateUp/Down) via per-point parent
  indices into the next-coarser level.

The reference erases/flags points freely and loops over a pointer graph;
here every level is a fixed-capacity masked array and each LM iteration is
one batched linearize + two einsums + an 8x8 solve inside ``lax.fori_loop``.
"""
from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.lie import SE3
from ..utils import lie
from ..utils.interp import bilinear_3
from ..utils.image import PATTERN_DSO8
from ..utils.precision import full_f32

NUM_NN = 10
ALPHA_K = 2.5 * 2.5            # CoarseInitializer.cpp:204
ALPHA_W = 150.0 * 150.0        # :205
REG_WEIGHT = 0.8               # :83
COUPLING_WEIGHT = 1.0          # :86
SNAPPED_THRESHOLD = 5          # frames the solution must stay snapped (:261)


class InitLevel(NamedTuple):
    """Fixed-capacity point set of one pyramid level."""
    uv: jax.Array        # [P, 2] pixel coords at this level
    color: jax.Array     # [P, K] reference pattern colors
    idepth: jax.Array    # [P]
    iR: jax.Array        # [P] regularized idepth (neighbor median target)
    nn: jax.Array        # [P, NUM_NN] neighbor indices (self-padded)
    parent: jax.Array    # [P] index into the next-coarser level (-1 at top)
    mask: jax.Array      # [P]
    good: jax.Array      # [P] passed the last residual gate


class InitState(NamedTuple):
    levels: List[InitLevel]
    T_10: SE3            # current relative pose (frame1 <- frame0)
    aff: jax.Array       # [2] affine a, b
    snapped: jax.Array   # bool
    snapped_at: jax.Array  # frame counter when first snapped (-1)
    frame_id: jax.Array


def _select_level_points(img_l, density: float, cap: int, rng_seed: int):
    """Grid-max gradient selection at one level (the reference's
    makePixelStatus/gridMaxSelection for levels >=1; PixelSelector handles
    level 0 in the full pipeline — for the initializer the grid-max is a
    faithful, recursion-free stand-in at every level)."""
    H, W = img_l.shape[:2]
    g2 = np.asarray(jnp.sum(img_l[..., 1:3] ** 2, -1))
    n_target = max(16, int(density))
    # potential grid: pick cell size so that #cells ~ n_target
    pot = max(1, int(np.sqrt(H * W / n_target)))
    gh, gw = H // pot, W // pot
    g2c = g2[:gh * pot, :gw * pot].reshape(gh, pot, gw, pot)
    flat = g2c.transpose(0, 2, 1, 3).reshape(gh, gw, pot * pot)
    arg = flat.argmax(-1)
    best = flat.max(-1)
    ys = (np.arange(gh)[:, None] * pot + arg // pot)
    xs = (np.arange(gw)[None, :] * pot + arg % pot)
    thr = np.median(best) * 0.1
    keep = best > max(thr, 1e-8)
    uv = np.stack([xs[keep], ys[keep]], -1).astype(np.float32)
    # border margin
    m = (uv[:, 0] > 2) & (uv[:, 0] < W - 3) & (uv[:, 1] > 2) & (uv[:, 1] < H - 3)
    uv = uv[m]
    rng = np.random.default_rng(rng_seed)
    if len(uv) > cap:
        uv = uv[rng.choice(len(uv), cap, replace=False)]
    n = len(uv)
    pad = cap - n
    uv_full = np.concatenate([uv, np.zeros((pad, 2), np.float32)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return uv_full, mask


def _knn(uv, mask, k=NUM_NN):
    """Brute-force k-NN indices (self excluded; invalid -> own index)."""
    P = len(uv)
    d2 = ((uv[:, None, :] - uv[None, :, :]) ** 2).sum(-1)
    d2[~mask] = np.inf
    d2[:, ~mask] = np.inf
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    own = np.arange(P)[:, None]
    valid = np.take_along_axis(d2, idx, 1) < np.inf
    idx = np.where(valid, idx, own)
    return idx.astype(np.int32)


def _parents(uv_fine, mask_fine, uv_coarse, mask_coarse):
    """Nearest coarser-level point for idepth propagation (propagateUp/Down
    traverse DSO's parent pointers; same content)."""
    d2 = (((uv_fine[:, None, :] * 0.5) - uv_coarse[None, :, :]) ** 2).sum(-1)
    d2[:, ~mask_coarse] = np.inf
    p = d2.argmin(1).astype(np.int32)
    p[~mask_fine] = -1
    return p


def set_first(pyr_ref, caps: List[int] | None = None,
              densities: List[float] | None = None,
              seed: int = 3141592) -> InitState:
    """Select points on the first frame at every level and build the
    neighbor/parent graphs (CoarseInitializer::setFirst + makeNN)."""
    n_levels = len(pyr_ref)
    H, W = pyr_ref[0].shape[:2]
    base = [0.03, 0.05, 0.15, 0.5, 1.0]          # CoarseInitializer.cpp:699
    # reference: densities[l]*w0*h0 selected at each level; clamp by the
    # level's own pixel count (coarse levels are tiny)
    densities = densities or [
        min(base[min(l, 4)] * W * H, ((W >> l) * (H >> l)) * 0.25)
        for l in range(n_levels)]
    caps = caps or [max(64, int(1.5 * d)) for d in densities]

    offs = np.asarray(PATTERN_DSO8, np.float32)
    levels = []
    sel = []
    for l in range(n_levels):
        uv, mask = _select_level_points(pyr_ref[l], densities[l], caps[l],
                                        seed + l)
        sel.append((uv, mask))
    for l in range(n_levels):
        uv, mask = sel[l]
        col = bilinear_3(pyr_ref[l],
                         jnp.asarray(uv[:, 0:1] + offs[None, :, 0]),
                         jnp.asarray(uv[:, 1:2] + offs[None, :, 1]))[..., 0]
        nn = _knn(uv, mask)
        if l + 1 < n_levels:
            parent = _parents(uv, mask, *sel[l + 1])
        else:
            parent = np.full(len(uv), -1, np.int32)
        levels.append(InitLevel(
            uv=jnp.asarray(uv), color=jnp.asarray(col),
            idepth=jnp.ones(len(uv), jnp.float32),
            iR=jnp.ones(len(uv), jnp.float32),
            nn=jnp.asarray(nn), parent=jnp.asarray(parent),
            mask=jnp.asarray(mask), good=jnp.asarray(mask)))
    return InitState(levels=levels, T_10=SE3.identity(),
                     aff=jnp.zeros(2, jnp.float32),
                     snapped=jnp.asarray(False),
                     snapped_at=jnp.asarray(-1),
                     frame_id=jnp.asarray(0))


def _neighbor_median(idepth, good, nn):
    """iR update: median over each point's (valid) neighbors blended with
    regWeight (optReg, CoarseInitializer.cpp)."""
    vals = idepth[nn]                                    # [P, K]
    okn = good[nn]
    big = jnp.where(okn, vals, jnp.inf)
    srt = jnp.sort(big, axis=1)
    cnt = jnp.sum(okn, axis=1)
    mid = jnp.clip((cnt - 1) // 2, 0, NUM_NN - 1)
    med = jnp.take_along_axis(srt, mid[:, None], axis=1)[:, 0]
    med = jnp.where(cnt > 0, med, idepth)
    return jnp.where(jnp.isfinite(med), med, idepth)


@partial(jax.jit, static_argnames=("iterations", "height", "width"))
@full_f32
def _track_level(lvl: InitLevel, img_new, K4, T_10: SE3, aff, snapped,
                 height: int, width: int, iterations: int = 30,
                 huber_th: float = 9.0, lam0: float = 0.1):
    """LM on one level: returns (lvl', T_10', aff', stats). The 8-dof system
    is Schur-reduced over per-point idepths every iteration
    (calcResAndGS + doStep structure, fully batched)."""
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    offs = jnp.asarray(PATTERN_DSO8, jnp.float32)
    Kk = offs.shape[0]
    P = lvl.uv.shape[0]
    maskf = lvl.mask

    alpha_w = jnp.float32(ALPHA_W)
    npts = jnp.maximum(jnp.sum(maskf), 1.0)

    def linearize(T: SE3, ab, idepth, iR):
        # pattern points in ref cam coords (z=1 plane * 1/idepth)
        u = (lvl.uv[:, 0:1] + offs[None, :, 0] - cx) / fx     # [P, K]
        v = (lvl.uv[:, 1:2] + offs[None, :, 1] - cy) / fy
        idp = idepth[:, None]
        # X = [u, v, 1] / idp ; warp: R X + t = (R [u,v,1] + t*idp) / idp
        Ru = T.R[0, 0] * u + T.R[0, 1] * v + T.R[0, 2]
        Rv = T.R[1, 0] * u + T.R[1, 1] * v + T.R[1, 2]
        Rw = T.R[2, 0] * u + T.R[2, 1] * v + T.R[2, 2]
        pu = Ru + T.t[0] * idp
        pv = Rv + T.t[1] * idp
        pw = Rw + T.t[2] * idp
        new_idp = idp / jnp.maximum(pw, 1e-12)
        un = pu / jnp.maximum(pw, 1e-12)
        vn = pv / jnp.maximum(pw, 1e-12)
        Ku = fx * un + cx
        Kv = fy * vn + cy
        inb = (Ku > 1.0) & (Ku < width - 2.0) & (Kv > 1.0) \
            & (Kv < height - 2.0) & (pw > 1e-6)
        hit = bilinear_3(img_new, Ku, Kv)
        Inew = hit[..., 0]
        gx = hit[..., 1] * fx
        gy = hit[..., 2] * fy
        r2ref = jnp.exp(ab[0]) * lvl.color + ab[1]
        res = Inew - r2ref
        ok = inb & jnp.isfinite(res) & maskf[:, None]
        hw = jnp.where(jnp.abs(res) < huber_th, 1.0,
                       huber_th / jnp.maximum(jnp.abs(res), 1e-12))
        energy = jnp.sum(jnp.where(ok, hw * res * res * (2.0 - hw), 0.0))

        iz = 1.0 / jnp.maximum(pw, 1e-12)
        # d(un, vn)/d xi (twist at identity on the warped point), affine rows
        J = jnp.stack([
            gx * iz * idp,                                    # tx
            gy * iz * idp,                                    # ty
            -(gx * un + gy * vn) * iz * idp,                  # tz
            -(gx * un * vn + gy * (1 + vn * vn)),             # rx
            (gx * (1 + un * un) + gy * un * vn),              # ry
            (-gx * vn + gy * un),                             # rz
            -jnp.exp(ab[0]) * lvl.color,                      # d res/d a
            -jnp.ones_like(res),                              # d res/d b
        ], axis=-1)                                           # [P, K, 8]
        # d res / d idepth: through (un, vn) = f((R uvw + t d)/w)
        dun_dd = (T.t[0] - T.t[2] * un) * iz
        dvn_dd = (T.t[1] - T.t[2] * vn) * iz
        Jd = gx * dun_dd + gy * dvn_dd                        # [P, K]

        w = jnp.where(ok, hw, 0.0)
        return res, J, Jd, w, energy, ok, new_idp

    def reg_terms(idepth, iR, snapped_now):
        """Snap-phase prior (pull idepth to 1 + translation damping) vs the
        post-snap neighbor coupling."""
        alpha_opt = jnp.where(snapped_now, 0.0, alpha_w)
        cw = jnp.where(snapped_now, jnp.float32(COUPLING_WEIGHT), 0.0)
        Hdd_r = alpha_opt + cw
        bd_r = alpha_opt * (idepth - 1.0) + cw * (idepth - iR)
        return Hdd_r, bd_r

    class Carry(NamedTuple):
        T_R: jax.Array
        T_t: jax.Array
        ab: jax.Array
        idepth: jax.Array
        iR: jax.Array
        lam: jax.Array
        energy: jax.Array

    def energy_total(T, ab, idepth, iR, snapped_now):
        *_, e, ok, _ = linearize(T, ab, idepth, iR)
        alpha_opt = jnp.where(snapped_now, 0.0, alpha_w)
        cw = jnp.where(snapped_now, jnp.float32(COUPLING_WEIGHT), 0.0)
        e_reg = jnp.sum(jnp.where(maskf,
                                  alpha_opt * (idepth - 1.0) ** 2
                                  + cw * (idepth - iR) ** 2, 0.0))
        e_a = alpha_opt * npts * jnp.sum(T.t * T.t)
        return e + e_reg + e_a

    def body(_, c: Carry):
        T = SE3(c.T_R, c.T_t)
        res, J, Jd, w, _, ok, _ = linearize(T, c.ab, c.idepth, c.iR)
        snapped_now = snapped | (jnp.sum(T.t * T.t) * alpha_w > ALPHA_K)
        Hdd_r, bd_r = reg_terms(c.idepth, c.iR, snapped_now)

        Jw = J * w[..., None]
        H88 = jnp.einsum("pka,pkb->ab", Jw, J)
        b8 = jnp.einsum("pka,pk->a", Jw, res)
        # alpha translation damping on t rows
        alpha_opt = jnp.where(snapped_now, 0.0, alpha_w)
        H88 = H88 + jnp.diag(jnp.concatenate(
            [jnp.full(3, alpha_opt * npts), jnp.zeros(5)])).astype(H88.dtype)
        b8 = b8.at[:3].add(alpha_opt * npts * T.t)

        Hdd = jnp.einsum("pk,pk->p", Jd * w, Jd) + Hdd_r
        bd = jnp.einsum("pk,pk->p", Jd * w, res) + bd_r
        Hd8 = jnp.einsum("pk,pka->pa", Jd * w, J)             # [P, 8]

        lam = c.lam
        Hdd_l = Hdd * (1.0 + lam) + 1e-10
        H_sc = H88 * (1.0 + lam) - (Hd8 / Hdd_l[:, None]).T @ Hd8
        b_sc = b8 - Hd8.T @ (bd / Hdd_l)
        dx8 = -jnp.linalg.solve(H_sc + 1e-8 * jnp.eye(8), b_sc)
        dx8 = jnp.where(jnp.isfinite(dx8), dx8, 0.0)
        dd = -(bd + Hd8 @ dx8) / Hdd_l
        dd = jnp.clip(dd, -2.0, 2.0)

        T_new = SE3.exp(dx8[:6]).compose(T)
        ab_new = c.ab + dx8[6:8]
        id_new = jnp.clip(jnp.where(maskf, c.idepth + dd, c.idepth),
                          1e-3, 50.0)
        iR_new = REG_WEIGHT * _neighbor_median(id_new, maskf, lvl.nn) \
            + (1 - REG_WEIGHT) * id_new

        e_new = energy_total(T_new, ab_new, id_new, iR_new, snapped_now)
        accept = e_new < c.energy
        return Carry(
            T_R=jnp.where(accept, T_new.R, c.T_R),
            T_t=jnp.where(accept, T_new.t, c.T_t),
            ab=jnp.where(accept, ab_new, c.ab),
            idepth=jnp.where(accept, id_new, c.idepth),
            iR=jnp.where(accept, iR_new, c.iR),
            lam=jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-5, 1e4),
            energy=jnp.where(accept, e_new, c.energy))

    snapped0 = snapped
    e0 = energy_total(T_10, aff, lvl.idepth, lvl.iR, snapped0)
    c0 = Carry(T_10.R, T_10.t, aff, lvl.idepth, lvl.iR,
               jnp.asarray(lam0, jnp.float32), e0)
    c = jax.lax.fori_loop(0, iterations, body, c0)

    T_out = SE3(c.T_R, c.T_t)
    snapped_out = snapped | (jnp.sum(c.T_t * c.T_t) * alpha_w > ALPHA_K)
    # refresh the good mask from the final residual gate
    _, _, _, w_f, _, ok_f, _ = linearize(T_out, c.ab, c.idepth, c.iR)
    good = maskf & (jnp.sum(ok_f, axis=1) >= 6)
    lvl_out = lvl._replace(idepth=c.idepth, iR=c.iR, good=good)
    return lvl_out, T_out, c.ab, snapped_out, c.energy


def track_frame(state: InitState, pyr_new, cam, iterations: int = 30
                ) -> tuple[InitState, bool]:
    """One new frame through the coarse-to-fine initializer
    (CoarseInitializer::trackFrame). Returns (state', initialized) where
    initialized goes True once the solution stayed 'snapped' for
    SNAPPED_THRESHOLD frames."""
    n_levels = len(state.levels)
    levels = list(state.levels)

    # propagate idepths up: coarser levels start from finer parents' medians
    for l in range(1, n_levels):
        fine = levels[l - 1]
        coarse = levels[l]
        P = coarse.uv.shape[0]
        num = jnp.zeros(P, jnp.float32).at[fine.parent].add(
            jnp.where(fine.mask & (fine.parent >= 0), fine.idepth, 0.0))
        den = jnp.zeros(P, jnp.float32).at[fine.parent].add(
            jnp.where(fine.mask & (fine.parent >= 0), 1.0, 0.0))
        prop = jnp.where(den > 0, num / jnp.maximum(den, 1.0), coarse.idepth)
        levels[l] = coarse._replace(idepth=prop, iR=prop)

    T = state.T_10
    aff = state.aff
    snapped = state.snapped
    for l in range(n_levels - 1, -1, -1):
        pin = cam.pyramid_level(l)
        K4 = jnp.asarray([pin.fx, pin.fy, pin.cx, pin.cy], jnp.float32)
        H, W = pyr_new[l].shape[:2]
        levels[l], T, aff, snapped, _ = _track_level(
            levels[l], pyr_new[l], K4, T, aff, snapped, H, W,
            iterations=iterations)
        if l > 0:
            # propagate down: children take parents' idepth where unset
            fine = levels[l - 1]
            par = levels[l]
            pid = jnp.where(fine.parent >= 0, fine.parent, 0)
            prop = par.idepth[pid]
            use = fine.mask & (fine.parent >= 0)
            levels[l - 1] = fine._replace(
                idepth=jnp.where(use, prop, fine.idepth),
                iR=jnp.where(use, prop, fine.iR))

    frame_id = state.frame_id + 1
    snapped_at = jnp.where(snapped & (state.snapped_at < 0),
                           frame_id, state.snapped_at)
    initialized = bool(snapped) and \
        int(frame_id - jnp.maximum(snapped_at, 0)) >= SNAPPED_THRESHOLD \
        and int(snapped_at) >= 0
    new_state = InitState(levels=levels, T_10=T, aff=aff, snapped=snapped,
                          snapped_at=snapped_at, frame_id=frame_id)
    return new_state, initialized


def extract_result(state: InitState):
    """Final (T_10, uv0 [P,2], idepth0 [P], mask) at level 0, idepths
    rescaled to mean-1 like initializeFromInitializer's rescaleFactor."""
    l0 = state.levels[0]
    ok = l0.mask & l0.good
    mean_id = jnp.sum(jnp.where(ok, l0.iR, 0.0)) / jnp.maximum(
        jnp.sum(ok), 1.0)
    mean_id = jnp.maximum(mean_id, 1e-6)
    # gauge fix: idepth mean -> 1, translation scaled inversely
    T = SE3(state.T_10.R, state.T_10.t * mean_id)
    return T, l0.uv, jnp.where(ok, l0.iR / mean_id, 0.0), ok
