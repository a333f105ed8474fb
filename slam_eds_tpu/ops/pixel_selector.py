"""Density-targeted pixel selection — array-based redesign of DSO's
``PixelSelector`` (reference src/mapping/PixelSelector.{h,cpp}) and of the
EDS keyframe candidate selector (``KeyFrame::candidatePoints``,
src/tracking/KeyFrame.cpp:740-823).

Reference semantics reproduced:
* 32x32-block gradient histograms -> per-block threshold =
  quantile(setting_minGradHistCut of sqrt-gradient, integer bins clipped at
  48) + setting_minGradHistAdd, box-smoothed over the 3x3 block neighborhood
  and squared (``makeHists``/``computeHistQuantil``, PixelSelector.cpp:60-135).
* three-scale potential-grid selection: in every pot-cell pick the argmax of
  |grad . dir| among pixels above the block threshold; 2pot/4pot cells only
  fire where no finer-scale pick exists, using down-weighted thresholds on
  half/quarter-resolution squared gradients (``select``,
  PixelSelector.cpp:231-374). Statuses 1/2/4 as in DSO.
* density adaptation: selected-count ~ K/(pot+1)^2 model with re-selection,
  then random subsampling toward the target (``makeMaps``,
  PixelSelector.cpp:136-227). The recursion becomes a bounded host-side loop
  over a handful of statically-compiled pot values.

Redesign notes (not a port): the sequential raster scan with stateful
random-direction draws becomes a batched reshape into [cells, pot*pot] tiles
with per-cell argmax — one pass over the image per scale, all VPU work. The
random direction/byte sequence is replaced by a counter-free pixel hash
(deterministic, parallel); DSO's own randomness is only a tie-breaking
heuristic, so trajectories match statistically rather than bit-exactly.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

# 16 unit directions used for gradient-direction tie-breaking
# (PixelSelector.cpp:248-264).
_DIRECTIONS = np.array([
    [0, 1.0000], [0.3827, 0.9239], [0.1951, 0.9808], [0.9239, 0.3827],
    [0.7071, 0.7071], [0.3827, -0.9239], [0.8315, 0.5556], [0.8315, -0.5556],
    [0.5556, -0.8315], [0.9808, 0.1951], [0.9239, -0.3827], [0.7071, -0.7071],
    [0.5556, 0.8315], [0.9808, -0.1951], [1.0000, 0.0000], [0.1951, -0.9808],
], dtype=np.float32)


def _hash_u32(x):
    """Cheap integer hash (xorshift-multiply) for deterministic per-cell
    pseudo-randomness; replaces the srand(3141592) byte table."""
    x = x.astype(jnp.uint32)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def block_thresholds(abs_sq_grad, block: int = 32, hist_cut: float = 0.5,
                     hist_add: float = 7.0):
    """Per-block squared selection thresholds from gradient histograms.

    abs_sq_grad: [H, W] squared gradient magnitude at level 0.
    Returns [H//block, W//block] smoothed squared thresholds.

    Matches makeHists: integer histogram of sqrt(g) clipped to 48 over each
    32x32 block (image borders of 1 px excluded), threshold = the histogram
    quantile + hist_add, 3x3 neighbor box-mean, then squared.
    """
    H, W = abs_sq_grad.shape
    hb, wb = H // block, W // block
    g = jnp.sqrt(abs_sq_grad[: hb * block, : wb * block])
    gi = jnp.minimum(g.astype(jnp.int32), 48)
    # exclude the 1px image border like the reference (it>w-2 || it<1 ...)
    ys, xs = jnp.meshgrid(jnp.arange(hb * block), jnp.arange(wb * block),
                          indexing="ij")
    valid = (xs >= 1) & (xs <= W - 2) & (ys >= 1) & (ys <= H - 2)

    tiles = gi.reshape(hb, block, wb, block).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(hb * wb, block * block)
    vmask = valid.reshape(hb, block, wb, block).transpose(0, 2, 1, 3)
    vmask = vmask.reshape(hb * wb, block * block)

    # histogram via one-hot compare: [cells, 50]
    bins = jnp.arange(49)
    onehot = (tiles[:, :, None] == bins[None, None, :]) & vmask[:, :, None]
    hist = jnp.sum(onehot, axis=1)  # [cells, 49] counts of value i
    total = jnp.sum(hist, axis=1)
    # computeHistQuantil: smallest i with cumsum(hist[0..i]) > total*cut
    # (reference decrements th=total*cut+0.5 by hist[i+1], returns first i
    # where it goes negative)
    th0 = (total.astype(jnp.float32) * hist_cut + 0.5).astype(jnp.int32)
    cum = jnp.cumsum(hist, axis=1)
    # quantile index = count of prefix sums <= th0 (caps at 48; ref caps at 90
    # but bins only reach 48)
    q = jnp.sum((cum <= th0[:, None]).astype(jnp.int32), axis=1)
    ths = q.astype(jnp.float32) + hist_add
    ths = ths.reshape(hb, wb)

    # 3x3 box smoothing with edge handling by count normalization
    pad = jnp.pad(ths, 1, mode="constant")
    cnt = jnp.pad(jnp.ones_like(ths), 1, mode="constant")
    sm = sum(pad[dy:dy + hb, dx:dx + wb] for dy in range(3) for dx in range(3))
    n = sum(cnt[dy:dy + hb, dx:dx + wb] for dy in range(3) for dx in range(3))
    sm = sm / n
    return sm * sm


def _cell_max(score, pot: int):
    """Per pot x pot cell max and argmax (flat pixel index) of a [H, W] score.
    H, W must be multiples of pot. Returns (max [hc, wc], argflat [hc, wc])."""
    H, W = score.shape
    hc, wc = H // pot, W // pot
    t = score.reshape(hc, pot, wc, pot).transpose(0, 2, 1, 3).reshape(hc, wc, pot * pot)
    best = jnp.max(t, axis=-1)
    arg = jnp.argmax(t, axis=-1)
    dy = arg // pot
    dx = arg % pot
    ys = jnp.arange(hc)[:, None] * pot + dy
    xs = jnp.arange(wc)[None, :] * pot + dx
    return best, ys * W + xs


@partial(jax.jit, static_argnames=("pot", "block"))
def select_status_map(dI, abs_sq0, abs_sq1, abs_sq2, pot: int,
                      th_factor: float = 1.0, block: int = 32,
                      hist_cut: float = 0.5, hist_add: float = 7.0,
                      downweight: float = 0.75, seed: int = 3141592):
    """One selection pass at a given potential. Returns (status [H, W] int8
    with values {0,1,2,4}, counts (n1, n2, n4)).

    dI: [H, W, 3] level-0 [I, gx, gy]; abs_sq{0,1,2}: squared-gradient images
    at pyramid levels 0/1/2.
    """
    H, W = abs_sq0.shape
    ths = block_thresholds(abs_sq0, block, hist_cut, hist_add)
    hb, wb = ths.shape
    # per-pixel block threshold (clamp block idx for the partial-border area)
    ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    by = jnp.clip(ys // block, 0, hb - 1)
    bx = jnp.clip(xs // block, 0, wb - 1)
    th0 = ths[by, bx] * th_factor
    th1 = th0 * (downweight ** 2)
    th2 = th0 * (downweight ** 4)

    # border exclusion (xf<4 || xf>=w-5 || yf<4 || yf>h-4)
    inb = (xs >= 4) & (xs < W - 5) & (ys >= 4) & (ys < H - 4)

    # half/quarter-res squared gradients sampled at this pixel
    # (int(xf*0.5+0.25) etc., PixelSelector.cpp:325,337)
    x1 = (xs.astype(jnp.float32) * 0.5 + 0.25).astype(jnp.int32)
    y1 = (ys.astype(jnp.float32) * 0.5 + 0.25).astype(jnp.int32)
    x2 = (xs.astype(jnp.float32) * 0.25 + 0.125).astype(jnp.int32)
    y2 = (ys.astype(jnp.float32) * 0.25 + 0.125).astype(jnp.int32)
    H1, W1 = abs_sq1.shape
    H2, W2 = abs_sq2.shape
    ag1 = abs_sq1[jnp.clip(y1, 0, H1 - 1), jnp.clip(x1, 0, W1 - 1)]
    ag2 = abs_sq2[jnp.clip(y2, 0, H2 - 1), jnp.clip(x2, 0, W2 - 1)]
    ag0 = abs_sq0

    # per-cell random directions from the coordinate hash, one per pot-cell
    def cell_dirs(cell_pot):
        cy = ys // cell_pot
        cx = xs // cell_pot
        h = _hash_u32(cy * jnp.uint32(92837111) ^ cx * jnp.uint32(689287499)
                      ^ jnp.uint32(seed))
        d = jnp.asarray(_DIRECTIONS)[(h & 0xF).astype(jnp.int32)]
        return d  # [H, W, 2]

    g = dI[..., 1:3]

    def dir_score(cell_pot):
        d = cell_dirs(cell_pot)
        return jnp.abs(g[..., 0] * d[..., 0] + g[..., 1] * d[..., 1])

    pass0 = (ag0 > th0) & inb
    pass1 = (ag1 > th1) & inb
    pass2 = (ag2 > th2) & inb

    neg = jnp.float32(-1.0)
    s0 = jnp.where(pass0, dir_score(pot), neg)
    s1 = jnp.where(pass1, dir_score(2 * pot), neg)
    s2 = jnp.where(pass2, dir_score(4 * pot), neg)

    # pad to multiples of 4*pot so cell reshapes are exact
    P4 = 4 * pot
    Hp = ((H + P4 - 1) // P4) * P4
    Wp = ((W + P4 - 1) // P4) * P4
    padder = lambda a: jnp.pad(a, ((0, Hp - H), (0, Wp - W)),
                               constant_values=-1.0)
    s0p, s1p, s2p = padder(s0), padder(s1), padder(s2)

    # level-1: winner per pot-cell
    best1, arg1 = _cell_max(s0p, pot)
    sel1 = jnp.zeros(Hp * Wp, jnp.bool_)
    # note: arg indices are in padded coords; convert later
    sel1 = sel1.at[arg1.ravel()].set(best1.ravel() > 0)

    # level-2 fires in 2pot-cells with no level-1 winner inside
    has1_2, _ = _cell_max(jnp.where(sel1.reshape(Hp, Wp), 1.0, 0.0), 2 * pot)
    best2, arg2 = _cell_max(s1p, 2 * pot)
    fire2 = (best2 > 0) & (has1_2 <= 0)
    sel2 = jnp.zeros(Hp * Wp, jnp.bool_)
    sel2 = sel2.at[arg2.ravel()].set(fire2.ravel())

    # level-4 fires in 4pot-cells with no level-1/2 winner inside
    occ = jnp.where(sel1 | sel2, 1.0, 0.0).reshape(Hp, Wp)
    has12_4, _ = _cell_max(occ, 4 * pot)
    best4, arg4 = _cell_max(s2p, 4 * pot)
    fire4 = (best4 > 0) & (has12_4 <= 0)
    sel4 = jnp.zeros(Hp * Wp, jnp.bool_)
    sel4 = sel4.at[arg4.ravel()].set(fire4.ravel())

    status_p = (sel1.astype(jnp.int8) * 1 + sel2.astype(jnp.int8) * 2
                + sel4.astype(jnp.int8) * 4).reshape(Hp, Wp)
    status = status_p[:H, :W]
    n1 = jnp.sum(sel1)
    n2 = jnp.sum(sel2)
    n4 = jnp.sum(sel4)
    return status, (n1, n2, n4)


def make_maps(dI, abs_sq_pyr, density: float, pot_initial: int = 3,
              rounds: int = 2, th_factor: float = 1.0, seed: int = 3141592,
              block: int = 32, hist_cut: float = 0.5, hist_add: float = 7.0,
              downweight: float = 0.75):
    """Density-adapted selection (``makeMaps`` semantics): run select at the
    current potential, adapt pot with the K/(pot+1)^2 model for up to
    ``rounds`` extra passes, then randomly subsample toward the target.

    Host-side loop over a few statically-jitted pots (selection runs once per
    keyframe — not a hot path; the per-pass kernel is fully on-device).

    Returns (status [H, W] int8, n_selected, next_pot).
    """
    pot = int(pot_initial)
    for attempt in range(rounds + 1):
        status, (n1, n2, n4) = select_status_map(
            dI, abs_sq_pyr[0], abs_sq_pyr[1], abs_sq_pyr[2], pot=pot,
            th_factor=th_factor, block=block, hist_cut=hist_cut,
            hist_add=hist_add, downweight=downweight, seed=seed)
        num_have = float(n1 + n2 + n4)
        quotia = density / max(num_have, 1.0)
        K = num_have * (pot + 1) ** 2
        ideal = int(np.sqrt(K / max(density, 1.0)) - 1)
        ideal = max(ideal, 1)
        if attempt < rounds and quotia > 1.25 and pot > 1:
            pot = min(ideal, pot - 1)
        elif attempt < rounds and quotia < 0.25:
            pot = max(ideal, pot + 1)
        else:
            break

    if quotia < 0.95:
        # random thinning toward the target (hash-based Bernoulli keep)
        H, W = status.shape
        ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
        u = (_hash_u32(ys * jnp.uint32(7919) ^ xs ^ jnp.uint32(seed))
             & jnp.uint32(0xFFFF)).astype(jnp.float32) / 65535.0
        status = jnp.where((status > 0) & (u > quotia), 0, status).astype(jnp.int8)
    n_sel = int(jnp.sum(status > 0))
    return status, n_sel, ideal


def status_to_points(status, score, capacity: int):
    """Convert a status map to a fixed-capacity point list ordered by score.

    Returns (uv [capacity, 2] float32, status_vals [capacity], mask
    [capacity]). Selected pixels beyond capacity are dropped lowest-score
    first; this replaces dynamic std::vector growth with static shapes.
    """
    H, W = status.shape
    flat_sel = (status > 0).ravel()
    flat_score = jnp.where(flat_sel, score.ravel(), -jnp.inf)
    vals, idx = jax.lax.top_k(flat_score, capacity)
    mask = jnp.isfinite(vals)
    ys = (idx // W).astype(jnp.float32)
    xs = (idx % W).astype(jnp.float32)
    uv = jnp.stack([xs, ys], axis=-1)
    return uv, status.ravel()[idx], mask


@partial(jax.jit, static_argnames=("patch", "capacity", "mode"))
def candidate_points_grid(grad_mag, patch: int, capacity: int,
                          mode: str = "max"):
    """EDS keyframe candidate selection (``KeyFrame::candidatePoints``,
    src/tracking/KeyFrame.cpp:740-823): split |grad| into patch x patch
    cells; MAX mode picks the top-magnitude pixel per cell, MEDIAN mode
    selects all pixels above the per-cell median.

    Array form: cell-reshape + argmax / median-compare, then top-k packing into
    fixed capacity. Returns (uv [capacity, 2], mask [capacity]).
    """
    H, W = grad_mag.shape
    Hc = (H // patch) * patch
    Wc = (W // patch) * patch
    g = grad_mag[:Hc, :Wc]
    hc, wc = Hc // patch, Wc // patch
    tiles = g.reshape(hc, patch, wc, patch).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(hc, wc, patch * patch)
    if mode == "max":
        sel_score = jnp.full((Hc, Wc), -jnp.inf, g.dtype)
        best = jnp.max(tiles, axis=-1)
        arg = jnp.argmax(tiles, axis=-1)
        dy, dx = arg // patch, arg % patch
        ys = jnp.arange(hc)[:, None] * patch + dy
        xs = jnp.arange(wc)[None, :] * patch + dx
        sel_score = sel_score.at[ys.ravel(), xs.ravel()].set(best.ravel())
    else:  # median
        med = jnp.median(tiles, axis=-1)
        med_img = jnp.repeat(jnp.repeat(med, patch, axis=0), patch, axis=1)
        sel_score = jnp.where(g > med_img, g, -jnp.inf)
    flat = sel_score.ravel()
    vals, idx = jax.lax.top_k(flat, capacity)
    mask = jnp.isfinite(vals)
    uv = jnp.stack([(idx % Wc).astype(jnp.float32),
                    (idx // Wc).astype(jnp.float32)], axis=-1)
    return uv, mask
