"""Sliding-window BA state — the array replacement for DSO's pointer
graph (FrameHessian/PointHessian/EFFrame/EFPoint/EFResidual, reference
src/tracking/HessianBlocks.h and src/bundles/EnergyFunctionalStructs.h).

Everything is one fixed-capacity pytree of arrays:
* F frame slots with validity mask (the 5-7 KF window + incoming slot;
  reference grows/shrinks std::vectors, we mask),
* P point slots, each owned by a host frame, with the DSO 8-pixel pattern
  colors/weights and first-estimate (FEJ) idepth,
* a dense [P, F] residual-activation mask replacing the residual objects and
  the host->target connectivity map,
* the dense marginalization prior HM/bM over the full padded state
  [C(4) | 8 per frame slot] (reference EnergyFunctional::HM/bM).

State parameterization (matches DSO):
* per-frame 8-vector delta = [tangent(6) | a, b] relative to the FEJ
  evaluation pose T_eval (worldToCam), current pose = exp(delta[:6]) @ T_eval,
  current affine = aff_eval + delta[6:8],
* per-point idepth with idepth_zero kept for FEJ geometric Jacobians,
* 4 intrinsics [fx, fy, cx, cy] with value_zero (CPARS block).

Point status codes mirror EFPointStatus (PS_GOOD/PS_MARGINALIZE/PS_DROP).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.lie import SE3

CPARS = 4
PATTERN = 8

# point status
PT_EMPTY = 0
PT_ACTIVE = 1
PT_MARGINALIZE = 2
PT_DROP = 3


class BAState(NamedTuple):
    # --- frames [F slots] ---
    T_eval: SE3            # batched worldToCam at FEJ: R [F,3,3], t [F,3]
    aff_eval: jax.Array    # [F, 2] (a, b) at FEJ
    delta: jax.Array       # [F, 8] current state minus eval
    exposure: jax.Array    # [F] ab_exposure
    frame_prior: jax.Array       # [F, 8] diagonal prior weights
    frame_prior_delta0: jax.Array  # [F, 8] prior anchor minus eval state
    frame_valid: jax.Array  # [F] bool
    frame_energy_th: jax.Array  # [F] outlier energy threshold
    # --- calib (CPARS) ---
    c_zero: jax.Array      # [4] fx fy cx cy at FEJ
    c_delta: jax.Array     # [4]
    # --- points [P slots] ---
    p_host: jax.Array      # [P] int32 host frame slot
    p_uv: jax.Array        # [P, 2] pixel in host frame
    p_idepth: jax.Array    # [P]
    p_idepth_zero: jax.Array  # [P]
    p_color: jax.Array     # [P, 8] pattern intensities in host
    p_weight: jax.Array    # [P, 8] pattern gradient weights
    p_prior: jax.Array     # [P] idepth prior weight
    p_status: jax.Array    # [P] int32
    # --- residuals ---
    r_active: jax.Array    # [P, F] bool (point i observed in target frame f)
    # --- marginalization prior over [CPARS + 8F] ---
    HM: jax.Array
    bM: jax.Array

    @property
    def num_frames(self):
        return self.frame_valid.shape[0]

    @property
    def num_points(self):
        return self.p_host.shape[0]

    @property
    def dim(self):
        return CPARS + 8 * self.num_frames

    def current_poses(self) -> SE3:
        """exp(delta[:6]) @ T_eval per frame."""
        def one(d, R, t):
            T = SE3.exp(d[:6]).compose(SE3(R, t))
            return T.R, T.t
        R, t = jax.vmap(one)(self.delta, self.T_eval.R, self.T_eval.t)
        return SE3(R, t)

    def current_aff(self):
        return self.aff_eval + self.delta[:, 6:8]

    def current_calib(self):
        return self.c_zero + self.c_delta


def empty_state(num_frames: int, num_points: int, calib,
                dtype=jnp.float32) -> BAState:
    F, P = num_frames, num_points
    D = CPARS + 8 * F
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (F, 3, 3))
    return BAState(
        T_eval=SE3(eye, jnp.zeros((F, 3), dtype)),
        aff_eval=jnp.zeros((F, 2), dtype),
        delta=jnp.zeros((F, 8), dtype),
        exposure=jnp.ones((F,), dtype),
        frame_prior=jnp.zeros((F, 8), dtype),
        frame_prior_delta0=jnp.zeros((F, 8), dtype),
        frame_valid=jnp.zeros((F,), bool),
        frame_energy_th=jnp.full((F,), 1e8, dtype),
        c_zero=jnp.asarray(calib, dtype),
        c_delta=jnp.zeros((CPARS,), dtype),
        p_host=jnp.zeros((P,), jnp.int32),
        p_uv=jnp.zeros((P, 2), dtype),
        p_idepth=jnp.ones((P,), dtype),
        p_idepth_zero=jnp.ones((P,), dtype),
        p_color=jnp.zeros((P, PATTERN), dtype),
        p_weight=jnp.ones((P, PATTERN), dtype),
        p_prior=jnp.zeros((P,), dtype),
        p_status=jnp.zeros((P,), jnp.int32),
        r_active=jnp.zeros((P, F), bool),
        HM=jnp.zeros((D, D), dtype),
        bM=jnp.zeros((D,), dtype),
    )


def synthetic_window(frames: int = 8, points: int = 2048, height: int = 480,
                     width: int = 640, seed: int = 0):
    """A seeded full window for timing and checking the BA: ``points``
    active points hosted on the first ``frames - 1`` slots, observed in
    every other slot, small random poses, a 1e8 gauge prior on slot 0 and
    one smooth [I, gx, gy] image per slot. The defaults are the reference
    operating point (2048 points, window 7+1, 640x480, focal 400).
    Returns (state, images [F, H, W, 3])."""
    F, P, H, W = frames, points, height, width
    rng = np.random.default_rng(seed)
    f = 400.0 * W / 640.0
    state = empty_state(F, P, jnp.asarray(
        [f, f, (W - 1) / 2.0, (H - 1) / 2.0], jnp.float32))
    taus = jnp.asarray(rng.uniform(-0.05, 0.05, (F, 6)), jnp.float32)
    T = jax.vmap(SE3.exp)(taus)
    uv = jnp.asarray(np.stack([rng.uniform(8, W - 8, P),
                               rng.uniform(8, H - 8, P)], -1), jnp.float32)
    hosts = rng.integers(0, F - 1, P)
    r_act = np.ones((P, F), bool)
    r_act[np.arange(P), hosts] = False
    state = state._replace(
        T_eval=T,
        frame_valid=jnp.ones(F, bool),
        p_uv=uv,
        p_host=jnp.asarray(hosts, jnp.int32),
        p_idepth=jnp.asarray(rng.uniform(0.3, 1.0, P), jnp.float32),
        p_idepth_zero=jnp.asarray(rng.uniform(0.3, 1.0, P), jnp.float32),
        p_color=jnp.asarray(rng.uniform(20, 200, (P, PATTERN)), jnp.float32),
        p_status=jnp.full((P,), PT_ACTIVE, jnp.int32),
        r_active=jnp.asarray(r_act),
        frame_prior=jnp.zeros((F, 8), jnp.float32).at[0, :6].set(1e8),
    )
    ys, xs = np.mgrid[0:H, 0:W]
    base = (np.sin(xs * 0.05) * np.cos(ys * 0.07) * 100 + 128).astype(
        np.float32)
    img = np.stack([base, np.gradient(base, axis=1),
                    np.gradient(base, axis=0)], -1)
    return state, jnp.asarray(np.broadcast_to(img, (F, H, W, 3)))
