"""Sliding-window manager: the host-side orchestration of the DSO backend.

The reference's driver layer is external (SURVEY §0 L7 — the orogen task
owns frame flow); this module is its array-based equivalent for the BA
window: slot allocation, keyframe insertion, immature-point bookkeeping,
point activation, marginalization policy, and coarse-tracker template
refresh. Control decisions (which slot, how many points) run in host numpy;
all numerical work stays in the jitted kernels (ops.energy, ops.immature,
ops.coarse_tracker).

Policy notes vs. the reference:
* frame marginalization keeps the two newest frames, first drops frames
  whose point support collapsed (setting_minPointsRemaining analog), then
  applies DSO's pairwise distance score (FullSystem::
  flagFramesForMarginalization, which lives outside the reference repo)
  to pick the most redundant remaining frame.
* point flags follow PointHessian::isOOB/isInlierNew (HessianBlocks.h:
  474-506): points of a dying frame are marginalized if well-constrained,
  dropped otherwise; points with too few residuals are dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import EDSConfig
from ..utils.cameras import Pinhole
from ..utils.lie import SE3
from ..utils import image as image_ops
from ..ops import energy, immature, pixel_selector
from ..ops import coarse_tracker as ct
from . import ba_state as bs

from functools import partial as _partial


# Whole-coarse-track and template-build as single jitted programs (each
# level's while_loop would otherwise dispatch separately). Module-level so the trace/compile cache is shared
# across WindowManager instances (one per sequence in multi-sequence eval);
# the config scalars are static arguments.
@_partial(jax.jit, static_argnames=("max_iterations", "huber_th",
                                    "cutoff_th"))
def _track_coarse_compiled(templates, pyr, cams, pose, aff, exposures,
                           aff_ref, min_res_for_abort, *, max_iterations,
                           huber_th, cutoff_th):
    return ct.track_newest_coarse(
        templates, pyr, cams, pose, aff, exposures, aff_ref,
        min_res_for_abort, max_iterations=max_iterations,
        huber_th=huber_th, cutoff_th=cutoff_th)


@_partial(jax.jit, static_argnames=("max_iterations", "huber_th",
                                    "cutoff_th"))
def _track_frame_compiled(state, slot, templates, pyr, cams, pose_init,
                          aff_init, exposure, min_res_for_abort, *,
                          max_iterations, huber_th, cutoff_th):
    """track_frame's whole device program in one dispatch: relative-pose
    prefix (refToNew from the window state) + the coarse LM + the world
    pose composition. Returns (TrackResult, T_wc)."""
    T = state.current_poses()
    T_kf = SE3(T.R[slot], T.t[slot])
    ref_to_new = pose_init.compose(T_kf.inverse())
    aff_kf = state.current_aff()[slot]
    res = ct.track_newest_coarse(
        templates, pyr, cams, ref_to_new, aff_init,
        (state.exposure[slot], exposure), aff_kf,
        min_res_for_abort,
        max_iterations=max_iterations, huber_th=huber_th,
        cutoff_th=cutoff_th)
    T_wc = res.pose.compose(T_kf)
    return res, T_wc


_build_template_compiled = jax.jit(ct.build_template,
                                   static_argnames=("caps",))


@_partial(jax.jit, static_argnames=("num_levels",))
def _pyramid_compiled(img, num_levels):
    levels, _ = image_ops.build_pyramid(img, num_levels)
    return levels


@jax.jit
def _all_pairs_compiled(state, K):
    """All host->target pair tensors in ONE dispatch: KRKi [F,F,3,3],
    Kt [F,F,3], aff [F,F,2] at the current state.

    Replaces the per-pair ``_pair_krki_kt_aff`` calls (each ~10 separate
    un-jitted ops; trace_all + activate_points issued O(F^2) of them per
    keyframe)."""
    T = state.current_poses()
    R_wc = jnp.swapaxes(T.R, -1, -2)                  # [F, 3, 3]
    t_wc = -jnp.einsum("fij,fj->fi", R_wc, T.t)
    # T_th = T_t o T_h^-1: R = R_t R_h^T, t = t_t - R_t R_h^T t_h
    R_th = jnp.einsum("tij,hkj->thik", T.R, T.R)      # [F_t, F_h, 3, 3]
    t_th = T.t[:, None, :] - jnp.einsum("thik,hk->thi", R_th, T.t)
    Kinv = jnp.linalg.inv(K)
    KRKi = jnp.einsum("ij,thjk,kl->htil", K, R_th, Kinv)   # [host, tgt,...]
    Kt = jnp.einsum("ij,thj->hti", K, t_th)
    a_rel, b_rel = energy.relative_affine(state, use_zero=False)
    aff = jnp.stack([a_rel, b_rel], -1)               # [host, tgt, 2]
    return KRKi, Kt, aff


@_partial(jax.jit, static_argnames=("gn_iterations",))
def _activate_idepth_v(pts_stack, images, KRKis, Kts, affs, tmasks,
                       gn_iterations: int):
    """Activation GN for EVERY contributing window slot in one dispatch:
    vmap of immature.activate_idepth over the slot axis (images shared)."""
    return jax.vmap(
        lambda p, kr, kt, af, tm: immature.activate_idepth(
            p, images, kr, kt, af, tm, gn_iterations=gn_iterations)
    )(pts_stack, KRKis, Kts, affs, tmasks)


@_partial(jax.jit, static_argnames=("outlier_th",))
def _activate_commit_compiled(state, images, dst, host, uv, idp, *,
                              outlier_th: float):
    """Batched point-activation commit: sample pattern colors/weights from
    each new point's host image and scatter all per-point arrays in one
    program. ``dst`` rows >= P are padding and are dropped.

    The host-image sample is a flat gather indexed by (host, y, x) — a
    per-point ``images[host]`` under vmap would materialize an [M, H, W, 3]
    copy of the window images (322 GB padded at the 640x480 operating
    point; the XLA allocation failure that killed the first e2e bench)."""
    offs = jnp.asarray(image_ops.PATTERN_DSO8, jnp.float32)
    F_, H_, W_, C_ = images.shape
    x = uv[:, 0:1] + offs[None, :, 0]                 # [M, 8]
    y = uv[:, 1:2] + offs[None, :, 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx_ = x - x0
    fy_ = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    flat = images.reshape(-1, C_)

    def gat(xi, yi):
        xi = jnp.clip(xi, 0, W_ - 1)
        yi = jnp.clip(yi, 0, H_ - 1)
        idx = (host[:, None] * H_ + yi) * W_ + xi
        return flat[idx]                              # [M, 8, 3]

    hit = (gat(x0i, y0i) * ((1 - fx_) * (1 - fy_))[..., None]
           + gat(x0i + 1, y0i) * (fx_ * (1 - fy_))[..., None]
           + gat(x0i, y0i + 1) * ((1 - fx_) * fy_)[..., None]
           + gat(x0i + 1, y0i + 1) * (fx_ * fy_)[..., None])  # [M,8,3]
    colors = hit[..., 0]
    g2 = jnp.sum(hit[..., 1:3] ** 2, -1)
    w = jnp.sqrt(outlier_th / (outlier_th + g2))
    F = state.num_frames
    r_rows = state.frame_valid[None, :] & (jnp.arange(F)[None, :]
                                           != host[:, None])
    mode = dict(mode="drop")
    return state._replace(
        p_host=state.p_host.at[dst].set(host, **mode),
        p_uv=state.p_uv.at[dst].set(uv, **mode),
        p_idepth=state.p_idepth.at[dst].set(idp, **mode),
        p_idepth_zero=state.p_idepth_zero.at[dst].set(idp, **mode),
        p_color=state.p_color.at[dst].set(colors, **mode),
        p_weight=state.p_weight.at[dst].set(w, **mode),
        p_prior=state.p_prior.at[dst].set(0.0, **mode),
        p_status=state.p_status.at[dst].set(bs.PT_ACTIVE, **mode),
        r_active=state.r_active.at[dst].set(r_rows, **mode),
    )


@_partial(jax.jit, static_argnames=("height", "width"))
def _marg_points_compiled(state, images, marg_weight, idepth_fac, huber_th,
                          *, height, width):
    """linearize + point-marginalization as ONE program (the eager
    marginalize_points issued ~40 dispatches per keyframe)."""
    lin = energy.linearize(state, images, height, width, huber_th=huber_th)
    return energy.marginalize_points(state, lin, marg_weight=marg_weight,
                                     idepth_prior_marg_fac=idepth_fac)


_marg_frame_compiled = jax.jit(energy.marginalize_frame,
                               static_argnames=("slot",))


@_partial(jax.jit, static_argnames=("height", "width"))
def _project_active_to_newest(state, cam_vec, newest_slot, *, height,
                              width):
    """Project all active points into the newest KF — the device part of
    ``rebuild_coarse_template`` fused into one dispatch. Returns
    (uv [P, 2], idepth_new [P], ok [P])."""
    fx, fy, cx, cy = cam_vec[0], cam_vec[1], cam_vec[2], cam_vec[3]
    T = state.current_poses()
    T_new = SE3(T.R[newest_slot], T.t[newest_slot])
    active = (state.p_status == bs.PT_ACTIVE)
    host = state.p_host
    Th = SE3(T.R[host], T.t[host])
    x = (state.p_uv[:, 0] - cx) / fx
    y = (state.p_uv[:, 1] - cy) / fy
    z = 1.0 / jnp.maximum(state.p_idepth, 1e-6)
    X_h = jnp.stack([x * z, y * z, z], -1)
    X_w = Th.inverse().apply(X_h)
    X_n = T_new.apply(X_w)
    u = fx * X_n[:, 0] / X_n[:, 2] + cx
    v = fy * X_n[:, 1] / X_n[:, 2] + cy
    idn = 1.0 / jnp.maximum(X_n[:, 2], 1e-6)
    ok = active & (X_n[:, 2] > 1e-6) & (u > 1) & (v > 1) \
        & (u < width - 2) & (v < height - 2)
    return jnp.stack([u, v], -1), idn, ok


@dataclass
class WindowManager:
    cam: Pinhole
    cfg: EDSConfig
    state: bs.BAState = None
    images: jnp.ndarray = None          # [F, H, W, 3]
    pyramids: list = None               # per-slot list of per-level stacks
    immatures: list = None              # per-slot ImmaturePoints or None
    frame_times: list = field(default_factory=list)
    frame_ids: list = field(default_factory=list)   # global id per slot (-1 empty)
    next_id: int = 0
    coarse_templates: list = None       # templates for newest KF
    newest_slot: int = -1
    # [256] forward-response derivative table (PhotometricCalib.
    # b_grad_table) or None: when set, the pixel selector's squared-
    # gradient maps are weighted by bg(I)^2 per level — the
    # setting_gammaWeightsPixelSelect path of FrameHessian::makeImages
    # (src/tracking/HessianBlocks.cpp, dabs_l *= gw*gw)
    photometric_bgrad: object = None
    marg_count: int = 0       # frames Schur-eliminated over this window's life

    def __post_init__(self):
        F = self.cfg.caps.max_window_frames
        P = self.cfg.caps.max_points_per_kf
        calib = jnp.asarray([self.cam.fx, self.cam.fy, self.cam.cx,
                             self.cam.cy], jnp.float32)
        if self.state is None:
            self.state = bs.empty_state(F, P, calib)
        H, W = self.cam.height, self.cam.width
        self.images = jnp.zeros((F, H, W, 3), jnp.float32)
        self.immatures = [None] * F
        self.frame_ids = [-1] * F
        self.frame_times = [0.0] * F

    # ------------------------------------------------------------------
    @property
    def num_active_frames(self):
        return int(np.sum(np.asarray(self.state.frame_valid)))

    def _free_slot(self) -> int:
        fv = np.asarray(self.state.frame_valid)
        free = np.where(~fv)[0]
        assert len(free) > 0, "window full — marginalize first"
        return int(free[0])

    def _pyramid(self, img):
        return _pyramid_compiled(jnp.asarray(img, jnp.float32),
                                 num_levels=self.cfg.coarse.pyr_levels)

    # ------------------------------------------------------------------
    def insert_frame(self, img, T_wc: SE3, time: float, aff=(0.0, 0.0),
                     exposure: float = 1.0, is_first: bool = False,
                     immature_seed=None) -> int:
        """Insert a new keyframe into a free slot (EnergyFunctional::
        insertFrame). Sets the FEJ evaluation point to the given pose and
        spawns immature points from the pixel selector."""
        slot = self._free_slot()
        pyr = self._pyramid(img)
        self.pyramids = self.pyramids or [None] * self.state.num_frames
        self.pyramids[slot] = pyr
        self.images = self.images.at[slot].set(pyr[0])
        self.frame_ids[slot] = self.next_id
        self.frame_times[slot] = time
        self.next_id += 1

        st = self.state
        prior = np.zeros(8, np.float32)
        if is_first:
            prior[:3] = self.cfg.bundles.initial_trans_prior
            prior[3:6] = self.cfg.bundles.initial_rot_prior
        # affine priors pin EVERY frame's (a, b) toward ABSOLUTE zero
        # (FrameHessian::getPrior p[6]/p[7] with getPriorZero() == 0 —
        # setting_affineOptModeA/B are quoted in SCALE_A/SCALE_B scaled
        # units; config stores the unscaled equivalents). Round-5 collapse
        # root cause #2: anchoring this prior at the INHERITED tracked
        # affine (frame_prior_delta0 = 0 pulls toward aff_eval) let the
        # tracker's per-generation (a, b) wander accumulate without bound
        # (b: 3 -> 35 over 6 keyframe generations on a constant-brightness
        # scene), ballooning the BA energy until the window collapsed.
        prior_d0 = np.zeros(8, np.float32)
        if self.cfg.bundles.affine_opt_mode_a > 0:
            prior[6] = self.cfg.bundles.affine_opt_mode_a
            prior_d0[6] = -float(aff[0])     # delta - d0 = absolute a
        if self.cfg.bundles.affine_opt_mode_b > 0:
            prior[7] = self.cfg.bundles.affine_opt_mode_b
            prior_d0[7] = -float(aff[1])     # delta - d0 = absolute b
        self.state = st._replace(
            T_eval=SE3(st.T_eval.R.at[slot].set(T_wc.R),
                       st.T_eval.t.at[slot].set(T_wc.t)),
            aff_eval=st.aff_eval.at[slot].set(jnp.asarray(aff, jnp.float32)),
            delta=st.delta.at[slot].set(0.0),
            exposure=st.exposure.at[slot].set(exposure),
            frame_prior=st.frame_prior.at[slot].set(jnp.asarray(prior)),
            frame_prior_delta0=st.frame_prior_delta0.at[slot].set(
                jnp.asarray(prior_d0)),
            frame_valid=st.frame_valid.at[slot].set(True),
            frame_energy_th=st.frame_energy_th.at[slot].set(1e8),
            # existing active points observe the new keyframe: DSO creates a
            # residual from every active point to each new KF
            # (FullSystem::makeKeyFrame "add new residuals for old points");
            # per-iteration OOB/outlier gating in linearize() prunes bad ones
            r_active=st.r_active.at[:, slot].set(
                st.p_status == bs.PT_ACTIVE),
        )
        self.newest_slot = slot
        self._spawn_immature(slot, immature_seed)
        return slot

    def _spawn_immature(self, slot: int, seed_depth=None):
        """Select candidate pixels on the new KF and create immature points
        (FullSystem::makeNewTraces equivalent; density from config)."""
        pyr = self.pyramids[slot]
        abs_sq = [jnp.sum(l[..., 1:3] ** 2, -1) for l in pyr[:3]]
        if self.photometric_bgrad is not None:
            bg = jnp.asarray(self.photometric_bgrad, jnp.float32)
            gw = [bg[jnp.clip((l[..., 0] + 0.5).astype(jnp.int32), 0, 255)]
                  for l in pyr[:3]]
            abs_sq = [a * g * g for a, g in zip(abs_sq, gw)]
        status, n_sel, _ = pixel_selector.make_maps(
            pyr[0], abs_sq, density=self.cfg.selector.desired_immature_density,
            pot_initial=self.cfg.selector.potential_initial,
            rounds=self.cfg.selector.adaptation_rounds)
        cap = self.cfg.caps.max_immature_per_kf
        uv, _, mask = pixel_selector.status_to_points(status, abs_sq[0], cap)
        if seed_depth is not None:
            # EDS seeding: idepth from an external depth map +-10%
            # (ImmaturePoint.cpp:68-114)
            from .keyframe import nn_depth_lookup
            idp, _ = nn_depth_lookup(uv, *seed_depth)
            pts = immature.make_immature(pyr[0], uv, mask)
            pts = pts._replace(idepth_min=jnp.maximum(idp * 0.9, 1e-4),
                               idepth_max=idp * 1.1)
        else:
            pts = immature.make_immature(pyr[0], uv, mask)
        self.immatures[slot] = pts

    # ------------------------------------------------------------------
    def _pair_krki_kt_aff(self, host_slot: int, target_slot: int):
        """K R K^-1, K t, relative affine for host->target at current state."""
        T = self.state.current_poses()
        Th = SE3(T.R[host_slot], T.t[host_slot])
        Tt = SE3(T.R[target_slot], T.t[target_slot])
        T_th = Tt.compose(Th.inverse())
        K = self.cam.K
        Kinv = jnp.linalg.inv(K)
        KRKi = K @ T_th.R @ Kinv
        Kt = K @ T_th.t
        a_rel, b_rel = energy.relative_affine(self.state, use_zero=False)
        aff = jnp.stack([a_rel[host_slot, target_slot],
                         b_rel[host_slot, target_slot]])
        return KRKi, Kt, aff

    def all_pairs(self):
        """Batched host->target pair tensors as numpy (one dispatch + one
        transfer; see _all_pairs_compiled)."""
        KRKi, Kt, aff = _all_pairs_compiled(self.state, self.cam.K)
        return jax.device_get((KRKi, Kt, aff))

    def trace_all(self, target_slot: int):
        """traceOn all immature points of every other frame against the
        target frame (FullSystem::traceNewCoarse equivalent)."""
        H, W = self.cam.height, self.cam.width
        tgt = self.pyramids[target_slot][0]
        valid = np.asarray(self.state.frame_valid)
        KRKi, Kt, aff = self.all_pairs()
        for slot in range(self.state.num_frames):
            if slot == target_slot or self.immatures[slot] is None:
                continue
            if not valid[slot]:
                continue
            self.immatures[slot] = immature.trace_on(
                self.immatures[slot], tgt, KRKi[slot, target_slot],
                Kt[slot, target_slot], aff[slot, target_slot], W, H,
                huber_th=self.cfg.bundles.huber_th,
                energy_th=8 * self.cfg.immature.outlier_th,
                max_pix_search_frac=self.cfg.immature.max_pix_search)

    # ------------------------------------------------------------------
    def _activation_distance_map(self, pairs_np=None):
        """Level-1 distance map from the projections of all active points
        into the newest keyframe (CoarseDistanceMap::makeDistanceMap,
        reference src/tracking/CoarseTracker.cpp:703+)."""
        from ..ops import distance_map as dmap
        st = self.state
        H, W = self.cam.height, self.cam.width
        active = np.asarray(st.p_status) == bs.PT_ACTIVE
        uvs = np.asarray(st.p_uv)
        proj = np.array(uvs)
        if self.newest_slot >= 0:
            KRKi_all, Kt_all, _ = pairs_np or self.all_pairs()
            idp = np.asarray(st.p_idepth)
            hosts = np.asarray(st.p_host)
            for slot in range(st.num_frames):
                sel = (hosts == slot) & active
                if slot == self.newest_slot or not sel.any():
                    continue
                KRKi = KRKi_all[slot, self.newest_slot]
                Kt = Kt_all[slot, self.newest_slot]
                xyz = (KRKi @ np.stack(
                    [uvs[sel, 0], uvs[sel, 1], np.ones(sel.sum())])).T \
                    + Kt[None, :] * idp[sel, None]
                proj[sel, 0] = xyz[:, 0] / np.maximum(xyz[:, 2], 1e-6)
                proj[sel, 1] = xyz[:, 1] / np.maximum(xyz[:, 2], 1e-6)
        return dmap.coarse_distance_map(jnp.asarray(proj) * 0.5,
                                        jnp.asarray(active),
                                        H // 2, W // 2, max_dist=40)

    def activate_points(self, max_new: Optional[int] = None):
        """Promote well-traced immature points into free BA point slots
        (FullSystem::activatePointsMT equivalent: GOOD/SKIPPED status,
        quality above threshold, tight relative interval). Candidates are
        gated + ranked by the coarse distance map so activation stays
        spatially distributed, with the activation distance adapting to the
        active-point count (DSO's currentMinActivationDistance policy).

        Dispatch budget: one
        all-pairs program, one distance-map program, ONE stacked activation
        GN over every slot (vmapped), one device_get of the candidate
        fields, and one batched commit program — independent of how many
        window slots contribute points (previously ~10 device calls per
        slot per keyframe)."""
        st = self.state
        status_np = np.asarray(st.p_status)
        free = np.where(status_np == bs.PT_EMPTY)[0]
        budget = len(free) if max_new is None else min(len(free), max_new)
        if budget == 0:
            return 0

        # adapt the min activation distance to current point density:
        # DSO steps currentMinActivationDistance +-0.8/KF toward an
        # equilibrium in [0, 4]; we map the density ratio there directly
        # (same fixed point, reached immediately), so sparse windows are
        # never gated and saturated windows spread spatially.
        n_active = int((status_np == bs.PT_ACTIVE).sum())
        desired = self.cfg.selector.desired_point_density
        ratio = n_active / max(desired, 1.0)
        # the reference's [0, 4] L1-pixel range is tuned for 640-wide
        # images; scale the spacing with resolution
        res_scale = self.cam.width / 640.0
        self.min_act_dist = float(np.clip(4.0 * (ratio - 0.4) / 0.6,
                                          0.0, 4.0)) * res_scale

        F = st.num_frames
        valid_np = np.asarray(st.frame_valid)
        pairs_np = self.all_pairs()
        dist_np = np.asarray(self._activation_distance_map(pairs_np))

        live = [s for s in range(F)
                if self.immatures[s] is not None and valid_np[s]]
        if not live:
            return 0
        # ONE stacked activation GN, always over ALL F slot lanes (dead
        # slots ride along fully masked): a per-live-slot-count stack
        # would recompile the heaviest activation program up to F times
        # across a sequence
        slots = list(range(F))
        filler = self.immatures[live[0]]
        pts_list, slot_alive = [], []
        for s in slots:
            if s in live:
                pts_list.append(self.immatures[s])
                slot_alive.append(True)
            else:
                pts_list.append(filler._replace(
                    mask=jnp.zeros_like(filler.mask)))
                slot_alive.append(False)
        KRKi_np, Kt_np, aff_np = pairs_np
        pts_stack = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *pts_list)
        tmask_np = np.stack([
            (valid_np & (np.arange(F) != s)) if slot_alive[s]
            else np.zeros(F, bool) for s in slots])
        idp_all, _ = _activate_idepth_v(
            pts_stack, self.images,
            jnp.asarray(KRKi_np), jnp.asarray(Kt_np),
            jnp.asarray(aff_np), jnp.asarray(tmask_np),
            gn_iterations=self.cfg.immature.gn_its_on_activation)
        # ONE transfer of everything the host policy reads
        (status_s, quality_s, lo_s, hi_s, mask_s, uv_s, idp_s) = \
            jax.device_get((pts_stack.status, pts_stack.quality,
                            pts_stack.idepth_min, pts_stack.idepth_max,
                            pts_stack.mask, pts_stack.uv, idp_all))

        total = 0
        sel_dst, sel_host, sel_uv, sel_idp = [], [], [], []
        dh, dw = dist_np.shape
        for si, slot in enumerate(slots):
            good = mask_s[si] & np.isin(status_s[si],
                                        [immature.IPS_GOOD,
                                         immature.IPS_SKIPPED])
            good &= quality_s[si] > self.cfg.immature.min_trace_quality
            good &= np.isfinite(hi_s[si]) & (hi_s[si] > 0) \
                & ((hi_s[si] + lo_s[si]) > 0)
            cand = np.where(good)[0]
            if len(cand) == 0:
                continue
            # spatial gate by distance-map value in the newest KF
            uv_c = uv_s[si][cand]
            idp_c = 0.5 * (lo_s[si][cand] + hi_s[si][cand])
            if slot != self.newest_slot and self.newest_slot >= 0:
                KRKi = KRKi_np[slot, self.newest_slot]
                Kt = Kt_np[slot, self.newest_slot]
                xyz = (KRKi @ np.stack(
                    [uv_c[:, 0], uv_c[:, 1], np.ones(len(cand))])).T \
                    + Kt[None, :] * idp_c[:, None]
                uv_c = xyz[:, :2] / np.maximum(xyz[:, 2:3], 1e-6)
            ix = np.clip(np.round(uv_c[:, 0] * 0.5).astype(int), 0, dw - 1)
            iy = np.clip(np.round(uv_c[:, 1] * 0.5).astype(int), 0, dh - 1)
            spaced = dist_np[iy, ix] >= self.min_act_dist
            if spaced.any():
                cand = cand[spaced]
            take = cand[: budget - total]
            if len(take) == 0:
                break
            dst = free[total: total + len(take)]
            sel_dst.append(dst)
            sel_host.append(np.full(len(take), slot, np.int32))
            sel_uv.append(uv_s[si][take])
            sel_idp.append(np.maximum(idp_s[si][take], 1e-4))
            # consume the immature slots
            m = np.array(mask_s[si])
            m[take] = False
            self.immatures[slot] = self.immatures[slot]._replace(
                mask=jnp.asarray(m))
            total += len(take)
            if total >= budget:
                break
        if total == 0:
            return 0

        # ONE batched commit (colors/weights sampled device-side from the
        # stacked window images). Padded to the FULL point capacity: one
        # compile total — per-activation-count bucketing re-compiled this
        # program repeatedly through a keyframe sequence (a compile per new
        # bucket), while the padded commit's runtime cost is a [P, 8]
        # gather + scatters
        P = st.p_uv.shape[0]
        bucket = P
        pad = bucket - total
        dst_b = np.concatenate(sel_dst + [np.full(pad, P, np.int64)])
        host_b = np.concatenate(sel_host + [np.zeros(pad, np.int32)])
        uv_b = np.concatenate(sel_uv + [np.zeros((pad, 2), np.float32)])
        idp_b = np.concatenate(sel_idp + [np.ones(pad, np.float32)])
        self.state = _activate_commit_compiled(
            st, self.images, jnp.asarray(dst_b), jnp.asarray(host_b),
            jnp.asarray(uv_b), jnp.asarray(idp_b),
            outlier_th=self.cfg.bundles.outlier_th_sum_component)
        return total

    # ------------------------------------------------------------------
    def activate_seed_points(self, slot: int, uv, idp, mask,
                             prior: float = 2500.0,
                             max_new: Optional[int] = None) -> int:
        """Directly promote externally-seeded points (depth-map / MiDaS
        bootstrap) into BA point slots with an idepth prior — the analog of
        FullSystem::initializeFromInitializer creating PointHessians with
        hasDepthPrior=true (reference seeds immatures from external depth at
        ImmaturePoint.cpp:68-114; bootstrap selector MiDAS,
        src/tracking/Config.hpp:39)."""
        st = self.state
        free = np.where(np.asarray(st.p_status) == bs.PT_EMPTY)[0]
        budget = len(free) if max_new is None else min(len(free), max_new)
        ok = np.asarray(mask) & np.isfinite(np.asarray(idp)) \
            & (np.asarray(idp) > 1e-4)
        take = np.where(ok)[0][:budget]
        if len(take) == 0:
            return 0
        dst = jnp.asarray(free[: len(take)])
        uv_t = jnp.asarray(uv)[jnp.asarray(take)]
        idp_t = jnp.maximum(jnp.asarray(idp)[jnp.asarray(take)], 1e-4)

        pyr0 = self.pyramids[slot][0]
        offs = jnp.asarray(image_ops.PATTERN_DSO8, jnp.float32)
        from ..utils.interp import bilinear_3
        hit = bilinear_3(pyr0, uv_t[:, 0:1] + offs[None, :, 0],
                         uv_t[:, 1:2] + offs[None, :, 1])
        colors = hit[..., 0]
        g2 = jnp.sum(hit[..., 1:3] ** 2, -1)
        w = jnp.sqrt(self.cfg.bundles.outlier_th_sum_component
                     / (self.cfg.bundles.outlier_th_sum_component + g2))

        F = st.num_frames
        target_mask = st.frame_valid & (jnp.arange(F) != slot)
        self.state = st._replace(
            p_host=st.p_host.at[dst].set(slot),
            p_uv=st.p_uv.at[dst].set(uv_t),
            p_idepth=st.p_idepth.at[dst].set(idp_t),
            p_idepth_zero=st.p_idepth_zero.at[dst].set(idp_t),
            p_color=st.p_color.at[dst].set(colors),
            p_weight=st.p_weight.at[dst].set(w),
            p_prior=st.p_prior.at[dst].set(prior),
            p_status=st.p_status.at[dst].set(bs.PT_ACTIVE),
            r_active=st.r_active.at[dst].set(target_mask),
        )
        return len(take)

    # ------------------------------------------------------------------
    def optimize(self, iterations: Optional[int] = None):
        """Run the window BA (ba_iterate)."""
        H, W = self.cam.height, self.cam.width
        its = iterations or self.cfg.bundles.max_opt_iterations
        self.state, e, lin = energy.ba_iterate(
            self.state, self.images, H, W, iterations=its,
            lam=self.cfg.bundles.fix_lambda,
            huber_th=self.cfg.bundles.huber_th,
            outlier_th_sum=self.cfg.bundles.outlier_th_sum_component,
            orth_from_iteration=self.cfg.bundles.orthogonalize_x_from_it,
            min_iterations=self.cfg.bundles.min_opt_iterations,
            break_tol=self.cfg.bundles.opt_break_tol)
        # refresh per-frame outlier thresholds from the residual statistics
        self._update_energy_th(lin)
        return float(e), lin

    def _update_energy_th(self, lin):
        """Per-frame energy threshold from the quantile of active residual
        energies (setNewFrameEnergyTH analog; reference driver-side)."""
        e = np.asarray(lin.energy)
        v = np.asarray(lin.valid)
        th = np.asarray(self.state.frame_energy_th).copy()
        for f in range(self.state.num_frames):
            ef = e[:, f][v[:, f]]
            if len(ef) > 16:
                q = np.quantile(np.sqrt(ef), self.cfg.bundles.frame_energy_th_n)
                t = (q * self.cfg.bundles.frame_energy_th_fac_median) ** 2
                w = self.cfg.bundles.frame_energy_th_const_weight
                th[f] = w * t + (1 - w) * th[f] if np.isfinite(th[f]) \
                    else t
                th[f] = max(th[f], 8 * self.cfg.bundles.huber_th ** 2)
        self.state = self.state._replace(frame_energy_th=jnp.asarray(th))

    # ------------------------------------------------------------------
    def flag_and_marginalize(self, lin):
        """Point flagging + frame marginalization policy. Runs after BA."""
        st = self.state
        F = st.num_frames
        # DSO permanence: a residual whose projection left the frame is
        # REMOVED, not suspended (linearizeAll collects ResState::OOB into
        # toRemove -> dropResidual; Residuals.cpp applyRes). This is what
        # creates point turnover: stale points lose residuals for good,
        # fall under the support threshold, and free their slots for
        # activation from newer hosts. Without it the point set freezes at
        # capacity with the bootstrap frame hosting most of the map, and
        # that frame's eventual marginalization deletes ~70% of all active
        # points at once (the round-4 640x480 window-full collapse —
        # root-caused round 5, see tests/test_window_survival.py).
        st = st._replace(r_active=st.r_active & ~lin.oob)
        self.state = st
        valid_np = np.asarray(lin.valid & ~lin.oob)
        n_res = valid_np.sum(axis=1)
        status = np.asarray(st.p_status)
        host = np.asarray(st.p_host)
        active = status == bs.PT_ACTIVE

        # choose a frame to marginalize if above the window budget
        slots = [s for s in range(F) if bool(st.frame_valid[s])]
        marg_slot = None
        if len(slots) > self.cfg.bundles.window_size:
            support = {s: (active & (host == s)).sum() for s in slots}
            # denominator of the minPointsRemaining ratio: all point slots
            # currently hosted at s (DSO's in+out counts residuals of live
            # and dying points; dropped slots recycled to other hosts leave
            # this denominator, which only makes the rule fire *later*)
            initial = {s: max(int((host == s).sum()), 1) for s in slots}
            # don't marginalize the two newest, nor frames younger than
            # setting_minFrameAge
            by_age = sorted(slots, key=lambda s: self.frame_ids[s])
            newest_id = self.frame_ids[by_age[-1]]
            candidates = by_age[:-2] if len(by_age) > 2 else by_age[:1]
            candidates = [s for s in candidates
                          if newest_id - self.frame_ids[s]
                          >= self.cfg.bundles.min_frame_age] or candidates[:1]
            # weak frames: too few surviving points (setting_minPointsRemaining)
            # or a diverged brightness factor vs the newest frame
            # (setting_maxLogAffFacInWindow)
            aff_np = np.asarray(st.current_aff())
            exp_np = np.asarray(st.exposure)
            newest = by_age[-1]

            def log_aff_fac(s):
                return abs(float(aff_np[s, 0] - aff_np[newest, 0]
                                 + np.log(max(exp_np[s], 1e-12)
                                          / max(exp_np[newest], 1e-12))))

            weak = [s for s in candidates
                    if support[s] < self.cfg.bundles.min_points_remaining
                    * max(initial[s], 1)
                    or log_aff_fac(s)
                    > self.cfg.bundles.max_log_aff_fac_in_window]
            if weak:
                marg_slot = weak[0]
            else:
                # DSO's pairwise distance score (FullSystem::
                # flagFramesForMarginalization — the external-repo policy the
                # reference relies on): distScore(i) =
                # -sqrt(d(i, newest)) * sum_j 1/(1e-5 + d(i, j)) over the
                # older frames; marginalize the argmax — frames redundant
                # w.r.t. the spread of the window go first
                T = st.current_poses()
                R_wc = np.swapaxes(np.asarray(T.R), -1, -2)
                t_wc = -np.einsum("fij,fj->fi", R_wc, np.asarray(T.t))
                newest = self.newest_slot
                others = [s for s in slots if s != newest]
                best = -np.inf
                for i in candidates:
                    ssum = sum(1.0 / (1e-5 + np.linalg.norm(t_wc[i] - t_wc[j]))
                               for j in others if j != i)
                    sc = -np.sqrt(np.linalg.norm(t_wc[i] - t_wc[newest])) * ssum
                    if sc > best:
                        best, marg_slot = sc, i

        # point flags: drop points with NO surviving residuals (DSO drops
        # at residuals.size()==0 / ngoodres==0, FullSystem removeOutliers +
        # resubstituteFPt guard; a >=2 threshold killed legitimately-thin
        # maps in small windows, e.g. the 26-point post-reset bootstrap
        # where every point has only 2 possible targets)
        new_status = status.copy()
        drop = active & (n_res < 1)
        new_status[drop] = bs.PT_DROP
        if marg_slot is not None:
            of_frame = active & (host == marg_slot)
            # well-constrained points of the dying frame -> marginalize,
            # poorly-constrained -> drop (isOOB/isInlierNew split;
            # floor = min_good_res_for_marg, see config.py note)
            n_marg = self.cfg.bundles.min_good_res_for_marg
            new_status[of_frame & (n_res >= n_marg)] = bs.PT_MARGINALIZE
            new_status[of_frame & (n_res < n_marg)] = bs.PT_DROP

        # drops: just free the slots
        dropped = new_status == bs.PT_DROP
        new_status[dropped] = bs.PT_EMPTY
        st = st._replace(p_status=jnp.asarray(new_status),
                         r_active=st.r_active
                         & ~jnp.asarray(dropped)[:, None])
        self.state = st

        H, W = self.cam.height, self.cam.width
        if (np.asarray(self.state.p_status) == bs.PT_MARGINALIZE).any():
            self.state = _marg_points_compiled(
                self.state, self.images,
                jnp.float32(self.cfg.bundles.marg_weight_fac),
                jnp.float32(self.cfg.bundles.idepth_fix_prior_marg_fac),
                jnp.float32(self.cfg.bundles.huber_th),
                height=H, width=W)

        if marg_slot is not None:
            self.state = _marg_frame_compiled(self.state, slot=marg_slot)
            self.immatures[marg_slot] = None
            self.frame_ids[marg_slot] = -1
            self.marg_count += 1
        return marg_slot

    # ------------------------------------------------------------------
    def rebuild_coarse_template(self):
        """Project active points into the newest KF and rebuild the coarse
        tracking templates (CoarseTracker::setCoarseTrackingRef). Two
        dispatches: the fused projection + the template build."""
        slot = self.newest_slot
        cam_vec = jnp.asarray([self.cam.fx, self.cam.fy, self.cam.cx,
                               self.cam.cy], jnp.float32)
        uv, idn, ok = _project_active_to_newest(
            self.state, cam_vec, slot, height=self.cam.height,
            width=self.cam.width)
        caps = tuple(min(8192 >> l, max(1,
                     (self.cam.height >> l) * (self.cam.width >> l)))
                     for l in range(self.cfg.coarse.pyr_levels))
        self.coarse_templates = _build_template_compiled(
            uv, idn, jnp.ones_like(idn), ok, self.pyramids[slot], caps=caps)

    def track_frame(self, img, pose_init: SE3, aff_init=(0.0, 0.0),
                    exposure: float = 1.0):
        """Coarse-track a non-KF frame against the newest keyframe.
        Returns (TrackResult, T_wc of the frame)."""
        pyr = self._pyramid(img)
        cams = [Pinhole(self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
                        self.cam.width, self.cam.height).pyramid_level(l)
                for l in range(self.cfg.coarse.pyr_levels)]
        return _track_frame_compiled(
            self.state, self.newest_slot, self.coarse_templates, pyr, cams,
            pose_init, jnp.asarray(aff_init, jnp.float32),
            jnp.asarray(exposure, jnp.float32),
            # abort thresholds disabled at the kernel level: DSO uses the
            # achieved residuals to widen/terminate the HYPOTHESIS ladder
            # (a policy the pipeline implements host-side), not as a hard
            # cross-frame failure gate
            jnp.full((self.cfg.coarse.pyr_levels,), 1e9, jnp.float32),
            max_iterations=tuple(self.cfg.coarse.max_iterations),
            huber_th=self.cfg.coarse.huber_th,
            cutoff_th=self.cfg.coarse.coarse_cutoff_th)

    def need_new_kf(self, track_res) -> bool:
        """DSO keyframe decision from flow indicators + affine change
        (setting_maxShiftWeight*, settings.cpp:38-42)."""
        w, h = self.cam.width, self.cam.height
        cfg = self.cfg.bundles
        fi = np.asarray(track_res.flow_indicators)
        a = np.asarray(track_res.aff)
        norm = (640 + 480) / (w + h)
        wT = cfg.max_shift_weight_t * norm
        wR = cfg.max_shift_weight_r * norm
        wRT = cfg.max_shift_weight_rt * norm
        # affine term: |log(e^{a})| = |a| (writing log(exp(a)) overflows to
        # -inf for a diverged affine estimate; reference takes the log of the
        # relative multiplier, CoarseTracker-based score in FullSystem)
        score = cfg.kf_global_weight * (
            wT * np.sqrt(max(fi[0], 0.0))
            + wR * np.sqrt(max(fi[1], 0.0))
            + wRT * np.sqrt(max(fi[2], 0.0))
            + cfg.max_affine_weight * abs(float(a[0])))
        return bool(score > 1.0)
