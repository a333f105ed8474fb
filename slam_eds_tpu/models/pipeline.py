"""End-to-end pipelines: the frame-only DSO slice and the full EDS loop.

The reference ships no main loop (the orogen task is external, SURVEY §0);
these drivers reproduce its reconstructed call stacks (SURVEY §3):

* ``FrameOnlyPipeline`` — BASELINE config 1: two-view bootstrap -> coarse
  tracking of every frame against the newest KF -> keyframe promotion ->
  immature tracing -> point activation -> sliding-window photometric BA
  with point/frame marginalization (call stack §3.3).
* ``EDSPipeline`` — config 3: the event front-end (§3.1: event frame ->
  event-to-model alignment -> depth filter -> KF promotion) running against
  keyframes produced and refined by the frame backend.

Host Python owns sequencing (inherently serial, mirroring the external
task); every numeric step is a jitted kernel.
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
from ..utils import klt
from ..utils import image as image_ops
from ..ops import initializer, event_tracker as et, depth_filter as df
from ..ops.pixel_selector import candidate_points_grid
from . import keyframe as kfm
from .event_frame import create_event_frame
from .window import WindowManager
from ..telemetry import Telemetry
from ..utils.precision import full_f32

from functools import partial as _partial


def _tree_where(cond, a, b):
    """Element-wise select over a pytree (cond scalar bool)."""
    import jax
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(cond, x, y), a, b)


@_partial(jax.jit, static_argnames=(
    "height", "width", "num_levels", "use_time_weights", "blur_ksize",
    "interpolation", "loss_kind", "refinement", "patch_radius",
    "refine_levels", "do_points_refinement"))
def _event_packet_fused(tracker_state, pose_filter, depth, cam,
                        kf_pose_R, kf_pose_t, frame_pred_R, frame_pred_t,
                        kf_uv, kf_nc, kf_grad,
                        kf_idp, kf_weight, kf_mask,
                        xs, ys, ts, ps, n_valid, fwd_maps,
                        iters_per_level, loss_scale, lim, *,
                        height, width,
                        num_levels, use_time_weights, blur_ksize,
                        interpolation, loss_kind, refinement, patch_radius,
                        refine_levels, do_points_refinement):
    """The entire per-packet event step (SURVEY call stack §3.1) as ONE
    jitted program: event-frame rasterization -> coarse-to-fine
    event-to-model solve -> solution-usability gate -> pose-filter push ->
    warp + optional track refinement -> Vogiatzis depth update -> KF-need
    statistics.

    Rationale: the host orchestration of this path previously issued ~100
    small dispatches per packet, each with its own launch and host
    round-trip; one dispatch per packet makes that cost O(1).

    The usability gate (Tracker.cpp:217-240) runs device-side: when the
    pose step exceeds the configured bounds every state update is selected
    back to its input (the host reads the `usable` flag from the scalar
    vector for telemetry/KF policy only).

    lim: dict of traced scalars {mu_range, px_noise, max_step_t,
    max_step_r, activity_th, search_range, consistency_px}.
    Returns (state, pose_filter, depth, mask, tracks, residuals,
    scalars [usable, energy, loss_scale, n_iter, flow, alive_count,
    ef_time, med_depth], T_w_ef_R, T_w_ef_t, vx).
    """
    from ..utils.stats import masked_median
    H, W = height, width
    ef = create_event_frame(
        xs, ys, ts, ps, n_valid, H, W, num_levels=num_levels,
        fwd_maps=fwd_maps, use_time_weights=use_time_weights,
        blur_ksize=blur_ksize, interpolation=interpolation)
    prev = tracker_state
    # clamp to the configured scene range: during a divergence episode the
    # keyframe's depth estimates can explode, and an unbounded med_depth
    # voids the translation gate exactly when it is needed
    med_depth = jnp.clip(
        masked_median(1.0 / jnp.maximum(kf_idp, 1e-6), kf_mask),
        lim["min_depth"], lim["max_depth"])

    def solve_from(st0):
        return et._pyramid_fused(st0, ef.frames, cam, kf_nc, kf_grad,
                                 kf_idp, kf_weight, kf_mask,
                                 iters_per_level, loss_kind, loss_scale,
                                 False)

    def gate(res):
        # solution-usability (Tracker.cpp:217-240): translation bound
        # relative to median scene depth (monocular scale is arbitrary),
        # rotation absolute
        dT = et.pose_kf_ef(res.state).compose(et.pose_kf_ef(prev).inverse())
        d_tau = dT.log()
        return (jnp.isfinite(res.energy)
                & jnp.all(jnp.isfinite(d_tau))
                & (jnp.linalg.norm(d_tau[:3])
                   < lim["max_step_t"] * med_depth)
                & (jnp.linalg.norm(d_tau[3:]) < lim["max_step_r"]))

    res = solve_from(prev)
    usable1 = gate(res)
    # retry ladder (the event-path analog of the frame tracker's
    # motion-hypothesis list): a diverged warm start is re-solved from the
    # frame tracker's pose prediction (T_ef_kf = T_cw_frame o T_w_kf — the
    # reference's driver re-seeds the event tracker from the frame pose
    # the same way), then from the keyframe pose (identity). lax.cond
    # makes both retries free when the earlier solve passes the gate.
    from ..utils import lie as _lie
    pred_R = frame_pred_R @ kf_pose_R
    pred_t = frame_pred_R @ kf_pose_t + frame_pred_t
    res = jax.lax.cond(
        usable1, lambda _: res,
        lambda _: solve_from(prev._replace(
            px=pred_t, qx=_lie.mat_to_quat(pred_R))),
        None)
    usable2 = usable1 | gate(res)
    res = jax.lax.cond(
        usable2, lambda _: res,
        lambda _: solve_from(prev._replace(
            px=jnp.zeros(3, kf_uv.dtype),
            qx=jnp.asarray([1.0, 0.0, 0.0, 0.0], kf_uv.dtype))),
        None)
    usable = usable2 | gate(res)

    new_state = _tree_where(usable, res.state, prev)
    pf_pushed = et.pose_filter_push(pose_filter, et.pose_kf_ef(res.state))
    new_pf = _tree_where(usable, pf_pushed, pose_filter)
    T_kf_ef_s = et.pose_filter_mean(new_pf)
    T_w_ef = SE3(kf_pose_R, kf_pose_t).compose(T_kf_ef_s)

    # warp + config-gated track refinement (Tracker.cpp:378-553)
    uv_ef, alive = et.warp_coords(res.state, cam, kf_nc, kf_idp, kf_mask)
    if refinement in ("klt", "klt_pyr"):
        delta, _ = et.refine_tracks_klt(
            ef.frames[0], uv_ef, kf_grad, alive, patch_radius=patch_radius,
            num_levels=(refine_levels if refinement == "klt_pyr" else 1))
        uv_ef = uv_ef + delta
    elif refinement == "model_klt":
        from ..ops.event_tracker import compute_flow as _cflow
        flow_m = _cflow(kf_nc, res.state.vx, kf_idp)
        model = -(kf_grad[:, 0] * flow_m[:, 0] + kf_grad[:, 1] * flow_m[:, 1])
        model = jnp.where(kf_mask, model, 0.0)
        model = model / jnp.sqrt(1e-3 + jnp.sum(model * model))
        delta, _ = et.refine_tracks_model_klt(
            ef.frames[0], uv_ef, model, alive, patch_radius=patch_radius)
        uv_ef = uv_ef + delta
    elif refinement == "epiline":
        from ..ops.event_tracker import compute_flow as _cflow
        flow_m = _cflow(kf_nc, res.state.vx, kf_idp)
        model = -(kf_grad[:, 0] * flow_m[:, 0] + kf_grad[:, 1] * flow_m[:, 1])
        model = jnp.where(kf_mask, model, 0.0)
        model = model / jnp.sqrt(1e-3 + jnp.sum(model * model))
        uv_ef, alive = et.refine_tracks_epiline(
            ef.frames[0], kf_uv, uv_ef, model, alive,
            et.pose_kf_ef(res.state), cam, patch_radius=patch_radius,
            search_range=lim["search_range"],
            consistency_px=lim["consistency_px"])
    tracks = uv_ef - kf_uv

    T_kf_ef = et.pose_kf_ef(res.state)
    depth_new = df.update(depth, T_kf_ef, kf_uv, tracks, cam,
                          mu_range=lim["mu_range"],
                          px_noise=lim["px_noise"], mask=alive)
    mask_new = alive
    if do_points_refinement:
        # drop points without nearby event activity (pointsRefinement,
        # KeyFrame.cpp:1031-1058)
        offs = jnp.arange(-2, 3, dtype=kf_uv.dtype)
        dy, dx = jnp.meshgrid(offs, offs, indexing="ij")
        from ..utils.interp import bilinear
        act = jnp.max(jnp.abs(bilinear(
            ef.frames[0], kf_uv[:, 0:1] + dx.ravel()[None, :],
            kf_uv[:, 1:2] + dy.ravel()[None, :])), axis=-1)
        mask_new = mask_new & (act > lim["activity_th"])

    depth_out = _tree_where(usable, depth_new, depth)
    mask_out = jnp.where(usable, mask_new, kf_mask)
    flow = et.mean_flow_magnitude(uv_ef, kf_uv, alive)
    scalars = jnp.stack([
        usable.astype(jnp.float32), res.energy,
        res.loss_scale.astype(jnp.float32),
        res.n_iter.astype(jnp.float32), flow,
        jnp.sum(mask_out).astype(jnp.float32),
        ef.time.astype(jnp.float32), med_depth])
    return (new_state, new_pf, depth_out, mask_out, tracks, res.residuals,
            scalars, T_w_ef.R, T_w_ef.t, res.state.vx)


@dataclass
class FrameOnlyPipeline:
    cam: Pinhole
    cfg: EDSConfig = field(default_factory=EDSConfig)
    # optional PhotometricCalib: its response-derivative table weights the
    # pixel selector's gradient maps (HessianBlocks::makeImages gamma path)
    photometric: object = None

    def __post_init__(self):
        bgrad = (self.photometric.b_grad_table()
                 if self.photometric is not None else None)
        self.window = WindowManager(self.cam, self.cfg,
                                    photometric_bgrad=bgrad)
        self.trajectory: List[np.ndarray] = []   # camToWorld translations
        self.poses: List[SE3] = []               # worldToCam per frame
        self.times: List[float] = []             # frame timestamp per entry
        self.telemetry = Telemetry()
        self._boot_img = None
        self._boot_time = None
        self._init_state = None      # DSO-style CoarseInitializer state
        self._initialized = False
        self._last_pose = SE3.identity()
        self._last_good_pose = SE3.identity()  # last OK-tracked pose
        self._motion = SE3.identity()   # last frame-to-frame relative motion
        self._frames_since_kf = 0
        self._lost = False              # explicit lost state (DSO isLost)
        self._lost_frames = 0           # consecutive lost frames
        self._last_rms = float("inf")   # finest-level residual of last OK
        self._first_rms = None          # finest rms of FIRST track on this KF
        self._resets = 0                # full-reset generation counter
        self._world_anchor = SE3.identity()  # segment start (worldToCam)

    # ------------------------------------------------------------------
    def _full_reset(self):
        """Full visual reset (the reference's setting_fullResetRequested,
        src/utils/settings.h:170): after a persistent tracking loss the
        window/map is discarded and the pipeline re-bootstraps from the
        next frames. The new segment is anchored at the last held pose so
        the exported trajectory stays continuous (a relocalized system
        cannot recover the drift accumulated during the outage; it can
        avoid teleporting to the origin). The anchor is the last pose an
        OK track produced — the constant-velocity hold can run away to
        absurd magnitudes during a long outage, and a non-finite anchor
        would poison every post-reset pose."""
        anchor = self._last_good_pose
        if not np.isfinite(np.asarray(anchor.t)).all() or \
                float(jnp.linalg.norm(anchor.t)) > 1e6:
            anchor = SE3.identity()
        self._world_anchor = anchor
        prev_margs = self.window.marg_count
        self.window = WindowManager(
            self.cam, self.cfg,
            photometric_bgrad=self.window.photometric_bgrad)
        self.window.marg_count = prev_margs   # lifetime counter
        self._boot_img = None
        self._boot_time = None
        self._init_state = None
        self._initialized = False
        self._lost = False
        self._lost_frames = 0
        self._last_rms = float("inf")
        self._first_rms = None
        self._motion = SE3.identity()
        self._frames_since_kf = 0
        self._resets += 1
        self.telemetry.counters["full_resets"] = \
            self.telemetry.counters.get("full_resets", 0) + 1

    def _record_boot(self, pairs):
        """Record bootstrap (time, worldToCam) entries. The first bootstrap
        replaces the pending placeholders (original semantics, keeps the
        ATE associator's timestamp bookkeeping); post-reset bootstraps
        append so the pre-outage trajectory is preserved."""
        if self._resets == 0:
            self.poses, self.trajectory, self.times = [], [], []
        for tt, TT in pairs:
            if self._resets > 0 and self.times and tt <= self.times[-1]:
                continue      # anchor frame already recorded as held pose
            self.poses.append(TT)
            self.trajectory.append(np.asarray(TT.inverse().t))
            self.times.append(tt)

    def _record_pending(self, time: float):
        """Bookkeeping for frames consumed while waiting for a bootstrap."""
        if self._resets == 0:
            self.poses = self.poses or [SE3.identity()]
            self.trajectory = self.trajectory or [np.zeros(3)]
            self.times = [time]
        else:
            self.poses.append(self._last_pose)
            self.trajectory.append(np.asarray(self._last_pose.inverse().t))
            self.times.append(time)

    # ------------------------------------------------------------------
    def _bootstrap(self, img0, t0, img1, t1) -> bool:
        """Two-view bootstrap (KLT tracks + batched-RANSAC essential matrix,
        reference path B, KeyFrame::initialStructure)."""
        g0 = jnp.asarray(img0, jnp.float32)
        g1 = jnp.asarray(img1, jnp.float32)
        gx, gy = image_ops.sobel(g0, 3)
        gmag = image_ops.gradient_magnitude(gx, gy)
        uv0, mask = candidate_points_grid(gmag, patch=8, capacity=512)
        # 4 pyramid levels at full resolution: the boot pair can carry
        # 20+ px of flow when the parallax gate holds the first frame
        # through a fast segment (re-bootstrapping after a reset); 3
        # levels lost most tracks there. Small images keep 3 — a 4th
        # level of a 96-px-tall frame is a 12-px thumbnail that degrades
        # the track instead
        n_lvl = 4 if min(g0.shape) >= 240 else 3
        pyr0 = [l[..., 0] for l in image_ops.build_pyramid(g0, n_lvl)[0]]
        pyr1 = [l[..., 0] for l in image_ops.build_pyramid(g1, n_lvl)[0]]
        uv1, ok, _ = klt.klt_track_pyramid(pyr0, pyr1, uv0)
        m = mask & ok
        # baseline overrun: ample parallax but the pair has drifted beyond
        # what KLT can bridge (track survival collapsed) — fail so the
        # caller re-anchors the pair at the current frame (the DSO
        # initializer's setFirst-again behavior when tracking breaks)
        n_cand = float(jnp.sum(mask))
        if n_cand > 0 and float(jnp.sum(m)) < 0.2 * n_cand:
            return False

        # parallax gate (the eight-point analog of the DSO initializer's
        # 'snapped' criterion, CoarseInitializer.cpp:204-261): an
        # essential matrix fit to sub-pixel flow is pure noise and its
        # recovered unit baseline seeds a garbage scale that the window
        # never recovers from (observed: idepth medians drifting 0.9->7
        # before total map collapse on a slow sequence). Keep waiting
        # until the median tracked displacement carries real parallax.
        disp = jnp.linalg.norm(uv1 - uv0, axis=-1)
        from ..utils.stats import masked_median
        med_disp = float(masked_median(disp, m))
        if med_disp < self.cfg.initializer.min_bootstrap_parallax_px:
            return "wait"     # hold the anchor; parallax will accumulate

        nc0 = jnp.stack([(uv0[:, 0] - self.cam.cx) / self.cam.fx,
                         (uv0[:, 1] - self.cam.cy) / self.cam.fy], -1)
        nc1 = jnp.stack([(uv1[:, 0] - self.cam.cx) / self.cam.fx,
                         (uv1[:, 1] - self.cam.cy) / self.cam.fy], -1)
        res = initializer.bootstrap_eight_point(nc0, nc1, m)
        if not bool(res.success):
            return False
        if int(jnp.sum(res.inliers)) < self.cfg.initializer.min_inliers:
            return False

        # canonicalize the monocular scale: median seed idepth -> 1 (the
        # DSO initializer applies the same rescale). The raw two-view
        # triangulation carries degenerate tails (observed idepth spreads
        # of 1e-4..1e2 on near-epipole tracks) whose immature intervals
        # trace straight to OOB and can starve activation; after the
        # rescale, seeds outside a generous band are dropped.
        from ..utils.stats import masked_median as _mmed
        med_idp = jnp.maximum(_mmed(res.idepth, res.inliers), 1e-6)
        seed_uv = uv0
        seed_idp = res.idepth / med_idp
        seed_mask = res.inliers & (seed_idp > 0.05) & (seed_idp < 20.0)
        # scaling depths by 1/med requires scaling the baseline the same
        # way to keep reprojections identical: X2 = R X1 + t with
        # z' = z * med  =>  t' = t * med
        T_21 = SE3(res.T_21.R, res.T_21.t * med_idp)
        anchor = self._world_anchor
        T1 = T_21.compose(anchor)
        self.window.insert_frame(img0, anchor, t0, is_first=True,
                                 immature_seed=(seed_uv, seed_idp, seed_mask))
        self.window.insert_frame(img1, T1, t1, immature_seed=None)
        self.window.trace_all(self.window.newest_slot)
        n_act = self.window.activate_points()
        # degenerate structure (inliers passed but almost nothing traced /
        # activated): a tens-of-points map collapses immediately — discard
        # the window and keep waiting for a better pair. Floor scales with
        # the configured budget (a 28-point bootstrap at a 2048 budget was
        # observed to lose tracking within two frames)
        if n_act < max(16, 0.05 * self.cfg.caps.max_points_per_kf):
            margs, kfs = self.window.marg_count, self.window.next_id
            self.window = WindowManager(
                self.cam, self.cfg,
                photometric_bgrad=self.window.photometric_bgrad)
            self.window.marg_count = margs   # lifetime counters
            self.window.next_id = kfs
            return False
        self.window.optimize()
        self.window.rebuild_coarse_template()
        self._last_pose = T1
        self._record_boot([(t0, anchor), (t1, T1)])
        self._initialized = True
        return True

    # ------------------------------------------------------------------
    def _bootstrap_dso(self, img, time: float) -> bool:
        """DSO-style pyramid initializer (reference path A,
        src/init/CoarseInitializer.cpp via ops.coarse_init): accumulate
        frames until the joint pose+idepth solve 'snaps', then seed the
        window from the level-0 structure."""
        from ..ops import coarse_init as ci
        n_lvl = self.cfg.initializer.pyr_levels
        pyr, _ = image_ops.build_pyramid(jnp.asarray(img, jnp.float32),
                                         n_lvl)
        if self._init_state is None:
            self._init_state = ci.set_first(pyr)
            self._boot_img = img
            self._boot_time = time
            return False
        self._init_state, done = ci.track_frame(self._init_state, pyr,
                                                self.cam)
        if not done:
            return False
        T_10, uv0, idp0, okm = ci.extract_result(self._init_state)
        anchor = self._world_anchor
        T1 = T_10.compose(anchor)
        self.window.insert_frame(self._boot_img, anchor,
                                 self._boot_time, is_first=True,
                                 immature_seed=(uv0, idp0, okm))
        self.window.insert_frame(img, T1, time, immature_seed=None)
        self.window.trace_all(self.window.newest_slot)
        self.window.activate_points()
        self.window.optimize()
        self.window.rebuild_coarse_template()
        self._last_pose = T1
        self._record_boot([(self._boot_time, anchor), (time, T1)])
        self._initialized = True
        return True

    # ------------------------------------------------------------------
    def _bootstrap_depthmap(self, img, time: float, depth_map) -> bool:
        """Depth-map bootstrap (reference path C, ``MiDAS`` selector,
        src/tracking/Config.hpp:39): an externally-supplied monocular depth
        (e.g. a MiDaS net output) seeds the first keyframe's structure
        directly — immatures via the depth ctor (ImmaturePoint.cpp:68-114)
        and active points with an idepth prior — so tracking starts from
        frame one without any two-view parallax."""
        g0 = jnp.asarray(img, jnp.float32)
        if isinstance(depth_map, tuple):
            uv, idp, mask = depth_map           # sparse IDepthMap form
        else:                                    # dense [H, W] depth image
            gx, gy = image_ops.sobel(g0, 3)
            gmag = image_ops.gradient_magnitude(gx, gy)
            uv, mask = candidate_points_grid(
                gmag, patch=8, capacity=self.cfg.caps.max_points_per_kf)
            d = jnp.asarray(depth_map, jnp.float32)
            ui = jnp.clip(uv[:, 0].astype(jnp.int32), 0, d.shape[1] - 1)
            vi = jnp.clip(uv[:, 1].astype(jnp.int32), 0, d.shape[0] - 1)
            z = d[vi, ui]
            mask = mask & jnp.isfinite(z) & (z > 1e-3)
            idp = 1.0 / jnp.maximum(z, 1e-3)
        anchor = self._world_anchor
        slot = self.window.insert_frame(img, anchor, time,
                                        is_first=True,
                                        immature_seed=(uv, idp, mask))
        n = self.window.activate_seed_points(
            slot, uv, idp, mask, prior=self.cfg.bundles.idepth_fix_prior)
        if n < 16:
            return False
        self.window.rebuild_coarse_template()
        self._last_pose = anchor
        self._record_boot([(time, anchor)])
        self._initialized = True
        return True

    # ------------------------------------------------------------------
    @full_f32
    def process_frame(self, img, time: float, depth_map=None):
        """Feed one grayscale frame; returns the worldToCam pose estimate.

        depth_map: optional external depth for the ``midas`` bootstrap —
        dense [H, W] metric depth or a sparse (uv [N,2], idepth [N],
        mask [N]) tuple."""
        if not self._initialized:
            held = self._world_anchor     # identity for the first segment
            if self.cfg.tracker.bootstrap == "midas":
                if depth_map is not None and \
                        self._bootstrap_depthmap(img, time, depth_map):
                    return self._last_pose
                # no depth yet: hold at the anchor until one arrives
                self._record_pending(time)
                return held
            if self.cfg.tracker.bootstrap == "dso":
                ok = self._bootstrap_dso(img, time)
                if not ok:
                    self._record_pending(time)
                    return held
                return self._last_pose
            if self._boot_img is None:
                self._boot_img = img
                self._boot_time = time
                self._record_pending(time)
                return held
            ok = self._bootstrap(self._boot_img, self._boot_time, img, time)
            if ok == "wait":
                # low parallax: HOLD the anchor so baseline accumulates
                # (sliding it would keep the pair one frame apart forever
                # on a slow sequence)
                if self._resets == 0:
                    self.times = [time]
                else:
                    self._record_pending(time)
                return held
            if not ok:
                # estimation failed on this pair: re-anchor at the newest
                # frame; the held pose now refers to this frame's time
                self._boot_img = img
                self._boot_time = time
                if self._resets == 0:
                    self.times = [time]
                else:
                    self._record_pending(time)
                return held
            return self._last_pose

        # DSO-style motion-hypothesis try-list (FullSystem::trackNewFrame):
        # zero motion first (primary — the event tracker usually seeds
        # _last_pose at packet rate, making extrapolation redundant), then
        # constant-velocity and half-motion retries; on total failure keep
        # the prediction instead of adopting a diverged solve (the tracker's
        # ok flag covers residual aborts and the affine sanity gates,
        # CoarseTracker.cpp:685-698).
        half = SE3.exp(0.5 * self._motion.log())
        preds = [self._last_pose,
                 self._motion.compose(self._last_pose),
                 half.compose(self._last_pose)]
        if self._lost:
            # relocalization hypothesis (DSO's try-list widens with
            # re-lock attempts once tracking is lost): the constant-
            # velocity hold drifts during an outage, so also try tracking
            # from the newest keyframe's own pose — the map is still good
            # even when the prediction is not
            w = self.window
            T = w.state.current_poses()
            s = w.newest_slot
            preds.append(SE3(T.R[s], T.t[s]))
        # DSO's re-track policy (achievedRes / lastCoarseRMSE): the first
        # OK hypothesis is accepted outright only when its finest-level
        # residual stays within 1.5x the previous frame's; otherwise the
        # remaining hypotheses are tried too and the best OK one wins —
        # a spuriously-converged local minimum (observed at 640x480: a
        # |t|~0.24 jump on a ~0.02 true motion) rarely beats a hypothesis
        # started from the correct basin.
        res = T_wc = None
        best = None
        for pred in preds:
            r, T = self.window.track_frame(img, pred)
            if not bool(r.ok):
                if res is None:
                    res, T_wc = r, T     # keep something for telemetry
                continue
            r0 = float(r.residuals[0])
            if best is None or r0 < best[2]:
                best = (r, T, r0)
            if r0 <= 1.5 * self._last_rms:
                break
        if best is not None:
            res, T_wc = best[0], best[1]
            # residual acceptance bound (the trackingIsGood check DSO's
            # FullSystem applies on achievedRes): the coarse tracker's
            # robust cutoff saturates per-pixel residuals at cutoff_th, so
            # a "converged" fit whose rms sits at the cutoff has aligned
            # nothing (white-noise frames produce exactly this and can
            # slip past the geometric/affine gates via the relocalization
            # hypotheses). Residual near the saturation level = failure.
            if best[2] > 0.75 * self.cfg.coarse.coarse_cutoff_th:
                res = res._replace(ok=jnp.asarray(False))
        if bool(res.ok):
            self._motion = T_wc.compose(self._last_pose.inverse())
            self._lost = False
            self._lost_frames = 0
            self._last_good_pose = T_wc
            self._last_rms = best[2]
            if self._first_rms is None:
                self._first_rms = best[2]
        else:
            # pure hold while lost (reference DSO sets isLost and stops
            # publishing). Advancing by _motion compounded: one spurious
            # accept makes |t_motion| ~ |t_last| and the held pose then
            # doubles every frame (observed exponential runaway to 1e3+
            # before the reset fired). The hypothesis ladder still spreads
            # through _motion; the published pose stays put.
            T_wc = self._last_pose
            self._lost = True
            self._lost_frames += 1
            self.telemetry.counters["track_lost"] = \
                self.telemetry.counters.get("track_lost", 0) + 1
        self.telemetry.frame(ok=bool(res.ok))
        self._last_pose = T_wc
        self.poses.append(T_wc)
        self.trajectory.append(np.asarray(T_wc.inverse().t))
        self.times.append(time)
        self._frames_since_kf += 1

        # no keyframe while lost: need_new_kf(res) would consume the diverged
        # hypothesis's flow/affine stats and the KF would pin an unverified
        # pose into the window — defer until a track with res.ok succeeds
        # DSO's third keyframe trigger (FullSystem::makeNonKeyFrame
        # decision): promote when the finest-level tracking residual has
        # doubled vs the FIRST frame tracked against this keyframe
        # (2*firstCoarseRMSE < tres[0]). Without it, fast sequence
        # segments degrade the track to rms ~10+ between flow-triggered
        # keyframes, new KFs then enter the window with bad poses, and the
        # BA energy balloons (the round-5 degradation trail leading into
        # the 640x480 collapse).
        # absolute floor: doubling a noise-level residual (tiny images,
        # well-textured scenes track at rms ~1) is not degradation — only
        # promote when the residual is also materially large
        rms_doubled = (bool(res.ok) and self._first_rms is not None
                       and self._last_rms > 2.0 * self._first_rms
                       and self._last_rms > 4.0)
        make_kf = (not self._lost) and (
            self.window.need_new_kf(res)
            or rms_doubled
            or self._frames_since_kf >= self.cfg.bundles.min_frames)
        if make_kf:
            self._add_keyframe(img, T_wc, time, res)
            self._frames_since_kf = 0
            self._first_rms = None     # re-anchor on the new keyframe
        elif self._lost and self._lost_frames \
                >= self.cfg.coarse.full_reset_lost_frames:
            # persistent loss: discard the window and re-bootstrap
            # (setting_fullResetRequested analog; see _full_reset)
            self._full_reset()
        return T_wc

    def _add_keyframe(self, img, T_wc: SE3, time: float, track_res):
        w = self.window
        if w.num_active_frames >= w.cfg.caps.max_window_frames:
            # should not happen (marginalization keeps a free slot)
            pass
        aff = tuple(np.asarray(track_res.aff)) if bool(track_res.ok) \
            else (0.0, 0.0)
        slot = w.insert_frame(img, T_wc, time, aff=aff)
        w.trace_all(slot)
        w.activate_points()
        e, lin = w.optimize()
        self.telemetry.ba(energy=e)
        w.flag_and_marginalize(lin)
        # Marginalizing a frame removes its hosted points from the active
        # set. When the dying frame hosted a large share of the map (the
        # bootstrap keyframe starts with all of it), refill from the
        # surviving frames' immature points BEFORE rebuilding the tracking
        # template, so the tracker never sees the hole — DSO reaches the
        # same equilibrium through activatePointsMT's density control at
        # the next keyframe, but at 640x480 the one-keyframe gap was
        # enough to lose tracking (round-5 collapse root cause).
        from . import ba_state as _bs
        n_act = int((np.asarray(w.state.p_status) == _bs.PT_ACTIVE).sum())
        if n_act < 0.7 * self.cfg.caps.max_points_per_kf:
            w.activate_points()
        w.rebuild_coarse_template()
        # tracking reference pose may have been refined by BA
        st = w.state
        T = st.current_poses()
        self._last_pose = SE3(T.R[w.newest_slot], T.t[w.newest_slot])

    # ------------------------------------------------------------------
    def positions(self):
        return np.stack(self.trajectory)


@dataclass
class EDSPipeline:
    """Full event-aided loop: the event front-end tracks pose against the
    newest keyframe's generative model at packet rate; frames keep the DSO
    backend (window BA) alive and provide keyframe images."""
    cam: Pinhole
    cfg: EDSConfig = field(default_factory=EDSConfig)
    photometric: object = None

    def __post_init__(self):
        self.frame_pipe = FrameOnlyPipeline(self.cam, self.cfg,
                                            photometric=self.photometric)
        self.kf: Optional[kfm.KeyFrame] = None
        self.depth: Optional[df.DepthFilterState] = None
        self.tracker_state = et.initial_tracker_state()
        self.loss_scale = self.cfg.tracker.loss.param
        self.pose_filter = et.pose_filter_init(
            self.cfg.tracker.pose_filter_window)
        self.event_poses: List[np.ndarray] = []   # (time, camToWorld t)
        self.event_pose_list: List[SE3] = []
        self.telemetry = Telemetry()
        self._pending_kf = False
        self._seen_resets = 0
        self.num_event_kfs = 0
        self.recorder = None
        if self.cfg.recorder.enabled:
            from ..io.recorder import Recorder
            self.recorder = Recorder(self.cfg.recorder)

    # ------------------------------------------------------------------
    @full_f32
    def process_frame(self, img, time: float, depth_map=None):
        T_wc = self.frame_pipe.process_frame(img, time, depth_map=depth_map)
        if self.frame_pipe._resets != self._seen_resets:
            # the frame backend performed a full reset: the event keyframe
            # and its depth filter refer to the discarded map
            self._seen_resets = self.frame_pipe._resets
            self.kf = None
            self.depth = None
            self.tracker_state = et.initial_tracker_state()
            self.pose_filter = et.pose_filter_init(
                self.cfg.tracker.pose_filter_window)
        if self.frame_pipe._initialized and (self.kf is None
                                             or self._pending_kf):
            self._make_event_keyframe(img, time, T_wc)
            self._pending_kf = False
        return T_wc

    def _ba_seed_points(self, T_wc: SE3):
        """Project the BA window's active points into the new keyframe
        (sparse IDepthMap seed, mapping/Types.hpp IDepthMap-from-pointcloud
        path). Returns (uv [P,2], idp [P], mask [P])."""
        st = self.frame_pipe.window.state
        active = np.asarray(st.p_status) == 1
        if active.sum() <= 16:
            return None
        T = st.current_poses()
        host = st.p_host
        Th = SE3(T.R[host], T.t[host])
        x = (st.p_uv[:, 0] - self.cam.cx) / self.cam.fx
        y = (st.p_uv[:, 1] - self.cam.cy) / self.cam.fy
        z = 1.0 / jnp.maximum(st.p_idepth, 1e-6)
        Xw = Th.inverse().apply(jnp.stack([x * z, y * z, z], -1))
        return self._project_seed(Xw, jnp.asarray(active), T_wc)

    def _project_seed(self, Xw, ok, T_wc: SE3):
        """World points -> (uv, idepth, mask) in the camera at T_wc.
        Seeds outside the configured depth range (with 2x slack) are dropped
        — a near-zero inverse depth makes translation unobservable in the
        event cost (flow ~ rotation-only), which lets the solver wander."""
        Xk = T_wc.apply(Xw)
        z = jnp.maximum(Xk[:, 2], 1e-6)
        u = self.cam.fx * Xk[:, 0] / z + self.cam.cx
        v = self.cam.fy * Xk[:, 1] / z + self.cam.cy
        ok = ok & (Xk[:, 2] > 1e-6) & (u >= 0) & (v >= 0) \
            & (u <= self.cam.width - 1) & (v <= self.cam.height - 1) \
            & (Xk[:, 2] > 0.5 * self.cfg.mapping.min_depth) \
            & (Xk[:, 2] < 2.0 * self.cfg.mapping.max_depth)
        return jnp.stack([u, v], -1), 1.0 / z, ok

    def _filter_seed_points(self, T_wc: SE3):
        """Converged depth-filter points of the outgoing event keyframe,
        transported into the new keyframe (the reference driver feeds the
        tracker's refined depth map forward into KeyFrame::setDepthMap)."""
        if self.kf is None or self.depth is None:
            return None
        kf = self.kf
        mu_range = self.cfg.mapping.max_depth - self.cfg.mapping.min_depth
        conv = df.converged(self.depth, mu_range,
                            self.cfg.mapping.convergence_sigma2_thresh)
        ok = kf.mask & conv
        if int(np.asarray(jnp.sum(ok))) <= 16:
            return None
        z = 1.0 / jnp.maximum(self.depth.mu, 1e-6)
        X = jnp.stack([kf.norm_coord[:, 0] * z,
                       kf.norm_coord[:, 1] * z, z], -1)
        Xw = kf.pose.apply(X)
        return self._project_seed(Xw, ok, T_wc)

    def _make_event_keyframe(self, img, time: float, T_wc: SE3):
        """Create the EDS keyframe (KeyFrame::create + Tracker::reset),
        seeding depth from the BA map + the previous keyframe's converged
        depth-filter points (call stack SURVEY §3.2)."""
        seeds = [s for s in (self._ba_seed_points(T_wc),
                             self._filter_seed_points(T_wc))
                 if s is not None]
        depth_map = None
        if seeds:
            depth_map = tuple(jnp.concatenate([s[i] for s in seeds], 0)
                              for i in range(3))
        self.kf = kfm.create_keyframe(
            img, self.cam, capacity=self.cfg.caps.max_points_per_kf,
            percent_points=self.cfg.keyframe.percent_points,
            selection_mode=self.cfg.keyframe.selection_mode,
            log_eps=self.cfg.keyframe.log_eps,
            sobel_ksize=self.cfg.keyframe.sobel_ksize,
            depth_map=depth_map,
            init_depth=0.5 * (self.cfg.mapping.min_depth
                              + self.cfg.mapping.max_depth),
            T_w_kf=T_wc.inverse(), time=time)
        if depth_map is not None:
            # drop points whose NN depth association is distant
            # (cleanPoints(0.7) after setDepthMap, KeyFrame.cpp:451)
            self.kf = kfm.clean_points(
                self.kf, self.cfg.keyframe.min_weight_clean)
        self.num_event_kfs += 1
        self.depth = df.init_from_prior(self.kf.idepth,
                                        self.cfg.mapping.min_depth,
                                        self.cfg.mapping.max_depth,
                                        self.cfg.mapping.init_a,
                                        self.cfg.mapping.init_b)
        # keep velocity across keyframes (Tracker::reset keep_velo); the
        # pose filter must restart too — its window holds tangents relative
        # to the OLD keyframe, which would corrupt the Lie mean for the next
        # `window` packets (the reference's warm-up rejection re-arms on
        # reset, Tracker.cpp:594-607)
        self.tracker_state = self.tracker_state._replace(
            px=jnp.zeros(3), qx=jnp.asarray([1.0, 0, 0, 0], jnp.float32))
        self.pose_filter = et.pose_filter_init(
            self.cfg.tracker.pose_filter_window)

    # ------------------------------------------------------------------
    def _packet_step_args(self):
        """Cache the fused-step config: traced limit scalars + statics."""
        if getattr(self, "_psa", None) is not None:
            return self._psa
        cfg = self.cfg
        lim = {
            "mu_range": jnp.float32(cfg.mapping.max_depth
                                    - cfg.mapping.min_depth),
            "min_depth": jnp.float32(cfg.mapping.min_depth),
            "max_depth": jnp.float32(cfg.mapping.max_depth),
            "px_noise": jnp.float32(cfg.mapping.px_noise),
            "max_step_t": jnp.float32(cfg.tracker.max_step_translation),
            "max_step_r": jnp.float32(cfg.tracker.max_step_rotation),
            "activity_th": jnp.float32(cfg.keyframe.refinement_activity_th),
            "search_range": jnp.float32(cfg.tracker.refinement_search_range),
            "consistency_px": jnp.float32(
                cfg.tracker.refinement_consistency_px),
        }
        iters = jnp.asarray(
            [cfg.tracker.max_iterations[
                min(l, len(cfg.tracker.max_iterations) - 1)]
             for l in range(cfg.event_frame.num_levels)], jnp.int32)
        statics = dict(
            height=self.cam.height, width=self.cam.width,
            num_levels=cfg.event_frame.num_levels,
            use_time_weights=cfg.event_frame.time_weighted,
            blur_ksize=cfg.event_frame.gaussian_blur_ksize,
            interpolation=cfg.event_frame.interpolation,
            loss_kind=cfg.tracker.loss.kind,
            refinement=cfg.tracker.track_refinement,
            patch_radius=cfg.tracker.refinement_patch_radius,
            refine_levels=cfg.tracker.refinement_pyr_levels,
            do_points_refinement=cfg.keyframe.points_refinement)
        self._psa = (lim, iters, statics)
        return self._psa

    @full_f32
    def process_events(self, packet, fwd_maps=None):
        """Feed one event packet (EventPacket). Returns worldToCam pose of
        the event frame, or None before initialization.

        The whole numeric step runs as one jitted dispatch
        (``_event_packet_fused``); this wrapper only owns telemetry,
        recording, and the keyframe-promotion flag."""
        if self.kf is None:
            return None
        kf = self.kf
        lim, iters, statics = self._packet_step_args()
        pred = self.frame_pipe._last_pose
        (state, pf, depth, mask, tracks, residuals, scalars,
         R_wef, t_wef, vx) = _event_packet_fused(
            self.tracker_state, self.pose_filter, self.depth, self.cam,
            kf.pose.R, kf.pose.t, pred.R, pred.t,
            kf.uv, kf.norm_coord, kf.grad, kf.idepth,
            kf.weight, kf.mask,
            jnp.asarray(packet.xs), jnp.asarray(packet.ys),
            jnp.asarray(packet.ts), jnp.asarray(packet.polarity),
            jnp.asarray(packet.n_valid), fwd_maps,
            iters, jnp.float32(self.loss_scale), lim, **statics)
        sc = np.asarray(scalars)      # ONE device->host sync per packet
        usable = bool(sc[0] > 0.5)
        if not usable:
            # rejected solve: fused step already selected every state back
            # to its input (Tracker.cpp:217-240 gate)
            self.telemetry.counters["event_solve_rejected"] = \
                self.telemetry.counters.get("event_solve_rejected", 0) + 1
            self._pending_kf = True
            return None
        self.tracker_state = state
        self.pose_filter = pf
        self.depth = depth
        if self.cfg.tracker.loss.scale_estimator == "mad":
            self.loss_scale = float(sc[2])
        self.telemetry.event_solve(n_iter=int(sc[3]), energy=float(sc[1]))

        T_w_ef = SE3(R_wef, t_wef)
        self.event_poses.append(np.asarray(t_wef))
        self.event_pose_list.append(T_w_ef.inverse())
        if self.recorder is not None:
            self.recorder.record_pose(float(sc[6]), T_w_ef)
            self.recorder.record_velocity(float(sc[6]), vx)

        self.kf = kf._replace(mask=mask, track=tracks, residual=residuals,
                              idepth=depth.mu)

        # the event tracker is the between-frame tracker of the system:
        # seed the frame front-end's next coarse track from its pose.
        # NOT while the frame tracker is lost: its event keyframe then
        # references an unverified pose, and gate-sized event steps
        # compounding into _last_pose were observed to walk the held pose
        # away faster than the full-reset ladder could catch it
        if self.cfg.tracker.seed_frame_tracker and not self.frame_pipe._lost:
            self.frame_pipe._last_pose = T_w_ef.inverse()

        # KF-need from flow magnitude / point loss (Tracker::needNewKeyframe
        # + KeyFrame::needNewKF); consumed at the next frame arrival, which
        # provides the new keyframe image (SURVEY §3.2)
        flow, alive_count = float(sc[4]), float(sc[5])
        if flow > self.cfg.tracker.kf_flow_threshold ** 2 or \
                alive_count < (1.0 - self.cfg.keyframe.kf_point_loss_percent) \
                * float(kf.n_initial):
            self._pending_kf = True
        return T_w_ef.inverse()
