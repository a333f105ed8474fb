"""One frozen configuration tree for the whole framework.

Replaces the reference's dual config system with a single immutable dataclass
hierarchy (SURVEY §5 "Config / flag system"):
* YAML-per-subsystem structs: ``readTrackingConfig`` (src/tracking/Config.hpp:
  92-129), ``readBundlesConfig`` (src/bundles/Config.hpp:86-114),
  ``readMappingConfig`` (src/mapping/Config.hpp:41-61),
  ``readCameraCalib/readDualCalibration`` (src/utils/Calib.cpp:65-169).
* DSO's ~80 mutable globals ``setting_*`` (src/utils/settings.cpp:32-184) and
  compile-time macros (PYR_LEVELS, patternNum, CPARS).

Defaults mirror the reference's compiled defaults so a config-less run behaves
like stock EDS/DSO. Static ints here (capacities, pyramid levels) become
compile-time constants of the jitted kernels.

Capacities are fixed: the reference grows/erases std::vectors freely; here
arrays have fixed capacities + validity masks (SURVEY §7 "The hard parts")
so every jitted program has static shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from .io import yaml_subset


@dataclass(frozen=True)
class LossConfig:
    """Robust loss for a solver (reference LOSS_FUNCTION enum + params)."""
    kind: str = "huber"          # none | huber | cauchy
    param: float = 0.2           # initial scale; re-estimated per solve (MAD)
    scale_estimator: str = "mad"  # mad | std | fixed  (Tracker.cpp:281-317)


@dataclass(frozen=True)
class EventTrackerConfig:
    """EDS event-to-model tracker (src/tracking/Config.hpp:37-58)."""
    percent_points: float = 1.0
    loss: LossConfig = field(default_factory=LossConfig)
    # per-pyramid-level LM iterations, coarse->fine (options.max_num_iterations)
    max_iterations: Tuple[int, ...] = (10, 10, 20)
    num_levels: int = 3
    function_tolerance: float = 1e-6
    # eight_points | dso (pyramid joint pose+idepth init) | midas (depth seed)
    bootstrap: str = "eight_points"
    # pose smoothing window (SE3MW size, src/tracking/Types.hpp:81-147)
    pose_filter_window: int = 5
    # KF trigger from mean flow magnitude (Tracker.cpp:650-654)
    kf_flow_threshold: float = 3.0
    # the event tracker is the system's between-frame tracker: seed the
    # frame front-end's coarse alignment from the latest event pose
    seed_frame_tracker: bool = True
    # solution-usability gate (Tracker.cpp:217-240 IsSolutionUsable +
    # pose-filter warm-up rejection): reject solves whose pose step since
    # the previous packet exceeds these bounds; state reverts and a new
    # keyframe is requested. Translation is scale-aware: the bound is a
    # fraction of the keyframe's median scene depth (the monocular scale is
    # arbitrary — same parallax ratio the occlusion KF-criterion uses,
    # src/utils/Utils.hpp:292-299). Rotation is absolute (radians).
    max_step_translation: float = 0.25
    max_step_rotation: float = 0.5
    # track refinement against the event frame before the depth-filter
    # update (Tracker::trackPoints / trackPointsPyr /
    # trackPointsAlongEpiline, src/tracking/Tracker.cpp:378-553):
    # none | klt | klt_pyr | model_klt | epiline (model_klt is the
    # scale-correct mode of this repo; klt/klt_pyr mirror the reference)
    track_refinement: str = "none"
    refinement_patch_radius: int = 3
    refinement_pyr_levels: int = 3          # klt_pyr depth (min 3x3 patch)
    refinement_search_range: float = 6.0    # epiline half-range (px)
    refinement_consistency_px: float = 5.0  # epiline ssd-vs-ncc gate


@dataclass(frozen=True)
class BundlesConfig:
    """Sliding-window photometric BA (src/bundles/Config.hpp + DSO settings)."""
    window_size: int = 7                # setting_maxFrames
    min_frames: int = 5                 # setting_minFrames
    max_opt_iterations: int = 6         # setting_maxOptIterations
    min_opt_iterations: int = 1         # setting_minOptIterations
    # relative energy improvement below which the per-keyframe GN loop
    # terminates early (the reference's external driver breaks the same
    # way between min/max iterations; 0 disables)
    opt_break_tol: float = 5e-5
    min_opt_iterations: int = 1         # setting_minOptIterations
    huber_th: float = 9.0               # setting_huberTH
    outlier_th: float = 144.0           # setting_outlierTH = 12^2
    outlier_th_sum_component: float = 2500.0  # 50^2
    marg_weight_fac: float = 0.25       # setting_margWeightFac = 0.5^2
    percent_marginalize_vis: float = 0.95
    # priors (settings.cpp:47-53)
    idepth_fix_prior: float = 2500.0           # 50^2
    idepth_fix_prior_marg_fac: float = 360000.0  # 600^2
    initial_rot_prior: float = 1e11
    initial_trans_prior: float = 1e10
    initial_aff_a_prior: float = 1e14
    initial_aff_b_prior: float = 1e14
    initial_calib_hessian: float = 5e9
    # per-frame affine priors toward absolute zero (setting_affineOptModeA/B,
    # settings.cpp:119-120; <0 fixes). The reference quotes them on SCALED
    # affine variables (SCALE_A=10, SCALE_B=1000, HessianBlocks.h:58-66) —
    # these are the UNSCALED equivalents (P_unscaled = P_scaled / scale^2):
    # 1e12/100 and 1e8/1e6.
    affine_opt_mode_a: float = 1e10
    affine_opt_mode_b: float = 100.0
    # solver behavior (setting_solverMode = FIX_LAMBDA | ORTHOGONALIZE_X_LATER)
    fix_lambda: float = 1e-5
    # 0 = project every GN step off the gauge nullspace (absolute pose +
    # scale). The reference's ORTHOGONALIZE_X_LATER starts at iteration 2;
    # with a young window (little marginalization prior) the first
    # unprojected iterations can slide arbitrarily far along the scale
    # direction (observed: a 3x scale jump in one keyframe BA on a
    # 3-frame window, which then mass-kills immature trace intervals) —
    # projecting from the start pins the bootstrap gauge at no cost
    orthogonalize_x_from_it: int = 0
    solver_mode_delta: float = 1e-5
    force_accept_step: bool = True      # setting_forceAceptStep
    # affine scaling (src/tracking/HessianBlocks.h:58-74)
    scale_a: float = 10.0
    scale_b: float = 1000.0
    # frame energy threshold update (settings.cpp:134-137)
    frame_energy_th_const_weight: float = 0.5
    frame_energy_th_n: float = 0.7
    frame_energy_th_fac_median: float = 1.5
    overall_energy_th_weight: float = 1.0
    # optimize camera intrinsics (CPARS block)
    optimize_calib: bool = False
    # keyframe decision (setting_maxShiftWeight*/kfGlobalWeight,
    # settings.cpp:38-42; per-pixel base, scaled by (640+480)/(w+h))
    max_shift_weight_t: float = 0.04
    max_shift_weight_r: float = 0.0
    max_shift_weight_rt: float = 0.02
    max_affine_weight: float = 2.0      # setting_maxAffineWeight
    kf_global_weight: float = 1.0       # >1 takes more keyframes
    # frame-marginalization policy (settings.cpp:74-80)
    min_frame_age: int = 1              # setting_minFrameAge
    min_points_remaining: float = 0.05  # setting_minPointsRemaining
    max_log_aff_fac_in_window: float = 0.7  # setting_maxLogAffFacInWindow
    # residual-count floor for point marginalization. The reference's
    # setting_minGoodResForMarg=4 counts only well-linearized residuals to
    # surviving frames; we count valid residuals, so the equivalent floor
    # is lower (2 keeps the same points the reference keeps on its 5-7
    # frame windows)
    min_good_res_for_marg: int = 2


@dataclass(frozen=True)
class CoarseTrackerConfig:
    """Frame-to-KF direct alignment (src/tracking/CoarseTracker.cpp)."""
    pyr_levels: int = 6                 # PYR_LEVELS (settings.h:50)
    max_iterations: Tuple[int, ...] = (10, 20, 50, 50, 50)  # per level, fine->coarse
    huber_th: float = 9.0
    coarse_cutoff_th: float = 20.0      # setting_coarseCutoffTH
    lambda_initial: float = 0.01
    lambda_extrapolation_limit: float = 0.001
    cutoff_repeat_saturated: float = 0.6
    cutoff_repeat_max: float = 50.0
    re_track_threshold: float = 1.5     # setting_reTrackThreshold
    # consecutive lost frames before the pipeline discards the window and
    # re-bootstraps (setting_fullResetRequested analog, settings.h:170)
    full_reset_lost_frames: int = 6


@dataclass(frozen=True)
class PixelSelectorConfig:
    """Gradient-histogram pixel selection (src/mapping/PixelSelector.cpp)."""
    block_size: int = 32
    min_grad_hist_cut: float = 0.5      # setting_minGradHistCut
    min_grad_hist_add: float = 7.0      # setting_minGradHistAdd
    grad_downweight_per_level: float = 0.75
    potential_initial: int = 3
    adaptation_rounds: int = 2          # fixed rounds replacing the recursion
    desired_immature_density: float = 1500.0
    desired_point_density: float = 2000.0
    rng_seed: int = 3141592             # reference srand seed (PixelSelector.cpp:38)


@dataclass(frozen=True)
class MappingConfig:
    """Depth filter + map (src/mapping/Config.hpp:29-61)."""
    min_depth: float = 0.3
    max_depth: float = 5.0
    convergence_sigma2_thresh: float = 100.0
    num_desired_points: int = 2000
    points_rel_baseline: float = 0.1
    px_noise: float = 3.0               # DepthPoints.hpp:37
    init_a: float = 2.0
    init_b: float = 5.0
    sor_active: bool = False
    sor_nb_points: int = 8
    sor_radius: float = 0.1


@dataclass(frozen=True)
class ImmatureConfig:
    """Epipolar depth tracing (src/tracking/ImmaturePoint.cpp + settings)."""
    max_pix_search: float = 0.027       # setting_maxPixSearch (rel. to w+h)
    trace_steps_max: int = 100          # discrete search cap (ImmaturePoint.cpp)
    trace_stepsize: float = 1.0
    trace_gn_iterations: int = 3
    trace_gn_threshold: float = 0.1
    trace_extra_slack: float = 1.2
    trace_slack_interval: float = 1.5
    trace_min_improvement_factor: float = 2.0
    min_trace_quality: float = 3.0
    min_trace_test_radius: int = 2
    gn_its_on_activation: int = 3       # setting_GNItsOnPointActivation
    outlier_th: float = 144.0


@dataclass(frozen=True)
class InitializerConfig:
    """Monocular bootstrap (src/init/CoarseInitializer.cpp)."""
    pyr_levels: int = 5
    max_iterations: Tuple[int, ...] = (5, 5, 10, 30, 50)  # per level fine->coarse
    reg_weight: float = 0.8
    alpha_k: float = 6.25               # 2.5^2
    alpha_w: float = 22500.0            # 150^2
    couple_w: float = 1.0
    snapped_threshold: int = 5
    densities: Tuple[float, ...] = (0.03, 0.05, 0.15, 0.5, 1.0)
    num_neighbors: int = 10
    # eight-point bootstrap: median KLT displacement (px) required before
    # an essential-matrix fit is attempted (the parallax analog of the
    # pyramid initializer's 'snapped' gate) — sub-pixel flow fits are
    # noise and their unit-baseline scale poisons the whole map
    min_bootstrap_parallax_px: float = 2.0
    # minimum essential-matrix inliers for a usable two-view bootstrap.
    # The reference accepts >12 (KeyFrame.cpp:930-934); a map seeded from
    # a dozen points collapses on the first marginalization, so the
    # default here is stricter
    min_inliers: int = 32


@dataclass(frozen=True)
class EventFrameConfig:
    """Event accumulation (src/tracking/EventFrame.cpp)."""
    num_levels: int = 3
    interpolation: str = "bilinear"     # nn | bilinear  (drawValuesPoints)
    time_weighted: bool = True          # Gaussian time-ordering weights
    # (default matches EventFrame::create's use_exp_weights path, which the
    # round-2 pipeline used unconditionally; set False for flat weighting)
    gaussian_blur_ksize: int = 3        # 0 disables
    events_per_frame: int = 16384       # fixed packet capacity (pad/truncate)


@dataclass(frozen=True)
class KeyFrameConfig:
    """KeyFrame creation (src/tracking/KeyFrame.cpp)."""
    log_eps: float = 0.2                # KeyFrame.hpp:54
    sobel_ksize: int = 3
    percent_points: float = 0.4
    selection_mode: str = "max"         # max | median (candidatePoints)
    patch_radius: int = 3               # gradient patch half-size for tracking
    adaptive_patch_factor: float = 0.0  # KeyFrame.hpp:55-57
    min_weight_clean: float = 0.7       # cleanPoints threshold (KeyFrame.cpp:451)
    kf_point_loss_percent: float = 0.3  # needNewKF (KeyFrame.cpp:1552-1557)
    kf_image_percent: float = 0.2       # needNewKFImageCriteria
    points_refinement: bool = False     # drop event-inactive points per
    refinement_activity_th: float = 1e-4  # packet (KeyFrame.cpp:1031-1058)


@dataclass(frozen=True)
class Capacities:
    """Fixed array capacities (static shapes of the jitted programs)."""
    max_points_per_kf: int = 2048       # active-point budget (2000 rounded up)
    max_immature_per_kf: int = 1536     # immature budget (1500 rounded up)
    max_window_frames: int = 8          # 7-KF window + incoming slot
    max_events: int = 16384


@dataclass(frozen=True)
class RecorderConfig:
    """Output recording (src/utils/Config.hpp:27-54)."""
    enabled: bool = False
    output_folder: str = "/tmp/slam_eds"
    poses_filename: str = "poses.txt"
    velos_filename: str = "velos.txt"
    save_viz: bool = False


@dataclass(frozen=True)
class EDSConfig:
    """Top-level config: the whole framework reads only this tree."""
    tracker: EventTrackerConfig = field(default_factory=EventTrackerConfig)
    bundles: BundlesConfig = field(default_factory=BundlesConfig)
    coarse: CoarseTrackerConfig = field(default_factory=CoarseTrackerConfig)
    selector: PixelSelectorConfig = field(default_factory=PixelSelectorConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    immature: ImmatureConfig = field(default_factory=ImmatureConfig)
    initializer: InitializerConfig = field(default_factory=InitializerConfig)
    event_frame: EventFrameConfig = field(default_factory=EventFrameConfig)
    keyframe: KeyFrameConfig = field(default_factory=KeyFrameConfig)
    caps: Capacities = field(default_factory=Capacities)
    recorder: RecorderConfig = field(default_factory=RecorderConfig)


def _update_dataclass(obj, data: dict):
    kwargs = {}
    for f in dataclasses.fields(obj):
        if f.name not in data:
            continue
        cur = getattr(obj, f.name)
        val = data[f.name]
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kwargs[f.name] = _update_dataclass(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
            kwargs[f.name] = tuple(val)
        else:
            kwargs[f.name] = val
    return dataclasses.replace(obj, **kwargs)


def load_config(path_or_dict) -> EDSConfig:
    """Build an EDSConfig from a YAML file path (read by
    ``io.yaml_subset``) or a nested dict, with
    defaults for everything unspecified (the YAML schema mirrors the
    dataclass field names, one section per subsystem)."""
    if isinstance(path_or_dict, dict):
        data = path_or_dict
    else:
        data = yaml_subset.load(path_or_dict) or {}
    return _update_dataclass(EDSConfig(), data)
