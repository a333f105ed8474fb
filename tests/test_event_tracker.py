"""Event tracker tests: synthesize a brightness-increment frame from a known
(pose, velocity) and check the tracker recovers the alignment."""
import numpy as np
import jax
import jax.numpy as jnp

from slam_eds_tpu.ops import event_tracker as et
from slam_eds_tpu.utils import lie
from slam_eds_tpu.utils.cameras import Pinhole
from slam_eds_tpu.utils.events import scatter_accumulate
from slam_eds_tpu.utils.image import gaussian_blur
from slam_eds_tpu.utils.lie import SE3

H, W = 96, 128
CAM = Pinhole(jnp.float32(110.0), jnp.float32(110.0),
              jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)


def make_points(rng, n=256):
    uv = np.stack([rng.uniform(15, W - 15, n), rng.uniform(15, H - 15, n)], -1)
    nc = np.stack([(uv[:, 0] - float(CAM.cx)) / float(CAM.fx),
                   (uv[:, 1] - float(CAM.cy)) / float(CAM.fy)], -1)
    grad = rng.normal(size=(n, 2)) * 50.0
    idp = rng.uniform(0.4, 0.7, n)
    return (jnp.asarray(uv, jnp.float32), jnp.asarray(nc, jnp.float32),
            jnp.asarray(grad, jnp.float32), jnp.asarray(idp, jnp.float32))


def _smooth_field(x, y):
    """Analytic 'normalized event frame' test function."""
    return (0.10 * jnp.sin(0.15 * x) * jnp.cos(0.12 * y)
            + 0.05 * jnp.sin(0.05 * x + 0.07 * y))


def synth_event_frame(nc, grad_out, idp, vx_true, T_ef_kf: SE3, alpha=100.0):
    """Construct an event frame + per-point gradients such that the true
    (pose, velocity) is the exact minimum of the cost:

    choose a smooth field S, warp each point with the true pose, set its
    target c_i = S(warp_i), and pick the KF gradient g_i along the true flow
    with magnitude making model_i = alpha*c_i; then model/||model|| ~ c at
    the truth (alpha >> the 1e-3 norm guard). Residual floor is only the
    bicubic-vs-analytic interpolation error of S.

    grad_out is OVERWRITTEN (returned) to satisfy the construction.
    """
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    img = _smooth_field(jnp.asarray(xs), jnp.asarray(ys))

    z = 1.0 / (idp + 1e-5)
    X = jnp.stack([nc[:, 0] * z, nc[:, 1] * z, z], -1)
    p = X @ T_ef_kf.R.T + T_ef_kf.t
    xp = CAM.fx * p[:, 0] / p[:, 2] + CAM.cx
    yp = CAM.fy * p[:, 1] / p[:, 2] + CAM.cy
    c = _smooth_field(xp, yp)
    # normalize so that model/||model|| == sampled frame exactly at truth
    cn = jnp.linalg.norm(c)
    c = c / cn
    img = img / cn

    flow = et.compute_flow(nc, vx_true, idp)
    f2 = jnp.sum(flow * flow, axis=-1)
    g = -(alpha * c / jnp.maximum(f2, 1e-8))[:, None] * flow
    return img, g


def test_compute_flow_formula():
    nc = jnp.asarray([[0.1, -0.2]], jnp.float32)
    vx = jnp.asarray([0.1, 0.2, 0.3, 0.01, 0.02, 0.03], jnp.float32)
    idp = jnp.asarray([0.5], jnp.float32)
    f = et.compute_flow(nc, vx, idp)
    x, y = 0.1, -0.2
    fx = -0.5 * 0.1 + x * 0.5 * 0.3 + x * y * 0.01 - (1 + x * x) * 0.02 + y * 0.03
    fy = -0.5 * 0.2 + y * 0.5 * 0.3 + (1 + y * y) * 0.01 - x * y * 0.02 - x * 0.03
    np.testing.assert_allclose(np.asarray(f[0]), [fx, fy], atol=1e-6)


def test_residuals_zero_at_truth(rng):
    uv, nc, _, idp = make_points(rng)
    vx = jnp.asarray([0.3, 0.1, -0.2, 0.05, -0.03, 0.08], jnp.float32)
    vx = vx / jnp.linalg.norm(vx)
    T = SE3.exp(jnp.asarray([0.01, -0.005, 0.008, 0.002, 0.001, -0.003],
                            jnp.float32))
    ef, grad = synth_event_frame(nc, None, idp, vx, T)
    st = et.TrackerState(px=T.t, qx=lie.mat_to_quat(T.R), vx=vx)
    r = et.event_residuals(st, ef, CAM, nc, grad, idp,
                           jnp.ones_like(idp), jnp.ones_like(idp, bool))
    # only bicubic-vs-analytic interpolation error remains
    assert float(jnp.abs(r).mean()) < 2e-4


def test_optimize_recovers_pose(rng):
    uv, nc, _, idp = make_points(rng)
    vx_true = jnp.asarray([0.3, 0.1, -0.2, 0.05, -0.03, 0.08], jnp.float32)
    vx_true = vx_true / jnp.linalg.norm(vx_true)
    T_true = SE3.exp(jnp.asarray([0.015, -0.01, 0.008, 0.003, 0.002, -0.004],
                                 jnp.float32))
    ef, grad = synth_event_frame(nc, None, idp, vx_true, T_true)

    st0 = et.TrackerState(px=jnp.zeros(3), qx=lie.quat_identity(),
                          vx=vx_true)  # start at zero pose, true velocity
    res = et.optimize(st0, ef, CAM, nc, grad, idp, jnp.ones_like(idp),
                      jnp.ones_like(idp, bool), max_iterations=50,
                      loss_kind="none")
    T_est = SE3(lie.quat_to_mat(res.state.qx), res.state.px)
    err = T_true.inverse().compose(T_est).log()
    assert float(jnp.linalg.norm(err)) < 2e-3, np.asarray(err)


def test_optimize_recovers_velocity_direction(rng):
    uv, nc, _, idp = make_points(rng, n=384)
    vx_true = jnp.asarray([0.5, -0.2, 0.1, 0.02, 0.04, -0.01], jnp.float32)
    vx_true = vx_true / jnp.linalg.norm(vx_true)
    T_true = SE3.exp(jnp.asarray([0.01, 0.005, -0.004, 0.001, -0.002, 0.002],
                                 jnp.float32))
    ef, grad = synth_event_frame(nc, None, idp, vx_true, T_true)
    v0 = vx_true + jnp.asarray([0.1, -0.05, 0.05, 0.01, -0.01, 0.02])
    st0 = et.TrackerState(px=T_true.t, qx=lie.mat_to_quat(T_true.R),
                          vx=v0 / jnp.linalg.norm(v0))
    res = et.optimize(st0, ef, CAM, nc, grad, idp, jnp.ones_like(idp),
                      jnp.ones_like(idp, bool), max_iterations=60,
                      loss_kind="none")
    cos = float(jnp.dot(res.state.vx, vx_true))
    assert cos > 0.995, (cos, np.asarray(res.state.vx))
    np.testing.assert_allclose(float(jnp.linalg.norm(res.state.vx)), 1.0,
                               atol=1e-5)


def test_warp_coords_and_flow_stat(rng):
    uv, nc, grad, idp = make_points(rng)
    st = et.initial_tracker_state()
    uv_ef, alive = et.warp_coords(st, CAM, nc, idp, jnp.ones_like(idp, bool))
    np.testing.assert_allclose(np.asarray(uv_ef), np.asarray(uv), atol=1e-3)
    assert bool(alive.all())
    assert float(et.mean_flow_magnitude(uv_ef, uv, alive)) < 1e-5


def test_pose_filter_mean(rng):
    f = et.pose_filter_init(5)
    taus = [np.concatenate([rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.005])
            for _ in range(3)]
    for t in taus:
        f = et.pose_filter_push(f, SE3.exp(jnp.asarray(t, jnp.float32)))
    mean = et.pose_filter_mean(f)
    np.testing.assert_allclose(np.asarray(mean.log()),
                               np.mean(taus, axis=0), atol=1e-4)


def test_mad_loss_scale_updates(rng):
    uv, nc, grad, idp = make_points(rng, n=128)
    vx = et.initial_tracker_state().vx
    ef = jnp.zeros((H, W), jnp.float32)
    st = et.initial_tracker_state()
    res = et.optimize(st, ef, CAM, nc, grad, idp, jnp.ones_like(idp),
                      jnp.ones_like(idp, bool), max_iterations=3)
    assert float(res.loss_scale) > 0
    assert np.isfinite(float(res.energy))


def test_analytic_jacobian_matches_autodiff():
    """event_residuals_and_jac vs jacfwd of the residual vector through the
    local parameterization — must agree to float tolerance (the autodiff
    path is the oracle; the analytic one is what optimize() runs)."""
    import jax
    import numpy as np
    from slam_eds_tpu.utils.cameras import Pinhole

    H, W, P = 48, 64, 40
    cam = Pinhole(jnp.float32(60.0), jnp.float32(60.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    rng = np.random.default_rng(3)
    ef = jnp.asarray(rng.normal(size=(H, W)) * 0.05, jnp.float32)
    nc = jnp.asarray(np.stack(
        [(rng.uniform(8, W - 8, P) - float(cam.cx)) / float(cam.fx),
         (rng.uniform(8, H - 8, P) - float(cam.cy)) / float(cam.fy)], -1),
        jnp.float32)
    grad = jnp.asarray(rng.normal(size=(P, 2)) * 12, jnp.float32)
    idp = jnp.asarray(rng.uniform(0.4, 1.2, P), jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 1.0, P), jnp.float32)
    mask = jnp.asarray(rng.random(P) > 0.15)

    # a non-trivial linearization point
    st0 = et.initial_tracker_state()
    st = et._apply_local(st0, jnp.asarray(
        rng.uniform(-0.05, 0.05, 12), jnp.float32))

    r_an, J_an = et.event_residuals_and_jac(st, ef, cam, nc, grad, idp, w,
                                            mask)

    def res_of(delta):
        return et.event_residuals(et._apply_local(st, delta), ef, cam, nc,
                                  grad, idp, w, mask)

    zero = jnp.zeros(12, jnp.float32)
    r_ad = res_of(zero)
    J_ad = jax.jacfwd(res_of)(zero)

    np.testing.assert_allclose(np.asarray(r_an), np.asarray(r_ad), atol=1e-6)
    np.testing.assert_allclose(np.asarray(J_an), np.asarray(J_ad),
                               atol=2e-4, rtol=2e-3)


def test_nc_jacobian_matches_autodiff():
    """PhotometricErrorNC variant (norm_event=True): the E-side rank-1
    normalization coupling must match forward-mode autodiff."""
    H, W, P = 48, 64, 40
    cam = Pinhole(jnp.float32(60.0), jnp.float32(60.0),
                  jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
    rng = np.random.default_rng(7)
    ef = jnp.asarray(rng.normal(size=(H, W)) * 4.0, jnp.float32)  # RAW frame
    nc = jnp.asarray(np.stack(
        [(rng.uniform(8, W - 8, P) - float(cam.cx)) / float(cam.fx),
         (rng.uniform(8, H - 8, P) - float(cam.cy)) / float(cam.fy)], -1),
        jnp.float32)
    grad = jnp.asarray(rng.normal(size=(P, 2)) * 12, jnp.float32)
    idp = jnp.asarray(rng.uniform(0.4, 1.2, P), jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 1.0, P), jnp.float32)
    mask = jnp.asarray(rng.random(P) > 0.15)

    st = et._apply_local(et.initial_tracker_state(), jnp.asarray(
        rng.uniform(-0.05, 0.05, 12), jnp.float32))

    r_an, J_an = et.event_residuals_and_jac(st, ef, cam, nc, grad, idp, w,
                                            mask, norm_event=True)

    def res_of(delta):
        return et.event_residuals(et._apply_local(st, delta), ef, cam, nc,
                                  grad, idp, w, mask, norm_event=True)

    zero = jnp.zeros(12, jnp.float32)
    np.testing.assert_allclose(np.asarray(r_an), np.asarray(res_of(zero)),
                               atol=5e-6)
    J_ad = jax.jacfwd(res_of)(zero)
    np.testing.assert_allclose(np.asarray(J_an), np.asarray(J_ad),
                               atol=2e-4, rtol=2e-3)


def test_nc_optimize_recovers_pose(rng):
    """NC cost with the RAW (un-normalized) synthetic frame still recovers
    the alignment: scale the frame arbitrarily — NC is scale-invariant."""
    uv, nc, _, idp = make_points(rng)
    vx = jnp.asarray([0.3, 0.1, -0.2, 0.05, -0.03, 0.08], jnp.float32)
    vx = vx / jnp.linalg.norm(vx)
    tau = jnp.asarray([0.02, -0.01, 0.015, 0.004, -0.003, 0.002], jnp.float32)
    T_true = SE3.exp(tau)
    img, grad = synth_event_frame(nc, None, idp, vx, T_true)
    img_raw = img * 37.5   # arbitrary scale: NC normalizes the samples

    st0 = et.TrackerState(
        px=T_true.t + jnp.asarray([0.004, -0.003, 0.002], jnp.float32),
        qx=lie.quat_normalize(lie.quat_mul(
            lie.quat_exp(jnp.asarray([0.002, 0.001, -0.002], jnp.float32)),
            lie.mat_to_quat(T_true.R))),
        vx=vx)
    w = jnp.ones((nc.shape[0],), jnp.float32)
    mask = jnp.ones((nc.shape[0],), bool)
    res = et.optimize(st0, img_raw, CAM, nc, grad, idp, w, mask,
                      max_iterations=30, loss_kind="none",
                      norm_event=True)
    err_t = float(jnp.linalg.norm(res.state.px - T_true.t))
    err0_t = float(jnp.linalg.norm(st0.px - T_true.t))
    assert err_t < 0.5 * err0_t, (err_t, err0_t)


# ---------------------------------------------------------------------------
# track refinement (Tracker.cpp:378-553)
# ---------------------------------------------------------------------------

def _refinement_scene(rng, n=64, f_true_px=0.7):
    """Points on a coarse grid; the 'event frame' is the splat of each
    point's brightness change -grad.f_true at the TRUE warped position;
    the predicted warp is short of truth by f_true."""
    H, W = 96, 128
    gx, gy = np.meshgrid(np.linspace(14, W - 14, 8),
                         np.linspace(14, H - 14, 8))
    uv_true = np.stack([gx.ravel(), gy.ravel()], -1)[:n].astype(np.float32)
    uv_true += rng.uniform(-2, 2, uv_true.shape).astype(np.float32)
    grad = rng.normal(size=(n, 2)).astype(np.float32) * 30
    # flow along each point's gradient direction — the component events
    # observe (flow normal to the gradient produces no brightness change,
    # so no event, so nothing any tracker could recover)
    gdir = grad / np.linalg.norm(grad, axis=-1, keepdims=True)
    f_true = gdir * f_true_px
    # brightness change seen by the event camera: dL = -grad . flow
    dl = -(grad[:, 0] * f_true[:, 0] + grad[:, 1] * f_true[:, 1])
    ev = scatter_accumulate(jnp.asarray(uv_true[:, 0]),
                            jnp.asarray(uv_true[:, 1]), jnp.asarray(dl),
                            H, W, method="bilinear")
    uv_warp = jnp.asarray(uv_true - f_true)
    return ev, uv_warp, jnp.asarray(uv_true), jnp.asarray(grad), \
        jnp.ones((n,), bool)


def test_refine_tracks_klt_reduces_error(rng):
    """One event-KLT step (trackPoints, Tracker.cpp:378-434) must move the
    warp-predicted correspondences toward the true event positions."""
    ev, uv_warp, uv_true, grad, mask = _refinement_scene(rng)
    delta, ok = et.refine_tracks_klt(ev, uv_warp, grad, mask,
                                     patch_radius=3)
    err_before = np.linalg.norm(np.asarray(uv_warp - uv_true), axis=-1)
    err_after = np.linalg.norm(
        np.asarray(uv_warp + delta - uv_true), axis=-1)
    okn = np.asarray(ok)
    assert okn.sum() > 56, f"few solvable systems: {okn.sum()}"
    assert err_after[okn].mean() < 0.4 * err_before[okn].mean(), \
        (err_before[okn].mean(), err_after[okn].mean())


def test_refine_tracks_klt_pyramidal_runs(rng):
    """Pyramidal accumulation (trackPointsPyr, Tracker.cpp:436-488) stays
    finite and bounded."""
    ev, uv_warp, uv_true, grad, mask = _refinement_scene(rng)
    delta, ok = et.refine_tracks_klt(ev, uv_warp, grad, mask,
                                     patch_radius=3, num_levels=3)
    d = np.asarray(delta)
    assert np.isfinite(d).all()
    assert (np.abs(d) <= 6.0 + 1e-6).all()
    # masked-out points must not move
    delta0, _ = et.refine_tracks_klt(ev, uv_warp, grad,
                                     jnp.zeros_like(mask), patch_radius=3)
    assert np.all(np.asarray(delta0) == 0.0)


def test_refine_tracks_epiline_consistency_gate(rng):
    """Epiline search (trackPointsAlongEpiline, Tracker.cpp:490-553):
    with the model splat reproduced in the event frame the matched
    positions must track the truth along the line, and the ssd/ncc
    consistency gate keeps coherent points alive."""
    n = 32
    H, W = 96, 128
    gx, gy = np.meshgrid(np.linspace(16, W - 16, 8),
                         np.linspace(16, H - 16, 4))
    kf_uv = np.stack([gx.ravel(), gy.ravel()], -1)[:n].astype(np.float32)
    model = rng.normal(size=n).astype(np.float32)
    model /= np.linalg.norm(model)
    # true positions: shifted 2px along +x; event frame = model splat there
    shift = np.array([2.0, 0.0], np.float32)
    uv_true = kf_uv + shift
    ev = scatter_accumulate(jnp.asarray(uv_true[:, 0]),
                            jnp.asarray(uv_true[:, 1]), jnp.asarray(model),
                            H, W, method="bilinear")
    # pose whose epipolar lines run along x: translation along x
    T = SE3.exp(jnp.asarray([0.05, 0, 0, 0, 0, 0], jnp.float32))
    uv_warp = jnp.asarray(kf_uv)  # prediction = no motion (2px off)
    uv_ref, alive = et.refine_tracks_epiline(
        ev, jnp.asarray(kf_uv), uv_warp, jnp.asarray(model),
        jnp.ones((n,), bool), T, CAM, patch_radius=3,
        search_range=4.0, num_steps=33)
    a = np.asarray(alive)
    assert a.sum() >= n * 0.8, a.sum()
    err = np.linalg.norm(np.asarray(uv_ref)[a] - uv_true[a], axis=-1)
    assert err.mean() < 0.75, err.mean()


def test_refinement_improves_depth_filter_convergence(rng):
    """With imperfect idepth seeds,
    warp-only tracks are self-consistent with the WRONG seed (the filter
    just reinforces it), while KLT-refined tracks pull the correspondence
    toward the true epipolar position and the triangulated depth toward
    truth (Tracker.cpp:378-434 feeding DepthPoints::update)."""
    from slam_eds_tpu.ops import depth_filter as df
    n = 48
    H, W = 96, 128
    gx, gy = np.meshgrid(np.linspace(20, W - 20, 8),
                         np.linspace(20, H - 20, 6))
    uv_kf = np.stack([gx.ravel(), gy.ravel()], -1)[:n].astype(np.float32)
    uv_kf += rng.uniform(-2, 2, uv_kf.shape).astype(np.float32)
    nc = np.stack([(uv_kf[:, 0] - float(CAM.cx)) / float(CAM.fx),
                   (uv_kf[:, 1] - float(CAM.cy)) / float(CAM.fy)], -1)
    rho_true = rng.uniform(0.45, 0.7, n).astype(np.float32)
    rho_seed = rho_true * (1.0 + rng.choice([-0.18, 0.18], n)).astype(
        np.float32)
    # translation along x (epipolar direction ~ x); T_ef_kf state
    T_ef_kf = SE3.exp(jnp.asarray([0.12, 0.0, 0.0, 0.0, 0.0, 0.0],
                                  jnp.float32))
    state = et.initial_tracker_state()._replace(
        px=T_ef_kf.t, qx=lie.mat_to_quat(T_ef_kf.R))
    mask = jnp.ones((n,), bool)
    uv_true, _ = et.warp_coords(state, CAM, jnp.asarray(nc),
                                jnp.asarray(rho_true), mask)
    uv_warp, alive = et.warp_coords(state, CAM, jnp.asarray(nc),
                                    jnp.asarray(rho_seed), mask)
    # normalized model values; event frame = the same values splatted at
    # the TRUE correspondence (what a perfectly-modeled sensor reports)
    dl = rng.normal(size=n).astype(np.float32)
    dl /= np.linalg.norm(dl)
    ev = scatter_accumulate(uv_true[:, 0], uv_true[:, 1], jnp.asarray(dl),
                            H, W, method="bilinear")

    T_kf_ef = et.pose_kf_ef(state)
    mu_range = 4.0

    def depth_err(tracks):
        st = df.init_from_prior(jnp.asarray(rho_seed), 0.25, 4.0, 10.0, 10.0)
        for _ in range(6):
            st = df.update(st, T_kf_ef, jnp.asarray(uv_kf), tracks, CAM,
                           mu_range=mu_range, px_noise=1.0, mask=alive)
        return float(jnp.mean(jnp.where(
            alive, jnp.abs(st.mu - jnp.asarray(rho_true)), 0.0)))

    tracks_warp = uv_warp - jnp.asarray(uv_kf)
    err_warp = depth_err(tracks_warp)

    uv_ref = uv_warp
    for _ in range(3):   # per-packet refinement (model_klt mode)
        delta, _ = et.refine_tracks_model_klt(ev, uv_ref, jnp.asarray(dl),
                                              alive, patch_radius=3)
        uv_ref = uv_ref + delta
    err_ref = depth_err(uv_ref - jnp.asarray(uv_kf))
    assert err_ref < 0.5 * err_warp, (err_warp, err_ref)
