"""Distributed event-to-model alignment over a device mesh.

The event tracker's point residuals (ops.event_tracker, reference
src/tracking/Tracker.cpp + PhotometricError.hpp) shard over the mesh the
same way the BA points do (parallel.sharded_ba): each device owns a block
of active points and the tiny [12, 12] Gauss-Newton system is psum-reduced.

Two global couplings require collectives:
* the model normalization ``model / ||model||`` — the reference normalizes
  per Ceres thread-chunk (SURVEY §7 notes the norm then depends on
  num_threads!); here the squared-norm is one ``psum``, giving a global,
  shard-count-independent normalization,
* the robust-loss statistics (MAD of the final residuals,
  Tracker::getLossParams) — computed via an all_gather of the (modest)
  residual vector; exact, and the gather is [P] floats over ICI.

Everything else (pose/velocity state, the event frame, the LM loop control)
is replicated, so the accepted step is bit-identical on all shards.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import event_tracker as et
from ..utils import lie
from ..utils.cameras import Pinhole
from ..utils.interp import bicubic
from ..utils.stats import huber_weight, cauchy_weight, masked_mad, HUBER_K
from ..utils.precision import full_f32

AXIS = "points"


def _residuals_sharded(state: et.TrackerState, event_frame, cam: Pinhole,
                       norm_coord, grad, idp, weights, mask,
                       norm_eps: float = 1e-3, norm_event: bool = False):
    """Per-shard residual block with a psum-global model norm.
    norm_event selects the PhotometricErrorNC cost (the sampled event
    values are normalized by their own psum-global l2 norm,
    src/tracking/PhotometricErrorNC.hpp:151-186)."""
    flow = et.compute_flow(norm_coord, state.vx, idp)
    model = -(grad[:, 0] * flow[:, 0] + grad[:, 1] * flow[:, 1])
    model = jnp.where(mask, model, 0.0)
    norm2 = jax.lax.psum(jnp.sum(model * model), AXIS)
    model_norm = jnp.sqrt(norm_eps + norm2)

    z = 1.0 / (idp + 1e-5)
    X = jnp.stack([norm_coord[:, 0] * z, norm_coord[:, 1] * z, z], axis=-1)
    R = lie.quat_to_mat(state.qx)
    p = X @ R.T + state.px[None, :]
    xp = cam.fx * (p[:, 0] / p[:, 2]) + cam.cx
    yp = cam.fy * (p[:, 1] / p[:, 2]) + cam.cy
    ev = bicubic(event_frame, xp, yp)
    if norm_event:
        ev = jnp.where(mask, ev, 0.0)
        e2 = jax.lax.psum(jnp.sum(ev * ev), AXIS)
        ev = ev / jnp.sqrt(norm_eps + e2)
    r = weights * (model / model_norm - ev)
    return jnp.where(mask, r, 0.0)


class _Carry(NamedTuple):
    state: et.TrackerState
    lam: jax.Array
    energy: jax.Array
    it: jax.Array
    done: jax.Array


@full_f32
def optimize_sharded(state: et.TrackerState, event_frame, cam: Pinhole,
                     norm_coord, grad, idp, weights, mask, mesh: Mesh,
                     max_iterations: int = 20, loss_kind: str = "huber",
                     loss_scale: float = 0.2,
                     function_tolerance: float = 1e-6,
                     norm_event: bool = False) -> et.TrackerResult:
    """Distributed Tracker::optimize — point arrays sharded over ``mesh``,
    LM control replicated. Matches ops.event_tracker.optimize numerically
    (up to reduction order)."""

    pt = P(AXIS)
    rep = jax.tree_util.tree_map(lambda _: P(), state)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(rep, P(), pt, pt, pt, pt, pt),
             out_specs=(rep, pt, P(), P(), P()),
             check_vma=False)
    def run(st0, ef, nc, gr, ip, w_pt, mk):
        dtype = nc.dtype
        scale = jnp.asarray(loss_scale, dtype)

        def res_of(delta, st):
            return _residuals_sharded(et._apply_local(st, delta), ef, cam,
                                      nc, gr, ip, w_pt, mk,
                                      norm_event=norm_event)

        def robust_w(r):
            if loss_kind == "huber":
                return huber_weight(r, scale)
            if loss_kind == "cauchy":
                return cauchy_weight(r, scale)
            return jnp.ones_like(r)

        def energy_of(r):
            return jax.lax.psum(jnp.sum(robust_w(r) * r * r), AXIS)

        zero = jnp.zeros(12, dtype)

        def body(c: _Carry):
            # analytic residual+Jacobian with the two norm couplings
            # psum-reduced inside (event_residuals_and_jac axis_name path)
            r, J = et.event_residuals_and_jac(c.state, ef, cam, nc, gr, ip,
                                              w_pt, mk, axis_name=AXIS,
                                              norm_event=norm_event)
            w = jax.lax.stop_gradient(robust_w(r)) * mk
            H = jax.lax.psum((J * w[:, None]).T @ J, AXIS)
            g = jax.lax.psum((J * w[:, None]).T @ r, AXIS)
            Hl = H + c.lam * jnp.diag(jnp.diagonal(H)) \
                + 1e-10 * jnp.eye(12, dtype=dtype)
            delta = -jnp.linalg.solve(Hl, g)
            delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
            new_state = et._apply_local(c.state, delta)
            e_new = energy_of(res_of(zero, new_state))
            accept = e_new < c.energy
            st = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), new_state, c.state)
            lam = jnp.clip(jnp.where(accept, c.lam * 0.5, c.lam * 4.0),
                           1e-7, 1e5)
            energy = jnp.where(accept, e_new, c.energy)
            rel = jnp.abs(c.energy - energy) / jnp.maximum(c.energy, 1e-12)
            done = accept & (rel < function_tolerance)
            return _Carry(st, lam, energy, c.it + 1, done)

        e0 = energy_of(res_of(zero, st0))
        init = _Carry(st0, jnp.asarray(1e-4, dtype), e0, jnp.asarray(0),
                      jnp.asarray(False))
        out = jax.lax.while_loop(
            lambda c: (c.it < max_iterations) & ~c.done, body, init)

        r_final = res_of(zero, out.state)
        # global MAD: gather the full residual vector (P floats) once
        r_all = jax.lax.all_gather(r_final, AXIS, tiled=True)
        m_all = jax.lax.all_gather(mk, AXIS, tiled=True)
        mad, _ = masked_mad(r_all, m_all)
        new_scale = jnp.maximum(HUBER_K * mad, 1e-6)
        return (out.state, r_final, out.energy, out.it, new_scale)

    st, r, e, it, sc = jax.jit(run)(state, event_frame, norm_coord, grad,
                                    idp, weights, mask)
    return et.TrackerResult(state=st, residuals=r, energy=e, n_iter=it,
                            loss_scale=sc)
