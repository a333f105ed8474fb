"""Distributed bundle adjustment over a device mesh.

The "distributed axis" of the framework (SURVEY §2.5/§7): the
reference is a single-process library whose only parallel substrate is a
6-thread pool + SSE (src/utils/IndexThreadReduce.h); here the *point* axis
of the sliding-window BA is sharded over a ``jax.sharding.Mesh`` with
``shard_map``:

* every device linearizes and assembles the residuals of its point block
  (ops.energy.linearize/assemble on the local shard),
* the reduced camera system ([4+8F]^2, tiny) and the point-Schur complement
  are ``psum``-reduced over the mesh axis — the all-reduce rides the ICI,
* the damped solve + nullspace orthogonalization run replicated (identical
  on all devices, no divergence), and each shard back-substitutes its own
  idepth block,
* marginalization priors (HM/bM) are produced by the same single psum so
  they evolve identically on every shard (the SURVEY §5 consistency rule).

Frame state, calib, images, and HM/bM are replicated; only the [P, ...]
point arrays (and the [P, F] residual mask) are sharded. The same code runs
on a virtual multi-device CPU mesh for testing (conftest) and on a pod
slice.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.ba_state import BAState
from ..ops import energy

AXIS = "points"

# BAState fields whose leading axis is the point axis
_POINT_FIELDS = ("p_host", "p_uv", "p_idepth", "p_idepth_zero", "p_color",
                 "p_weight", "p_prior", "p_status", "r_active")


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (axis,))


def state_specs(axis: str = AXIS) -> BAState:
    """PartitionSpec pytree for a BAState: point arrays sharded, rest
    replicated."""
    def spec_for(name):
        return P(axis) if name in _POINT_FIELDS else P()
    fields = {name: spec_for(name) for name in BAState._fields}
    # T_eval is an SE3 NamedTuple of two replicated arrays
    from ..utils.lie import SE3
    fields["T_eval"] = SE3(P(), P())
    return BAState(**fields)


def ba_iterate_sharded(state: BAState, target_images, mesh: Mesh,
                       height: int, width: int, iterations: int = 6,
                       lam: float = 1e-5, huber_th: float = 9.0,
                       orth_from_iteration: int = 2):
    """Distributed ba_iterate: GN iterations with the point axis sharded
    over ``mesh``. Returns (state, final_energy)."""
    specs = state_specs()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(specs, P()),
             out_specs=(specs, P()),
             check_vma=False)
    def run(st: BAState, images):
        # fori_loop: the GN body (the big program) compiles once; use_orth
        # becomes a traced select on the iteration index (as in ba_iterate)
        def body(it, s):
            lin = energy.linearize(s, images, height, width,
                                   huber_th=huber_th)
            asm = energy.assemble(s, lin)
            sol = energy.solve_delta(s, asm, lam=lam,
                                     use_orth=(it >= orth_from_iteration),
                                     axis_name=AXIS)
            return energy.apply_step(s, sol)

        st = jax.lax.fori_loop(0, iterations, body, st)
        lin = energy.linearize(st, images, height, width, huber_th=huber_th)
        e = jax.lax.psum(jnp.sum(lin.energy), AXIS)
        return st, e

    return jax.jit(run)(state, target_images)


def marginalize_points_sharded(state: BAState, target_images, mesh: Mesh,
                               height: int, width: int,
                               marg_weight: float = 0.25) -> BAState:
    """Distributed point marginalization: every shard contributes its
    flagged points; HM/bM update via one psum (replicated result)."""
    specs = state_specs()

    @partial(jax.shard_map, mesh=mesh, in_specs=(specs, P()),
             out_specs=specs, check_vma=False)
    def run(st: BAState, images):
        lin = energy.linearize(st, images, height, width)
        return energy.marginalize_points(st, lin, marg_weight=marg_weight,
                                         axis_name=AXIS)

    return jax.jit(run)(state, target_images)


def shard_state(state: BAState, mesh: Mesh) -> BAState:
    """Place a host BAState onto the mesh with the point axis sharded."""
    specs = state_specs()
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        state, specs)
