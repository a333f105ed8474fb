"""Every contraction that forms or solves normal equations carries an
explicit float32 precision (utils.precision.full_f32), so a GPU does not
run it as TF32."""
import jax
from jax.extend.core import ClosedJaxpr, Jaxpr
import jax.numpy as jnp
import pytest

from slam_eds_tpu.models.ba_state import PT_MARGINALIZE, synthetic_window
from slam_eds_tpu.ops import energy

H, W, P, F = 48, 64, 64, 4


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for val in eqn.params.values():
            for sub in val if isinstance(val, (list, tuple)) else [val]:
                if isinstance(sub, ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _ba_case(name):
    state, images = synthetic_window(F, P, H, W)
    if name == "ba_iterate":
        return lambda s, im: energy.ba_iterate(s, im, H, W, iterations=2), \
            (state, images)
    if name == "marginalize_points":
        state = state._replace(p_status=state.p_status.at[:8].set(
            PT_MARGINALIZE))

        def marg(s, im):
            lin = energy.linearize(s, im, H, W)
            return energy.marginalize_points(s, lin)
        return marg, (state, images)
    return (lambda s: energy.marginalize_frame(s, 1)), (state,)


def _event_case():
    import __graft_entry__
    return __graft_entry__.entry(H, W, P)


@pytest.mark.parametrize("name", ["ba_iterate", "marginalize_points",
                                  "marginalize_frame", "event_optimize"])
def test_normal_equation_dots_are_float32(name):
    fn, args = _event_case() if name == "event_optimize" else _ba_case(name)
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(precisions)


def test_plain_dot_keeps_default_precision():
    """The check above can fail: an unwrapped dot has no precision."""
    a = jnp.ones((3, 3))
    assert _dot_precisions(jax.make_jaxpr(jnp.dot)(a, a).jaxpr) == [None]


def test_event_residuals_dots_are_float32():
    """The event cost's projection X @ R.T: a TF32 projection moves image
    coordinates by a fraction of a pixel."""
    from slam_eds_tpu.ops import event_tracker as et
    _, (state, ef, nc, grad, idp, w, mask) = _event_case()
    jaxpr = jax.make_jaxpr(lambda *a: et.event_residuals(a[0], a[1], _cam(),
                                                         *a[2:]))(
        state, ef, nc, grad, idp, w, mask).jaxpr
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    precisions = _dot_precisions(jaxpr)
    assert precisions and all(p == highest for p in precisions)


def _cam():
    from slam_eds_tpu.utils.cameras import Pinhole
    f = 400.0 * W / 640.0
    return Pinhole(jnp.float32(f), jnp.float32(f), jnp.float32(W / 2 - 0.5),
                   jnp.float32(H / 2 - 0.5), W, H)


@pytest.mark.parametrize("step", ["EDSPipeline.process_frame",
                                  "EDSPipeline.process_events",
                                  "FrameOnlyPipeline.process_frame",
                                  "SyntheticSequence._render_impl"])
def test_pipeline_steps_run_in_float32_scope(step):
    from slam_eds_tpu.io import dataset
    from slam_eds_tpu.models import pipeline
    cls, name = step.split(".")
    owner = getattr(pipeline, cls, None) or getattr(dataset, cls)
    assert getattr(getattr(owner, name), "__wrapped__", None) is not None
