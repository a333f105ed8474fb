"""``events.scatter_accumulate`` (the event raster) against a per-event
numpy loop of the reference's drawValuesPoints (Utils.cpp:50-123)."""
import numpy as np
import jax.numpy as jnp
import pytest

from slam_eds_tpu.utils import events


def _loop_reference(xs, ys, vals, h, w, method="bilinear"):
    """One event at a time, in float64: 4 bilinear taps with out-of-image
    taps dropped, or the nearest pixel with clamping."""
    img = np.zeros((h, w))
    for x, y, v in zip(np.float64(xs), np.float64(ys), np.float64(vals)):
        if method == "nn":
            ix = int(np.clip(np.round(x), 0, w - 1))
            iy = int(np.clip(np.round(y), 0, h - 1))
            img[iy, ix] += v
            continue
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        for ix, iy, wt in ((x0, y0, (1 - fx) * (1 - fy)),
                           (x0, y0 + 1, (1 - fx) * fy),
                           (x0 + 1, y0, fx * (1 - fy)),
                           (x0 + 1, y0 + 1, fx * fy)):
            if 0 <= ix < w and 0 <= iy < h:
                img[iy, ix] += wt * v
    return img


def _packet(rng, n, h, w, margin=2.0):
    xs = rng.uniform(-margin, w + margin, n).astype(np.float32)
    ys = rng.uniform(-margin, h + margin, n).astype(np.float32)
    vals = (rng.choice([-1.0, 1.0], n)
            * rng.uniform(0.1, 1.0, n)).astype(np.float32)
    return xs, ys, vals


def _raster(xs, ys, vals, h, w, **kw):
    return np.asarray(events.scatter_accumulate(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(vals), h, w, **kw))


@pytest.mark.parametrize("h,w,n", [(16, 24, 50), (48, 64, 700),
                                   (96, 128, 8192)])
def test_random_packets_match_loop(rng, h, w, n):
    xs, ys, vals = _packet(rng, n, h, w)
    got = _raster(xs, ys, vals, h, w)
    want = _loop_reference(xs, ys, vals, h, w)
    # float32 accumulation of a few unit-size terms per pixel
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_border_taps_dropped():
    h, w = 16, 32
    # x1 = w and x0 = -1 fall outside: only the inside taps remain
    xs = np.asarray([w - 1 + 0.75, -0.25, 5.5], np.float32)
    ys = np.asarray([3.5, 3.5, h - 1 + 0.5], np.float32)
    vals = np.ones(3, np.float32)
    got = _raster(xs, ys, vals, h, w)
    np.testing.assert_allclose(got, _loop_reference(xs, ys, vals, h, w),
                               atol=1e-6)
    np.testing.assert_allclose(got.sum(), 0.25 + 0.75 + 0.5, atol=1e-6)


def test_masked_events_give_zero(rng):
    h, w, n = 32, 40, 256
    xs, ys, vals = _packet(rng, n, h, w, margin=0.0)
    mask = np.arange(n) < 100
    got = _raster(xs, ys, vals, h, w, mask=jnp.asarray(mask))
    want = _loop_reference(xs[:100], ys[:100], vals[:100], h, w)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(_raster(xs, ys, vals, h, w,
                          mask=jnp.zeros(n, bool)) == 0)


def test_nn_method_matches_loop(rng):
    h, w, n = 24, 32, 500
    xs, ys, vals = _packet(rng, n, h, w)
    got = _raster(xs, ys, vals, h, w, method="nn")
    np.testing.assert_allclose(
        got, _loop_reference(xs, ys, vals, h, w, method="nn"), atol=1e-5)
