import numpy as np
import jax
import jax.numpy as jnp

from slam_eds_tpu.utils import interp


def test_bilinear_exact_on_plane(rng):
    """Bilinear interpolation is exact for affine images."""
    H, W = 32, 40
    ys, xs = np.mgrid[0:H, 0:W]
    img = jnp.asarray(1.5 * xs - 0.7 * ys + 3.0, jnp.float32)
    x = jnp.asarray(rng.uniform(1, W - 2, size=50), jnp.float32)
    y = jnp.asarray(rng.uniform(1, H - 2, size=50), jnp.float32)
    v = interp.bilinear(img, x, y)
    np.testing.assert_allclose(v, 1.5 * x - 0.7 * y + 3.0, rtol=1e-5, atol=1e-4)


def test_bilinear_at_integers(rng):
    img = jnp.asarray(rng.normal(size=(16, 16)), jnp.float32)
    v = interp.bilinear(img, jnp.asarray([3.0, 7.0]), jnp.asarray([2.0, 9.0]))
    np.testing.assert_allclose(v, [img[2, 3], img[9, 7]], atol=1e-6)


def test_bicubic_exact_on_cubic_poly(rng):
    """Catmull-Rom convolution reproduces cubics along each axis exactly
    (separable kernel, order-3 accuracy on polynomials up to degree 3 in
    each variable separately)."""
    H, W = 32, 32
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    img = jnp.asarray(0.01 * xs ** 3 - 0.05 * xs ** 2 + xs + 2.0, jnp.float32)
    x = jnp.asarray(rng.uniform(3, W - 4, size=30), jnp.float32)
    y = jnp.asarray(rng.uniform(3, H - 4, size=30), jnp.float32)
    f, dfdx, dfdy = interp.bicubic_with_grad(img, x, y)
    xe = np.asarray(x, np.float64)
    np.testing.assert_allclose(f, 0.01 * xe ** 3 - 0.05 * xe ** 2 + xe + 2.0,
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(dfdx, 0.03 * xe ** 2 - 0.1 * xe + 1.0,
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(dfdy, np.zeros_like(xe), atol=1e-2)


def test_bicubic_grad_matches_autodiff(rng):
    img = jnp.asarray(rng.normal(size=(24, 24)), jnp.float32)

    def f(x, y):
        return interp.bicubic(img, x, y)

    x0, y0 = 11.3, 7.8
    _, dx, dy = interp.bicubic_with_grad(img, jnp.float32(x0), jnp.float32(y0))
    gx = jax.grad(f, argnums=0)(jnp.float32(x0), jnp.float32(y0))
    gy = jax.grad(f, argnums=1)(jnp.float32(x0), jnp.float32(y0))
    np.testing.assert_allclose(dx, gx, atol=1e-4)
    np.testing.assert_allclose(dy, gy, atol=1e-4)


def test_bilinear_3channel(rng):
    img3 = jnp.asarray(rng.normal(size=(16, 16, 3)), jnp.float32)
    v = interp.bilinear_3(img3, jnp.asarray([4.5]), jnp.asarray([5.5]))
    assert v.shape == (1, 3)
    expect = 0.25 * (img3[5, 4] + img3[5, 5] + img3[6, 4] + img3[6, 5])
    np.testing.assert_allclose(v[0], expect, atol=1e-5)


def test_pattern_tile_sample_matches_plane_sampling():
    """The per-tap 4x4 patch sampler must equal bilinear sampling of the
    precomputed [I, gx, gy] central-difference planes (interior taps)."""
    import numpy as np
    from slam_eds_tpu.utils.interp import pattern_tile_sample, bilinear_3
    from slam_eds_tpu.utils.image import central_gradients

    rng = np.random.default_rng(1)
    F, H, W, P, K = 3, 64, 80, 37, 8
    imgs = jnp.asarray(rng.uniform(0, 255, (F, H, W)), jnp.float32)
    cu = rng.uniform(6, W - 7, (P, F, 1))
    cv = rng.uniform(6, H - 7, (P, F, 1))
    Ku = jnp.asarray(cu + rng.uniform(-3, 3, (P, F, K)), jnp.float32)
    Kv = jnp.asarray(cv + rng.uniform(-3, 3, (P, F, K)), jnp.float32)
    I, gx, gy, ok = pattern_tile_sample(imgs, Ku, Kv)
    assert bool(ok.all())

    planes = []
    for f in range(F):
        g = central_gradients(imgs[f])
        planes.append(jnp.stack([imgs[f], g[0], g[1]], -1))
    hit = jax.vmap(lambda im, u, v: bilinear_3(im, u, v),
                   in_axes=(0, 1, 1), out_axes=1)(jnp.stack(planes), Ku, Kv)
    np.testing.assert_allclose(np.asarray(I), np.asarray(hit[..., 0]),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(hit[..., 1]),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(gy), np.asarray(hit[..., 2]),
                               atol=1e-3)


def test_pattern_tile_sample_out_of_bounds_masked():
    import numpy as np
    from slam_eds_tpu.utils.interp import pattern_tile_sample
    F, H, W, P, K = 2, 32, 40, 5, 8
    imgs = jnp.ones((F, H, W), jnp.float32)
    Ku = jnp.asarray(np.array([[-5.0, 0.5, 1.5, 20.0, W - 2.5, W - 1.5,
                                W + 9.0, np.nan]] * F)[None].repeat(P, 0),
                     jnp.float32)
    Kv = jnp.full((P, F, K), 10.0, jnp.float32)
    _, _, _, ok = pattern_tile_sample(imgs, Ku, Kv)
    expect = np.array([False, False, True, True, True, False, False, False])
    np.testing.assert_array_equal(np.asarray(ok[0, 0]), expect)


def test_pattern_tile_sample_matches_float64_reference():
    """pattern_tile_sample on a build_pyramid level against a float64 numpy
    bilinear of that level's own [I, gx, gy] planes (interior taps)."""
    from slam_eds_tpu.utils.image import build_pyramid
    from slam_eds_tpu.utils.interp import pattern_tile_sample

    rng = np.random.default_rng(2)
    F, H, W, P, K = 2, 48, 64, 64, 8
    raw = rng.uniform(0, 255, (F, 2 * H, 2 * W)).astype(np.float32)
    planes = [np.asarray(build_pyramid(jnp.asarray(im), 2)[0][1],
                         np.float64) for im in raw]        # [H, W, 3]
    u = rng.uniform(1, W - 2, (P, F, K)).astype(np.float32)
    v = rng.uniform(1, H - 2, (P, F, K)).astype(np.float32)
    I, gx, gy, ok = pattern_tile_sample(
        jnp.asarray(np.stack([p[..., 0] for p in planes]), jnp.float32),
        jnp.asarray(u), jnp.asarray(v))
    assert bool(ok.all())

    ud, vd = u.astype(np.float64), v.astype(np.float64)
    x0, y0 = np.floor(ud).astype(int), np.floor(vd).astype(int)
    fx, fy = ud - x0, vd - y0
    f = np.broadcast_to(np.arange(F)[None, :, None], u.shape)
    stack = np.stack(planes)                                # [F, H, W, 3]
    want = ((1 - fx) * (1 - fy))[..., None] * stack[f, y0, x0] \
        + (fx * (1 - fy))[..., None] * stack[f, y0, x0 + 1] \
        + ((1 - fx) * fy)[..., None] * stack[f, y0 + 1, x0] \
        + (fx * fy)[..., None] * stack[f, y0 + 1, x0 + 1]
    for got, c in ((I, 0), (gx, 1), (gy, 2)):
        # float32 bilinear weights on values up to 255
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   want[..., c], atol=1e-3)
