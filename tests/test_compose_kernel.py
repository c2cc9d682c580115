"""The compose step against plain references.

``blend_blocks_m`` / ``compose_region_auto`` (the one device compose path)
against a float64 numpy evaluation of x1 + U^T diag(m) U (x0 - x1) with the
reference's truncating requantize, and against the S-basis spec
``blend_blocks``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from libmodjpeg_tpu.ops.compose import (_dct_kron, blend_blocks,
                                        blend_blocks_m, compose_region_auto,
                                        mask_pix_np)
from conftest import FIXTURE_IMAGES as IMAGES

SIZES = [1, 7, 2048, 2051, 4096]


def blend_f64(x1, x0, m):
    """x1 + U^T diag(m) U (x0 - x1) on [n, 64] rows, in float64 (row-vector
    convention: pixels = X @ U)."""
    U = _dct_kron().astype(np.float64)
    X = x0.astype(np.float64) - x1
    return x1 + ((X @ U) * m) @ U.T


def compose_f64(region, x0, m, q):
    """Dequantize, blend, truncating correction and truncating requantize
    (compose.c:277-336) in float64 / int64 numpy."""
    ri = region.astype(np.int64)
    x1 = ri * q
    corr = np.trunc(blend_f64(x1.astype(np.float64), x0, m) - x1)
    v = ri * q + corr.astype(np.int64)
    out = np.sign(v) * (np.abs(v) // q)
    return np.clip(out, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("n", SIZES)
def test_blend_matches_float64_and_spec(n):
    rng = np.random.RandomState(n)
    x1 = (rng.randn(n, 8, 8) * 300).astype(np.float32)
    x0 = (rng.randn(n, 8, 8) * 300).astype(np.float32)
    w = (rng.randn(n, 8, 8) * 0.02).astype(np.float32)
    w[:, 0, 0] = 0.25
    m = mask_pix_np(w)
    out = np.asarray(blend_blocks_m(jnp.asarray(x1), jnp.asarray(x0),
                                    jnp.asarray(m)))
    ref = blend_f64(x1.reshape(n, 64), x0.reshape(n, 64),
                    m.reshape(n, 64)).reshape(n, 8, 8)
    spec = np.asarray(blend_blocks(jnp.asarray(x1), jnp.asarray(x0),
                                   jnp.asarray(w)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(out, spec, rtol=1e-4, atol=5e-3)


def test_opaque_identity():
    """Opaque mask: the blend returns the dropon (to f32 eps)."""
    from libmodjpeg_tpu.ops.dct import fdct_blocks

    adct = np.rint(np.asarray(fdct_blocks(
        jnp.full((1, 8, 8), 255.0, jnp.float32))))[0]
    adct[0, 0] += 1024
    f = np.full((8, 8), 0.25)
    f[0, :] = 0.3535534 * 0.5
    f[:, 0] = 0.3535534 * 0.5
    f[0, 0] = 0.3535534 ** 2
    w = (adct * f / 1020.0).astype(np.float32)
    m = mask_pix_np(w)
    rng = np.random.RandomState(0)
    n = 16
    x1 = (rng.randn(n, 8, 8) * 300).astype(np.float32)
    x0 = (rng.randn(n, 8, 8) * 300).astype(np.float32)
    mb = np.broadcast_to(m, (n, 8, 8)).astype(np.float32)
    out = np.asarray(blend_blocks_m(jnp.asarray(x1), jnp.asarray(x0),
                                    jnp.asarray(mb)))
    np.testing.assert_allclose(out, x0, atol=3e-2)


@pytest.mark.parametrize("n", SIZES[:4])
def test_compose_matches_numpy_requant(n):
    """The requantized output may differ from the float64 reference only
    where the f32 blend lands on a truncation edge."""
    rng = np.random.RandomState(100 + n)
    region = rng.randint(-900, 900, (n, 8, 8)).astype(np.int16)
    x0 = (rng.randn(n, 8, 8) * 300).astype(np.float32)
    m = (rng.rand(n, 8, 8) * 0.9).astype(np.float32)
    q = rng.randint(1, 255, (n, 8, 8)).astype(np.int32)
    out = np.asarray(compose_region_auto(jnp.asarray(region),
                                         jnp.asarray(x0), jnp.asarray(m),
                                         jnp.asarray(q)))
    ref = compose_f64(region.reshape(n, 64), x0.reshape(n, 64),
                      m.reshape(n, 64), q.reshape(n, 64)).reshape(n, 8, 8)
    assert out.dtype == np.int16
    diff = out.astype(int) - ref.astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.005


def test_zero_mask_is_exact_identity():
    """All-zero mask weights (untouched blocks, and the zero-alpha padding
    that realizes sub-block placement) reproduce the input coefficients
    EXACTLY, dequantize + requantize round trip included."""
    rng = np.random.RandomState(7)
    n = 2053
    region = rng.randint(-2047, 2048, (n, 8, 8)).astype(np.int16)
    x0 = (rng.randn(n, 8, 8) * 500).astype(np.float32)
    w = np.zeros((n, 8, 8), np.float32)
    q = rng.randint(1, 65535, (n, 8, 8)).astype(np.int32)
    out = np.asarray(compose_region_auto(jnp.asarray(region),
                                         jnp.asarray(x0), jnp.asarray(w),
                                         jnp.asarray(q)))
    np.testing.assert_array_equal(out, region)


def test_compose_region_nd_with_broadcast_quant():
    """Leading batch axes and one [8, 8] quant table broadcast over them."""
    rng = np.random.RandomState(3)
    shape = (2, 3, 4, 8, 8)
    region = rng.randint(-600, 600, shape).astype(np.int16)
    d = (rng.randn(*shape) * 200).astype(np.float32)
    a = (rng.rand(*shape) * 0.9).astype(np.float32)
    q = rng.randint(1, 128, (8, 8)).astype(np.int32)
    out = np.asarray(compose_region_auto(jnp.asarray(region), jnp.asarray(d),
                                         jnp.asarray(a), jnp.asarray(q)))
    assert out.dtype == np.int16 and out.shape == shape
    qb = np.broadcast_to(q, shape).reshape(-1, 64)
    ref = compose_f64(region.reshape(-1, 64), d.reshape(-1, 64),
                      a.reshape(-1, 64), qb).reshape(shape)
    diff = out.astype(int) - ref.astype(int)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() < 0.005


def test_grid_sharded_matches_single_device():
    """The compose inside the GSPMD-sharded grid (8-device CPU mesh) gives
    the single-device result."""
    import libmodjpeg_tpu as mj
    from libmodjpeg_tpu.parallel import compose_sharded, make_mesh

    img = mj.read_jpeg(f"{IMAGES}/image.jpg")
    logo = mj.read_dropon(f"{IMAGES}/dropon.png")
    single = mj.compose(img, logo, mj.ALIGN_CENTER, 3, -7)
    sharded = compose_sharded(img, logo, mj.ALIGN_CENTER, 3, -7,
                              make_mesh(batch=1, grid=8))
    for c in range(3):
        np.testing.assert_array_equal(sharded.coefs[c], single.coefs[c])
