"""DCT, color conversion and resampling primitives (pure JAX).

The reference never runs its own FDCT: it re-encodes the dropon through
libjpeg at quality 100 to obtain subsampled DCT coefficients
(dropon.c:376, image.c:257-347).  Here the dropon compilation pipeline is
computed directly on device: RGB->YCbCr, box-filter chroma subsampling, and a
batched 8x8 forward DCT expressed as two matmuls per block.  At quality 100 every libjpeg quantval is 1, so
"quantized at Q100" is simply round-to-nearest-integer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def dct_matrix_np() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix T; JPEG coefficients are T @ X @ T.T."""
    T = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        cu = np.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            T[u, x] = 0.5 * cu * np.cos((2 * x + 1) * u * np.pi / 16)
    return T


@functools.lru_cache(maxsize=1)
def _t32() -> np.ndarray:
    # numpy, not jnp: a device constant created here could be cached as a
    # tracer when first touched inside a jit trace; as numpy it embeds as a
    # literal in each traced computation instead
    return dct_matrix_np().astype(np.float32)


@functools.partial(jax.jit, static_argnums=(1,))
def fdct_blocks(pixels: jax.Array, center: float = 128.0) -> jax.Array:
    """Forward DCT of level-shifted pixel blocks.

    pixels: [..., 8, 8] float32 sample values in [0, 2^P - 1]; ``center`` is
    the level shift 2^(P-1) (128 for 8-bit samples, 2048 for 12-bit).
    Returns [..., 8, 8] float32 unquantized JPEG-scale coefficients.
    """
    x = pixels - center
    T = _t32()
    return jnp.einsum("ux,...xy,vy->...uv", T, x, T,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnums=(1,))
def idct_blocks(coefs: jax.Array, center: float = 128.0) -> jax.Array:
    """Inverse DCT: [..., 8, 8] coefficients -> [..., 8, 8] pixel values."""
    T = _t32()
    x = jnp.einsum("ux,...uv,vy->...xy", T, coefs, T,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return x + center


def tile_blocks(plane: jax.Array) -> jax.Array:
    """[H, W] plane (H, W multiples of 8) -> [H/8, W/8, 8, 8] blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def untile_blocks(blocks: jax.Array) -> jax.Array:
    """[bh, bw, 8, 8] -> [bh*8, bw*8]."""
    bh, bw = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


# -- color conversion (JFIF / libjpeg float formulas) ------------------------

@functools.partial(jax.jit, static_argnums=(1,))
def rgb_to_ycc(rgb: jax.Array, center: float = 128.0) -> jax.Array:
    """[..., 3] float32 RGB in [0, 2^P - 1] -> [..., 3] YCbCr; ``center`` is
    the chroma zero point 2^(P-1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + center
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + center
    return jnp.stack([y, cb, cr], axis=-1)


@functools.partial(jax.jit, static_argnums=(1,))
def ycc_to_rgb(ycc: jax.Array, center: float = 128.0) -> jax.Array:
    """[..., 3] YCbCr -> RGB (JFIF inverse)."""
    y, cb, cr = ycc[..., 0], ycc[..., 1] - center, ycc[..., 2] - center
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return jnp.stack([r, g, b], axis=-1)


def subsample_plane(plane: jax.Array, fh: int, fv: int) -> jax.Array:
    """Box-average downsample [H, W] by integer factors (fh, fv).

    Matches libjpeg's jcsample box filter used during the reference's Q100
    dropon re-encode (within rounding; PSNR criterion applies inside the
    composited footprint).
    """
    if fh == 1 and fv == 1:
        return plane
    h, w = plane.shape
    return plane.reshape(h // fv, fv, w // fh, fh).mean(axis=(1, 3))


def upsample_plane_fancy(plane: jax.Array, fh: int, fv: int) -> jax.Array:
    """Triangle-filter ("fancy") upsample, matching libjpeg's default
    h2v1/h2v2 upsamplers used when the reference decodes a dropon JPEG to
    pixels (image.c:412-451 -> libjpeg jdsample).  Only factors 1 and 2 are
    supported (the only ones libjpeg implements fancily)."""
    out = plane
    if fh == 2:
        left = out
        right = jnp.concatenate([out[:, :1], out[:, :-1]], axis=1)
        nxt = jnp.concatenate([out[:, 1:], out[:, -1:]], axis=1)
        a = (3.0 * left + right + 1.0) / 4.0  # approximates (3a+b+1)>>2
        b = (3.0 * left + nxt + 2.0) / 4.0
        out = jnp.stack([a, b], axis=-1).reshape(out.shape[0], -1)
    elif fh != 1:
        out = jnp.repeat(out, fh, axis=1)
    if fv == 2:
        up = jnp.concatenate([out[:1], out[:-1]], axis=0)
        down = jnp.concatenate([out[1:], out[-1:]], axis=0)
        a = (3.0 * out + up + 1.0) / 4.0
        b = (3.0 * out + down + 2.0) / 4.0
        out = jnp.stack([a, b], axis=1).reshape(-1, out.shape[1])
    elif fv != 1:
        out = jnp.repeat(out, fv, axis=0)
    return out
