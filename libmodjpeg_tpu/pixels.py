"""CoefImage -> pixels on device (dequant + IDCT + upsample + color convert).

Replaces the reference's delegation to libjpeg's decompressor for dropon
ingestion (image.c:349-451): dequantization and the IDCT are batched matmuls,
upsampling/color conversion are vectorized elementwise ops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .errors import UnsupportedColorspaceError
from .model import CoefImage
from .ops import dct as dctops


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _plane_from_coefs(coefs: jax.Array, quant: jax.Array, comp_w: int,
                      comp_h: int, fh: int, fv: int,
                      center: float = 128.0) -> jax.Array:
    """[bh, bw, 8, 8] int16 + [8,8] quant -> float32 [comp_h*fv? ...] plane
    upsampled by (fh, fv) with libjpeg-style fancy filtering for factor 2."""
    deq = coefs.astype(jnp.float32) * quant.astype(jnp.float32)
    pix = dctops.idct_blocks(deq, center)
    plane = dctops.untile_blocks(pix)[:comp_h, :comp_w]
    return dctops.upsample_plane_fancy(plane, fh, fv)


def to_pixels(img: CoefImage, colorspace: int = C.COLORSPACE_RGB) -> np.ndarray:
    """Decode to raw pixels.

    colorspace: COLORSPACE_RGB, COLORSPACE_YCC or COLORSPACE_GRAYSCALE
    (mirrors mj_decode_jpeg_to_raw's want_colorspace, image.c:412-427).
    Returns uint8 [H, W, 3] (or [H, W, 1] for grayscale); 12-bit frames
    return uint16 samples in [0, 4095].
    """
    precision = getattr(img, "precision", 8)
    center = float(1 << (precision - 1))
    maxval = (1 << precision) - 1
    max_h, max_v = img.sampling.max_h_samp, img.sampling.max_v_samp
    planes = []
    for c, ci in enumerate(img.components):
        comp_w = -(-(img.width * ci.h_samp) // max_h)
        comp_h = -(-(img.height * ci.v_samp) // max_v)
        plane = _plane_from_coefs(
            jnp.asarray(img.coefs[c]),
            jnp.asarray(img.quant_table_for(c)),
            int(comp_w), int(comp_h),
            max_h // ci.h_samp, max_v // ci.v_samp,
            center,
        )
        planes.append(np.asarray(plane)[: img.height, : img.width])

    jcs = img.jpeg_color_space
    if jcs == C.JCS_GRAYSCALE:
        y = planes[0]
        if colorspace == C.COLORSPACE_GRAYSCALE:
            out = y[..., None]
        elif colorspace == C.COLORSPACE_RGB:
            out = np.repeat(y[..., None], 3, axis=-1)
        elif colorspace == C.COLORSPACE_YCC:
            out = np.dstack([y, np.full_like(y, center),
                             np.full_like(y, center)])
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    elif jcs == C.JCS_YCbCr:
        ycc = np.dstack(planes)
        if colorspace == C.COLORSPACE_YCC:
            out = ycc
        elif colorspace == C.COLORSPACE_RGB:
            out = np.asarray(dctops.ycc_to_rgb(jnp.asarray(ycc, jnp.float32),
                                               center))
        elif colorspace == C.COLORSPACE_GRAYSCALE:
            out = ycc[..., :1]
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    elif jcs == C.JCS_RGB:
        rgb = np.dstack(planes)
        if colorspace == C.COLORSPACE_RGB:
            out = rgb
        elif colorspace == C.COLORSPACE_YCC:
            out = np.asarray(dctops.rgb_to_ycc(jnp.asarray(rgb, jnp.float32),
                                               center))
        elif colorspace == C.COLORSPACE_GRAYSCALE:
            ycc = np.asarray(dctops.rgb_to_ycc(jnp.asarray(rgb, jnp.float32),
                                               center))
            out = ycc[..., :1]
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    elif jcs in (C.JCS_CMYK, C.JCS_YCCK):
        # Adobe convention: samples stored inverted (255 = no ink), so
        # R = C' * K' / maxval; YCCK additionally YCC-transforms C'M'Y'
        maxf = float(maxval)
        if jcs == C.JCS_YCCK:
            cmy = np.asarray(dctops.ycc_to_rgb(
                jnp.asarray(np.dstack(planes[:3]), jnp.float32), center))
        else:
            cmy = np.dstack(planes[:3])
        k = np.clip(planes[3], 0.0, maxf)[..., None]
        rgb = np.clip(cmy, 0.0, maxf) * k / maxf
        if colorspace == C.COLORSPACE_RGB:
            out = rgb
        elif colorspace == C.COLORSPACE_YCC:
            out = np.asarray(dctops.rgb_to_ycc(jnp.asarray(rgb, jnp.float32),
                                               center))
        elif colorspace == C.COLORSPACE_GRAYSCALE:
            out = np.asarray(dctops.rgb_to_ycc(
                jnp.asarray(rgb, jnp.float32), center))[..., :1]
        else:
            raise UnsupportedColorspaceError(str(colorspace))
    else:
        raise UnsupportedColorspaceError(f"jpeg colorspace {jcs}")
    dtype = np.uint8 if precision == 8 else np.uint16
    return np.clip(np.rint(out), 0, maxval).astype(dtype)
