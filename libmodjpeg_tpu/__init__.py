"""libmodjpeg_tpu — JPEG DCT-domain compositing engine in JAX.

A from-scratch reimplementation of the capabilities of libmodjpeg
(https://github.com/ioppermann/libmodjpeg), run on an NVIDIA GPU:

* a from-scratch parallel C++ entropy codec (restart-marker-segmented
  Huffman/arithmetic decode + encode) replaces libjpeg delegation;
* dequantize → masked DCT-domain compose → requantize run as dense batched
  JAX/XLA programs over 8x8 coefficient blocks (Jonsson ICIP'97 masked
  composition, computed as batched matmuls);
* batches and MCU tile grids shard over a `jax.sharding.Mesh`.

Public API mirrors the mj_* lifecycle of the reference
(/root/reference/src/libmodjpeg.h:129-149) in idiomatic Python.
"""

from .constants import (  # noqa: F401
    ALIGN_BOTTOM,
    ALIGN_CENTER,
    ALIGN_LEFT,
    ALIGN_RIGHT,
    ALIGN_TOP,
    BLEND_FULL,
    BLEND_NONE,
    BLEND_NONUNIFORM,
    COLORSPACE_GRAYSCALE,
    COLORSPACE_GRAYSCALEA,
    COLORSPACE_RGB,
    COLORSPACE_RGBA,
    COLORSPACE_YCC,
    COLORSPACE_YCCA,
    OPTION_ARITHMETIC,
    OPTION_ARITHMETRIC,
    OPTION_NONE,
    OPTION_OPTIMIZE,
    OPTION_PROGRESSIVE,
    VERSION_STR,
)
from .errors import (  # noqa: F401
    DecodeError,
    DroponDimensionsError,
    EncodeError,
    FileIOError,
    ImageSizeError,
    ModJpegError,
    NullDataError,
    UnsupportedColorspaceError,
    UnsupportedFiletypeError,
)
from .model import CoefImage, CompiledDropon, Dropon  # noqa: F401

__version__ = VERSION_STR


def read_jpeg(source, max_pixel: int = 0,
              allow_cmyk: bool = False) -> "CoefImage":
    """Read a JPEG (path or bytes) into coefficient space.

    Mirrors mj_read_jpeg_from_file/_memory (image.c:33,115) including the
    max_pixel anti-DoS guard (image.c:79-82) and the colorspace guard
    (image.c:84-92).  allow_cmyk=True extends the guard to admit
    4-component Adobe CMYK/YCCK frames (beyond the reference).
    """
    from .jpegio import read_jpeg as _impl

    return _impl(source, max_pixel=max_pixel, allow_cmyk=allow_cmyk)


def write_jpeg(img: "CoefImage", dest=None, options: int = 0,
               ref_markers: bool = False):
    """Write a CoefImage to a path (dest=str) or return bytes (dest=None).

    Mirrors mj_write_jpeg_to_file/_memory (image.c:136,211); options are
    OPTION_* flags (image.c:170-189).  ref_markers=True reproduces libjpeg's
    marker emission (duplicated JFIF APP0) for byte-parity with the
    reference binary — pair with compose(..., bitexact=True).
    """
    from .jpegio import write_jpeg as _impl

    return _impl(img, dest, options=options, ref_markers=ref_markers)


def read_dropon(source, mask=None, blend: int = BLEND_FULL) -> "Dropon":
    """Load a dropon from a PNG/JPEG path or bytes, with optional JPEG mask.

    Mirrors mj_read_dropon_from_file/_memory (dropon.c:34,66).
    """
    from .dropon import read_dropon as _impl

    return _impl(source, mask=mask, blend=blend)


def read_dropon_from_raw(rawdata, colorspace: int, width: int, height: int,
                         blend: int = BLEND_FULL) -> "Dropon":
    """Mirrors mj_read_dropon_from_raw (dropon.c:203)."""
    from .dropon import read_dropon_from_raw as _impl

    return _impl(rawdata, colorspace, width, height, blend)


def compose(img: "CoefImage", dropon: "Dropon", align: int = 0,
            offset_x: int = 0, offset_y: int = 0,
            bitexact: bool = False) -> "CoefImage":
    """Compose a dropon onto an image entirely in the DCT domain.

    Mirrors mj_compose (compose.c:33): placement from align flags + offsets,
    crop against borders, MCU-grid alignment via zero-alpha padding, masked
    Jonsson blend.  Returns a new CoefImage (functional style; the reference
    mutates in place).

    ``bitexact=True`` selects the host-side reference-parity path
    (bitexact.py): touched blocks reproduce compose.c's arithmetic
    coefficient-for-coefficient, so with ``write_jpeg(..., ref_markers=True)``
    whole output files are byte-identical to the reference binary's.
    """
    if bitexact:
        from .bitexact import compose_bitexact

        return compose_bitexact(img, dropon, align, offset_x, offset_y)
    from .composer import compose as _impl

    return _impl(img, dropon, align, offset_x, offset_y)


_WATERMARK_CACHE: dict = {}   # (dropon fp, geometry, placement) -> composer
_WATERMARK_CACHE_MAX = 16


def _dropon_fingerprint(d) -> str:
    """Content hash of a dropon, memoized on the instance (dropons are
    immutable after ingestion)."""
    fp = getattr(d, "_fingerprint", None)
    if fp is None:
        import hashlib

        import numpy as _np

        h = hashlib.sha1()
        h.update(_np.ascontiguousarray(d.image).tobytes())
        h.update(_np.ascontiguousarray(d.alpha).tobytes())
        h.update(f"{d.colorspace}/{d.blend}".encode())
        fp = h.hexdigest()
        try:
            d._fingerprint = fp
        except AttributeError:
            pass   # slotted/frozen instance: just recompute next time
    return fp


def watermark(data: bytes, dropon: "Dropon", align: int = 0,
              offset_x: int = 0, offset_y: int = 0,
              surgical=None) -> bytes:
    """One-shot bytes-in/bytes-out compose: decode + compose + encode.

    For sequential-Huffman inputs carrying restart markers this takes the
    surgical splice path (surgical.py): only the restart segments the overlay
    footprint touches are entropy-coded, the rest of the bitstream is copied
    verbatim — output coefficients identical to compose()+write_jpeg().
    ``surgical=False`` forces the full pipeline.

    The compiled dropon (and its jitted compose program) is cached keyed by
    (dropon content, image geometry+quant tables, placement), so repeated
    calls with the same logo over same-shaped images skip dropon compilation
    and XLA recompilation entirely.  For large fleets, prefer
    parallel.BatchComposer.watermark_stream, which also pipelines the
    decode/compose/encode stages and batches the device round trips.
    """
    from . import codec
    from .corpus import _geometry_key
    from .parallel.batch import BatchComposer
    from .surgical import parse_structure

    # header-only geometry probe where possible: on a cache HIT the stream's
    # band splice is then the ONLY entropy work (a full template decode per
    # call would halve the splice's benefit for repeat-logo workloads).
    # DNL-deferred-height streams carry height 0 in the SOF — the real
    # height only exists after a decode — so they must NOT share a
    # header-probe key (same-skeleton DNL files of different heights would
    # collide and composite at the wrong rows).
    st = parse_structure(data)
    if st is not None and st.height == 0:
        st = None
    template = None
    if st is not None:
        gkey = st.geometry_key()
    else:
        template = codec.decode(data)
        gkey = _geometry_key(template)
    key = (_dropon_fingerprint(dropon), gkey, align, offset_x, offset_y)
    bc = _WATERMARK_CACHE.get(key)
    if bc is None:
        if template is None:
            template = codec.decode(data)
        bc = BatchComposer(template, dropon, align, offset_x, offset_y)
        while len(_WATERMARK_CACHE) >= _WATERMARK_CACHE_MAX:
            _WATERMARK_CACHE.pop(next(iter(_WATERMARK_CACHE)))
        _WATERMARK_CACHE[key] = bc
    if bc.noop:
        return codec.encode(template if template is not None
                            else codec.decode(data))
    return next(iter(bc.watermark_stream(iter([data]), batch=1,
                                         surgical=surgical)))


def effect_grayscale(img: "CoefImage") -> "CoefImage":
    from .effects import grayscale

    return grayscale(img)


def effect_pixelate(img: "CoefImage") -> "CoefImage":
    from .effects import pixelate

    return pixelate(img)


def effect_tint(img: "CoefImage", cb_value: int, cr_value: int) -> "CoefImage":
    from .effects import tint

    return tint(img, cb_value, cr_value)


def effect_luminance(img: "CoefImage", value: int) -> "CoefImage":
    from .effects import luminance

    return luminance(img, value)
