"""Masked DCT-domain composition kernels.

The reference implements R. Jonsson's masked composition
y = x1 + W (*) (x0 - x1) with ~1100 lines of unrolled scalar C
(convolve.c:29-1096): for each mask frequency (k, l) it applies a separable
pair of sparse 8x8 operators.  Reading off that structure, the per-frequency
operator is S_k (rows) x S_l (columns) where

  S_0 = 2*I
  S_n[m, .] couples x[|m-n|] (weight sqrt(2) when the index is 0) and the
  reflectively folded x[m+n]  (+x[m+n] for m+n<8, nothing at m+n=8,
  -x[16-(m-n)] past the fold), and S_n[0, n] = sqrt(2)

— the DCT-II product identity.  The full blend is therefore

  Y = sum_{k,l} w[k,l] * S_k @ X @ S_l^T

which we evaluate as three batched einsums (~12k MACs per block) instead of the reference's O(64^2) scalar pass per block
(compose.c:300-312).  Identity check: a fully-opaque mask makes the total
operator the identity, so Y == X exactly (tested in test_compose_math.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SQRT2 = float(np.sqrt(2.0))


def basis_matrices_np() -> np.ndarray:
    """The eight 1-D convolution operators S_n, shape [8, 8, 8] (n, m, j)."""
    S = np.zeros((8, 8, 8), dtype=np.float64)
    S[0] = 2.0 * np.eye(8)
    for n in range(1, 8):
        for m in range(8):
            if m == 0:
                S[n, 0, n] = SQRT2
                continue
            j1 = abs(m - n)
            S[n, m, j1] += SQRT2 if j1 == 0 else 1.0
            p = m + n
            if p < 8:
                S[n, m, p] += 1.0
            elif p > 8:
                S[n, m, 16 - p] -= 1.0
    return S


@functools.lru_cache(maxsize=1)
def _s32() -> np.ndarray:
    # numpy, not jnp: avoids import-time backend init AND tracer caching
    return basis_matrices_np().astype(np.float32)


@jax.jit
def blend_blocks(x_image: jax.Array, x_dropon: jax.Array,
                 w_alpha: jax.Array) -> jax.Array:
    """Masked blend of batched dequantized blocks.

    x_image:  [N, 8, 8] float32 dequantized image coefficients (x1)
    x_dropon: [N, 8, 8] float32 dropon coefficients (x0)
    w_alpha:  [N, 8, 8] float32 normalized mask-DCT weights w'
    Returns   [N, 8, 8] float32: x1 + sum_{kl} w'[k,l] S_k (x0-x1) S_l^T
    """
    X = x_dropon - x_image                       # compose.c:289-298
    S = _s32()
    # M[n,k] = sum_l w[n,k,l] * S_l
    hi = jax.lax.Precision.HIGHEST  # full f32: bf16/TF32 passes would cost
    M = jnp.einsum("nkl,lcd->nkcd", w_alpha, S,      # several coefficient
                   preferred_element_type=jnp.float32,  # units of error
                   precision=hi)
    # P[n,k] = S_k @ X[n]
    P = jnp.einsum("kab,nbc->nkac", S, X,
                   preferred_element_type=jnp.float32, precision=hi)
    # Y[n] = sum_k P[n,k] @ M[n,k]^T
    Y = jnp.einsum("nkac,nkdc->nad", P, M,
                   preferred_element_type=jnp.float32, precision=hi)
    return x_image + Y


@functools.lru_cache(maxsize=1)
def _dct_kron() -> np.ndarray:
    """U = C (x) C, the orthonormal 2-D DCT-II operator on row-major
    flattened 8x8 blocks, float32 [64, 64] (built in float64)."""
    C = np.zeros((8, 8), dtype=np.float64)
    for i in range(8):
        for j in range(8):
            c = np.sqrt(1 / 8) if i == 0 else np.sqrt(2 / 8)
            C[i, j] = c * np.cos((2 * j + 1) * i * np.pi / 16)
    return np.kron(C, C).astype(np.float32)


# mask-DCT weight -> pixel-mask scale: the operator sum_{kl} w_kl S_k (x) S_l
# is EXACTLY diagonal in the orthonormal DCT basis (verified to 1e-14 in
# test_compose_math), with diagonal m = C^T (w * g) C where g = 16 f f^T,
# f = [sqrt2, 1, ..., 1].
_MASK_GAIN = 16.0 * np.outer(*([np.array([SQRT2] + [1.0] * 7)] * 2))


def mask_pix_np(w_alpha: np.ndarray) -> np.ndarray:
    """Normalized mask-DCT weights [..., 8, 8] -> the equivalent per-
    coefficient PIXEL-domain mask m [..., 8, 8] (float64 math, f32 out).

    With m, the blend collapses from 16 Kronecker GEMMs + 64 scaling
    passes to DCT -> one elementwise multiply -> IDCT (2 GEMMs total):
    Y = x1 + U^T diag(m) U (x0 - x1), U = C (x) C.  Exactly equivalent in
    exact arithmetic; opaque mask -> m == 1, zero mask -> m == 0 exactly.
    """
    C = np.zeros((8, 8), dtype=np.float64)
    for i in range(8):
        for j in range(8):
            c = np.sqrt(1 / 8) if i == 0 else np.sqrt(2 / 8)
            C[i, j] = c * np.cos((2 * j + 1) * i * np.pi / 16)
    wg = np.asarray(w_alpha, np.float64) * _MASK_GAIN
    m = np.einsum("ki,...kl,lj->...ij", C, wg, C)
    return np.ascontiguousarray(m, np.float32)


@jax.jit
def blend_blocks_m(x_image: jax.Array, x_dropon: jax.Array,
                   mask_pix: jax.Array) -> jax.Array:
    """Masked blend via the pixel-domain mask (the hot-path formulation).

    x_image/x_dropon: [N, 8, 8] float32; mask_pix: [N, 8, 8] float32 from
    mask_pix_np.  Returns x1 + IDCT2(m * DCT2(x0 - x1)) — identical to
    blend_blocks (the S-basis spec) up to f32 rounding, at 2 GEMMs/block.
    """
    n = x_image.shape[0]
    U = jnp.asarray(_dct_kron())
    hi = jax.lax.Precision.HIGHEST
    X = (x_dropon - x_image).reshape(n, 64)
    # row-vector convention: pixels p = X @ U, mask, back via @ U^T
    t = jnp.dot(X, U, preferred_element_type=jnp.float32, precision=hi)
    t = t * mask_pix.reshape(n, 64)
    Y = jnp.dot(t, U.T, preferred_element_type=jnp.float32, precision=hi)
    return x_image + Y.reshape(n, 8, 8)


def compose_region_auto(region: jax.Array, dropon: jax.Array,
                        mask_pix: jax.Array, quant: jax.Array) -> jax.Array:
    """The full compose step for a region of quantized coefficients:
    dequantize, masked blend, truncating correction, truncating requantize
    (compose.c:277-336 semantics), returned as int16.

    region: [..., 8, 8] int16/int32 quantized image coefficients
    dropon/mask_pix: same shape, float-castable (already broadcast);
    mask_pix is the PIXEL-domain mask from mask_pix_np
    quant: int-castable, broadcastable to region's shape

    All compose paths (batch, packed, grid-sharded, graft entry) route
    through here; XLA fuses the integer prologue and epilogue around the two
    GEMMs.  An exactly-zero mask block reproduces its input EXACTLY
    (m=0 makes the delta exactly 0 and sign(r*q)*(|r*q|//q) == r), which is
    what keeps transparent-padding blocks bit-exact."""
    shape = region.shape
    region = region.astype(jnp.int32)
    qi = jnp.broadcast_to(quant.astype(jnp.int32), shape)
    x1 = region.astype(jnp.float32) * qi.astype(jnp.float32)
    y = blend_blocks_m(x1.reshape(-1, 8, 8),
                       dropon.astype(jnp.float32).reshape(-1, 8, 8),
                       mask_pix.astype(jnp.float32).reshape(-1, 8, 8))
    y = y.reshape(shape)
    corr = jnp.trunc(y - x1).astype(jnp.int32)
    out = requant_trunc(region * qi + corr, qi)
    return jnp.clip(out, -32768, 32767).astype(jnp.int16)


@jax.jit
def requant_trunc(values: jax.Array, quant: jax.Array) -> jax.Array:
    """C-style truncating integer division (compose.c:327-336 semantics).

    values: [..., 8, 8] int32; quant: [8, 8] uint16/int32.
    """
    q = quant.astype(jnp.int32)
    v = values.astype(jnp.int32)
    return jnp.sign(v) * (jnp.abs(v) // q)


