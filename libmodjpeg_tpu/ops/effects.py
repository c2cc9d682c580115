"""DCT-domain effects as vectorized device ops (effect.c parity).

All four effects are elementwise over the block grid — embarrassingly
parallel, trivially shardable over a mesh (SURVEY.md §3.5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def zero_component(comp_grid: jax.Array) -> jax.Array:
    """grayscale: zero every coefficient of a chroma component
    (effect.c:44-65)."""
    return jnp.zeros_like(comp_grid)


@jax.jit
def zero_ac(comp_grid: jax.Array) -> jax.Array:
    """pixelate: zero all 63 AC coefficients of every block
    (effect.c:88-108)."""
    mask = jnp.zeros((8, 8), dtype=comp_grid.dtype).at[0, 0].set(1)
    return comp_grid * mask


@functools.partial(jax.jit, static_argnums=(3,))
def add_to_dc(comp_grid: jax.Array, quant: jax.Array, value: jax.Array,
              clamp: int = 2047) -> jax.Array:
    """tint / luminance: dequantize DC, add value, clamp to +-clamp,
    requantize with truncating division (effect.c:143-153,207-217).

    The reference hardcodes +-2047, the dequantized DC range for 8-bit
    samples; 12-bit frames use +-32767 ((1 << (precision + 3)) - 1)."""
    q0 = quant[0, 0].astype(jnp.int32)
    dc = comp_grid[:, :, 0, 0].astype(jnp.int32)
    dc = dc * q0 + value.astype(jnp.int32)
    dc = jnp.clip(dc, -clamp, clamp)
    dc = jnp.sign(dc) * (jnp.abs(dc) // q0)
    return comp_grid.at[:, :, 0, 0].set(dc.astype(comp_grid.dtype))
