"""Device-side Huffman symbol histograms: optimize as a mesh all-reduce.

libjpeg's optimized-tables mode is a serial two-pass host walk (jchuff
statistics then emission; the reference delegates to it via
image.c:170-189 ``optimize_coding``).  Every sequential-scan Huffman
symbol is derivable from the coefficient grid itself with vectorized ops:

- AC (run, size) symbols, ZRL and EOB are **block-local** — runs of zeros
  in zigzag order, magnitude categories, and the end-of-block condition
  depend only on the block's own 64 coefficients;
- DC difference categories need only each block's predecessor in scan
  order, a static gather (``seq_pred_indices``), with -1 sentinels where
  restart intervals reset the predictor.

So the whole statistics pass runs on device as bincounts over the (possibly
sharded) grids.  Under a mesh, XLA turns the replicated-output scatter-adds
into per-shard partial histograms + an all-reduce (SURVEY.md §7: "Huffman-
optimize as a global histogram pass — a natural all-reduce"): a grid-sharded
100MP image's optimize statistics never leave the device mesh until the
257-entry totals come back for table build.  The tables are then built by
the native encoder's own builder (codec.build_optimal_table) so tie-breaking
matches the host optimize pass exactly and the output file is byte-identical
to ``OPTION_OPTIMIZE``.

Scope: sequential Huffman scans (the reference's "optimize" for baseline
output).  Progressive per-scan statistics depend on EOB-run chunking and
stay in the native encoder's parallel host pass.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C

_ZIGZAG = jnp.asarray(np.asarray(C.ZIGZAG, dtype=np.int32))


def _bit_width(av: jax.Array) -> jax.Array:
    """Magnitude category: 0 for 0, floor(log2(av))+1 otherwise (av >= 0)."""
    return jnp.where(av > 0, 32 - jax.lax.clz(av.astype(jnp.int32)), 0)


def _histn(sym: jax.Array, valid: jax.Array, nbins: int) -> jax.Array:
    """Count symbols 0..nbins-1 where ``valid``, [nbins] int32.

    An int32 scatter-add: exact for any count a frame can hold (GPUs run it
    as native integer atomics), so the tables built from it match the host
    optimize pass byte for byte."""
    m = jnp.where(valid, sym, -1).reshape(-1)
    v = (m >= 0).astype(jnp.int32)
    return jnp.zeros(nbins, jnp.int32).at[jnp.maximum(m, 0)].add(v)


def _hist256(sym: jax.Array, valid: jax.Array) -> jax.Array:
    return _histn(sym, valid, 256)


def _ac_symbols(blocks: jax.Array) -> tuple:
    """Per-coefficient AC (run,size) symbols for one plane.

    Returns (sym [N,63] with -1 at zeros, zrl_count scalar, eob_count scalar)
    — the exact symbol stream walk_seq_segment emits (encoder.inc)."""
    zz = jnp.take(blocks.reshape(-1, 64).astype(jnp.int32), _ZIGZAG, axis=1)
    ac = zz[:, 1:]                                   # [N, 63]
    nz = ac != 0
    idx = jnp.arange(1, 64, dtype=jnp.int32)
    marked = jnp.where(nz, idx, 0)
    incl = jax.lax.associative_scan(jnp.maximum, marked, axis=1)
    prev = jnp.concatenate(
        [jnp.zeros_like(incl[:, :1]), incl[:, :-1]], axis=1)
    run = idx - prev - 1                             # zeros since last nonzero
    size = _bit_width(jnp.abs(ac))
    sym = jnp.where(nz, ((run & 15) << 4) | size, -1)
    zrl = jnp.sum(jnp.where(nz, run >> 4, 0))
    eob = jnp.sum((incl[:, -1] < 63).astype(jnp.int32))
    return sym, zrl, eob


def _dc_categories(blocks: jax.Array, pred_idx: jax.Array) -> jax.Array:
    dc = blocks.reshape(-1, 64).astype(jnp.int32)[:, 0]
    pred = jnp.where(pred_idx >= 0, dc[jnp.maximum(pred_idx, 0)], 0)
    return _bit_width(jnp.abs(dc - pred))


@functools.partial(jax.jit, static_argnames=("slots",))
def _freqs_fused(planes, preds, *, slots) -> tuple:
    """All components' DC+AC histograms in ONE dispatch.  The table slot is
    folded into the symbol's high bits, so a single scatter-add yields every
    slot's histogram at once.

    Returns [nslots, 32 + 256] int32: DC categories then AC symbols."""
    ns = max(slots) + 1
    ac_parts, ac_valid, dc_parts = [], [], []
    zrl = [jnp.int32(0)] * ns
    eob = [jnp.int32(0)] * ns
    for blocks, pred, slot in zip(planes, preds, slots):
        sym, z, e = _ac_symbols(blocks)
        ac_parts.append((sym + (slot << 8)).reshape(-1))
        ac_valid.append((sym >= 0).reshape(-1))
        zrl[slot] = zrl[slot] + z
        eob[slot] = eob[slot] + e
        cat = _dc_categories(blocks, pred)
        dc_parts.append(cat + slot * 32)
    ac_sym = jnp.concatenate(ac_parts)
    ac_ok = jnp.concatenate(ac_valid)
    ac = _histn(ac_sym, ac_ok, ns * 256).reshape(ns, 256)
    for s in range(ns):
        ac = ac.at[s, 0xF0].add(zrl[s])
        ac = ac.at[s, 0x00].add(eob[s])
    dc_cat = jnp.concatenate(dc_parts)
    dc = _histn(dc_cat, jnp.ones_like(dc_cat, dtype=bool),
                ns * 32).reshape(ns, 32)
    return jnp.concatenate([dc, ac], axis=1)        # one [ns, 288] transfer


@jax.jit
def ac_symbol_hist(blocks: jax.Array) -> jax.Array:
    """AC symbol counts for a sequential full scan, [256] int32.

    ``blocks``: [..., 8, 8] integer coefficients (natural order).  Counts
    exactly the symbols walk_seq_segment emits (encoder.inc): (run, size)
    per nonzero with ZRL (0xF0) for runs > 15, EOB (0x00) when the last
    nonzero is before position 63.
    """
    sym, zrl, eob = _ac_symbols(blocks)
    hist = _hist256(sym, sym >= 0)
    hist = hist.at[0xF0].add(zrl)
    hist = hist.at[0].add(eob)
    return hist


@jax.jit
def dc_category_hist(blocks: jax.Array, pred_idx: jax.Array) -> jax.Array:
    """DC difference-category counts, [256] int32.

    ``pred_idx``: int32 [N] index of each block's predecessor in scan order
    (into the same flattened plane), or -1 where the predictor resets
    (scan/restart-segment starts) — see seq_pred_indices.
    """
    cat = _dc_categories(blocks, pred_idx)
    return _hist256(cat, jnp.ones_like(cat, dtype=bool))


def seq_pred_indices(components, mcus_wide: int,
                     restart_interval: int = 0) -> list[np.ndarray]:
    """Static DC-predecessor maps for a sequential full scan.

    For each component (with its padded [ph, pw] block plane) returns the
    flattened row-major index of the block encoded immediately before it in
    the interleaved MCU walk, or -1 at scan/segment starts.  Single-component
    frames degenerate to raster order.  Purely geometric — computed once per
    (geometry, restart interval) on host.
    """
    interleaved = len(components) > 1
    out = []
    for ci in components:
        h, v = (ci.h_samp, ci.v_samp) if interleaved else (1, 1)
        pw = ci.padded_width_in_blocks
        ph = ci.padded_height_in_blocks
        mw = mcus_wide if interleaved else pw
        row, col = np.mgrid[0:ph, 0:pw]
        m = (row // v) * mw + (col // h)             # MCU index in the walk
        j = (row % v) * h + (col % h)                # block slot within MCU
        s = m * (h * v) + j                          # component walk index
        mp, jp = (s - 1) // (h * v), (s - 1) % (h * v)
        prow = (mp // mw) * v + jp // h
        pcol = (mp % mw) * h + jp % h
        pidx = prow * pw + pcol
        reset = (s == 0) | ((j == 0) & (restart_interval > 0)
                            & (m % max(restart_interval, 1) == 0))
        out.append(np.where(reset, -1, pidx).astype(np.int32).ravel())
    return out


@functools.lru_cache(maxsize=64)
def _device_pred_indices(key) -> tuple:
    """Device-resident predecessor maps, cached per geometry (the maps are
    purely geometric, so they are uploaded once)."""
    geo, mcus_wide, restart_interval = key
    comps = [types.SimpleNamespace(h_samp=h, v_samp=v,
                                   padded_width_in_blocks=pw,
                                   padded_height_in_blocks=ph)
             for h, v, pw, ph in geo]
    return tuple(jnp.asarray(p) for p in
                 seq_pred_indices(comps, mcus_wide, restart_interval))


def symbol_freqs(coefs, components, mcus_wide: int,
                 restart_interval: int = 0) -> dict:
    """Per-table-slot symbol frequencies for a sequential full scan.

    ``coefs``: list of [H, W, 8, 8] arrays (numpy or device/sharded jax) —
    the REAL padded planes (no mesh padding rows).  Slot assignment mirrors
    the encoder: component 0 -> slot 0, all others -> slot 1.  Returns
    {("dc"|"ac", slot): int64[257]} matching the native FreqSink counts
    exactly.
    """
    key = (tuple((c.h_samp, c.v_samp, c.padded_width_in_blocks,
                  c.padded_height_in_blocks) for c in components),
           mcus_wide, restart_interval)
    preds = _device_pred_indices(key)
    slots = tuple(0 if c == 0 else 1 for c in range(len(coefs)))
    h = np.asarray(_freqs_fused(tuple(coefs), preds, slots=slots))
    freqs: dict = {}
    for slot in sorted(set(slots)):
        dc = np.zeros(257, np.int64)
        ac = np.zeros(257, np.int64)
        dc[:32] = h[slot, :32]
        ac[:256] = h[slot, 32:]
        freqs[("dc", slot)] = dc
        freqs[("ac", slot)] = ac
    return freqs


def optimal_tables(coefs, components, mcus_wide: int,
                   restart_interval: int = 0) -> list:
    """Device histogram -> native table build.  Returns the preset-table
    list codec.encode(preset_tables=...) accepts; the resulting file is
    byte-identical to the host OPTION_OPTIMIZE pass."""
    from .. import codec

    freqs = symbol_freqs(coefs, components, mcus_wide, restart_interval)
    tables = []
    for (kind, slot), f in sorted(freqs.items()):
        counts, syms = codec.build_optimal_table(f)
        tables.append((0 if kind == "dc" else 1, slot, counts, syms))
    return tables
