"""Batched compose: many same-geometry images, one (or per-image) dropon.

The BASELINE.json config-3 workload: watermark a fleet of thumbnails with a
logo, batch sharded over chips.  Each image is block-local, so the compose is
embarrassingly parallel over the batch axis — no collectives on the hot path.
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..model import CoefImage, Dropon
from ..ops.compose import compose_region_auto


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("row0", "col0"))
def _compose_batch_component(grids: jax.Array, dropon_blocks: jax.Array,
                             mask_pix: jax.Array, quant: jax.Array,
                             row0: int, col0: int) -> jax.Array:
    """grids: [N, H, W, 8, 8] int16; dropon/alpha: [h, w, 8, 8] (broadcast
    over the batch) or [N, h, w, 8, 8] per-image.  Static origin lets XLA
    lower to a plain strided update, sharded over the batch axis."""
    n = grids.shape[0]
    h, w = dropon_blocks.shape[-4:-2]
    region = grids[:, row0:row0 + h, col0:col0 + w]
    if dropon_blocks.ndim == 4:
        dropon_b = jnp.broadcast_to(dropon_blocks, (n, h, w, 8, 8))
        alpha_b = jnp.broadcast_to(mask_pix, (n, h, w, 8, 8))
    else:
        dropon_b, alpha_b = dropon_blocks, mask_pix
    out = compose_region_auto(region, dropon_b, alpha_b, quant)
    return grids.at[:, row0:row0 + h, col0:col0 + w].set(out)


def _wirepack(flat: np.ndarray):
    """Exact int8+exceptions packing of the host->device region payload.

    Quantized DCT coefficients are tiny: <0.2% of real footprint values
    fall outside int8.  So the host->device wire carries ``lo`` = clip(v, -128, 127) as
    int8 plus a fixed-capacity per-row exception list; the device restores
    exact int16 with one scatter (pad slots index past the row end and are
    dropped).  Capacity quantizes to
    power-of-two buckets so jit re-specializes at most a handful of times.
    Returns (lo, eidx, evals) or None when the payload is exception-heavy
    (fall back to the raw int16 wire).
    """
    n, sz = flat.shape
    lo = np.clip(flat, -128, 127).astype(np.int8)
    mask = flat != lo
    counts = mask.sum(axis=1)
    mx = int(counts.max()) if n else 0
    if mx * 4 > sz:  # degenerate content: packing would not pay
        return None
    cap = 8
    while cap < mx:
        cap *= 2
    # pad slots point one past the row end: jax wraps NEGATIVE indices
    # (numpy semantics), so only a too-HIGH index is dropped by mode="drop"
    eidx = np.full((n, cap), sz, np.int32)
    evals = np.zeros((n, cap), np.int16)
    rows, cols = np.nonzero(mask)
    if rows.size:
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(rows.size) - starts[rows]
        eidx[rows, slot] = cols.astype(np.int32)
        evals[rows, slot] = flat[rows, cols]
    return lo, eidx, evals


def _downunpack(wire: np.ndarray, cap: int):
    """Host restore of the packed downlink wire (see _packed_compose_fn's
    pack_down): returns (flat int16 [n, sz], counts int32 [n]).  Rows with
    counts > cap are incomplete and must be refetched from the raw output."""
    sz = wire.shape[1] - cap * 6 - 4
    lo = wire[:, :sz]
    eidx = wire[:, sz:sz + cap * 4].copy().view(np.int32)
    evals = wire[:, sz + cap * 4:sz + cap * 6].copy().view(np.int16)
    counts = wire[:, sz + cap * 6:].copy().view(np.int32)[:, 0]
    flat = lo.astype(np.int16)
    # pad slots index sz-1 and carry its true value, so the scatter is
    # unconditional
    np.put_along_axis(flat, eidx, evals, axis=1)
    return flat, counts


@functools.lru_cache(maxsize=32)
def _packed_compose_fn(meta, mesh, packed, down_cap=None):
    """Build the jitted packed-compose callable for one footprint geometry.

    meta: static per-component tuple of n_blocks (= h_c * w_c); mesh: a
    hashable 1-D-"batch" Mesh (shards the packed batch over local chips) or
    None (single device); packed selects the int8+exceptions wire
    (_wirepack) or the raw int16 wire.

    down_cap packs the DOWNLINK the same way.  The composed coefficients
    have the same statistics as the inputs (<0.2% outside int8), so the
    compose epilogue emits ONE int8 wire per batch:

      [ lo = clip(out,-128,127) | eidx i32 | evals i16 | counts i32 ]

    with a fixed per-row exception capacity ``down_cap`` (static, so jit
    re-specializes only on power-of-two bucket changes).  Pad slots of
    eidx point at sz-1 and evals carries the TRUE value at every listed
    index (gathered from out), so the host restore is one unconditional
    put_along_axis — no validity masks.  Rows whose exception count
    overflows the capacity are restored from ``out``, which is also
    returned but stays on-device (and untransferred) unless needed.
    The raw-wire signature is

      fn(flat[n, per_file] i16, qstack[n, ncomps*64] i32, drops, masks)
        -> [n, per_file] i16

    where per component c, ``drops[c]``/``masks[c]`` are the broadcast
    [hw, 64] f32 dropon coefficients / PIXEL-domain mask (mask_pix_np).
    All blocks run the one 2-GEMM compose step: an all-zero mask block
    (transparent padding) is an exact pass-through inside it.  Every row
    (file) composes with its OWN quant tables, so mixed corpora are
    correct.

    Batch-major row packing means ONE host->device and ONE device->host
    transfer per batch, and rows shard cleanly over the mesh's "batch" axis
    with zero collectives (the compose is block-local).
    """
    def body(flat, qstack, drops, masks):
        n = flat.shape[0]
        outs, off = [], 0
        for c, hw in enumerate(meta):
            sz = hw * 64
            region = jax.lax.slice(flat, (0, off), (n, off + sz)) \
                .reshape(n, hw, 64)
            off += sz
            q = jax.lax.slice(qstack, (0, c * 64), (n, (c + 1) * 64))
            # every block goes through the one compose step (2 GEMMs in the
            # diagonalized pixel-mask form); zero-mask blocks are exact
            # pass-throughs inside it, so transparent padding stays
            # bit-exact
            qb = jnp.broadcast_to(q[:, None, :], (n, hw, 64))
            db = jnp.broadcast_to(drops[c][None], (n, hw, 64))
            mb = jnp.broadcast_to(masks[c][None], (n, hw, 64))
            out = compose_region_auto(region.reshape(n * hw, 8, 8),
                                      db.reshape(n * hw, 8, 8),
                                      mb.reshape(n * hw, 8, 8),
                                      qb.reshape(n * hw, 8, 8)) \
                .reshape(n, sz)
            outs.append(out)
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)

    def pack_down(out):
        """Device epilogue: one int8 downlink wire + the raw out fallback."""
        n, sz = out.shape
        cap = down_cap
        lo = jnp.clip(out, -128, 127).astype(jnp.int8)
        exc = out != lo.astype(jnp.int16)
        pos = jnp.cumsum(exc.astype(jnp.int32), axis=1)
        # non-exceptions and beyond-capacity exceptions land on slot cap
        # and are dropped by the scatter
        slot = jnp.where(exc, pos - 1, cap)
        col = jnp.broadcast_to(jnp.arange(sz, dtype=jnp.int32), (n, sz))
        eidx = jnp.full((n, cap), sz - 1, jnp.int32).at[
            jnp.arange(n)[:, None], slot].set(col, mode="drop")
        evals = jnp.take_along_axis(out, eidx, axis=1)
        counts = pos[:, -1:]
        wire = jnp.concatenate([
            lo,
            jax.lax.bitcast_convert_type(eidx, jnp.int8).reshape(n, cap * 4),
            jax.lax.bitcast_convert_type(evals, jnp.int8).reshape(n, cap * 2),
            jax.lax.bitcast_convert_type(counts, jnp.int8).reshape(n, 4),
        ], axis=1)
        return wire, out

    post = pack_down if down_cap else (lambda out: out)
    if packed:
        def fn(lo, eidx, evals, qstack, drops, masks):
            # restore exact int16 from the int8 wire + exception scatter
            n = lo.shape[0]
            flat = lo.astype(jnp.int16).at[
                jnp.arange(n)[:, None], eidx].set(evals, mode="drop")
            return post(body(flat, qstack, drops, masks))
        in_specs = (P("batch"), P("batch"), P("batch"), P("batch"), P(), P())
    else:
        def fn(flat, qstack, drops, masks):
            return post(body(flat, qstack, drops, masks))
        in_specs = (P("batch"), P("batch"), P(), P())
    out_specs = (P("batch"), P("batch")) if down_cap else P("batch")
    if mesh is None:
        return jax.jit(fn)
    fn_sharded = jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
    return jax.jit(fn_sharded)


class BatchComposer:
    """Reusable compiled-dropon compose over batches of same-geometry images.

    Compile the dropon once against the first image's geometry, then apply to
    any number of batches; with a mesh, batches shard over the "batch" axis.
    """

    def __init__(self, template: CoefImage, dropon: Dropon, align: int = 0,
                 offset_x: int = 0, offset_y: int = 0,
                 mesh: Optional[Mesh] = None):
        from ..composer import compile_dropon, plan_placement

        self.template = template
        self.mesh = mesh
        p = plan_placement(template, dropon, align, offset_x, offset_y)
        self.noop = p.noop
        if self.noop:
            return
        self.cd = compile_dropon(dropon, template, p.blockoffset_x,
                                 p.blockoffset_y, p.crop_x, p.crop_y,
                                 p.crop_w, p.crop_h)
        self.block_x = p.block_x
        self.block_y = p.block_y
        # device-resident compiled dropon + quant tables
        self._dev_dropon = [jnp.asarray(b) for b in self.cd.image_blocks]
        self._dev_mask = [jnp.asarray(m) for m in self.cd.mask_pixels]
        self._dev_quant = [jnp.asarray(template.quant_table_for(c))
                           for c in range(len(self.cd.image_blocks))]
        # Packed streaming path: shard over local chips unless a mesh was
        # given explicitly (its "batch" axis is used either way).
        from .mesh import stream_mesh

        self._stream_mesh = mesh if mesh is not None else stream_mesh()
        self._comp_shapes = [b.shape[:2] for b in self.cd.image_blocks]
        self._meta = tuple(h * w for h, w in self._comp_shapes)
        # Static per-block mask classification, reported for diagnostics
        # (zero = transparent padding, DC-only = constant-alpha interior,
        # general = mask edges).  It routes nothing: one compose step
        # serves every class.
        self.mask_block_classes = []
        for weights in self.cd.alpha_weights:
            h, w = weights.shape[:2]
            wf = np.ascontiguousarray(weights, np.float32).reshape(h * w, 64)
            nz = wf != 0.0
            zero = ~nz.any(axis=1)
            dc = nz[:, 0] & ~nz[:, 1:].any(axis=1)
            self.mask_block_classes.append(
                (int(zero.sum()), int(dc.sum()), int((~zero & ~dc).sum())))
        self._drops = tuple(
            jnp.asarray(np.ascontiguousarray(b, np.float32).reshape(-1, 64))
            for b in self.cd.image_blocks)
        self._masks = tuple(
            jnp.asarray(np.ascontiguousarray(m, np.float32).reshape(-1, 64))
            for m in self.cd.mask_pixels)
        # downlink exception capacity (power-of-two buckets, adapts upward
        # when a batch overflows; overflowed rows restore from the raw
        # on-device output so adaptation never costs correctness)
        self._down_cap = 32

    def compose_arrays(self, comp_batches: Sequence[jax.Array]) -> list:
        """comp_batches[c]: [N, H, W, 8, 8] int16 device arrays (one per
        component, matching the template geometry).  Returns updated arrays.
        """
        if self.noop:
            return list(comp_batches)
        out = []
        for c, grids in enumerate(comp_batches):
            ci = self.template.components[c]
            out.append(_compose_batch_component(
                grids, self._dev_dropon[c], self._dev_mask[c],
                self._dev_quant[c],
                row0=self.block_y * ci.v_samp, col0=self.block_x * ci.h_samp))
        return out

    def compose_images(self, images: Sequence[CoefImage]) -> None:
        """In-place batched compose, region-only dataflow.

        Only the overlay footprint travels host<->device (the untouched MCU
        grid never leaves the host — it is bit-exact by construction), and
        all components go through ONE jit dispatch: one transfer each way
        per batch.
        """
        self.finish(self.compose_images_async(images), images)

    def _region_origins(self) -> list:
        """Per component (r0, c0, h, w) block rectangles of the footprint."""
        origins = []
        for c in range(len(self.cd.image_blocks)):
            ci = self.template.components[c]
            h, w = self.cd.image_blocks[c].shape[:2]
            origins.append((self.block_y * ci.v_samp,
                            self.block_x * ci.h_samp, h, w))
        return origins

    def _pack_regions(self, regions, quants):
        """Dispatch the packed compose for per-file footprint regions.

        regions[i][c]: [h_c, w_c, 8, 8] int16 for file i, component c;
        quants[i][c]: that file's [8, 8] quant table.  Returns a pending
        (device_out, n) — one transfer each way for the whole batch; rows
        (files) shard over the stream mesh's local chips when present.
        """
        ncomps = len(self.cd.image_blocks)
        n = len(regions)
        parts = [np.stack([np.asarray(regions[i][c], np.int16)
                           for i in range(n)]).reshape(n, -1)
                 for c in range(ncomps)]
        flat = parts[0] if ncomps == 1 else np.concatenate(parts, axis=1)
        qstack = np.concatenate(
            [np.stack([np.asarray(quants[i][c], np.int32).reshape(64)
                       for i in range(n)]) for c in range(ncomps)], axis=1)
        mesh = self._stream_mesh
        if mesh is not None:
            shards = mesh.shape["batch"]
            n_pad = -(-n // shards) * shards
            if n_pad != n:
                flat = np.concatenate(
                    [flat, np.zeros((n_pad - n, flat.shape[1]), np.int16)])
                # q=1 keeps the padded rows' requant division well-defined
                qstack = np.concatenate(
                    [qstack,
                     np.ones((n_pad - n, qstack.shape[1]), np.int32)])
        import os as _os

        down_cap = (None if _os.environ.get("MJT_NO_DOWNPACK")
                    else self._down_cap)
        packed = None
        if not _os.environ.get("MJT_NO_WIREPACK"):
            packed = _wirepack(flat)
        if packed is not None:
            lo, eidx, evals = packed
            fn = _packed_compose_fn(self._meta, mesh, True, down_cap)
            out = fn(lo, eidx, evals, qstack, self._drops, self._masks)
        else:
            fn = _packed_compose_fn(self._meta, mesh, False, down_cap)
            out = fn(flat, qstack, self._drops, self._masks)
        probe = out[0] if down_cap else out
        self.last_dispatch_devices = len(probe.sharding.device_set)
        return (out, n, down_cap)

    def _unpack_regions(self, pending) -> list:
        """Fetch a _pack_regions result: parts[c][i] = [h, w, 8, 8]."""
        out, n, down_cap = pending
        if down_cap:
            wire_dev, raw_dev = out
            flat, counts = _downunpack(np.asarray(wire_dev), down_cap)
            over = np.nonzero(counts > down_cap)[0]
            if over.size:
                # rare: restore overflowed rows from the (still on-device)
                # raw output, then widen the capacity bucket for the next
                # batches
                flat[over] = np.asarray(raw_dev[np.asarray(over)])
                cap = self._down_cap
                mx = int(counts.max())
                while cap < mx:
                    cap *= 2
                self._down_cap = cap
            flat = flat[:n]
        else:
            flat = np.asarray(out)[:n]
        off, parts = 0, []
        for (h, w) in self._comp_shapes:
            sz = h * w * 64
            parts.append(flat[:, off:off + sz].reshape(n, h, w, 8, 8))
            off += sz
        return parts

    def compose_images_async(self, images: Sequence[CoefImage]):
        """Dispatch the region compose without blocking; returns a pending
        handle.  jax dispatch is async, so the device works while the host
        keeps decoding/encoding — pair with finish() to overlap stages.
        Each image composes with its OWN quant tables."""
        if self.noop:
            return None
        origins = self._region_origins()
        regions = [[im.coefs[c][r0:r0 + h, c0:c0 + w]
                    for c, (r0, c0, h, w) in enumerate(origins)]
                   for im in images]
        quants = [[im.quant_table_for(c) for c in range(len(origins))]
                  for im in images]
        return self._pack_regions(regions, quants)

    def finish(self, pending, images: Sequence[CoefImage]) -> None:
        """Fetch a compose_images_async result and scatter it back."""
        if pending is None:
            return
        parts = self._unpack_regions(pending)
        origins = self._region_origins()
        for c, (r0, c0, h, w) in enumerate(origins):
            for i, im in enumerate(images):
                im.coefs[c][r0:r0 + h, c0:c0 + w] = parts[c][i]

    def _surgical_plan(self):
        """Lazily built surgical splice plan (see surgical.py); plan.ok is
        False when the template is outside the surgical envelope."""
        if not hasattr(self, "_splan"):
            from ..surgical import SurgicalPlan

            origins = []
            for c in range(len(self.cd.image_blocks)):
                ci = self.template.components[c]
                h, w = self.cd.image_blocks[c].shape[:2]
                origins.append((self.block_y * ci.v_samp,
                                self.block_x * ci.h_samp, h, w))
            self._splan = SurgicalPlan(self.template, origins,
                                       self.template.restart_interval)
        return self._splan

    def _compose_surgical_async(self, plan, planes_list, quants_list):
        """Pack the gathered footprint regions of a batch of window planes
        and dispatch the same packed compose the full path uses.
        quants_list[i]: per-component quant tables of file i (from its
        surgical payload)."""
        regions = [plan.gather(p) for p in planes_list]
        return self._pack_regions(regions, quants_list)

    def _finish_surgical(self, plan, pending, planes_list) -> None:
        parts = self._unpack_regions(pending)
        for i, planes in enumerate(planes_list):
            plan.scatter(planes, [p[i] for p in parts])

    def watermark_stream(self, datas, *, batch: int = 32, pool=None,
                         options: int = 0, restart_interval=None,
                         lookahead: int = 2, surgical=None,
                         max_pixel: int = 0):
        """Streaming watermark pipeline: JPEG bytes in -> JPEG bytes out.

        Three overlapped stages — host entropy decode (thread pool), device
        region compose (async dispatch, ``lookahead`` batches in flight),
        host entropy encode (thread pool) — so steady-state throughput is the
        SLOWEST stage, not the sum (a serial loop pays decode + round trip +
        encode per batch).  Yields encoded bytes in input order.

        When an input is sequential-Huffman with restart markers and no
        re-encode options are requested, the pipeline entropy-codes ONLY the
        restart segments the footprint touches and byte-splices the rest
        (surgical.py) — output coefficients are identical to the full
        pipeline's.  The choice is PER FILE: out-of-envelope files in a
        batch take the full path while the rest stay surgical (both share
        one device dispatch), and every fallback is counted by reason in
        ``last_fallback_reasons``.  ``last_stream_path`` reports "surgical"
        (all files surgical), "mixed", or "full".  ``surgical=False`` forces
        the full path for every file.

        ``datas``: iterable of JPEG byte strings with the template's
        geometry.  ``pool``: optional ThreadPoolExecutor shared with the
        caller (host decode/encode parallelism).
        """
        import queue as _queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from .. import codec

        own_pool = pool is None
        if own_pool:
            import os as _os
            pool = ThreadPoolExecutor(max_workers=max(2, _os.cpu_count() or 2))
        # three hand-off queues: producer (decode) -> dispatcher (pack +
        # host->device) -> fetcher (device->host) -> consumer (scatter +
        # encode).  Decode, upload, download, and encode each own a thread,
        # so a batch's upload overlaps the next batch's decode AND the
        # previous batch's download/encode — without the dispatcher stage
        # the producer serialized decode+pack+upload and became the wall.
        # Each queue holds 1 (plus one in each stage's hands): total
        # in-flight decoded batches stays ~lookahead+2.
        q0: _queue.Queue = _queue.Queue(maxsize=1)
        q: _queue.Queue = _queue.Queue(
            maxsize=max(1, lookahead - lookahead // 2))
        q2: _queue.Queue = _queue.Queue(maxsize=max(1, lookahead // 2))
        stop = object()
        closed = threading.Event()

        def put_to(dst, item) -> bool:
            while not closed.is_set():
                try:
                    dst.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    pass
            return False

        def put(item) -> bool:
            return put_to(q, item)

        plan = None
        if surgical is not False and not self.noop and options == 0 and (
                restart_interval is None
                or restart_interval == self.template.restart_interval):
            plan = self._surgical_plan()
            if not plan.ok:
                plan = None
        # Restart-free BAND splice (codec.decode_band/encode_splice_band,
        # round 5 — generalizes the round-4 prefix splice): when the
        # surgical (restart-segmented) plan does not apply, only the
        # footprint's MCU rows are decoded and re-encoded; the prefix is
        # skip-indexed + byte-copied and the suffix skip-indexed +
        # bit-shift-copied (one MCU re-coded at the DC seam) — output
        # bytes identical to the full path for ANY logo placement.
        # Per-file: ineligible streams (progressive/arithmetic/restarts/
        # DNL/multi-scan) fall back to the full path and are counted in
        # last_fallback_reasons.
        import os as _os

        splice_band = None
        if (plan is None and surgical is not False and not self.noop
                and options == 0
                and not self.template.progressive
                and not self.template.arithmetic
                and self.template.restart_interval == 0
                and (restart_interval is None or restart_interval == 0)
                and not _os.environ.get("MJT_NO_SPLICE")):
            t = self.template
            rows_total = -(-t.height // (8 * t.sampling.max_v_samp))
            mcu_rows = max(
                -(-self.cd.image_blocks[c].shape[0]
                  // t.components[c].v_samp)
                for c in range(len(self.cd.image_blocks)))
            row0 = self.block_y
            row1 = min(self.block_y + mcu_rows, rows_total)
            if row0 > 0 or row1 < rows_total:
                splice_band = (row0, row1)
        self.last_stream_path = ("surgical" if plan is not None else
                                 "splice" if splice_band is not None else
                                 "full")
        self.last_fallback_reasons = {}
        # per-stage cumulative wall clocks (seconds): producer writes
        # decode/pack, the consumer thread writes fetch/scatter/encode —
        # disjoint keys, no lock needed.  Read via last_stream_stats after
        # the stream drains; stage sums exceeding total wall = good overlap.
        stats = {"decode_s": 0.0, "pack_dispatch_s": 0.0, "fetch_s": 0.0,
                 "scatter_s": 0.0, "encode_s": 0.0, "wall_s": 0.0,
                 "batches": 0}
        self.last_stream_stats = stats
        t_start = time.perf_counter()
        origins = None if self.noop else self._region_origins()

        def decode_batch(chunk):
            """Decode a batch: surgical windows / splice tails where
            eligible, full decode otherwise."""
            n = len(chunk)
            payloads = [None] * n
            splices = [None] * n
            if plan is not None:
                for i, (payload, reason) in enumerate(
                        pool.map(plan.extract, chunk)):
                    if payload is None:
                        self.last_fallback_reasons[reason] = \
                            self.last_fallback_reasons.get(reason, 0) + 1
                        self.last_stream_path = "mixed"
                    else:
                        payloads[i] = payload

            def prep_one(i):
                if payloads[i] is not None:
                    return plan.decode_windows(payloads[i])
                if splice_band is not None:
                    try:
                        img, sp = codec.decode_band(chunk[i],
                                                    splice_band[0],
                                                    splice_band[1],
                                                    max_pixel=max_pixel)
                        splices[i] = sp
                        return img
                    except codec.SpliceIneligible as e:
                        reason = str(e)
                        self.last_fallback_reasons[reason] = \
                            self.last_fallback_reasons.get(reason, 0) + 1
                        self.last_stream_path = "mixed"
                # in a batch the pool already decodes files concurrently;
                # intra-file thread parallelism on top would oversubscribe
                return codec.decode(chunk[i], max_pixel=max_pixel,
                                    nthreads=1 if n > 1 else 0)

            t0 = time.perf_counter()
            prepped = list(pool.map(prep_one, range(n)))
            stats["decode_s"] += time.perf_counter() - t0
            return payloads, splices, prepped

        def dispatch_batch(payloads, prepped):
            """Gather footprint regions and run the packed device dispatch
            (one host->device transfer) — both paths share it."""
            if self.noop:
                return None
            n = len(prepped)
            regions, quants = [], []
            for i in range(n):
                if payloads[i] is not None:
                    regions.append(plan.gather(prepped[i]))
                    quants.append(payloads[i][4])
                else:
                    im = prepped[i]
                    regions.append([im.coefs[c][r0:r0 + h, c0:c0 + w]
                                    for c, (r0, c0, h, w)
                                    in enumerate(origins)])
                    quants.append([im.quant_table_for(c)
                                   for c in range(len(origins))])
            t0 = time.perf_counter()
            pending = self._pack_regions(regions, quants)
            stats["pack_dispatch_s"] += time.perf_counter() - t0
            return pending

        def producer():
            try:
                it = iter(datas)
                while not closed.is_set():
                    chunk = []
                    for _ in range(batch):
                        try:
                            chunk.append(next(it))
                        except StopIteration:
                            break
                    if not chunk:
                        break
                    payloads, splices, prepped = decode_batch(chunk)
                    if not put_to(q0, (chunk, payloads, splices, prepped)):
                        return
                put_to(q0, stop)
            except BaseException as e:  # surface decode errors to the consumer
                put_to(q0, e)

        def dispatcher():
            """Second stage: pack + host->device dispatch OFF the decode
            thread, so batch i's upload overlaps batch i+1's decode."""
            try:
                while not closed.is_set():
                    try:
                        item = q0.get(timeout=0.2)
                    except _queue.Empty:
                        continue
                    if item is stop or isinstance(item, BaseException):
                        put(item)
                        return
                    chunk, payloads, splices, prepped = item
                    pending = dispatch_batch(payloads, prepped)
                    if not put((chunk, payloads, splices, prepped, pending)):
                        return
            except BaseException as e:
                put(e)

        def fetcher():
            """Middle pipeline stage: block on the device->host transfer OFF
            the consumer thread, so the wire wait of batch i overlaps the
            (CPU-bound) encode of batch i-1 instead of serializing with it.
            np.asarray on a device array releases the GIL while it waits."""
            try:
                while not closed.is_set():
                    try:
                        item = q.get(timeout=0.2)
                    except _queue.Empty:
                        continue
                    if item is stop or isinstance(item, BaseException):
                        put_to(q2, item)
                        return
                    chunk, payloads, splices, prepped, pending = item
                    parts = None
                    if pending is not None:
                        t0 = time.perf_counter()
                        parts = self._unpack_regions(pending)
                        stats["fetch_s"] += time.perf_counter() - t0
                    if not put_to(q2,
                                  (chunk, payloads, splices, prepped, parts)):
                        return
            except BaseException as e:
                put_to(q2, e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        td = threading.Thread(target=dispatcher, daemon=True)
        td.start()
        tf = threading.Thread(target=fetcher, daemon=True)
        tf.start()
        try:
            while True:
                item = q2.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                chunk, payloads, splices, prepped, parts = item
                stats["batches"] += 1
                if parts is not None:
                    t0 = time.perf_counter()
                    for i in range(len(chunk)):
                        regions_i = [p[i] for p in parts]
                        if payloads[i] is not None:
                            plan.scatter(prepped[i], regions_i)
                        else:
                            im = prepped[i]
                            for c, (r0, c0, h, w) in enumerate(origins):
                                im.coefs[c][r0:r0 + h, c0:c0 + w] = \
                                    regions_i[c]
                    stats["scatter_s"] += time.perf_counter() - t0

                def enc_one(i):
                    if payloads[i] is not None:
                        try:
                            return plan.reencode(chunk[i], payloads[i],
                                                 prepped[i])
                        except codec.EncodeError:
                            # same optimized-tables hazard as the band
                            # splice below: the original tables lack a
                            # code the composed segment now needs
                            reason = "surgical: original tables lack a " \
                                     "needed symbol"
                            self.last_fallback_reasons[reason] = \
                                self.last_fallback_reasons.get(reason,
                                                               0) + 1
                            self.last_stream_path = "mixed"
                            full_im = codec.decode(chunk[i],
                                                   max_pixel=max_pixel,
                                                   nthreads=1)
                            regions_i = plan.gather(prepped[i])
                            for c, (r0, c0, h, w) in enumerate(origins):
                                full_im.coefs[c][r0:r0 + h, c0:c0 + w] = \
                                    regions_i[c]
                            return codec.encode(
                                full_im, options=options,
                                restart_interval=restart_interval)
                    if splices[i] is not None:
                        try:
                            return codec.encode_splice_band(
                                chunk[i], prepped[i], splice_band[0],
                                splice_band[1], splices[i])
                        except codec.EncodeError:
                            # the file's ORIGINAL (optimized) Huffman
                            # tables lack a code for a symbol the composed
                            # band now needs — the splice must keep the
                            # original tables for bit-identity, so redo
                            # this file on the full path (fresh tables).
                            # The composed footprint is already in
                            # prepped[i]'s band rows; graft it onto a full
                            # decode.
                            reason = "splice: original tables lack a " \
                                     "needed symbol"
                            self.last_fallback_reasons[reason] = \
                                self.last_fallback_reasons.get(reason,
                                                               0) + 1
                            self.last_stream_path = "mixed"
                            full_im = codec.decode(chunk[i],
                                                   max_pixel=max_pixel,
                                                   nthreads=1)
                            for c, (r0, c0, h, w) in enumerate(origins):
                                full_im.coefs[c][r0:r0 + h, c0:c0 + w] = \
                                    prepped[i].coefs[c][r0:r0 + h,
                                                        c0:c0 + w]
                            return codec.encode(
                                full_im, options=options,
                                restart_interval=restart_interval)
                    return codec.encode(prepped[i], options=options,
                                        restart_interval=restart_interval)

                t0 = time.perf_counter()
                yield from pool.map(enc_one, range(len(chunk)))
                stats["encode_s"] += time.perf_counter() - t0
        finally:
            stats["wall_s"] = time.perf_counter() - t_start
            closed.set()
            t.join(timeout=2.0)
            td.join(timeout=2.0)
            tf.join(timeout=2.0)
            if own_pool:
                pool.shutdown(wait=False)

    def put_batch(self, images: Sequence[CoefImage]) -> list:
        """Stack host images into device batches (sharded if mesh given)."""
        batches = []
        for c in range(self.template.num_components):
            arr = np.stack([im.coefs[c] for im in images])
            if self.mesh is not None:
                sh = NamedSharding(self.mesh, P("batch"))
                batches.append(jax.device_put(arr, sh))
            else:
                batches.append(jnp.asarray(arr))
        return batches


def compose_batch(images: Sequence[CoefImage], dropon: Dropon, align: int = 0,
                  offset_x: int = 0, offset_y: int = 0,
                  mesh: Optional[Mesh] = None) -> list:
    """One-shot batched compose; returns new CoefImages."""
    bc = BatchComposer(images[0], dropon, align, offset_x, offset_y, mesh)
    batches = bc.put_batch(images)
    results = bc.compose_arrays(batches)
    outs = []
    host = [np.asarray(r) for r in results]
    for i, im in enumerate(images):
        o = im.copy()
        for c in range(o.num_components):
            o.coefs[c] = host[c][i]
        outs.append(o)
    return outs
