"""Device-resident pipeline session for huge images.

For the 100MP tiled-JPEG workload (BASELINE config-4) the coefficient grids
should be put on the mesh ONCE, flow through a chain of effects/composes
entirely on device, and come back once at the end — not round-trip per op
like the convenience wrappers in grid.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..model import CoefImage, Dropon
from .grid import _apply_effect, _compose_component_sharded


class GridSession:
    """Holds one image's component grids sharded over the mesh.

    Usage::

        sess = GridSession(img, mesh)
        sess.effect("luminance", value=40).effect("pixelate")
        sess.compose(dropon, ALIGN_CENTER)
        out = sess.to_image()
    """

    def __init__(self, img: CoefImage, mesh: Optional[Mesh] = None):
        self.meta = img
        self.mesh = mesh
        self._orig_rows = [a.shape[0] for a in img.coefs]
        if mesh is not None:
            from .grid import _shard_grid

            # block-row axis padded to the mesh multiple (zero blocks are
            # inert under every effect, and compose never writes past the
            # real rows), so ANY image geometry shards over ANY mesh
            self.grids = [_shard_grid(mesh, a) for a in img.coefs]
        else:
            self.grids = [jnp.asarray(a) for a in img.coefs]
        self.quants = [jnp.asarray(img.quant_table_for(c))
                       for c in range(img.num_components)]

    def effect(self, name: str, value: int = 0, cb_value: int = 0,
               cr_value: int = 0) -> "GridSession":
        jcs_ok = self.meta.jpeg_color_space == C.JCS_YCbCr
        for c in range(len(self.grids)):
            g, q = self.grids[c], self.quants[c]
            if name == "grayscale" and jcs_ok and c > 0:
                self.grids[c] = _apply_effect(g, q, jnp.int32(0), "zero")
            elif name == "pixelate":
                self.grids[c] = _apply_effect(g, q, jnp.int32(0), "pixelate")
            elif name == "tint" and jcs_ok and c == 1 and cb_value:
                self.grids[c] = _apply_effect(g, q, jnp.int32(cb_value), "dc_add")
            elif name == "tint" and jcs_ok and c == 2 and cr_value:
                self.grids[c] = _apply_effect(g, q, jnp.int32(cr_value), "dc_add")
            elif name == "luminance" and jcs_ok and c == 0:
                self.grids[c] = _apply_effect(g, q, jnp.int32(value), "dc_add")
        return self

    def compose(self, dropon: Dropon, align: int = 0, offset_x: int = 0,
                offset_y: int = 0) -> "GridSession":
        from ..composer import compile_dropon, plan_placement

        p = plan_placement(self.meta, dropon, align, offset_x, offset_y)
        if p.noop:
            return self
        cd = compile_dropon(dropon, self.meta, p.blockoffset_x,
                            p.blockoffset_y, p.crop_x, p.crop_y,
                            p.crop_w, p.crop_h)
        for c in range(len(cd.image_blocks)):
            ci = self.meta.components[c]
            self.grids[c] = _compose_component_sharded(
                self.grids[c], jnp.asarray(cd.image_blocks[c]),
                jnp.asarray(cd.mask_pixels[c]), self.quants[c],
                row0=p.block_y * ci.v_samp, col0=p.block_x * ci.h_samp)
        return self

    def block_until_ready(self) -> "GridSession":
        for g in self.grids:
            g.block_until_ready()
        return self

    def optimized_tables(self, restart_interval: int = 0) -> list:
        """Huffman-optimize statistics computed ON the sharded grids.

        The symbol histograms (ops/histogram.py) run where the coefficient
        shards live — per-shard bincounts + an XLA all-reduce over the mesh —
        and only the 257-entry totals come back for table build.  Feed the
        result to ``to_jpeg``/``codec.encode(preset_tables=...)``: the file
        is byte-identical to the host ``OPTION_OPTIMIZE`` pass.
        """
        from ..ops.histogram import optimal_tables

        real = [g[:rows] for g, rows in zip(self.grids, self._orig_rows)]
        mcus_wide = self.meta.components[0].padded_width_in_blocks \
            // self.meta.components[0].h_samp
        return optimal_tables(real, self.meta.components, mcus_wide,
                              restart_interval)

    def to_jpeg(self, options: int = 0, restart_interval: int = 0,
                nthreads: int = 0) -> bytes:
        """Encode the session's image; OPTION_OPTIMIZE statistics run on the
        mesh (optimized_tables) instead of as a host walk."""
        from .. import codec

        preset = None
        if (options & C.OPTION_OPTIMIZE) and not (
                options & (C.OPTION_PROGRESSIVE | C.OPTION_ARITHMETRIC)):
            preset = self.optimized_tables(restart_interval)
        return codec.encode(self.to_image(), options=options,
                            restart_interval=restart_interval,
                            nthreads=nthreads, preset_tables=preset)

    def to_image(self) -> CoefImage:
        out = self.meta.copy()
        for c in range(len(self.grids)):
            out.coefs[c] = np.asarray(self.grids[c])[:self._orig_rows[c]]
        return out


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     cpu_collectives: Optional[str] = None) -> bool:
    """Initialize jax.distributed for runs that span several processes.

    Reads MJT_COORDINATOR / MJT_NUM_PROCS / MJT_PROC_ID when args are None;
    no-op (returns False) when no coordinator is configured, so single-host
    runs need no special casing.  On GPUs the cross-process collectives go
    through NCCL; on CPU backends (the multi-process tests)
    ``cpu_collectives`` / MJT_CPU_COLLECTIVES selects the transport
    (e.g. "gloo") — it must be set before the backend initializes, which this
    helper guarantees by being the first jax call of the process.
    """
    import os

    coordinator = coordinator or os.environ.get("MJT_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("MJT_NUM_PROCS", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("MJT_PROC_ID", "0"))
    cpu_collectives = cpu_collectives or os.environ.get("MJT_CPU_COLLECTIVES")
    if cpu_collectives:
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True
