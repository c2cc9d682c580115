"""Worker process for the 2-process jax.distributed tests.

Launched by tests/test_multiprocess.py; the platform is switched to the CPU
in-process before any backend init.  Everything below runs the
PRODUCT code paths: parallel.init_distributed, BatchComposer's compiled
dropon, and the batched compose kernel over a global 2-process mesh.

argv: process_id num_processes port outdir mode [mode args...]
modes:
  compose <n_images>   -- global-mesh batched compose, saves local shards
  corpus  <in> <out>   -- corpus runner with --hosts num_processes
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

# NOT `from conftest import FIXTURE_IMAGES`: conftest's import-time setup
# appends --xla_force_host_platform_device_count=8 to XLA_FLAGS, which would
# override the 4-device-per-process flag the spawning test set for this
# worker (last flag wins -> 16 global devices for an 8-image batch).
IMAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def main():
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]
    mode = sys.argv[5]

    from libmodjpeg_tpu.parallel import init_distributed

    os.environ["MJT_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["MJT_NUM_PROCS"] = str(nprocs)
    os.environ["MJT_PROC_ID"] = str(pid)
    os.environ["MJT_CPU_COLLECTIVES"] = "gloo"
    assert init_distributed() is True
    assert jax.process_count() == nprocs, jax.process_count()

    if mode == "compose":
        run_compose(pid, int(sys.argv[6]), outdir)
    elif mode == "corpus":
        run_corpus_mode(pid, nprocs, sys.argv[6], sys.argv[7])
    else:
        raise SystemExit(f"unknown mode {mode}")


def make_batch(n_images):
    """Deterministic batch of perturbed fixture images (identical in every
    process — the corpus itself is replicated input, only compute shards)."""
    import libmodjpeg_tpu as mj

    base = mj.read_jpeg(f"{IMAGES}/image.jpg")
    rng = np.random.RandomState(42)
    images = []
    for _ in range(n_images):
        im = base.copy()
        for c in range(3):
            mask = rng.randint(0, 3, im.coefs[c].shape[:2])[..., None, None]
            im.coefs[c] = (im.coefs[c] + mask.astype(np.int16)).astype(np.int16)
        images.append(im)
    return images


def run_compose(pid, n_images, outdir):
    import libmodjpeg_tpu as mj
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from libmodjpeg_tpu.parallel.batch import (BatchComposer,
                                               _compose_batch_component)

    devices = jax.devices()
    mesh = Mesh(np.array(devices), ("batch",))
    batch_sh = NamedSharding(mesh, P("batch"))
    repl = NamedSharding(mesh, P())

    images = make_batch(n_images)
    logo = mj.read_dropon(f"{IMAGES}/dropon.png")
    bc = BatchComposer(images[0], logo, mj.ALIGN_BOTTOM | mj.ALIGN_RIGHT,
                       -5, -3)

    shards_out = {}
    for c in range(3):
        ci = images[0].components[c]
        full = np.stack([im.coefs[c] for im in images])
        garr = jax.make_array_from_callback(
            full.shape, batch_sh, lambda idx, f=full: f[idx])
        dropon = jax.device_put(np.asarray(bc._dev_dropon[c]), repl)
        alpha = jax.device_put(np.asarray(bc._dev_mask[c]), repl)
        quant = jax.device_put(np.asarray(bc._dev_quant[c]), repl)
        out = _compose_batch_component(
            garr, dropon, alpha, quant,
            row0=bc.block_y * ci.v_samp, col0=bc.block_x * ci.h_samp)
        out.block_until_ready()
        for s in out.addressable_shards:
            i0 = s.index[0].start or 0
            shards_out[f"c{c}_i{i0}"] = np.asarray(s.data)
    np.savez(os.path.join(outdir, f"shards_p{pid}.npz"), **shards_out)
    print(json.dumps({"proc": pid, "n_shards": len(shards_out)}), flush=True)


def run_corpus_mode(pid, nprocs, indir, outdir):
    from libmodjpeg_tpu.corpus import CorpusConfig, run_corpus

    cfg = CorpusConfig(
        inputs=[indir], output_dir=outdir,
        dropon_path=f"{IMAGES}/dropon.png",
        align=3 | 12,  # bottom-right: ALIGN_BOTTOM|ALIGN_RIGHT resolved below
        num_hosts=nprocs, host_id=pid, batch_size=4)
    from libmodjpeg_tpu import constants as C

    cfg.align = C.ALIGN_BOTTOM | C.ALIGN_RIGHT
    cfg.effects = [("luminance", (35,))]
    summary = run_corpus(cfg)
    print(json.dumps(summary), flush=True)
    assert summary["files_failed"] == 0


if __name__ == "__main__":
    main()
