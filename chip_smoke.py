#!/usr/bin/env python3
"""Run the watermarking path once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py              # one card: library, stream, grid
    python chip_smoke.py --cards 4    # four cards: sharded stream and grid,
                                      # each against the same work on card 0

Phases, in one process (a second JAX process could not share the card):

- device:  JAX must report a GPU, and nvidia-smi must name it.
- library: read_jpeg / read_dropon / compose / effect_* / write_jpeg in all
  four entropy modes on the committed fixtures, and the CLI in-process,
  against the same calls pinned to the CPU backend.
- stream:  BatchComposer.watermark_stream on 64 synthetic 1920x1088 4:2:0
  q85 JPEGs (splice and forced-full paths) and 32 restart-interval copies
  (surgical path), plus single-file watermark() calls.
- grid:    a 12288x8192 (100.7 MP) 4:2:0 coefficient frame in a GridSession:
  compose, tint, luminance, pixelate and device-built optimized tables.

Tolerances: untouched blocks must be bit-identical; splice output must equal
full-path output byte for byte; effects (integer operations) and optimized
tables must match exactly.  Footprint coefficients may differ from the CPU
backend by at most +-1 on at most 0.5% of them: the blend runs in f32 at
HIGHEST precision on both, but the GPU sums in another order before a
truncating requantize.

Exits non-zero, without a result line, when JAX finds no GPU or any check
fails.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from libmodjpeg_tpu.constants import ALIGN_BOTTOM, ALIGN_RIGHT

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
SCRATCH = os.path.join(HERE, ".cache", "chip_smoke")
MAX_ABS_DIFF = 1        # footprint coefficients vs the CPU backend
MAX_DIFF_SHARE = 0.005
ALIGN_BR = ALIGN_BOTTOM | ALIGN_RIGHT


class CheckFailed(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    """The card's name and power limit, one line per card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.exit(f"device: nvidia-smi failed: {e}")
    if r.returncode != 0 or not r.stdout.strip():
        sys.exit(f"device: nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def device_phase(cards: int) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"device: JAX found {devs[0].platform} "
                 f"({devs[0].device_kind}), not a GPU")
    if len(devs) < cards:
        sys.exit(f"device: {cards} cards asked for, JAX found {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "devices": [str(d) for d in devs],
            "nvidia_smi": nvidia_smi()}


# ---------------------------------------------------------------- helpers --

def footprint_rects(img, dropon, align, ox, oy) -> list:
    """Per component (r0, c0, h, w) block rectangle the overlay may touch."""
    from libmodjpeg_tpu.parallel.batch import BatchComposer

    return BatchComposer(img, dropon, align, ox, oy)._region_origins()


def compare_outside(out, ref, rects, what: str) -> None:
    """Every block outside the footprint must be bit-identical."""
    for c, (r0, c0, h, w) in enumerate(rects):
        keep = np.ones(out.coefs[c].shape[:2], bool)
        keep[r0:r0 + h, c0:c0 + w] = False
        check(np.array_equal(out.coefs[c][keep], ref.coefs[c][keep]),
              f"{what}: component {c} changed outside the footprint")


def compare_footprint(out, ref, rects, what: str) -> dict:
    """Footprint coefficients within +-MAX_ABS_DIFF on <= MAX_DIFF_SHARE."""
    d = np.concatenate([
        np.abs(out.coefs[c][r0:r0 + h, c0:c0 + w].astype(np.int32)
               - ref.coefs[c][r0:r0 + h, c0:c0 + w]).ravel()
        for c, (r0, c0, h, w) in enumerate(rects)])
    res = {"max_abs": int(d.max()), "share": float((d != 0).mean()),
           "n": int(d.size)}
    check(res["max_abs"] <= MAX_ABS_DIFF and res["share"] <= MAX_DIFF_SHARE,
          f"{what}: footprint differs from the CPU backend: {res}")
    return res


def equal_images(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.coefs, b.coefs))


# ---------------------------------------------------------------- library --

def library_phase(dev, ref) -> dict:
    """The public API and the CLI on the committed fixtures."""
    import jax

    import libmodjpeg_tpu as mj
    from libmodjpeg_tpu import cli, codec

    image = os.path.join(FIXTURES, "image.jpg")
    logo = os.path.join(FIXTURES, "dropon.png")
    mask = os.path.join(FIXTURES, "mask.jpg")
    modes = {"baseline": mj.OPTION_NONE, "progressive": mj.OPTION_PROGRESSIVE,
             "optimize": mj.OPTION_OPTIMIZE,
             "arithmetic": mj.OPTION_ARITHMETIC}

    def run(device):
        with jax.default_device(device):
            img = mj.read_jpeg(image)
            d = mj.read_dropon(logo, mask=mask)
            out = mj.compose(img, d, ALIGN_BR, -10, -10)
            fx = {"grayscale": mj.effect_grayscale(img),
                  "pixelate": mj.effect_pixelate(img),
                  "tint": mj.effect_tint(img, 30, -20),
                  "luminance": mj.effect_luminance(img, 40)}
            files = {k: mj.write_jpeg(out, options=o)
                     for k, o in modes.items()}
        return img, d, out, fx, files

    img, d, out, fx, files = run(dev)
    _, _, out_ref, fx_ref, _ = run(ref)
    rects = footprint_rects(img, d, ALIGN_BR, -10, -10)
    compare_outside(out, img, rects, "library compose")
    res = {"compose_vs_cpu": compare_footprint(out, out_ref, rects,
                                               "library compose")}
    for k in fx:
        check(equal_images(fx[k], fx_ref[k]), f"effect_{k} differs from CPU")
    for k, data in files.items():
        check(equal_images(codec.decode(data), out),
              f"write_jpeg {k} does not decode to the composed image")
    res["effects_equal_cpu"] = sorted(fx)
    res["write_modes_lossless"] = sorted(files)

    os.makedirs(SCRATCH, exist_ok=True)
    cli_out = os.path.join(SCRATCH, "cli.jpg")
    with jax.default_device(dev):
        rc = cli.main(["-i", image, "-p", "br", "-m", "-10,-10",
                       "-d", f"{logo},{mask}", "-y", "30", "-O",
                       "-o", cli_out])
        check(rc == 0, f"cli.main returned {rc}")
        want = mj.effect_luminance(out, 30)
    check(equal_images(mj.read_jpeg(cli_out), want),
          "CLI output differs from the library path")
    res["cli"] = "equal to compose + effect_luminance"
    return res


# ----------------------------------------------------------------- stream --

def make_stream_inputs(seed, n_free, n_rst, width, height, logo_wh):
    """Synthetic camera-like JPEGs (made on the CPU backend) and a logo."""
    import jax

    import libmodjpeg_tpu as mj
    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu.encode_pixels import from_pixels
    from bench import make_logo, make_test_image

    rng = np.random.RandomState(seed)
    with jax.default_device(jax.devices("cpu")[0]):
        imgs = [from_pixels(make_test_image(rng, width, height), quality=85,
                            subsampling="420") for _ in range(n_free)]
    free = [codec.encode(im) for im in imgs]
    rst = [codec.encode(im, restart_interval=32) for im in imgs[:n_rst]]
    dropon = mj.read_dropon_from_raw(make_logo(rng, *logo_wh),
                                     mj.COLORSPACE_RGBA, *logo_wh)
    return free, rst, dropon


def run_stream(data, dropon, batch, pool, mesh=None, **kw):
    """One watermark_stream pass; returns (outputs, path, seconds)."""
    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu.parallel.batch import BatchComposer

    bc = BatchComposer(codec.decode(data[0]), dropon, ALIGN_BR, -32, -32,
                       mesh=mesh)
    t0 = time.perf_counter()
    out = list(bc.watermark_stream(iter(data), batch=batch, pool=pool, **kw))
    return out, bc.last_stream_path, time.perf_counter() - t0, bc


def stream_phase(dev, ref, n_free=64, n_rst=32, batch=32, width=1920,
                 height=1088, logo_wh=(256, 64), seed=0) -> dict:
    """watermark_stream on every path, against the CPU backend."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import Mesh

    import libmodjpeg_tpu as mj
    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu.parallel.batch import BatchComposer

    free, rst, dropon = make_stream_inputs(seed, n_free, n_rst, width,
                                           height, logo_wh)
    res = {"files": n_free + n_rst, "width": width, "height": height,
           "batch": batch}
    with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2)) as pool, \
            jax.default_device(dev):
        splice, path, dt, _ = run_stream(free, dropon, batch, pool)
        check(path == "splice", f"default path {path!r}, want 'splice'")
        res["splice_s"] = dt
        full, path, dt, _ = run_stream(free, dropon, batch, pool,
                                       surgical=False)
        check(path == "full", f"surgical=False path {path!r}, want 'full'")
        res["full_s"] = dt
        surg, path, dt, _ = run_stream(rst, dropon, batch, pool,
                                       restart_interval=32)
        check(path == "surgical", f"restart set path {path!r}, "
              "want 'surgical'")
        res["surgical_s"] = dt
        t0 = time.perf_counter()
        single = [mj.watermark(x, dropon, ALIGN_BR, -32, -32)
                  for x in free[:4]]
        res["watermark_x4_s"] = time.perf_counter() - t0
    check(splice == full, "splice output differs from full-path output")
    res["splice_equals_full_bytes"] = True

    # the reference: the same packed compose on a one-device CPU mesh
    inputs = [codec.decode(x) for x in free]
    rects = footprint_rects(inputs[0], dropon, ALIGN_BR, -32, -32)
    with jax.default_device(ref):
        bc = BatchComposer(inputs[0], dropon, ALIGN_BR, -32, -32,
                           mesh=Mesh(np.asarray([ref]), ("batch",)))
        composed = [im.copy() for im in inputs]
        for i in range(0, len(composed), batch):
            bc.compose_images(composed[i:i + batch])
    outs = [codec.decode(x) for x in full]
    worst = {"max_abs": 0, "share": 0.0}
    for i, (o, inp, want) in enumerate(zip(outs, inputs, composed)):
        compare_outside(o, inp, rects, f"stream file {i}")
        r = compare_footprint(o, want, rects, f"stream file {i}")
        worst = {"max_abs": max(worst["max_abs"], r["max_abs"]),
                 "share": max(worst["share"], r["share"])}
    res["footprint_vs_cpu_worst_file"] = worst
    for i, x in enumerate(surg):
        check(equal_images(codec.decode(x), outs[i]),
              f"surgical file {i} differs from the full path")
    res["surgical_equals_full_coefs"] = True
    for i, x in enumerate(single):
        o = codec.decode(x)
        compare_outside(o, inputs[i], rects, f"watermark() file {i}")
        compare_footprint(o, composed[i], rects, f"watermark() file {i}")
    res["watermark_calls_checked"] = len(single)
    return res


# ------------------------------------------------------------------- grid --

GRID_EFFECTS = [("tint", {"cb_value": 3, "cr_value": -2}),
                ("luminance", {"value": 1})]


def check_tables(sess, what: str) -> float:
    """Device-built optimized tables must give the host optimize bytes."""
    import libmodjpeg_tpu as mj
    from libmodjpeg_tpu import codec

    t0 = time.perf_counter()
    tables = sess.optimized_tables()
    dt = time.perf_counter() - t0
    img = sess.to_image()
    check(codec.encode(img, preset_tables=tables)
          == codec.encode(img, options=mj.OPTION_OPTIMIZE),
          f"{what}: device-built tables differ from the host optimize pass")
    return dt


def grid_phase(dev, ref, width=12288, height=8192, logo_wh=(256, 64),
               seed=1) -> dict:
    """GridSession on a frame whose block grid lives on the device."""
    import jax

    import libmodjpeg_tpu as mj
    from libmodjpeg_tpu.parallel import GridSession
    from bench import make_grid_frame, make_logo

    img = make_grid_frame(seed, width, height)
    dropon = mj.read_dropon_from_raw(
        make_logo(np.random.RandomState(seed), *logo_wh),
        mj.COLORSPACE_RGBA, *logo_wh)
    res = {"frame_mp": width * height / 1e6,
           "blocks": int(sum(c.size // 64 for c in img.coefs))}
    with jax.default_device(dev):
        t0 = time.perf_counter()
        sess = GridSession(img).block_until_ready()
        res["upload_s"] = time.perf_counter() - t0
        check(sess.grids[0].devices() == {dev}, "grid not on the device")
        t0 = time.perf_counter()
        sess.compose(dropon, mj.ALIGN_CENTER).block_until_ready()
        res["compose_s"] = time.perf_counter() - t0
    with jax.default_device(ref):
        ref_composed = GridSession(img).compose(dropon,
                                                mj.ALIGN_CENTER).to_image()
    composed = sess.to_image()
    rects = footprint_rects(img, dropon, mj.ALIGN_CENTER, 0, 0)
    compare_outside(composed, img, rects, "grid compose")
    res["compose_vs_cpu"] = compare_footprint(composed, ref_composed, rects,
                                              "grid compose")
    # effects are integer operations: continue a CPU session from the
    # device's composed frame and require equality
    with jax.default_device(ref):
        rsess = GridSession(composed)
        for name, kw in GRID_EFFECTS:
            rsess.effect(name, **kw)
    with jax.default_device(dev):
        t0 = time.perf_counter()
        for name, kw in GRID_EFFECTS:
            sess.effect(name, **kw)
        sess.block_until_ready()
        res["tint_luminance_s"] = time.perf_counter() - t0
        check(equal_images(sess.to_image(), rsess.to_image()),
              "tint/luminance differ from the CPU backend")
        res["tables_s"] = check_tables(sess, "after tint/luminance")
        t0 = time.perf_counter()
        sess.effect("pixelate").block_until_ready()
        res["pixelate_s"] = time.perf_counter() - t0
    with jax.default_device(ref):
        rsess.effect("pixelate")
    check(equal_images(sess.to_image(), rsess.to_image()),
          "pixelate differs from the CPU backend")
    with jax.default_device(dev):
        res["tables_after_pixelate_s"] = check_tables(sess,
                                                      "after pixelate")
    res["effects_equal_cpu"] = ["tint", "luminance", "pixelate"]
    res["tables_equal_host_optimize"] = True
    return res


# ------------------------------------------------------------- four cards --

def cards_stream_phase(mesh, card0, n_free=64, n_rst=32, batch=32,
                       width=1920, height=1088, logo_wh=(256, 64),
                       seed=0) -> dict:
    """watermark_stream sharded over ``mesh`` vs the same on card 0."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import Mesh

    free, rst, dropon = make_stream_inputs(seed, n_free, n_rst, width,
                                           height, logo_wh)
    one = Mesh(np.asarray([card0]), ("batch",))
    res = {"cards": int(mesh.devices.size)}
    with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() or 2)) as pool:
        for name, data, kw in (("splice", free, {}),
                               ("full", free, {"surgical": False}),
                               ("surgical", rst, {"restart_interval": 32})):
            many, path, dt, bc = run_stream(data, dropon, batch, pool,
                                            mesh=mesh, **kw)
            check(bc.last_dispatch_devices == mesh.devices.size,
                  f"{name}: dispatch used {bc.last_dispatch_devices} cards")
            single, path1, dt1, _ = run_stream(data, dropon, batch, pool,
                                               mesh=one, **kw)
            check(path == path1 == name, f"{name}: paths {path}/{path1}")
            check(many == single, f"{name}: sharded output differs from "
                  "card 0 alone")
            res[name] = {"sharded_s": dt, "card0_s": dt1,
                         "bytes_equal": True}
    return res


def cards_grid_phase(mesh, card0, width=12288, height=8192,
                     logo_wh=(256, 64), seed=1) -> dict:
    """GridSession over a 1xN grid mesh vs the same session on card 0."""
    import jax

    import libmodjpeg_tpu as mj
    from libmodjpeg_tpu import codec
    from libmodjpeg_tpu.parallel import GridSession
    from bench import make_grid_frame, make_logo

    img = make_grid_frame(seed, width, height)
    dropon = mj.read_dropon_from_raw(
        make_logo(np.random.RandomState(seed), *logo_wh),
        mj.COLORSPACE_RGBA, *logo_wh)

    def run(m):
        with jax.default_device(card0):
            t0 = time.perf_counter()
            s = GridSession(img, m)
            s.compose(dropon, mj.ALIGN_CENTER)
            for name, kw in GRID_EFFECTS:
                s.effect(name, **kw)
            s.effect("pixelate").block_until_ready()
            tables = s.optimized_tables()
            return s, tables, time.perf_counter() - t0

    sharded, t_many, dt = run(mesh)
    check(len(sharded.grids[0].sharding.device_set) == mesh.devices.size,
          "grid not sharded over the mesh")
    single, t_one, dt1 = run(None)
    out = sharded.to_image()
    check(equal_images(out, single.to_image()),
          "sharded grid differs from card 0 alone")
    check(codec.encode(out, preset_tables=t_many)
          == codec.encode(out, preset_tables=t_one),
          "sharded optimized tables differ from card 0 alone")
    return {"cards": int(mesh.devices.size), "sharded_s": dt, "card0_s": dt1,
            "frame_equal": True, "tables_equal": True}


# ------------------------------------------------------------------- main --

def run_phase(name, fn, *args, **kw) -> dict:
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase {name}: {json.dumps(res)}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: only the sharded stream and grid phases")
    args = ap.parse_args(argv)

    import jax

    info = run_phase("device", device_phase, args.cards)
    from libmodjpeg_tpu.compile_cache import use_compile_cache
    from libmodjpeg_tpu.parallel.mesh import make_mesh, stream_mesh

    use_compile_cache()
    gpus = jax.devices()
    cpu = jax.devices("cpu")[0]
    if args.cards == 1:
        run_phase("library", library_phase, gpus[0], cpu)
        run_phase("stream", stream_phase, gpus[0], cpu)
        run_phase("grid", grid_phase, gpus[0], cpu)
    else:
        mesh = stream_mesh()
        check(mesh is not None and mesh.devices.size == args.cards,
              f"stream_mesh() spans {0 if mesh is None else mesh.devices.size}"
              f" cards, want {args.cards}")
        run_phase("stream_cards", cards_stream_phase, mesh, gpus[0])
        run_phase("grid_cards", cards_grid_phase,
                  make_mesh(gpus[:args.cards], batch=1, grid=args.cards),
                  gpus[0])
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
