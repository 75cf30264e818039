#!/usr/bin/env python3
"""The flagship scene with the reference's own texture images, on the
PyTorch/CUDA port, after ``scripts/asset_render.py``.

    python3 scripts/torch_asset_render.py --assets DIR [--res 512] [--passes 8]
        [--rounds 16] [--photons 131072] [--atlas-res 128] [--platform cpu]
        [--out PATH] [--png PATH]

``DIR`` is the reference's ``raytracer/`` directory, which holds
``wall.jpg`` (marble), ``timg.jpg`` (the red marble floor) and
``planet.jpg``; without ``--assets`` it is ``RT3_ASSET_TEXTURES``.  The
script sets ``RT3_ASSET_TEXTURES`` to it while it builds the scene, so the
atlas slots read those files (``scenes._atlas``, PIL's bilinear resize, as
JAX's); the reference has no ``blue.jpg``, so the teapot keeps its flat
blue (SURVEY quirk #11).  A directory that holds none of ``wall``, ``timg`` and
``planet`` is refused (exit 2, nothing written): the script cannot write a
record of procedural stand-ins under the asset record's name.

The render is ``render.driver.render`` on the bench-tuned configuration of
``scripts/asset_render.py:64-73``: ``full``, depth 13, live SPPM, the regen
walk, Bezier compaction 0.09 / 0.05, hit-point factor 1.3 and the staged
eye schedule ((1, .25), (4, .04), (6, .02)) at 512^2, ((1, .3), (4, .055),
(6, .028)) otherwise.  On the card the Newton kernel (#1) at 8 restarts x
10 iterations (the config's ``newton_restarts=4`` is JAX's quirk, kept:
the kernel is built at 8) and ``ops/deposit_kernel.make_tile_deposit``
(kernel #2 at tile 256 / chunk 2048, 1-D banding, bounds from the scene
and the camera: JAX's ``make_pallas_deposit``); on the CPU the default
solver and the brute-force deposit, as JAX's script off the TPU.

Writes ``docs/ASSET_TEAPOT<res>_PORT.json`` (JAX's keys, ``dropped`` and
``deposits_dropped`` summed over every pass, plus the device, the card's
name and power limit, ``reduced`` and ``asset_slots``: the file each atlas
slot was read from) and the tone-mapped PNG.  A run that dropped an eye
ray or a deposit writes neither and exits 3
(``utils.metrics.refuse_drops``).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raytrace3_tpu_torch.core.device import record_fields, resolve_device  # noqa: E402

DEFAULTS = dict(res=512, passes=8, rounds=16, photons=131072, atlas_res=128)
#: The reference camera (main.cpp:24), the deposit bounds' extra point.
CAMERA = [50.0, 35.0, 230.0]
#: The atlas slots the reference reads from files (it has no blue.jpg).
REFERENCE_SLOTS = ("wall", "timg", "planet")
#: The Newton kernel's build (``scripts/asset_render.py:89``; the config
#: says 4 restarts, JAX's quirk, kept).
NEWTON = dict(iters=10, restarts=8)


def asset_slots(asset_dir: str) -> dict:
    """{atlas slot: file name} of the slots ``scenes._atlas`` reads from
    ``asset_dir`` (its stems and extension order)."""
    from raytrace3_tpu_torch.scenes import _ASSET_EXTS, ATLAS_ASSETS

    found = {}
    for stem in ATLAS_ASSETS:
        for ext in _ASSET_EXTS:
            if os.path.exists(os.path.join(asset_dir, stem + ext)):
                found[stem] = stem + ext
                break
    return found


def config(args):
    """``scripts/asset_render.py:64-73``'s ``RenderConfig`` at ``args``."""
    from raytrace3_tpu_torch.utils.config import RenderConfig

    return RenderConfig(
        scene="full", width=args.res, height=args.res, passes=args.passes,
        rounds=args.rounds, photons_per_round=args.photons, max_depth=13,
        atlas_res=args.atlas_res,
        bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
        newton_restarts=4, newton_iters=10, update_mode="sppm",
        hitpoint_factor=1.3, photon_regen=True,
        eye_compact_schedule=((1, 0.25), (4, 0.04), (6, 0.02))
        if args.res == 512 else ((1, 0.3), (4, 0.055), (6, 0.028)),
        out=args.png)


def backends(scene, device):
    """(deposit_fn, newton_fn): on the card the tile deposit and the Newton
    kernel at 8 restarts (``scripts/asset_render.py:80-89``), on the CPU
    None for both (the brute-force deposit, ``solve_winner``)."""
    if device.type != "cuda":
        return None, None
    from raytrace3_tpu_torch.ops.deposit_kernel import (make_tile_deposit,
                                                        world_bounds_from_scene)
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton

    b = world_bounds_from_scene(scene, extra_points=[CAMERA])
    deposit_fn = make_tile_deposit(bucket2d=False,
                                   **{k: b[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")})
    return deposit_fn, make_newton(**NEWTON)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k.replace('_', '-')}", type=int, default=v)
    ap.add_argument("--assets", default=os.environ.get("RT3_ASSET_TEXTURES"),
                    help="the reference's raytracer/ directory (default: RT3_ASSET_TEXTURES)")
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="the record (default docs/ASSET_TEAPOT<res>_PORT.json)")
    ap.add_argument("--png", default=None,
                    help="the image (default docs/asset_teapot<res>_port.png)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.assets:
        print("torch_asset_render: pass --assets DIR (the reference's raytracer/) or set "
              "RT3_ASSET_TEXTURES", file=sys.stderr)
        return 2
    slots = asset_slots(args.assets)
    if not set(slots) & set(REFERENCE_SLOTS):
        print(f"torch_asset_render: {args.assets} holds none of "
              f"{', '.join(REFERENCE_SLOTS)} (.jpg, .jpeg or .png): refused, since the "
              "record would be of procedural stand-ins; nothing written", file=sys.stderr)
        return 2
    args.out = args.out or os.path.join(REPO, "docs", f"ASSET_TEAPOT{args.res}_PORT.json")
    args.png = args.png or os.path.join(REPO, "docs", f"asset_teapot{args.res}_port.png")

    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)
    from raytrace3_tpu_torch.render import driver
    from raytrace3_tpu_torch.render.sppm import tonemap
    from raytrace3_tpu_torch.utils.image import save_png
    from raytrace3_tpu_torch.utils.metrics import DROP_COUNTERS, refuse_drops

    cfg = config(args)
    previous = os.environ.get("RT3_ASSET_TEXTURES")
    os.environ["RT3_ASSET_TEXTURES"] = args.assets       # the scene's atlas reads it
    try:
        scene = driver.build_scene(cfg, device)
    finally:
        if previous is None:
            del os.environ["RT3_ASSET_TEXTURES"]
        else:
            os.environ["RT3_ASSET_TEXTURES"] = previous
    deposit_fn, newton_fn = backends(scene, device)
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "passes.jsonl")
        t0 = time.time()
        img, stats = driver.render(cfg, scene=scene, deposit_fn=deposit_fn,
                                   newton_fn=newton_fn, metrics_jsonl=metrics)
        dt = time.time() - t0
        with open(metrics) as f:
            passes = [json.loads(line) for line in f]
    drops = {k: sum(int(p[k]) for p in passes) for k in DROP_COUNTERS}
    refuse_drops(drops, f"the asset render at {args.res}^2 over {len(passes)} passes")

    os.makedirs(os.path.dirname(os.path.abspath(args.png)), exist_ok=True)
    save_png(args.png, tonemap(torch.as_tensor(img)).numpy(), tonemapped=True)
    record = {
        "what": "full scene with the reference's real textures "
                "(wall.jpg/timg.jpg/planet.jpg via RT3_ASSET_TEXTURES; "
                "blue.jpg absent upstream -> flat blue, quirk #11)",
        "reference_image": "raytracer/大理石.jpg of the reference (README.md:355)",
        "res": args.res, "passes": args.passes,
        "backend": device.type, "seconds": round(dt, 1),
        "meter": stats["meter"],
        "dropped": drops["dropped"], "deposits_dropped": drops["deposits_dropped"],
        "out": os.path.relpath(os.path.abspath(args.png), REPO),
        "asset_slots": slots,
        "newton": "kernel #1, 8 restarts" if newton_fn is not None else "solve_winner",
        "deposit": ("make_tile_deposit: DepositTile(tile=256, chunk=2048), 1-D banding"
                    if deposit_fn is not None else "bruteforce"),
        **record_fields(device),
        "reduced": [f"{k.replace('_', '-')} {v} -> {getattr(args, k)}"
                    for k, v in DEFAULTS.items() if getattr(args, k) != v],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, ensure_ascii=False)
        f.write("\n")
    print(json.dumps({k: v for k, v in record.items() if k != "meter"}, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
