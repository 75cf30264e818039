#!/usr/bin/env python
"""Cross-validate the PyTorch/CUDA port against the independent C++
implementation of the reference algorithm (native/baseline_sppm.cpp) on the
FULL scene: the port's counterpart of ``scripts/crossval.py``, with its
settings, comparison and pass rule.

The two implementations share no code, no random numbers and no layout;
they estimate the same integral.  Block-pooled linear radiance is compared
(``crossval.pool``) where the C++ block is brighter than 0.05, and the
tone-mapped images by PSNR: a run passes when the mean relative error is
below 0.10 and the PSNR above 25 dB.

The port renders one pass of ``--photons`` photons (rounds of at most
131072, or 65536 under ``--update-mode sppm``) at ``--res``^2: scene
``full_flat`` (``full`` with ``--textures``, whose atlas is dumped for the
C++ side), atlas 16 (64), Bezier compaction 0.12 / 0.06, hit-point factor
1.5, depth 13.  The deposit is ``DepositTile(tile=128, chunk=1024)`` with
1-D banding, exact and uncapped (on the CPU its plain twin: the grid
backend at ``max_per_cell=1024`` drops deposits in the dense cells of
these rounds, and a run with drops is refused); ``--newton-restarts N`` picks the Newton kernel at N restarts (the
plain twin on the CPU), else the default solver ``solve_winner``.

Writes ``docs/CROSSVAL_PORT{,_TEX,_SPPM,_PN<N>}.json`` (``--out``) and the
port's image ``docs/crossval_port{,_tex,_sppm,_pn<N>}.png`` (``--png``),
never the JAX package's artifacts.  Exits 1 when the run fails the rule,
and 3, writing nothing, when the port's pass dropped an eye ray or a
deposit (``utils.metrics.refuse_drops``).

  python3 scripts/torch_crossval.py [--res 128] [--photons 2097152] \\
      [--block 16] [--textures] [--update-mode sppm] [--newton-restarts 8] \\
      [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(SCRIPTS)
sys.path[:0] = [REPO, SCRIPTS]

from crossval import pool, run_cpp  # noqa: E402  (scripts/crossval.py)

#: The reference camera (main.cpp:24, 27), as scripts/crossval.py aims it.
CAMERA = ((50.0, 35.0, 230.0), (50.0, 35.042612, 229.0))


def tonemap(x):
    """scripts/crossval.py's tone map for the PSNR: (1 - e^-x)^(1/2.2)."""
    return np.power(1.0 - np.exp(-np.maximum(x, 0.0)), 1.0 / 2.2)


def dump_atlas(atlas: np.ndarray, path: str) -> None:
    """The atlas (T, H, W, 3) for the C++ side, in scripts/crossval.py's
    format (int32 T; per texture int32 H, W, then H x W x 3 float32)."""
    atlas = np.asarray(atlas, np.float32)
    with open(path, "wb") as f:
        f.write(np.asarray([atlas.shape[0]], np.int32).tobytes())
        for t in range(atlas.shape[0]):
            f.write(np.asarray(atlas.shape[1:3], np.int32).tobytes())
            f.write(np.ascontiguousarray(atlas[t]).tobytes())


def build(res: int, photons: int, device, scene_name: str, update_mode: str,
          per_round_cap: int, atlas_res: int, newton_restarts: int):
    """(config, scene, pass function rng -> (image, stats), photons) of the
    port at scripts/crossval.py's settings (``run_jax``)."""
    from raytrace3_tpu_torch.ops.deposit_kernel import DepositTile, world_bounds_from_scene
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.sppm import render_pass
    from raytrace3_tpu_torch.utils.config import RenderConfig

    per_round = min(photons, per_round_cap)
    rounds = max(photons // per_round, 1)
    cfg = RenderConfig(scene=scene_name, width=res, height=res, rounds=rounds,
                       photons_per_round=per_round, max_depth=13, atlas_res=atlas_res,
                       update_mode=update_mode, bezier_compact_frac=0.12,
                       bezier_compact_frac_photon=0.06, hitpoint_factor=1.5)
    scene = build_scene(cfg, device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    org, dirs = emit_rays(look_at(f32(CAMERA[0]), f32(CAMERA[1]), res, res))
    photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
    b = world_bounds_from_scene(scene, extra_points=[CAMERA[0]])
    deposit_fn = DepositTile(tile=128, chunk=1024,
                             **{k: b[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")})
    newton_fn = (make_newton(iters=cfg.newton_iters, restarts=newton_restarts)
                 if newton_restarts else None)

    def one_pass(rng):
        return render_pass(scene, org, dirs, rng, hitpoint_capacity=cfg.hitpoint_capacity,
                           n_rounds=rounds, photons_per_round=per_round,
                           max_depth=cfg.max_depth, update_mode=update_mode,
                           deposit_fn=deposit_fn, newton_fn=newton_fn,
                           photon_scene=photon_scene)

    return cfg, scene, one_pass, rounds * per_round


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--photons", type=int, default=2097152)
    ap.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--textures", action="store_true",
                    help="the textured full scene, its atlas dumped for the C++ side")
    ap.add_argument("--update-mode", choices=["reference", "sppm"], default="reference")
    ap.add_argument("--newton-restarts", type=int, default=0,
                    help="the Newton kernel at this many restarts (0: solve_winner)")
    ap.add_argument("--out", default=None, help="the JSON record's path")
    ap.add_argument("--png", default=None, help="the port image's path")
    args = ap.parse_args(argv)

    from raytrace3_tpu_torch.core.device import card_line, resolve_device
    from raytrace3_tpu_torch.utils.image import save_png
    from raytrace3_tpu_torch.utils.metrics import refuse_drops

    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    cuda = device.type == "cuda"
    scene_name = "full" if args.textures else "full_flat"
    atlas_res = 64 if args.textures else 16
    tag = (("_tex" if args.textures else "") + ("_sppm" if args.update_mode == "sppm" else "")
           + (f"_pn{args.newton_restarts}" if args.newton_restarts else ""))
    docs = os.path.join(REPO, "docs")
    out = args.out or os.path.join(docs, f"CROSSVAL_PORT{tag.upper()}.json")
    png = args.png or os.path.join(docs, f"crossval_port{tag}.png")
    per_round_cap = 65536 if args.update_mode == "sppm" else 131072
    onetime = per_round_cap if args.update_mode == "sppm" else 100

    cfg, scene, one_pass, emitted = build(args.res, args.photons, device, scene_name,
                                          args.update_mode, per_round_cap, atlas_res,
                                          args.newton_restarts)
    with tempfile.TemporaryDirectory() as tmp:
        texbin = None
        if args.textures:
            # The atlas the port samples, so that the C++ side compares
            # transport, not assets.
            texbin = os.path.join(tmp, "atlas.bin")
            dump_atlas(scene.atlas.detach().cpu().numpy(), texbin)
        dump = os.path.join(tmp, "cpp.bin")
        print(f"torch_crossval: C++ side ({args.photons} photons @ {args.res}^2, "
              f"{scene_name}, {args.update_mode}) ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        cpp_stats = run_cpp(args.res, args.photons, dump, texbin=texbin, onetime=onetime,
                            update_mode=args.update_mode)
        cpp_s = time.perf_counter() - t0
        cpp = np.fromfile(dump, dtype=np.float32).reshape(args.res, args.res, 3)
    print(f"torch_crossval: C++ {cpp_s:.1f} s, {cpp_stats}", file=sys.stderr, flush=True)

    print(f"torch_crossval: port side on {device} ...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    img, stats = one_pass(torch.Generator(device=device).manual_seed(args.seed))
    ours = img.reshape(args.res, args.res, 3).cpu().numpy()
    port_s = time.perf_counter() - t0
    stats = {k: float(v) for k, v in stats.items()}
    print(f"torch_crossval: port pass {port_s:.1f} s, {stats}", file=sys.stderr, flush=True)
    refuse_drops(stats, f"the port's pass ({scene_name}, {args.update_mode})")

    po, pc = pool(ours, args.block), pool(cpp, args.block)
    mask = pc.mean(-1) > 0.05            # skip near-black blocks (MC noise floor)
    rel = np.abs(po - pc)[mask] / (pc[mask] + 0.05)
    mse = float(np.mean((tonemap(ours) - tonemap(cpp)) ** 2))
    psnr = 10.0 * np.log10(1.0 / mse) if mse > 0 else float("inf")

    os.makedirs(os.path.dirname(os.path.abspath(png)), exist_ok=True)
    save_png(png, ours)
    record = {
        "scene": f"{scene_name} (mirror+glass spheres, mirror wall, teapot)"
                 + (" TEXTURED via shared atlas dump" if args.textures else ""),
        "update_mode": args.update_mode,
        "res": args.res,
        "photons_each": int(emitted),
        "block": args.block,
        "blocks_compared": int(mask.sum()),
        "blocks_total": int(mask.size),
        "rel_err_mean": round(float(rel.mean()), 4),
        "rel_err_p95": round(float(np.percentile(rel, 95)), 4),
        "rel_err_max": round(float(rel.max()), 4),
        "psnr_tonemapped_db": round(psnr, 2),
        "port_stats": {k: round(v, 2) for k, v in stats.items()},
        "cpp_stats": cpp_stats,
        "pass": bool(rel.mean() < 0.10 and psnr > 25.0),
        "newton": (f"kernel #1, {args.newton_restarts} restarts" if args.newton_restarts
                   else "solve_winner"),
        "deposit": "DepositTile(tile=128, chunk=1024), 1-D banding",
        "port_seconds": round(port_s, 2),
        "cpp_seconds": round(cpp_s, 2),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": card_line() if cuda else None,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(json.dumps(record, indent=2))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
