"""Command-line renderer of the port: ``python -m raytrace3_tpu_torch.cli``
(installed as ``rt3-torch``).

Port of ``raytrace3_tpu/cli.py`` with its flags and defaults: named scenes
and presets, every constant a flag, checkpoint and resume, a preview PNG,
per-pass metrics and a profiler trace.  It runs on the card unless
``--platform cpu`` asks for the CPU; without a card it raises.  ``--pallas``
picks the Newton kernel (``ops/newton_kernel``, 8 restarts) and
``--deposit pallas`` the block deposit (kernel #5); without ``--pallas`` the
Bezier solve is ``geometry.bezier.solve_winner``, as in the JAX package.
The sharded renderer (``--sharded``, ``--hp-sharded``) is not ported: those
flags exit non-zero.
"""

from __future__ import annotations

import argparse
import logging
import sys

#: Hit-point capacity above which a render counts as large (1024^2-class)
#: and the banded deposits take their larger tile and work-cap sizes.
BIG_CAPACITY = 1 << 19


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rt3-torch", description="SPPM renderer, PyTorch/CUDA port")
    p.add_argument("--preset", default=None,
                   help="named config preset (cornell128/specular256/"
                        "bezier256/teapot512/sharded10m/reference1024)")
    p.add_argument("--scene", default=None, help="scene name (overrides preset scene)")
    p.add_argument("--res", type=int, default=None, help="square resolution")
    p.add_argument("--passes", type=int, default=None)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--photons", type=int, default=None, help="photons per round per light")
    p.add_argument("--depth", type=int, default=None, help="max trace depth")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--update-mode", choices=["sppm", "reference"], default=None)
    p.add_argument("--deposit", choices=["bruteforce", "grid", "pallas", "lane", "tile"],
                   default=None)
    p.add_argument("--hp-sharded", action="store_true",
                   help="not ported (ROADMAP Slice D): exits non-zero")
    p.add_argument("--pallas", action="store_true",
                   help="use the Newton kernel (the JAX package's Pallas flag)")
    p.add_argument("--regen", action="store_true",
                   help="refill dead photon lanes every segment")
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--checkpoint", default=None, help="checkpoint file path")
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--preview-every", type=int, default=1,
                   help="write the running-average PNG every N passes (default 1, "
                        "the reference's per-pass dump, Raytracer.h:472-474; "
                        "0 disables)")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of one pass here")
    p.add_argument("--platform", default=None,
                   help="the device: cpu, or the GPU (cuda, the default)")
    p.add_argument("--sharded", action="store_true",
                   help="not ported (ROADMAP Slice D): exits non-zero")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def config_from_args(args):
    """The ``RenderConfig`` of the parsed flags (preset, then overrides)."""
    from .utils.config import RenderConfig, get_config

    cfg = get_config(args.preset) if args.preset else RenderConfig()
    over = {}
    if args.scene: over["scene"] = args.scene
    if args.res: over.update(width=args.res, height=args.res)
    if args.passes is not None: over["passes"] = args.passes
    if args.rounds is not None: over["rounds"] = args.rounds
    if args.photons is not None: over["photons_per_round"] = args.photons
    if args.depth is not None: over["max_depth"] = args.depth
    if args.seed is not None: over["seed"] = args.seed
    if args.update_mode: over["update_mode"] = args.update_mode
    if args.deposit: over["deposit"] = args.deposit
    if args.pallas: over["use_pallas"] = True
    if args.regen: over["photon_regen"] = True
    if args.out: over["out"] = args.out
    if args.checkpoint_every is not None:
        over["checkpoint_every"] = args.checkpoint_every
    return cfg.replace(**over)


def make_backends(cfg, scene):
    """(newton_fn, deposit_fn) of the config, as ``raytrace3_tpu/cli.py``
    picks them; None means the render's default (``solve_winner``, the
    bruteforce deposit)."""
    from .ops.deposit_kernel import DepositBlock, DepositTile, world_bounds_from_scene
    from .ops.grid import make_grid_deposit
    from .ops.lane_kernel import DepositLane
    from .ops.newton_kernel import make_newton
    from .render.driver import CAMERA_POS

    newton_fn = make_newton(iters=cfg.newton_iters) if cfg.use_pallas else None
    if cfg.deposit == "bruteforce":
        return newton_fn, None
    # The camera bounds where eye hit points land.
    b = world_bounds_from_scene(scene, extra_points=[CAMERA_POS])
    xy = {k: b[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")}
    big = cfg.hitpoint_capacity > BIG_CAPACITY
    if cfg.deposit == "grid":
        deposit_fn = make_grid_deposit(lo=(b["x_lo"], b["y_lo"], b["z_lo"]),
                                       hi=(b["x_hi"], b["y_hi"], b["z_hi"]))
    elif cfg.deposit == "tile":
        deposit_fn = DepositTile(tile=512 if big else 256, chunk=2048, bucket2d=False, **xy)
    elif cfg.deposit == "lane":
        deposit_fn = DepositLane(tile=256, chunk=512, work_cap=49152 if big else 16384, **b)
    elif cfg.deposit == "pallas":
        # A 1024^2 canvas needs ~74k work items at tile 512; at tile 1024
        # the cap of 65536 holds it (raytrace3_tpu/cli.py:150-162).
        deposit_fn = DepositBlock(tile=1024 if big else 512,
                                  work_cap=65536 if big else 16384, **xy)
    else:
        raise ValueError(f"unknown deposit backend {cfg.deposit!r}")
    return newton_fn, deposit_fn


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    if args.sharded or args.hp_sharded:
        print("rt3-torch: --sharded and --hp-sharded are not ported yet "
              "(ROADMAP Slice D, the parallel axes)", file=sys.stderr)
        return 2

    from .core.device import DEFAULT_DEVICE, resolve_device
    from .render import driver
    from .utils.image import save_png

    device = resolve_device(args.platform or DEFAULT_DEVICE)
    cfg = config_from_args(args)
    scene = driver.build_scene(cfg, device)
    newton_fn, deposit_fn = make_backends(cfg, scene)
    img, metrics = driver.render(
        cfg, scene=scene, checkpoint_path=args.checkpoint,
        preview_every=args.preview_every, metrics_jsonl=args.metrics_jsonl,
        newton_fn=newton_fn, deposit_fn=deposit_fn, profile_dir=args.profile_dir)
    save_png(cfg.out, img)
    m = metrics.get("meter", {})
    print(f"wrote {cfg.out}  passes={m.get('passes')}  "
          f"photons/s={m.get('photons_per_s', 0):.3g}  "
          f"Mrays/s={m.get('mrays_per_s', 0):.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
