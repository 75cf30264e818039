#!/usr/bin/env python3
"""Eye rays alive at each segment of the bench's eye pass, pass by pass.

For passes 0..N-1 of ``bench_torch.py`` (the camera jitter drawn from
``render.driver.pass_generator(0, i)`` as ``make_pass_fn`` draws it), runs
the 512^2 eye pass of the bench's scene with the Newton kernel at 8
restarts, without a compaction schedule, and prints one JSON line a pass:
the jitter's (z, phi), the pass's counters, and the rays alive entering
each of the 14 segments.  A ray trapped inside the mirror sphere (the
reference's self-hit quirk) stays alive to the end; the bench's eye stages
must hold the rays alive at segments 1, 4 and 6 (ROADMAP section 3, F3).

    python3 scripts/torch_eye_survivors.py [--passes 12] [--platform cpu]
        [--pose Z PHI]

``--pose`` takes one jitter instead (the same camera on another device).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=12)
    ap.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--pose", type=float, nargs=2, default=None, metavar=("Z", "PHI"))
    args = ap.parse_args(argv)

    from bench_torch import BASE, LOOK
    from raytrace3_tpu_torch.core.device import resolve_device
    from raytrace3_tpu_torch.core.sampling import TWO_PI, as_draws, uniform_sphere
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render import eye
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.driver import build_scene, pass_generator
    from raytrace3_tpu_torch.utils.config import RenderConfig

    dev = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    cfg = RenderConfig(scene="full", width=512, height=512, atlas_res=128,
                       bezier_compact_frac=0.09, hitpoint_factor=1.3)
    scene = build_scene(cfg, dev)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    base, look = f32(BASE), f32(LOOK)
    newton = make_newton(cfg.newton_iters, 8)
    alive = []
    segment = eye.eye_segment

    def counting(scene_, fetch_mat, lanes, newton_fn=None, slots=1):
        alive.append(int(lanes[4].sum()))
        return segment(scene_, fetch_mat, lanes, newton_fn, slots)

    poses = []
    if args.pose is not None:
        poses.append((None, f32(args.pose[0]), f32(args.pose[1])))
    else:
        for i in range(args.passes):
            draws = as_draws(pass_generator(0, i, dev))
            poses.append((i, draws.uniform((), -1.0, 1.0), draws.uniform((), 0.0, TWO_PI)))
    eye.eye_segment = counting
    try:
        for i, z, phi in poses:
            alive.clear()
            pos = base + cfg.jitter * uniform_sphere(z, phi)
            org, dir = emit_rays(look_at(pos, look, cfg.width, cfg.height))
            _, st = eye.eye_pass(scene, org, dir, cfg.hitpoint_capacity, cfg.max_depth,
                                 newton_fn=newton)
            print(json.dumps({"pass": i, "z": float(z), "phi": float(phi), "device": str(dev),
                              "stats": {k: int(v) for k, v in st.items()},
                              "alive": alive[:]}), flush=True)
    finally:
        eye.eye_segment = segment
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
