"""Dry run of the sharded forward pass and train step on a 2 x (n / 2) mesh.

Port of ``__graft_entry__.dryrun_multichip``: the ``full`` scene (mirror and
glass spheres, mirror back wall, the 32-patch Bezier teapot) at tiny
shapes, so the sharded eye pass crosses specular chains and the gathered
hit points are real multi-bounce ones:

1. the tuned forward pass through ``make_sharded_pass_fn``: the regen walk,
   the staged eye wavefront, layout-space rounds through the tile deposit
   (kernel #2) and the Newton solve (kernel #1);
2. the differentiable train step through ``make_train_step(mesh=)`` and the
   lane deposit (kernels #3 and #4), with finite gradients for the
   albedos, the atlas and the teapot's control points (the albedos' not
   zero).

Both drop counters of both steps are checked, the eye's included
(``utils.metrics.check_drops``; JAX's dry run checks only the deposit
counter, ADVICE.md:5).  On the card the kernels run; on the CPU their plain twins.

    python -m raytrace3_tpu_torch.parallel.dryrun [ranks] [--platform cpu] [--backend gloo]
        [--out docs/MULTICHIP_PORT.json]

``--out`` writes the record: ``MULTICHIP_r05.json``'s keys, the mesh, the
loss, the largest gradients, both steps' counters and where it ran.  The
loss is drawn from torch's generators, so it is not JAX's 0.593946:
tests/test_torch_multihost.py holds the train step to that number on
JAX's draws.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils.metrics import check_drops
from .mesh import make_mesh


def _setup(mesh):
    """(cfg, scene, the tile and lane deposits' (x, y) bounds, the Newton
    solve) of the dry run on ``mesh``: ``__graft_entry__.py:79-108``."""
    from ..ops.deposit_kernel import world_bounds_from_scene
    from ..ops.newton_kernel import make_newton
    from ..render.driver import CAMERA_POS, build_scene
    from ..utils.config import RenderConfig
    from .mesh import PHOTON_AXIS

    cfg = RenderConfig(scene="full", width=16, height=16, passes=1, rounds=2,
                       photons_per_round=64 * mesh.size(PHOTON_AXIS), max_depth=4, atlas_res=8,
                       bezier_compact_frac=1.0, newton_restarts=2, newton_iters=4,
                       hitpoint_factor=2.0)
    scene = build_scene(cfg, mesh.device)
    b = world_bounds_from_scene(scene, extra_points=[CAMERA_POS])
    b1 = {k: b[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")}
    return cfg, scene, b1, make_newton(cfg.newton_iters, restarts=2)


def dryrun_mesh(device=None):
    """This rank's mesh of the dry run: 2 x (world / 2) on an even world,
    1 x world otherwise (``__graft_entry__.py:73-76``)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(2 if world % 2 == 0 and world >= 2 else 1, device=device)


def train_step(mesh):
    """(cfg, scene, init_fn, step_fn) of the dry run's differentiable train
    step on ``mesh``: ``make_train_step(mesh=)`` with Adam at 1e-2, the
    Newton solve and the lane deposit (kernels #3 and #4) at
    ``__graft_entry__.py:113-120``'s settings."""
    from ..diff.train import adam, make_train_step
    from ..ops.lane_kernel import DepositLane

    cfg, scene, b1, newton = _setup(mesh)
    lane = DepositLane(tile=128, chunk=256, differentiable=True, bucket2d=False,
                       work_cap=1024, **b1)
    init_fn, step_fn = make_train_step(scene, cfg, adam(1e-2), mesh=mesh, newton_fn=newton,
                                       deposit_fn=lane)
    return cfg, scene, init_fn, step_fn


def dryrun(device=None) -> dict:
    """Both steps on this rank of a 2 x (world / 2) mesh (1 x 1 alone);
    returns what it checked, the same on every rank."""
    from ..diff.train import extract_params
    from ..ops.deposit_kernel import DepositTile
    from ..render.driver import CAMERA_LOOK, CAMERA_POS
    from .shard import make_sharded_pass_fn, shard_generators

    mesh = dryrun_mesh(device)
    cfg, scene, b1, newton = _setup(mesh)

    # 1: the tuned forward pass.
    fwd_cfg = cfg.replace(photon_regen=True, eye_compact_schedule=((1, 0.5),))
    fwd = make_sharded_pass_fn(scene, fwd_cfg, CAMERA_POS, CAMERA_LOOK, mesh,
                               deposit_fn=DepositTile(tile=128, chunk=256, **b1),
                               newton_fn=newton)
    img, fstats = fwd(*shard_generators(1, 0, mesh))
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
        raise RuntimeError("the sharded image is not finite and positive")
    check_drops(fstats, "sharded forward pass")

    # 2: the differentiable train step.
    _, scene, init_fn, step_fn = train_step(mesh)
    params = extract_params(scene)
    if "ctrl" not in params:
        raise RuntimeError("the dry run must reach the Bezier control points")
    opt = init_fn(params)
    rng = shard_generators(0, 0, mesh)[1]
    target = torch.zeros((cfg.height, cfg.width, 3), device=mesh.device)
    params, opt, loss, tstats = step_fn(params, opt, rng, target)
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")
    check_drops(tstats, "train step")
    for k, v in params.items():
        if not bool(torch.isfinite(v).all()) or not bool(torch.isfinite(v.grad).all()):
            raise RuntimeError(f"non-finite params or gradients in {k}")
    if not float(params["diff"].grad.abs().max()) > 0:
        raise RuntimeError("no gradient reaches the albedos")
    return {"mesh": dict(mesh.shape), "loss": float(loss),
            "grad_max": {k: float(v.grad.abs().max()) for k, v in params.items()},
            "image_mean": float(img.mean()),
            "forward": {k: float(v) for k, v in fstats.items()},
            "train": {k: int(v) for k, v in tstats.items()}}


def dryrun_multichip(n_ranks: int, backend: str | None = None, device=None,
                     timeout: float = 600.0) -> list:
    """:func:`dryrun` on ``n_ranks`` spawned ranks (``parallel.launch``);
    returns each rank's result.  ``backend`` defaults as ``multihost_init``'s
    does: NCCL for ranks on the card, gloo on the CPU."""
    from .launch import spawn
    from .mesh import default_backend

    return spawn(dryrun, n_ranks, (device,), timeout=timeout,
                 backend=default_backend(device) if backend is None else backend)


def record(outs: list, backend: str, seconds: float, device=None) -> dict:
    """The dry run's record: ``MULTICHIP_r05.json``'s keys (``n_devices``,
    ``rc``, ``ok``, ``skipped``, and ``tail``, JAX's last line) and what
    every rank returned, with where it ran.  ``ok``: every rank returned
    the same result."""
    from ..core.device import DEFAULT_DEVICE, record_fields

    o = outs[0]
    ok = all(x == o for x in outs)
    return {"n_devices": len(outs), "rc": 0 if ok else 1, "ok": ok, "skipped": False,
            "tail": f"dryrun_multichip OK: mesh={o['mesh']} fwd_regen=1 "
                    f"loss={o['loss']:.6f}\n",
            "ranks": len(outs), "backend": backend, "seconds": seconds, **o,
            "torch": torch.__version__,
            **record_fields(device if device is not None else DEFAULT_DEVICE)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ranks", type=int, nargs="?", default=4)
    p.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    p.add_argument("--backend", default=None, help="nccl (the card's default) or gloo")
    p.add_argument("--out", default=None, help="write the record (JSON) here")
    args = p.parse_args(argv)
    import time

    from .mesh import default_backend

    backend = args.backend or default_backend(args.platform)
    t0 = time.perf_counter()
    out = dryrun_multichip(args.ranks, backend, args.platform)
    rec = record(out, backend, time.perf_counter() - t0, args.platform)
    print(f"dryrun OK: {out[0]}" if rec["ok"] else "dryrun: the ranks disagree")
    if args.out:
        import json

        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
    return rec["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
