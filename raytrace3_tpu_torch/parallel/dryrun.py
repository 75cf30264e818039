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

Both drop counters of the forward pass are checked, the eye's included
(``check_drops``; JAX's dry run checks only the deposit counter,
ADVICE.md:5).  On the card the kernels run; on the CPU their plain twins.

    python -m raytrace3_tpu_torch.parallel.dryrun [ranks] [--platform cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .mesh import make_mesh


def check_drops(stats: dict, what: str) -> None:
    """Raise unless both drop counters of ``stats`` are 0: a clipped eye
    ray or a dropped deposit is lost flux."""
    for k in ("dropped", "deposits_dropped"):
        if int(stats[k]) != 0:
            raise RuntimeError(f"{what}: {k} = {int(stats[k])}, the dry run drops nothing")


def dryrun(device=None) -> dict:
    """Both steps on this rank of a 2 x (world / 2) mesh (1 x 1 alone);
    returns what it checked, the same on every rank."""
    from ..diff.train import adam, extract_params, make_train_step
    from ..ops.deposit_kernel import DepositTile, world_bounds_from_scene
    from ..ops.lane_kernel import DepositLane
    from ..ops.newton_kernel import make_newton
    from ..render.driver import CAMERA_LOOK, CAMERA_POS, build_scene
    from ..utils.config import RenderConfig
    from .mesh import PHOTON_AXIS
    from .shard import make_sharded_pass_fn, shard_generators

    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_pass = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = make_mesh(n_pass, device=device)
    n_photon = mesh.size(PHOTON_AXIS)
    cfg = RenderConfig(scene="full", width=16, height=16, passes=1, rounds=2,
                       photons_per_round=64 * n_photon, max_depth=4, atlas_res=8,
                       bezier_compact_frac=1.0, newton_restarts=2, newton_iters=4,
                       hitpoint_factor=2.0)
    scene = build_scene(cfg, mesh.device)
    b = world_bounds_from_scene(scene, extra_points=[CAMERA_POS])
    b1 = {k: b[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")}
    newton = make_newton(cfg.newton_iters, restarts=2)

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
    lane = DepositLane(tile=128, chunk=256, differentiable=True, bucket2d=False,
                       work_cap=1024, **b1)
    init_fn, step_fn = make_train_step(scene, cfg, adam(1e-2), mesh=mesh, newton_fn=newton,
                                       deposit_fn=lane)
    params = extract_params(scene)
    if "ctrl" not in params:
        raise RuntimeError("the dry run must reach the Bezier control points")
    opt = init_fn(params)
    rng = shard_generators(0, 0, mesh)[1]
    target = torch.zeros((cfg.height, cfg.width, 3), device=mesh.device)
    params, opt, loss, tstats = step_fn(params, opt, rng, target)
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")
    if int(tstats["deposits_dropped"]) != 0:
        raise RuntimeError(f"train step: deposits_dropped = {int(tstats['deposits_dropped'])}")
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ranks", type=int, nargs="?", default=4)
    p.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    p.add_argument("--backend", default=None, help="nccl (the card's default) or gloo")
    args = p.parse_args(argv)
    out = dryrun_multichip(args.ranks, args.backend, args.platform)
    print(f"dryrun OK: {out[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
