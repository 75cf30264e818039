"""Differentiable rendering and the inverse-rendering train step.

Port of ``raytrace3_tpu/diff/train.py``: gradients of an image loss with
respect to the material albedos, the texture atlas and the Bezier control
points, through the whole SPPM pass (the deposit's custom backward, the
Newton solve's implicit-function-theorem backward, the texture and
material lookups), on one rank or with eye rays and photons sharded over
the photon axis of a ``parallel.mesh.Mesh`` (``make_train_step(mesh=)``).

Learnable parameters, a dict of leaf tensors pulled from / injected into a
``Scene``:

  * ``diff``  - (N, 3) diffuse albedo table     (reference Material.diff)
  * ``atlas`` - (T, H, W, 3) texture maps       (reference Texture grids)
  * ``ctrl``  - (B, 4, 4, 3) Bezier control pts (reference Bezier3::P)
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.bezier import BezierObject
from ..geometry.scene import Scene
from ..ops.deposit_kernel import world_bounds_from_scene
from ..ops.lane_kernel import DepositLane
from ..render.camera import emit_rays, look_at
from ..render.sppm import render_pass
from ..utils.config import RenderConfig
from .vjp import deposit_bruteforce_vjp

#: The reference camera (main.cpp:22-27).
CAMERA_POS = (50.0, 35.0, 230.0)
CAMERA_LOOK = (50.0, 35.042612, 229.0)


def extract_params(scene: Scene) -> dict:
    """The scene's learnable tensors, as copies (training never writes into
    the scene)."""
    p = {"diff": scene.materials.diff, "atlas": scene.atlas}
    if scene.has_bezier:
        p["ctrl"] = scene.bezier.ctrl
    return {k: v.detach().clone() for k, v in p.items()}


def inject_params(scene: Scene, params: dict) -> Scene:
    scene = scene.replace(materials=scene.materials.replace(diff=params["diff"]),
                          atlas=params["atlas"])
    if "ctrl" in params and scene.has_bezier:
        scene = scene.replace(bezier=BezierObject(ctrl=params["ctrl"]))
    return scene


def default_deposit_vjp(scene: Scene, cfg: RenderConfig, camera_pose=None,
                        capacity: int | None = None, device=None):
    """The gradient path's deposit backend.

    On the card at >= 256^2 the all-pairs VJP's C x D pair tests stop being
    affordable, so the banded lane deposit with its transposed-kernel
    backward (``DepositLane(differentiable=True)``) is the default; on the
    CPU and on small canvases the bruteforce VJP stays (simpler, exactly as
    accurate).  ``capacity`` sizes the deposit's work cap, which bounds the
    deposit WORK of one call, not the hit-point buffer it receives: pass
    the per-rank share C / n_photon when photons are sharded (the sharded
    loss hands the backend all C gathered hit points, but each rank
    deposits only its photon shard); defaults to ``cfg.hitpoint_capacity``.
    An undersized cap is loud: its overflow is counted in
    ``deposits_dropped``.  ``device``: where the pass runs; defaults to the
    scene's.
    """
    if capacity is None:
        capacity = cfg.hitpoint_capacity
    device = torch.device(device) if device is not None else scene.device
    if device.type == "cuda" and cfg.n_pixels >= 256 * 256:
        pos = camera_pose[0] if camera_pose is not None else CAMERA_POS
        bounds = world_bounds_from_scene(scene, extra_points=[[float(x) for x in pos]])
        big = capacity > (1 << 19)
        return DepositLane(tile=256, chunk=512, work_cap=49152 if big else 16384,
                           differentiable=True, **bounds)
    return deposit_bruteforce_vjp


def _camera_rays(scene: Scene, cfg: RenderConfig, camera_pose):
    pos, look = camera_pose if camera_pose is not None else (CAMERA_POS, CAMERA_LOOK)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=scene.device)
    return emit_rays(look_at(f32(pos), f32(look), cfg.width, cfg.height))


def _make_pass(scene, cfg, camera_pose, newton_fn, deposit_fn):
    """(params, rng) -> (image (H*W, 3), stats) of one differentiable pass."""
    org, dir = _camera_rays(scene, cfg, camera_pose)
    if deposit_fn is None:
        deposit_fn = default_deposit_vjp(scene, cfg, camera_pose)

    def run(params, rng):
        return render_pass(
            inject_params(scene, params), org, dir, rng,
            hitpoint_capacity=cfg.hitpoint_capacity,
            n_rounds=cfg.rounds,
            photons_per_round=cfg.photons_per_round,
            max_depth=cfg.max_depth,
            slots=cfg.slots,
            init_r2=cfg.init_r2,
            update_mode=cfg.update_mode,
            deposit_fn=deposit_fn,
            newton_fn=newton_fn,
        )

    return run


def make_render_fn(scene: Scene, cfg: RenderConfig, camera_pose=None,
                   newton_fn=None, deposit_fn=None, with_drops: bool = False):
    """``render(params, rng) -> (H*W, 3)`` differentiable image.

    ``rng``: a ``torch.Generator`` on the scene's device or a draws source.
    The pass is JAX's: the slot eye wavefront and the static photon walk.
    ``with_drops``: also return both drop counters, ``{"dropped",
    "deposits_dropped"}``, as ``make_train_step``'s step does (a work-cap
    overflow drops real flux and its gradient; JAX's returns the second
    alone)."""
    run = _make_pass(scene, cfg, camera_pose, newton_fn, deposit_fn)

    def render(params, rng):
        img, stats = run(params, rng)
        if with_drops:
            return img, {k: stats[k] for k in ("dropped", "deposits_dropped")}
        return img

    return render


def adam(lr: float = 1e-2):
    """An optimizer factory for :func:`make_train_step`: ``torch.optim.Adam``
    with optax.adam's defaults (betas 0.9 / 0.999, eps 1e-8 outside the
    square root)."""
    return lambda tensors: torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999),
                                            eps=1e-8)


def adam_cosine(tensors, lr: float, steps: int, alpha: float):
    """(optimizer, scheduler): Adam as :func:`adam` under optax's
    ``cosine_decay_schedule(lr, steps, alpha)``, the rate ``lr ((1 - alpha)
    (1 + cos(pi t / steps)) / 2 + alpha)`` at step t, which is
    ``CosineAnnealingLR(T_max=steps, eta_min=alpha lr)``.  Call the
    scheduler's ``step()`` after each optimizer step."""
    opt = adam(lr)(tensors)
    return opt, torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps,
                                                           eta_min=alpha * lr)


def optimizer_tree(opt: torch.optim.Optimizer, params: dict) -> dict:
    """The Adam state of ``opt`` over ``params`` (as :func:`make_train_step`'s
    ``init_fn`` built it) as a tree for ``utils.checkpoint.save_tree``:
    per parameter name its ``step``, ``exp_avg`` and ``exp_avg_sq``.  A
    parameter not stepped yet gets zeros, the template
    :func:`load_optimizer_tree` restores into."""
    sd = opt.state_dict()
    tree = {}
    for name, i in zip(params, sd["param_groups"][0]["params"]):
        p = params[name]
        st = sd["state"].get(i) or {"step": torch.zeros((), dtype=torch.float32),
                                    "exp_avg": torch.zeros_like(p),
                                    "exp_avg_sq": torch.zeros_like(p)}
        tree[name] = {k: st[k] for k in ("step", "exp_avg", "exp_avg_sq")}
    return tree


def load_optimizer_tree(opt: torch.optim.Optimizer, params: dict, tree: dict) -> None:
    """Set ``opt``'s Adam state from an :func:`optimizer_tree` tree."""
    sd = opt.state_dict()
    sd["state"] = {i: {k: v.clone() for k, v in tree[name].items()}
                   for name, i in zip(params, sd["param_groups"][0]["params"])}
    opt.load_state_dict(sd)


def make_train_step(scene: Scene, cfg: RenderConfig, optimizer=None,
                    camera_pose=None, newton_fn=None, deposit_fn=None, mesh=None):
    """(init_fn, step_fn) for inverse rendering.

    ``init_fn(params)`` makes the dict's tensors leaves that require grad
    and returns the optimizer over them (``optimizer``, a factory such as
    :func:`adam`; default ``adam(1e-2)``).
    ``step_fn(params, opt_state, rng, target) -> (params, opt_state, loss,
    stats)``: one forward pass, the MSE loss against ``target`` (H, W, 3),
    the full backward and one optimizer step, which updates ``params`` in
    place.  ``stats["deposits_dropped"]`` is the pass's dropped-flux
    counter: nonzero means the deposit work cap clipped real flux and its
    gradient, a configuration error.  ``stats["dropped"]`` is the eye
    pass's.  The train state saves and restores with
    ``utils.checkpoint.save_tree`` / ``load_tree`` of ``{"params": params,
    "opt": optimizer_tree(opt_state, params)}`` (:func:`load_optimizer_tree`).

    With ``mesh`` every rank runs ``step_fn`` with its own ``rng`` (JAX's
    ``fold_in(fold_in(key, pass index), photon index)``) and the same
    params, optimizer state and target: the loss of :func:`_make_sharded_loss`,
    the rank gradients averaged over all ranks (JAX's number, see there)
    and one identical optimizer step on each; the loss returned is the mean
    over the pass axis and both counters are summed over the mesh.
    """
    if optimizer is None:
        optimizer = adam(1e-2)
    if mesh is None:
        run = _make_pass(scene, cfg, camera_pose, newton_fn, deposit_fn)

        def loss_fn(params, rng, target):
            img, stats = run(params, rng)
            return ((img - target.reshape(-1, 3)) ** 2).mean(), stats
    else:
        loss_fn = _make_sharded_loss(scene, cfg, mesh, camera_pose, newton_fn, deposit_fn)

    def init_fn(params):
        return optimizer([v.requires_grad_(True) for v in params.values()])

    def step_fn(params, opt_state, rng, target):
        opt_state.zero_grad(set_to_none=True)
        loss, stats = loss_fn(params, rng, target)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            from ..parallel.mesh import AXES, PASS_AXIS

            world = mesh.n_pass * mesh.n_photon
            for v in params.values():
                g = v.grad if v.grad is not None else torch.zeros_like(v)
                v.grad = mesh.all_reduce(g, AXES) / world
            loss = mesh.all_reduce(loss, PASS_AXIS) / mesh.size(PASS_AXIS)
        opt_state.step()
        return params, opt_state, loss, {
            "deposits_dropped": stats["deposits_dropped"], "dropped": stats["dropped"]}

    return init_fn, step_fn


def _make_sharded_loss(scene: Scene, cfg: RenderConfig, mesh, camera_pose, newton_fn,
                       deposit_fn):
    """``loss_fn(params, rng, target) -> (loss, stats)`` of this rank with eye
    rays and photons sharded over the mesh's photon axis (JAX's
    ``_make_sharded_loss``): the rank's slice of the camera rays, all hit
    points gathered, its ``cfg.photons_per_round / n_photon`` photons a
    round from ``rng`` and each round's deposits summed over the axis, all
    inside the autograd graph; the loss is the rank's own MSE against
    ``target`` (the same on the ranks of a pass group).

    JAX's gradient of its sharded loss (under ``shard_map(check_vma=
    False)``) is the gradient of the pass-mean loss itself: against the
    single-device emulation of the same shards it reads 1.00 times the
    emulation's own gradient, not ``n_photon`` times
    (tests/test_torch_multihost.py).  Here the collectives' backwards sum
    the cotangents of the photon axis's identical loss copies (the
    transposes ``psum`` -> ``psum``, ``all_gather`` -> ``psum_scatter``:
    ``Mesh.all_reduce_grad``, ``all_gather_grad``), so the rank gradients
    sum to ``n_photon`` times each pass group's; ``make_train_step``
    divides their sum over all ranks by the number of ranks, which gives
    JAX's number.  ``stats``: both drop counters summed over the mesh.
    """
    from ..parallel.mesh import AXES, PHOTON_AXIS
    from ..parallel.shard import gather_hitpoints
    from ..render.eye import eye_pass
    from ..render.sppm import estimate_image, photon_rounds

    org, dir = _camera_rays(scene, cfg, camera_pose)
    n_photon = mesh.size(PHOTON_AXIS)
    R = cfg.n_pixels
    if R % n_photon or cfg.photons_per_round % n_photon:
        raise ValueError(f"pixels {R} and photons_per_round {cfg.photons_per_round} must "
                         f"divide over the photon axis {n_photon}")
    ray_shard = R // n_photon
    local_capacity = cfg.hitpoint_capacity // n_photon
    local_photons = cfg.photons_per_round // n_photon
    lo = mesh.photon_index * ray_shard
    dep_fn = deposit_fn or default_deposit_vjp(scene, cfg, camera_pose, capacity=local_capacity)
    psum = lambda x: mesh.all_reduce_grad(x, PHOTON_AXIS)

    def loss_fn(params, rng, target):
        s = inject_params(scene, params)
        hp_local, eye_stats = eye_pass(s, org[lo:lo + ray_shard], dir[lo:lo + ray_shard],
                                       local_capacity, cfg.max_depth, cfg.slots, cfg.init_r2,
                                       newton_fn=newton_fn, pixel_offset=lo)
        hp = gather_hitpoints(mesh, hp_local, grad=True)
        hp, _, drops = photon_rounds(s, rng, hp, cfg.rounds, local_photons, cfg.max_depth,
                                     cfg.update_mode, dep_fn, newton_fn, psum=psum)
        img = estimate_image(hp, R, cfg.rounds * cfg.photons_per_round)
        loss = ((img - target.reshape(-1, 3)) ** 2).mean()
        return loss, {"deposits_dropped": mesh.all_reduce(drops, AXES),
                      "dropped": mesh.all_reduce(eye_stats["dropped"], AXES)}

    return loss_fn
