"""Differentiable rendering and the inverse-rendering train step.

Port of ``raytrace3_tpu/diff/train.py``: gradients of an image loss with
respect to the material albedos, the texture atlas and the Bezier control
points, through the whole SPPM pass (the deposit's custom backward, the
Newton solve's implicit-function-theorem backward, the texture and
material lookups).  The sharded loss waits for the parallel slice.

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
    accurate).  ``capacity``: the hit-point count that sizes the deposit's
    work cap (its work grows with it); defaults to
    ``cfg.hitpoint_capacity``.  ``device``: where the pass runs; defaults
    to the scene's.
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
    ``with_drops``: also return the pass's ``deposits_dropped`` counter
    (a work-cap overflow drops real flux and its gradient)."""
    run = _make_pass(scene, cfg, camera_pose, newton_fn, deposit_fn)

    def render(params, rng):
        img, stats = run(params, rng)
        if with_drops:
            return img, stats["deposits_dropped"]
        return img

    return render


def adam(lr: float = 1e-2):
    """An optimizer factory for :func:`make_train_step`: ``torch.optim.Adam``
    with optax.adam's defaults (betas 0.9 / 0.999, eps 1e-8 outside the
    square root)."""
    return lambda tensors: torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999),
                                            eps=1e-8)


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
                    camera_pose=None, newton_fn=None, deposit_fn=None):
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
    """
    if optimizer is None:
        optimizer = adam(1e-2)
    run = _make_pass(scene, cfg, camera_pose, newton_fn, deposit_fn)

    def init_fn(params):
        return optimizer([v.requires_grad_(True) for v in params.values()])

    def step_fn(params, opt_state, rng, target):
        opt_state.zero_grad(set_to_none=True)
        img, stats = run(params, rng)
        loss = ((img - target.reshape(-1, 3)) ** 2).mean()
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach(), {
            "deposits_dropped": stats["deposits_dropped"], "dropped": stats["dropped"]}

    return init_fn, step_fn
