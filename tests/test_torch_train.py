"""The differentiable slice as a whole: the port's train step against the
JAX package's, on a small ``full`` configuration.

* The loss of ``diff/train.make_render_fn`` and its gradients with respect
  to ``diff``, ``atlas`` and ``ctrl`` against ``jax.value_and_grad`` of
  JAX's: the slot eye wavefront, the static photon walk, the lane deposit
  on both sides (JAX: ``PallasDepositLane`` in interpret mode, the port:
  the plain twins of kernels #3 and #4), the Newton kernel contract (JAX:
  interpret mode), JAX's draws replayed into the port, and both walks held
  to JAX's one segment at a time (``raytrace3_tpu_torch.testing``).  The
  holding hands on JAX's values pinned to the port's own autograd graph
  (``testing.pin``: ``ref + (x - x.detach())``), so the port's gradients
  are its own, taken along JAX's path.
* A finite-difference check on one albedo (tests/test_diff.py:117-124).
* Five train steps reduce the loss to a target rendered at the true
  albedos (tests/test_diff.py:193-213), with no dropped deposit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_util import jax_walk_steps, static_rounds_draws
from raytrace3_tpu.diff import train as jtrain
from raytrace3_tpu.ops.deposit_pallas import PallasDepositLane
from raytrace3_tpu.ops.deposit_pallas import world_bounds_from_scene as j_bounds
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.utils.config import RenderConfig as JaxConfig

from raytrace3_tpu_torch.convert import params_from_numpy
from raytrace3_tpu_torch.core.sampling import ReplayDraws
from raytrace3_tpu_torch.diff import train
from raytrace3_tpu_torch.ops.deposit_kernel import world_bounds_from_scene
from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import driver
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments
from raytrace3_tpu_torch.utils.config import RenderConfig

#: A small ``full`` train configuration (scripts/perf_trainstep.py:53-64 cut
#: to 16 x 16 and 2 x 256 photons), every gated ray through the Newton
#: solve, the camera and the light on the teapot.  The teapot's texture is
#: flat, so ``ctrl`` reaches the loss only through photons that leave the
#: teapot along its normal and meet a textured wall or floor; the light
#: next to it (as tests/test_diff.py:139 moves it) and the key make some do.
SMALL = dict(scene="full", width=16, height=16, rounds=2, photons_per_round=256,
             max_depth=13, atlas_res=16, bezier_compact_frac=0.5, hitpoint_factor=1.5)
POSE = ((30.0, 20.0, 170.0), (20.0, 5.0, 120.0))
LIGHT = [[35.0, 15.0, 125.0]]
KEY = 4
#: The port-only tests take the slice configuration's compaction, 0.12
#: (scripts/perf_trainstep.py:56): the plain Newton twin dominates their
#: time on the CPU.
FAST = dict(SMALL, bezier_compact_frac=0.12)
#: The lane deposit at tests/test_deposit.py's small bounds (tile 32,
#: chunk 128), the world bounds from the scene.
LANE = dict(tile=32, chunk=128, work_cap=2048)
SEGS = 14
#: Gradients of the held slice, per parameter, relative to its largest.  The
#: port's gradients are taken at its own values along JAX's path; where
#: those differ within their classes' tolerances (far-field hits 1e-3,
#: self-hits 1e-2 of a position; testing.py), the derivatives follow.
#: Seen: diff 3.3e-8, atlas 6.8e-4, ctrl 9.6e-4.
SLICE_GRAD_ATOL = 2e-3




def _t(x):
    return torch.as_tensor(np.array(x))


def _target(cfg, seed=3):
    return np.random.default_rng(seed).uniform(0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)


def _jax_slice(key, target):
    cfg = JaxConfig(**SMALL)
    scene = jdriver.build_scene(cfg).replace(light_pos=jnp.asarray(LIGHT, jnp.float32))
    dep = PallasDepositLane(interpret=True, differentiable=True, **LANE,
                            **j_bounds(scene, extra_points=[POSE[0]]))
    render = jtrain.make_render_fn(
        scene, cfg, POSE, make_newton_pallas(iters=10, restarts=8, interpret=True), dep,
        with_drops=True)
    params = jtrain.extract_params(scene)

    def loss(p):
        img, drops = render(p, key)
        return jnp.mean((img - jnp.asarray(target).reshape(-1, 3)) ** 2), (img, drops)

    with jax_walk_steps() as steps:
        (val, (img, drops)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        jax.block_until_ready(grads)
    return params, float(val), np.asarray(img), int(drops), grads, steps


def _port_render(cfg, deposit=True):
    scene = driver.build_scene(cfg, device="cpu").replace(light_pos=_t(LIGHT).float())
    dep = None
    if deposit:
        dep = DepositLane(differentiable=True, **LANE,
                          **world_bounds_from_scene(scene, extra_points=[POSE[0]]))
    return scene, dep


def test_slice_loss_and_gradients_match_jax():
    """The port's ``make_render_fn`` loss and its gradients w.r.t. ``diff``,
    ``atlas`` and ``ctrl`` against ``jax.value_and_grad`` of JAX's, both
    walks held to JAX's segment by segment with the graph kept."""
    cfg = RenderConfig(**SMALL)
    key = jax.random.key(KEY)
    target = _target(cfg)
    j_params, j_val, j_img, j_drops, j_grads, steps = _jax_slice(key, target)
    assert len(steps["eye"]) == SEGS and len(steps["static"]) == cfg.rounds * SEGS

    scene, dep = _port_render(cfg)
    render = train.make_render_fn(scene, cfg, POSE, make_newton(10, 8), dep, with_drops=True)
    params = params_from_numpy({k: np.asarray(v) for k, v in j_params.items()})
    for v in params.values():
        v.requires_grad_(True)
    draws = ReplayDraws(static_rounds_draws(key, cfg.rounds, 1, cfg.photons_per_round, SEGS))
    with pinned_segments(eye_steps=steps["eye"], static_steps=steps["static"]) as report:
        img, drops = render(params, draws)
    loss = ((img - _t(target).reshape(-1, 3)) ** 2).mean()
    loss.backward()
    print(report)
    assert draws.remaining == 0
    assert report.segments == {"eye": SEGS, "photon": 0, "static": cfg.rounds * SEGS}
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    assert int(drops) == j_drops == 0
    img = img.detach().numpy()
    l1 = np.abs(img - j_img).sum() / np.abs(j_img).sum()
    print(f"loss {float(loss.detach())} vs {j_val}, image relative L1 {l1:.3g}")
    assert l1 <= 1e-5
    np.testing.assert_allclose(float(loss.detach()), j_val, rtol=1e-5)
    for k in ("diff", "atlas", "ctrl"):
        g, w = params[k].grad.numpy(), np.asarray(j_grads[k])
        err = np.abs(g - w).max() / np.abs(w).max()
        print(f"{k}: max |grad| {np.abs(w).max():.3g} port {np.abs(g).max():.3g}, max |d grad| / max |grad| {err:.3g}")
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g, w, rtol=0, atol=SLICE_GRAD_ATOL * np.abs(w).max(),
                                   err_msg=k)


def test_albedo_gradient_matches_finite_difference():
    """The floor albedo's gradient against a central difference with the
    same draws (tests/test_diff.py:117-124, 15%), through the CPU default
    deposit (the bruteforce VJP)."""
    cfg = RenderConfig(**FAST)
    scene, _ = _port_render(cfg, deposit=False)
    render = train.make_render_fn(scene, cfg, POSE, make_newton(10, 8))
    target = _t(_target(cfg)).reshape(-1, 3)

    def loss(p):
        return ((render(p, torch.Generator().manual_seed(0)) - target) ** 2).mean()

    params = train.extract_params(scene)
    params["diff"].requires_grad_(True)
    loss(params).backward()
    ad = float(params["diff"].grad[3, 0])
    eps = 1e-2
    unit = torch.zeros_like(params["diff"])
    unit[3, 0] = 1.0
    with torch.no_grad():
        shifted = lambda e: dict(params, diff=params["diff"] + e * unit)
        fd = (float(loss(shifted(eps))) - float(loss(shifted(-eps)))) / (2 * eps)
    print(f"albedo d loss: autograd {ad:.5g}, central difference {fd:.5g}")
    assert abs(fd - ad) <= 0.15 * max(abs(fd), abs(ad), 1e-4), (fd, ad)
    assert abs(ad) > 1e-4


def test_train_step_reduces_loss():
    """Five Adam steps from half the true albedos toward a target rendered
    at the true ones, same draws every step, lane deposit (plain twins):
    the loss falls and no deposit or eye ray is dropped."""
    cfg = RenderConfig(**FAST)
    scene, dep = _port_render(cfg)
    newton = make_newton(10, 8)
    gen = lambda: torch.Generator().manual_seed(0)
    p_true = train.extract_params(scene)
    with torch.no_grad():
        target = train.make_render_fn(scene, cfg, POSE, newton, dep)(p_true, gen())
    target = target.reshape(cfg.height, cfg.width, 3)
    params = dict(p_true, diff=p_true["diff"] * 0.5)
    init_fn, step_fn = train.make_train_step(scene, cfg, train.adam(5e-2), POSE, newton, dep)
    opt = init_fn(params)
    losses = []
    for _ in range(5):
        params, opt, loss, stats = step_fn(params, opt, gen(), target)
        losses.append(float(loss))
        assert int(stats["deposits_dropped"]) == 0 and int(stats["dropped"]) == 0
    print("losses", losses)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
