"""The render driver: the scene from a config, one pass, and the
multi-pass progressive render with checkpoint, preview and metrics.

Port of ``raytrace3_tpu/render/driver.py`` (reference
``SPPMRayTracer::render``, Raytracer.h:421-477).  A pass is a plain function
of its random source; there is no jit.  :func:`render` accumulates the
passes on the device.  Pass i draws from :func:`pass_generator` ``(seed,
i)``, a pure function of the two (the counterpart of JAX's
``fold_in(key(seed), i)``), so a resumed render repeats the uninterrupted
one; the two packages draw different numbers from the same seed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.sampling import TWO_PI, as_draws, uniform_sphere
from ..geometry.scene import Scene
from ..scenes import get_scene
from ..utils import checkpoint as ckpt
from ..utils.config import RenderConfig
from ..utils.image import save_png
from ..utils.metrics import PassMeter
from .camera import emit_rays, look_at
from .deposit import deposit_bruteforce
from .sppm import render_pass

#: The reference camera pose (main.cpp:24, 27).
CAMERA_POS = np.array([50.0, 35.0, 230.0])
CAMERA_LOOK = CAMERA_POS + np.array([0.0, 0.042612, -1.0])


def build_scene(cfg: RenderConfig, device=DEFAULT_DEVICE) -> Scene:
    """The config's scene on ``device``, the card unless the caller asks
    for the CPU (``core.device``), with the config's Bezier compaction and
    default-solver budget."""
    scene = get_scene(cfg.scene, atlas_res=cfg.atlas_res,
                      device=resolve_device(device))
    return scene.replace(bezier_compact_frac=cfg.bezier_compact_frac,
                         newton_iters=cfg.newton_iters,
                         newton_restarts=cfg.newton_restarts)


def make_pass_fn(scene: Scene, cfg: RenderConfig, base_pos, base_look,
                 deposit_fn=None, newton_fn=None):
    """The single-pass function ``rng -> (image (H, W, 3), stats)``.

    ``rng`` is a ``torch.Generator`` on the scene's device (or a draws
    source).  The camera jitter (Raytracer.h:429-441: pos + 0.00015 x a
    random unit vector, then lookAt) is drawn first, then the photon walk's
    uniforms.  The config picks the photon walk, the staged or the K-slot
    eye wavefront and the deposit compaction, as in the JAX package.
    """
    dev = scene.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    base_pos, base_look = f32(base_pos), f32(base_look)
    if deposit_fn is None:
        deposit_fn = deposit_bruteforce
    photon_scene = None
    if cfg.bezier_compact_frac_photon >= 0.0 and scene.has_bezier:
        photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)

    def one_pass(rng):
        draws = as_draws(rng)
        z = draws.uniform((), -1.0, 1.0)
        phi = draws.uniform((), 0.0, TWO_PI)
        pos = base_pos + cfg.jitter * uniform_sphere(z, phi)
        org, dir = emit_rays(look_at(pos, base_look, cfg.width, cfg.height))
        img, stats = render_pass(
            scene, org, dir, draws,
            hitpoint_capacity=cfg.hitpoint_capacity,
            n_rounds=cfg.rounds,
            photons_per_round=cfg.photons_per_round,
            max_depth=cfg.max_depth,
            slots=cfg.slots,
            init_r2=cfg.init_r2,
            update_mode=cfg.update_mode,
            deposit_fn=deposit_fn,
            newton_fn=newton_fn,
            deposit_compact_frac=cfg.deposit_compact_frac,
            debias_roulette=cfg.debias_roulette,
            photon_scene=photon_scene,
            photon_regen=cfg.photon_regen,
            eye_compact_schedule=cfg.eye_compact_schedule,
        )
        return img.reshape(cfg.height, cfg.width, 3), stats

    return one_pass


def pass_generator(seed: int, i: int, device) -> torch.Generator:
    """Pass ``i``'s random source: a ``torch.Generator`` on ``device``
    seeded by a pure function of (``seed``, ``i``)."""
    state = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _stat_value(v):
    v = v.item() if isinstance(v, torch.Tensor) else v
    return int(v) if isinstance(v, (int, np.integer)) else float(v)


def render(cfg: RenderConfig, scene: Scene | None = None,
           checkpoint_path: str | None = None, preview_every: int = 0,
           metrics_jsonl: str | None = None, deposit_fn=None, newton_fn=None,
           camera_pose=None, profile_dir: str | None = None,
           device=DEFAULT_DEVICE, pass_rng=None):
    """The progressive render: ``cfg.passes`` passes, their mean returned as
    (mean image (H, W, 3) numpy, {"meter": summary, **last pass's stats}).

    The image accumulates on the scene's device (``device`` when no scene
    is given: the card unless the caller asks for the CPU).  With
    ``checkpoint_path`` the render resumes from the file when it exists,
    saves every ``cfg.checkpoint_every`` passes and at the end;
    ``preview_every`` writes the running mean to ``cfg.out``;
    ``metrics_jsonl`` appends one record per pass (``PassMeter``) with the
    pass's hit points, both drop counters and mean r2; ``profile_dir``
    writes a ``torch.profiler`` trace of the second pass run.
    ``pass_rng(i)``: pass i's random source (a generator or a draws
    source); defaults to :func:`pass_generator` ``(cfg.seed, i)``.
    """
    if scene is None:
        scene = build_scene(cfg, device)
    dev = scene.device
    base_pos, base_look = camera_pose if camera_pose is not None else (CAMERA_POS, CAMERA_LOOK)
    pass_fn = make_pass_fn(scene, cfg, base_pos, base_look, deposit_fn, newton_fn)
    if pass_rng is None:
        pass_rng = lambda i: pass_generator(cfg.seed, i, dev)

    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=dev)
    start_pass = 0
    if checkpoint_path:
        state = ckpt.load(checkpoint_path)
        if state is not None:
            saved_accum, start_pass, saved_seed, _ = state
            if saved_seed != cfg.seed:
                raise ValueError(f"checkpoint {checkpoint_path} has seed {saved_seed}, "
                                 f"the render {cfg.seed}")
            accum = torch.as_tensor(np.asarray(saved_accum, np.float32), device=dev)

    L = scene.light_pos.shape[0]
    photons_per_pass = cfg.rounds * cfg.photons_per_round * L
    # Traced ray segments per pass (an upper bound: every lane, every segment).
    rays_per_pass = (cfg.max_depth + 1) * (cfg.n_pixels * cfg.slots + photons_per_pass)
    meter = PassMeter(photons_per_pass, rays_per_pass, metrics_jsonl)

    stats = {}
    for i in range(start_pass, cfg.passes):
        meter.start_pass()
        profiler = None
        if profile_dir and i == start_pass + 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.__enter__()
        img, stats = pass_fn(pass_rng(i))
        accum = accum + img
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, f"pass{i}.trace.json"))
        meter.end_pass({"hitpoints": int(stats["count"]),
                        "dropped": int(stats["dropped"]),
                        "deposits_dropped": int(stats["deposits_dropped"]),
                        "mean_r2": float(stats["mean_r2"])},
                       photons=float(stats["photons_emitted"]) * L)
        if checkpoint_path and cfg.checkpoint_every and (i + 1) % cfg.checkpoint_every == 0:
            ckpt.save(checkpoint_path, accum.cpu().numpy(), i + 1, cfg.seed)
        if preview_every and (i + 1) % preview_every == 0:
            save_png(cfg.out, accum.cpu().numpy() / (i + 1))

    accum_np = accum.cpu().numpy()
    if checkpoint_path:
        ckpt.save(checkpoint_path, accum_np, cfg.passes, cfg.seed)
    mean_img = accum_np / max(cfg.passes, 1)
    return mean_img, {"meter": meter.summary(),
                      **{k: _stat_value(v) for k, v in stats.items()}}
