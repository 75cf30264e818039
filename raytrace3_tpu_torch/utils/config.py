"""Render configuration: the reference's compile-time constants as data.

Reference: no config system exists — every knob is a #define or literal
(SURVEY.md section 5 lists them all: canvas 1024^2 Camera.h:16-17, fov 50
Camera.h:44, alpha 0.7 Raytracer.h:45, R2 2.0 Raytracer.h:13, depth 13
Raytracer.h:12, photons 100x10000 Raytracer.h:218,384, passes 100000
Raytracer.h:425, jitter 1.5e-4 Raytracer.h:434, light 5000 Scene.h:157).
Here they are one dataclass with named presets mirroring BASELINE.json's
five configs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class RenderConfig:
    scene: str = "full"
    width: int = 512
    height: int = 512
    passes: int = 10                    # SPPM outer passes (Raytracer.h:425)
    rounds: int = 16                    # photon rounds per pass
    photons_per_round: int = 65536      # photons per light per round
    max_depth: int = 13                 # Raytracer.h:12
    slots: int = 1                      # eye-wavefront slots per pixel
    hitpoint_factor: float = 2.0        # capacity = factor * pixels
    init_r2: float = 2.0                # Raytracer.h:13
    alpha: float = 0.7                  # Raytracer.h:45
    update_mode: str = "sppm"           # or "reference" (dead-code parity)
    jitter: float = 0.00015             # camera AA jitter (Raytracer.h:434)
    seed: int = 0
    atlas_res: int = 256
    bezier_compact_frac: float = 0.25       # eye-pass ray compaction
    bezier_compact_frac_photon: float = -1.0  # photon-pass (<0 = same as eye)
    newton_iters: int = 10
    newton_restarts: int = 4
    deposit: str = "bruteforce"         # or "grid"
    deposit_compact_frac: float = 1.0   # compact valid deposits before the op
    debias_roulette: bool = False       # divide flux by branch probability
    photon_regen: bool = False          # refill dead photon lanes every segment
    #: ((segment, frac), ...) — compact surviving eye rays to frac * rays at
    #: each listed segment (slots=1 only); overflow is counted in "dropped".
    eye_compact_schedule: tuple = ()
    use_pallas: bool = False            # Pallas kernels for newton/deposit
    checkpoint_every: int = 0           # passes between checkpoints (0 = off)
    out: str = "render.png"
    dtype: str = "float32"

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def hitpoint_capacity(self) -> int:
        return int(self.n_pixels * self.hitpoint_factor)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


#: BASELINE.json's five benchmark configurations.
PRESETS = {
    # 1: Cornell spheres+planes, diffuse only, 1 pass, 128x128, 100K photons
    "cornell128": RenderConfig(
        scene="cornell_diffuse", width=128, height=128, passes=1,
        rounds=4, photons_per_round=25000, atlas_res=64,
    ),
    # 2: textured + specular/refractive, 256x256
    "specular256": RenderConfig(
        scene="cornell_specular", width=256, height=256, passes=4,
        rounds=8, photons_per_round=32768, atlas_res=128,
    ),
    # 3: single Bezier patch Newton + UV texture, 256x256
    "bezier256": RenderConfig(
        scene="bezier_patch", width=256, height=256, passes=4,
        rounds=8, photons_per_round=32768, atlas_res=128,
    ),
    # 4: full teapot caustics, 10 passes, 512x512
    "teapot512": RenderConfig(
        scene="full", width=512, height=512, passes=10,
        rounds=16, photons_per_round=65536,
    ),
    # 5: multi-pass 10M-photon sharded run
    "sharded10m": RenderConfig(
        scene="full", width=512, height=512, passes=100,
        rounds=8, photons_per_round=131072,
    ),
    # The reference's own converged workload: 1024x1024 canvas
    # (Camera.h:16-17), ~50M photons total (README.md:349), jittered passes.
    # Execution path = the bench-tuned one (Pallas deposit + Newton, photon
    # regen, staged eye wavefront); hitpoint_factor 1.3 measured sufficient
    # at 512^2 (~0.99 hit points per pixel in the full scene).
    # Eye compact fractions carry ~2x headroom over the measured survival
    # (20% after segment 1, ~2.5% after 4, ~1.1% after 6): the round-2
    # schedule (.25/.04/.02), tuned at 512^2, clipped 260 live rays at this
    # 4x-pixel shape (VERDICT round 2 weak item 5) — a preset claiming the
    # reference workload must trace drop-free.
    "reference1024": RenderConfig(
        scene="full", width=1024, height=1024, passes=50,
        rounds=8, photons_per_round=131072, deposit="pallas",
        use_pallas=True, photon_regen=True, hitpoint_factor=1.3,
        bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
        eye_compact_schedule=((1, 0.3), (4, 0.055), (6, 0.028)),
        checkpoint_every=5,
    ),
}


def get_config(name: str, **overrides) -> RenderConfig:
    cfg = PRESETS.get(name)
    if cfg is None:
        raise KeyError(f"unknown preset '{name}'; have {sorted(PRESETS)}")
    return cfg.replace(**overrides) if overrides else cfg
