"""The inputs the benchmark makes and hands to both the program and the
plain reference: the scene's arrays and each pass's uniforms.

Everything here is the benchmark's own: the scene is read from
``benchmark/scenes/<scene>.json`` and the teapot's patch file beside it,
the atlas is made by the procedural generators below, and a pass's random
source is a ``torch.Generator`` seeded from (``--seed``, pass index) the way
the renderer's driver seeds its passes.  Nothing here imports the program.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

SCENES = Path(__file__).resolve().parent.parent / "scenes"


# -- procedural textures (the reference's assets are not in the repository) --

def _bricks(res: int) -> np.ndarray:
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    row = np.floor(y * 8)
    xs = x + 0.5 * (row % 2)
    mortar = ((np.abs((y * 8) % 1.0) < 0.08) | (np.abs((xs * 4) % 1.0) < 0.05))
    base = np.stack([0.62 + 0.08 * np.sin(37 * x + 11 * y), 0.32 * np.ones_like(x),
                     0.26 * np.ones_like(x)], -1)
    return np.where(mortar[..., None], np.array([0.75, 0.73, 0.7]), base).astype(np.float32)


def _marble(res: int) -> np.ndarray:
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    v = 0.5 + 0.5 * np.sin(14 * x + 6 * np.sin(9 * y + 3 * np.sin(5 * x)))
    base = 0.55 + 0.4 * v
    return np.stack([base, base * 0.98, base * 0.95], -1).astype(np.float32)


def _planet(res: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    val = np.zeros((res, res), np.float32)
    for octave in range(1, 5):
        f = 2.0 ** octave
        ph = rng.uniform(0, 2 * np.pi, 2)
        val += np.sin(2 * np.pi * f * y + ph[0]) * np.cos(2 * np.pi * f * x + ph[1]) / f
    val = (val - val.min()) / (np.ptp(val) + 1e-9)
    a = np.array([0.85, 0.65, 0.4], np.float32)
    b = np.array([0.3, 0.45, 0.6], np.float32)
    return (val[..., None] * a + (1 - val[..., None]) * b).astype(np.float32)


def _blue(res: int) -> np.ndarray:
    return np.broadcast_to(np.asarray((0.2, 0.35, 0.9), np.float32), (res, res, 3)).copy()


TEXTURES = {"bricks": _bricks, "marble": _marble, "planet": _planet, "blue": _blue}


def _teapot(spec: dict) -> np.ndarray:
    """Newell ``.bpt`` patches -> (B, 4, 4, 3) float32, each point p taken
    to rot @ (scale p) + translate with rot = Ry(90 deg) @ (swap y, z)
    (Scene.h:142-153)."""
    tok = (SCENES / spec["file"]).read_text().split()
    n = int(tok[0])
    swap = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, 1.0, 0]])
    th = math.pi / 2.0
    ry = np.array([[math.cos(th), 0, math.sin(th)], [0, 1.0, 0],
                   [-math.sin(th), 0, math.cos(th)]])
    rot = ry @ swap
    out = np.empty((n, 4, 4, 3), np.float64)
    k = 1
    for p in range(n):
        if (tok[k], tok[k + 1]) != ("3", "3"):
            raise ValueError(f"patch {p} of {spec['file']} is not bicubic")
        pts = np.array(tok[k + 2:k + 2 + 48], np.float64).reshape(16, 3)
        k += 2 + 48
        out[p] = ((rot @ (pts * spec["scale"]).T).T + np.asarray(spec["translate"])).reshape(4, 4, 3)
    return out.astype(np.float32)


def scene_arrays(name: str, atlas_res: int) -> dict:
    """The scene's arrays as float32 / int32 numpy: plane_p0, plane_n,
    plane_umod, plane_vmod, sph_c, sph_r, sph_tu, sph_tv, ctrl, mat_diff,
    mat_refl, mat_refr, mat_refrn, mat_refln, obj_color, obj_tex, atlas,
    light_pos, light_color, and the flag uv_quirk."""
    s = json.loads((SCENES / f"{name}.json").read_text())
    f32 = lambda x: np.asarray(x, np.float32)
    pl, sp, m = s["planes"], s["spheres"], s["materials"]
    normal = f32(pl["normal"])
    tu = f32(sp["tex_u"])
    P = normal.shape[0]
    return {
        "plane_p0": f32(pl["p0"]),
        "plane_n": (normal / np.sqrt((normal * normal).sum(-1, keepdims=True))).astype(np.float32),
        "plane_umod": np.full((P,), pl["tex_u_mod"], np.float32),
        "plane_vmod": np.full((P,), pl["tex_v_mod"], np.float32),
        "sph_c": f32(sp["center"]), "sph_r": f32(sp["radius"]),
        "sph_tu": (tu / np.float32(np.sqrt(np.float32((tu * tu).sum())))).astype(np.float32),
        "sph_tv": f32(sp["tex_v"]),
        "ctrl": _teapot(s["teapot"]),
        "mat_diff": f32(m["diff"]), "mat_refl": f32(m["refl"]), "mat_refr": f32(m["refr"]),
        "mat_refrn": f32(m["refrn"]), "mat_refln": f32(m["refln"]),
        "obj_color": f32(s["obj_color"]),
        "obj_tex": np.asarray(s["obj_tex"], np.int32),
        "atlas": np.stack([TEXTURES[t](atlas_res) for t in s["atlas"]], 0).astype(np.float32),
        "light_pos": f32(s["light_pos"]), "light_color": f32(s["light_color"]),
        "uv_quirk": bool(s["bezier_uv_quirk"]),
    }


def on_device(arrays: dict, device) -> dict:
    """The arrays as tensors on ``device`` (flags stay as they are)."""
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()}


def pass_generator(seed: int, i: int, device) -> torch.Generator:
    """Pass ``i``'s random source: a ``torch.Generator`` on ``device`` seeded
    by a pure function of (``seed``, ``i``), as the renderer's driver seeds
    pass i of a render with seed ``seed``."""
    state = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class RecordingDraws:
    """A draws source (``uniform(shape, lo, hi)``) over a generator that
    keeps each array it hands out, on its device, in ``arrays``.  It draws
    the same numbers as the program's own source over that generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.arrays: list = []

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.generator.device)
        u = u * (hi - lo) + lo
        self.arrays.append(u)
        return u

    def take(self) -> list:
        """The arrays handed out since the last ``take``."""
        out, self.arrays = self.arrays, []
        return out
