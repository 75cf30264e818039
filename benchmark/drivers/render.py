"""The render cells: the program's progressive render, pass after pass.

A render configuration (``"driver": "render"``) names the scene, the image,
the eye, walk, deposit and Newton settings; its traffic names the photons a
pass (rounds x photons a round).  Set-up builds the program's pass function
from the benchmark's inputs and runs one warm pass.  The window then runs
passes back to back as the program's ``render()`` loop does: each pass
draws from its own generator, seeded by (seed, pass index), its image is
added to the running sum, the card is synchronised and the pass's counters
are read.  After the window one pass, drawn from the seed, is replayed and
held to the reference stage by stage (``harness.hold``).
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch

from ..harness import hold as holding
from ..harness import inputs

#: The warm pass's index: beyond any window's passes.
WARM_PASS = 1 << 40


def _tuple(x):
    return tuple(_tuple(v) for v in x) if isinstance(x, list) else x


class RenderCell:
    """The program's pass at a configuration and a traffic, on ``device``."""

    def __init__(self, config: dict, traffic: dict, device):
        from raytrace3_tpu_torch.core.types import Materials
        from raytrace3_tpu_torch.geometry.bezier import BezierObject
        from raytrace3_tpu_torch.geometry.plane import Planes
        from raytrace3_tpu_torch.geometry.scene import Scene
        from raytrace3_tpu_torch.geometry.sphere import Spheres
        from raytrace3_tpu_torch.ops.deposit_kernel import DepositTile, world_bounds_from_scene
        from raytrace3_tpu_torch.ops.newton_kernel import make_newton
        from raytrace3_tpu_torch.render.driver import make_pass_fn
        from raytrace3_tpu_torch.utils.config import RenderConfig

        self.device = torch.device(device)
        c = dict(config["settings"], **traffic["pass"])
        self.cfg = c
        a = inputs.on_device(inputs.scene_arrays(c["scene"], c["atlas_res"]), self.device)
        self.sc = a
        scene = Scene(
            planes=Planes(p0=a["plane_p0"], normal=a["plane_n"], tex_u_mod=a["plane_umod"],
                          tex_v_mod=a["plane_vmod"]),
            spheres=Spheres(center=a["sph_c"], radius=a["sph_r"], tex_u=a["sph_tu"],
                            tex_v=a["sph_tv"]),
            bezier=BezierObject(ctrl=a["ctrl"]),
            materials=Materials(diff=a["mat_diff"], refl=a["mat_refl"], refr=a["mat_refr"],
                                refrn=a["mat_refrn"], refln=a["mat_refln"]),
            obj_color=a["obj_color"], obj_tex=a["obj_tex"], atlas=a["atlas"],
            light_pos=a["light_pos"], light_color=a["light_color"],
            bezier_uv_quirk=a["uv_quirk"], bezier_compact_frac=c["bezier_compact_frac"],
            newton_iters=c["newton_iters"])
        self.rcfg = RenderConfig(
            scene=c["scene"], width=c["width"], height=c["height"], passes=1,
            rounds=c["rounds"], photons_per_round=c["photons_per_round"],
            max_depth=c["max_depth"], slots=1, hitpoint_factor=c["hitpoint_factor"],
            init_r2=c["init_r2"], update_mode="sppm", jitter=c["jitter"],
            atlas_res=c["atlas_res"], bezier_compact_frac=c["bezier_compact_frac"],
            bezier_compact_frac_photon=c["bezier_compact_frac_photon"],
            newton_iters=c["newton_iters"], deposit_compact_frac=1.0,
            photon_regen=c["photon_regen"], eye_compact_schedule=_tuple(c["eye_compact_schedule"]))
        if not c["photon_regen"]:
            raise ValueError("the render check holds the regen photon walk only")
        pos = np.asarray(c["camera_pos"], np.float64)
        look = pos + np.asarray(c["camera_look_dir"], np.float64)
        self.pose = tuple(torch.as_tensor(x.astype(np.float32), device=self.device)
                          for x in (pos, look))
        dep = c["deposit"]
        bounds = world_bounds_from_scene(scene, extra_points=[c["camera_pos"]])
        if not dep["bucket2d"]:
            bounds = {k: bounds[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")}
        self.deposit_fn = DepositTile(tile=dep["tile"], chunk=dep["chunk"],
                                      bucket2d=dep["bucket2d"], **bounds)
        self.newton_fn = make_newton(c["newton_iters"], c["newton_restarts"])
        self.pass_fn = make_pass_fn(scene, self.rcfg, pos, look, deposit_fn=self.deposit_fn,
                                    newton_fn=self.newton_fn)
        self.n_lights = int(a["light_pos"].shape[0])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def one_pass(self, seed: int, i: int, accum: torch.Tensor):
        """Pass i of the render as the program's ``render()`` loop runs it:
        (image, its host counters, accum + image, host seconds)."""
        t = time.perf_counter()
        img, stats = self.pass_fn(inputs.pass_generator(seed, i, self.device))
        accum = accum + img
        self.sync()
        host = {"hitpoints": int(stats["count"]), "dropped": int(stats["dropped"]),
                "deposits_dropped": int(stats["deposits_dropped"]),
                "mean_r2": float(stats["mean_r2"]),
                "photons": float(stats["photons_emitted"]) * self.n_lights}
        return img, host, accum, time.perf_counter() - t

    def zeros(self):
        return torch.zeros((self.cfg["height"], self.cfg["width"], 3), dtype=torch.float32,
                           device=self.device)

    def hold(self, seed: int, i: int, window_img, subject: str = "program"):
        """Replay pass i under the hold; return it (``harness.hold.Hold``)
        with ``image_diff``, the largest difference from the window's
        image of that pass (None when there is none to compare)."""
        draws = inputs.RecordingDraws(inputs.pass_generator(seed, i, self.device))
        h = holding.Hold(self.sc, self.cfg, self.deposit_fn, draws, self.pose, subject)
        with h.patched():
            img, _ = self.pass_fn(draws)
        h.finish(self.cfg["rounds"])
        h.image_diff = None if window_img is None else float((img - window_img).abs().max())
        self.sync()
        return h


def numbers(holds: list) -> dict:
    """The compared numbers of one or more held passes."""
    lanes = [sum(h.lanes[k] for h in holds) for k in (0, 1)]
    slots = [sum(h.slots[k] for h in holds) for k in (0, 1)]
    diffs = [h.image_diff for h in holds if h.image_diff is not None]
    return {
        "image_replay_diff": max(diffs) if diffs else 0.0,
        "stage_faults": float(sum(len(h.faults) for h in holds)),
        "walk_mismatch_share": lanes[0] / max(lanes[1], 1),
        "deposit_mismatch_share": slots[0] / max(slots[1], 1),
        "update_rel_err": max(h.update_err for h in holds),
        "estimate_rel_err": max(h.estimate_err for h in holds),
    }


def run(cell: RenderCell, seed: int, seconds: float, trace: bool, limits: dict,
        trace_passes: int, log) -> dict:
    """Set-up is done (``cell`` built and warmed); run the window, then the
    check.  Returns the driver's record for ``run.py``."""
    from ..harness import profile

    accum = cell.zeros()
    imgs, hosts, times = [], [], []
    prof = None
    if trace:
        from torch.profiler import record_function

        prof = profile.Trace()
        with prof:
            for i in range(trace_passes):
                with record_function(profile.PASS_SPAN):
                    img, host, accum, dt = cell.one_pass(seed, i, accum)
                imgs.append(img)
                hosts.append(host)
                times.append(dt)
        window_s = sum(times)
    else:
        t0 = time.perf_counter()
        i = 0
        while True:
            img, host, accum, dt = cell.one_pass(seed, i, accum)
            imgs.append(img)
            hosts.append(host)
            times.append(dt)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    n = len(times)
    photons = sum(h["photons"] for h in hosts)
    dropped = [(i, h["dropped"], h["deposits_dropped"]) for i, h in enumerate(hosts)
               if h["dropped"] or h["deposits_dropped"]]
    failed = len(dropped)
    if dropped:
        log(f"passes that lost flux (pass, eye rays, deposits dropped): {dropped}")
    log(f"window: {n} passes in {window_s:.3f} s, {photons:.0f} photons, "
        f"{failed} passes with drops; pass seconds {[round(t, 3) for t in times]}")

    # The check: the traced passes, or one pass drawn from the seed.
    held = range(n) if trace else [random.Random(seed).randrange(n)]
    holds = []
    t_check = time.perf_counter()
    for k in held:
        holds.append(cell.hold(seed, k, imgs[k]))
    del imgs
    nums = numbers(holds)
    faults = [f for h in holds for f in h.faults]
    log(f"check of passes {list(held)}: {time.perf_counter() - t_check:.1f} s; "
        f"faults: {faults[:5]}")

    out = {
        "attempted": n, "failed": failed, "window_s": window_s,
        "memory_peak_bytes": int(peak),
        "e2e": {"photons_per_s": photons / window_s,
                "pass_p90_s": (statistics.quantiles(times, n=10, method="inclusive")[8]
                               if n > 1 else times[0])},
        "checks": {k: (v, limits[k]) for k, v in nums.items()},
        "faults": faults,
        "layer": {"passes": n, "peak_bytes": int(peak), "pass_times": times},
    }
    if trace:
        t_read = time.perf_counter()
        s = profile.summarize(prof.records())
        log(f"trace read in {time.perf_counter() - t_read:.1f} s: {s['device_events']} device "
            f"events, host CUDA calls {sorted(s['cuda_calls'].items(), key=lambda kv: -kv[1])[:8]}")
        s["work"] = {"newton": [w for h in holds for w in h.work["newton"]],
                     "deposit": [w for h in holds for w in h.work["deposit"]]}
        s["config"] = cell.cfg
        out["layer"].update(s)
        out["busy_s"], out["traced_window_s"] = s["busy_s"], s["window_s"]
        out["breakdown"] = s["breakdown"]
    return out


def build(config: dict, traffic: dict, device, seed: int, log) -> RenderCell:
    """Set-up: the cell and one warm pass (which builds the kernels on a
    checkout's first run)."""
    cell = RenderCell(config, traffic, device)
    t = time.perf_counter()
    cell.one_pass(seed, WARM_PASS, cell.zeros())
    log(f"warm pass: {time.perf_counter() - t:.3f} s")
    return cell
