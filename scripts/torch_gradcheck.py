#!/usr/bin/env python3
"""Finite-difference gradient check of the PyTorch/CUDA port, after
``scripts/gradcheck.py``.

    python3 scripts/torch_gradcheck.py [--platform cpu] [--res 16] [--photons 1024]
        [--rounds 2] [--columns plain,cuda,cuda+lane] [--out docs/GRADCHECK_PORT.json]

The configuration is JAX's: scene ``bezier_patch`` (the curved teapot body
patch 4), the light at (10, 18, 108), the camera at (8, 8, 128) looking at
(16, 6.6, 116), Bezier compaction 1.0, depth 6, atlas 16, and the scalar
loss ``sum(render(params, rng) * w)`` with a fixed positive projection ``w``
(uniform in [0.5, 1.5], from ``np.random.default_rng(7)`` here; JAX draws it
from its own key 7).  Per realisation (seeds ``--seed`` and ``--seed`` +
1000; every render of one realisation draws from one ``torch.Generator``
seeded with it, common random numbers) one autograd gradient, then central
differences of the chosen coordinates of ``ctrl``, ``atlas`` and ``diff`` at
three nested eps, scored by JAX's stability test, signal floor and
tolerances, and a group passes by JAX's rule (enough scored coordinates,
pass rate 0.8 for ctrl and 0.9 otherwise; the record passes when every
group does and the pooled rate is at least 0.9).

Columns (JAX's names in brackets):

  * ``plain`` [jnp]: the default solver ``solve_winner`` and the bruteforce
    deposit VJP;
  * ``cuda`` [pallas]: the Newton kernel (#1) at 8 restarts, its plain twin
    on the CPU;
  * ``cuda+lane`` [pallas+lane]: plus ``DepositLane(tile=256, chunk=512,
    work_cap=16384, differentiable=True)``, kernels #3 and #4.

Writes JAX's record with the device, the card's name and power limit, both
drop counters summed over every render, and ``reduced``.  Exits 1 when the
record does not pass, and 3, writing nothing, when a render dropped an eye
ray or a deposit (``utils.metrics.refuse_drops``).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raytrace3_tpu_torch.core.device import record_fields, resolve_device  # noqa: E402

REL_TOL = 0.15
#: ctrl's tolerance: its central difference sits between boundary jumps at
#: large eps and the render's float32 noise at small eps
#: (scripts/gradcheck.py:53-60).
REL_TOL_CTRL = 0.4
ABS_TOL = 1e-5
#: Scored (not excluded) coordinates a group needs, over both realisations.
MIN_CHECKED = {"ctrl": 8, "atlas": 10, "diff": 8}
#: Candidates (largest |gradient|, random nonzero) and eps per group.
PICKS = {"ctrl": (40, 16, 5e-4), "atlas": (8, 4, 2e-2), "diff": (5, 2, 1e-2)}
LIGHT = [[10.0, 18.0, 108.0]]
POSE = ((8.0, 8.0, 128.0), (16.0, 6.6, 116.0))
COLUMNS = ("plain", "cuda", "cuda+lane")
#: JAX's names of the columns.
JAX_NAMES = {"plain": "jnp", "cuda": "pallas", "cuda+lane": "pallas+lane"}
DEFAULTS = dict(res=16, photons=1024, rounds=2, seed=0)


def check_group(loss, params, name, coords, eps, grads):
    """Central differences of ``coords`` (index tuples) of ``params[name]``
    at eps / 2, eps and 2 eps against the autograd gradient ``grads[name]``
    (numpy).  A coordinate is scored when an adjacent pair of the three
    agrees within 30% (the pair's smaller eps is the estimate); otherwise it
    is excluded as ``discont``.  Scored only at a signal of 3x the float32
    noise floor 0.003 / (2 eps), else ``low_signal``."""
    g = grads[name]
    results = []
    for idx in coords:
        base = params[name]

        def fd_at(e):
            plus, minus = base.clone(), base.clone()
            plus[idx] += e
            minus[idx] -= e
            return (float(loss(dict(params, **{name: plus})))
                    - float(loss(dict(params, **{name: minus})))) / (2 * e)

        fd_h, fd, fd2 = fd_at(eps / 2), fd_at(eps), fd_at(2 * eps)
        ad = float(g[idx])
        fd_est = None
        for a, b in [(fd_h, fd), (fd, fd2)]:
            if abs(a - b) <= 0.3 * max(abs(a), abs(b)) + 1e-3:
                fd_est = a
                break
        if fd_est is None:
            results.append({"coord": [int(i) for i in idx], "fd": fd, "fd_half": fd_h,
                            "fd_2eps": fd2, "ad": ad, "discont": True})
            continue
        fd = fd_est
        floor = 3.0 * 0.003 / (2 * eps)
        if abs(ad) < floor:
            results.append({"coord": [int(i) for i in idx], "fd": fd, "ad": ad,
                            "low_signal": True})
            continue
        rel = REL_TOL_CTRL if name == "ctrl" else REL_TOL
        ok = abs(fd - ad) <= rel * max(abs(fd), abs(ad)) + ABS_TOL
        results.append({"coord": [int(i) for i in idx], "fd": fd, "ad": ad,
                        "pass": bool(ok)})
    return results


def pick_coords(g, n_top, n_rand, rng):
    """Indices of the n_top largest-|g| coords + n_rand random nonzero ones."""
    flat = np.abs(np.asarray(g)).ravel()
    order = np.argsort(-flat)
    top = [np.unravel_index(int(i), g.shape) for i in order[:n_top]]
    nz = np.flatnonzero(flat > 0)
    pool = [i for i in nz if int(i) not in set(int(np.ravel_multi_index(t, g.shape)) for t in top)]
    rand = [np.unravel_index(int(i), g.shape)
            for i in rng.choice(pool, size=min(n_rand, len(pool)),
                                replace=False)] if pool else []
    return top + rand


def wilson_lo(p: int, n: int, z: float = 1.96) -> float:
    """95% Wilson-score lower bound for p successes in n trials."""
    if n == 0:
        return 0.0
    ph = p / n
    den = 1.0 + z * z / n
    centre = ph + z * z / (2 * n)
    rad = z * ((ph * (1 - ph) + z * z / (4 * n)) / n) ** 0.5
    return max(0.0, (centre - rad) / den)


def summarize(name: str, results: list) -> dict:
    """A group's verdict by JAX's rule (scripts/gradcheck.py:300-347): a
    group with nothing scored, or all of it zero, fails; it passes with
    at least MIN_CHECKED scored coordinates and a pass rate of 0.8 (ctrl)
    or 0.9.  Marks vacuous checks in ``results`` as JAX does."""
    scored = [r for r in results if not (r.get("discont") or r.get("low_signal"))]
    n = len(scored)
    vacuous = n == 0 or all(r["ad"] == 0.0 and r["fd"] == 0.0 for r in scored)
    if vacuous:
        for r in scored:
            r["pass"] = False
            r["vacuous"] = True
        n = max(n, 1)
    p = sum(r.get("pass", False) for r in scored)
    sufficient = n >= MIN_CHECKED.get(name, 4) and not vacuous
    rate = p / n
    bar = 0.8 if name == "ctrl" else 0.9
    return {"checked": n, "passed": p, "discont_excluded": len(results) - len(scored),
            "pass_rate": round(rate, 3), "pass_rate_lo95": round(wilson_lo(p, n), 3),
            "sufficient": sufficient, "group_pass": sufficient and rate >= bar,
            "checks": results}


def verdict(groups: dict) -> dict:
    """The record's totals and ``pass`` from its groups' summaries."""
    checked = sum(g["checked"] for g in groups.values())
    passed = sum(g["passed"] for g in groups.values())
    rate = round(passed / checked, 4)
    return {"checked": checked, "passed": passed, "grad_check_pass_rate": rate,
            "pass": bool(all(g["group_pass"] for g in groups.values()) and rate >= 0.9)}


def make_loss(column: str, device, res: int, photons: int, rounds: int, newton_fn=None):
    """(loss(params, seed) -> scalar, params, drops) of a column: the
    render's projected sum with every draw from a generator seeded with
    ``seed``; ``drops`` accumulates both counters over every render.
    ``newton_fn`` replaces the cuda columns' solver (kernel #1 at 8
    restarts)."""
    from raytrace3_tpu_torch.diff.train import extract_params, make_render_fn
    from raytrace3_tpu_torch.ops.deposit_kernel import world_bounds_from_scene
    from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(scene="bezier_patch", width=res, height=res, rounds=rounds,
                       photons_per_round=photons, max_depth=6, atlas_res=16,
                       bezier_compact_frac=1.0)
    scene = build_scene(cfg, device)
    scene = scene.replace(light_pos=torch.tensor(LIGHT, dtype=torch.float32, device=device))
    if column == "plain":
        newton_fn = None
    elif newton_fn is None:
        newton_fn = make_newton(cfg.newton_iters, 8)
    deposit_fn = None
    if column == "cuda+lane":
        bounds = world_bounds_from_scene(scene, extra_points=[list(POSE[0])])
        deposit_fn = DepositLane(tile=256, chunk=512, work_cap=16384, differentiable=True,
                                 **bounds)
    render = make_render_fn(scene, cfg, camera_pose=POSE, newton_fn=newton_fn,
                            deposit_fn=deposit_fn, with_drops=True)
    w = torch.as_tensor(np.random.default_rng(7).uniform(0.5, 1.5, (cfg.n_pixels, 3))
                        .astype(np.float32), device=device)
    drops = {"dropped": 0, "deposits_dropped": 0}

    def loss(params, seed):
        img, stats = render(params, torch.Generator(device=device).manual_seed(seed))
        for k in drops:
            drops[k] += int(stats[k])
        return (img * w).sum()

    return loss, extract_params(scene), drops


def check_at_seed(loss, params, seed: int, groups=("ctrl", "atlas", "diff"), picks=PICKS):
    """One realisation: the autograd gradient at ``seed`` and the checks of
    each group's picked coordinates, ``{group: results}``."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss(leaves, seed).backward()
    grads = {k: v.grad.cpu().numpy() for k, v in leaves.items()}
    for k, v in grads.items():
        if not np.isfinite(v).all():
            raise SystemExit(f"non-finite autograd gradient in {k}")
    rng = np.random.default_rng(seed)
    fixed = lambda p: loss(p, seed)
    out = {}
    with torch.no_grad():
        for name in groups:
            n_top, n_rand, eps = picks[name]
            out[name] = check_group(fixed, params, name,
                                    pick_coords(grads[name], n_top, n_rand, rng), eps, grads)
    return out


def run(column: str, device, res: int, photons: int, rounds: int, seed: int) -> tuple:
    """({group: results over both realisations}, drops) of one column."""
    loss, params, drops = make_loss(column, device, res, photons, rounds)
    groups = check_at_seed(loss, params, seed)
    second = check_at_seed(loss, params, seed + 1000)
    return {name: groups[name] + second[name] for name in groups}, drops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--res", type=int, default=DEFAULTS["res"])
    ap.add_argument("--photons", type=int, default=DEFAULTS["photons"])
    ap.add_argument("--rounds", type=int, default=DEFAULTS["rounds"])
    ap.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    ap.add_argument("--columns", default=",".join(COLUMNS))
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "GRADCHECK_PORT.json"))
    args = ap.parse_args(argv)

    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)
    from raytrace3_tpu_torch.utils.metrics import refuse_drops

    record = {"scene": "bezier_patch (curved teapot body patch 4)", "res": args.res,
              "photons": args.photons * args.rounds,
              "rel_tol": {"ctrl": REL_TOL_CTRL, "atlas": REL_TOL, "diff": REL_TOL},
              "min_checked": MIN_CHECKED, "columns": JAX_NAMES, "groups": {}}
    t0 = time.time()
    drops = {"dropped": 0, "deposits_dropped": 0}
    for column in args.columns.split(","):
        groups, d = run(column, device, args.res, args.photons, args.rounds, args.seed)
        drops = {k: drops[k] + d[k] for k in drops}
        for name, results in groups.items():
            g = record["groups"][f"{name}[{column}]"] = summarize(name, results)
            print(f"gradcheck: {name}[{column}] {g['passed']}/{g['checked']} "
                  f"{'ok' if g['group_pass'] else 'FAIL'}", file=sys.stderr, flush=True)
    refuse_drops(drops, f"the grad check's renders ({args.columns})")
    record.update(verdict(record["groups"]))
    record["seconds"] = round(time.time() - t0, 1)
    record.update(eye_dropped_total=drops["dropped"],
                  deposits_dropped_total=drops["deposits_dropped"], **record_fields(device))
    record["reduced"] = [f"{k} {v} -> {getattr(args, k)}" for k, v in DEFAULTS.items()
                         if getattr(args, k) != v]
    if args.columns != ",".join(COLUMNS):
        record["reduced"].append(f"columns {','.join(COLUMNS)} -> {args.columns}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(json.dumps({k: v for k, v in record.items() if k != "groups"}, indent=2))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
