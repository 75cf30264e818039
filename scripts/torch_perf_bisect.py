#!/usr/bin/env python3
"""The bench's pass with one subsystem turned off at a time, on the
PyTorch/CUDA port, after ``scripts/perf_bisect.py``.

    python3 scripts/torch_perf_bisect.py [variant ...] [--res 512] [--rounds 16]
        [--photons 131072] [--restarts 16] [--passes 2] [--platform cpu]
        [--out docs/PERF_BISECT_PORT.json]

Each variant is the teapot512 pass of ``scripts/perf_bisect.py:50-64``
minus one subsystem, so (full - variant) is that subsystem's share of the
pass.  The configuration is JAX's, kept as it is: ``full`` at 512^2, 16
rounds x 131072 photons, depth 13, atlas 128, live SPPM, the regen walk,
deposit compaction 0.9, Bezier compaction 0.09 / 0.05, hit-point factor
1.3, the bench's eye schedule, the reference camera without jitter; the
block deposit (kernel #5, ``DepositBlock`` at tile 512, wchunk 1024, work
cap 16384, 1-D banding, default bounds) and on the card the Newton kernel
(#1) at ``--restarts`` (JAX's ``RT3_BENCH_RESTARTS``, 16) while the config
says 4; on the CPU the default solver, as JAX's script off the TPU.  The
sizes default to JAX's ``RT3_BENCH_RES``, ``_ROUNDS``, ``_PHOTONS`` and
``_RESTARTS``.

Variants (JAX's meaning):

  * ``full``: the pass;
  * ``nodeposit``: the deposit returns zeros (the walk still runs);
  * ``notex``: the photon walk's scene has no textures (flat colours);
  * ``nobezier``: the photon walk's scene has no teapot;
  * ``nonewton``: the AABB gate and the compaction run, the solve is an
    always-miss solver (eye and walk);
  * ``eyeonly``: one photon round;
  * ``rbg``: JAX's full pass on the TPU's hardware generator; the card has
    no counterpart, and the record says so.

Per variant: the first pass's seconds (the kernels' first load), each of
``--passes`` timed passes' seconds (a synchronisation after each), their
mean (JAX's ``pass_seconds``) and median, the kernels' launches over all
its passes, both drop counters summed over them, and (full - variant) /
full.  The pass is host-bound, so its seconds spread by about 20% from
pass to pass; on the card one more pass runs under ``torch.profiler`` and
its device events (what the host issues) give ``event_share_of_full``,
1 - variant's events / full's, which does not spread.  The ``full`` variant's
drops go through ``utils.metrics.refuse_drops``: with a drop the script
writes nothing and exits 3.  The variants change the image: they are
timing probes, not estimators.  Writes ``docs/PERF_BISECT_PORT.json`` with
the device, the card's name and power limit and ``reduced``.  Imports no
JAX.
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

VARIANTS = ("full", "nodeposit", "notex", "nobezier", "nonewton", "eyeonly", "rbg")
#: JAX's variants with no counterpart on the card.
NO_COUNTERPART = {
    "rbg": "JAX's full pass drawn from an rbg-impl key, the TPU's hardware generator; "
           "torch.Generator on the card has one generator (Philox), which every variant uses",
}
#: The sizes' defaults: JAX's environment variables, else its defaults.
DEFAULTS = dict(res=int(os.environ.get("RT3_BENCH_RES", "512")),
                rounds=int(os.environ.get("RT3_BENCH_ROUNDS", "16")),
                photons=int(os.environ.get("RT3_BENCH_PHOTONS", "131072")),
                restarts=int(os.environ.get("RT3_BENCH_RESTARTS", "16")), passes=2)
JAX_DEFAULTS = dict(res=512, rounds=16, photons=131072, restarts=16, passes=2)
#: The reference camera (main.cpp:24, 27).
BASE = (50.0, 35.0, 230.0)
LOOK = (50.0, 35.042612, 229.0)


def config(res: int, rounds: int, photons: int):
    """``scripts/perf_bisect.py:56-64``'s ``RenderConfig``."""
    from raytrace3_tpu_torch.utils.config import RenderConfig

    return RenderConfig(
        scene="full", width=res, height=res, passes=1, rounds=rounds,
        photons_per_round=photons, max_depth=13, atlas_res=128,
        bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
        newton_restarts=4, newton_iters=10,
        update_mode="sppm", deposit="pallas", deposit_compact_frac=0.9,
        hitpoint_factor=1.3, photon_regen=True,
        eye_compact_schedule=((1, 0.25), (4, 0.04), (6, 0.02)))


def zero_deposit(hp, dep, prep=None):
    """Timing probe: the deposit op dropped, the photon walk kept."""
    c = hp.r2.shape[0]
    return (torch.zeros((c,), dtype=torch.float32, device=hp.r2.device),
            torch.zeros((c, 3), dtype=torch.float32, device=hp.r2.device))


def never_hit(org, dir, ctrl):
    """Timing probe: an always-miss solver (the AABB gate and the compaction
    still run before it)."""
    r = org.shape[0]
    z = torch.zeros((r,), dtype=torch.float32, device=org.device)
    return (torch.full((r,), 1e9, dtype=torch.float32, device=org.device), z, z,
            torch.zeros((r,), dtype=torch.int32, device=org.device),
            torch.zeros((r,), dtype=torch.bool, device=org.device))


def make_variants(res: int, rounds: int, photons: int, restarts: int, device,
                  newton_fn=None):
    """{variant: pass function ``rng -> (image, stats)``} of every variant
    with a counterpart; ``newton_fn`` (a solver of the Newton kernel at
    ``restarts``) replaces the one built here."""
    from raytrace3_tpu_torch.ops.deposit_kernel import DepositBlock
    from raytrace3_tpu_torch.ops.newton_kernel import make_newton
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.sppm import render_pass

    cfg = config(res, rounds, photons)
    scene = build_scene(cfg, device)
    if newton_fn is None and device.type == "cuda":
        newton_fn = make_newton(cfg.newton_iters, restarts)
    deposit_fn = DepositBlock(tile=512, wchunk=1024, work_cap=16384)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    org, dirs = emit_rays(look_at(f32(BASE), f32(LOOK), cfg.width, cfg.height))

    def variant(name):
        ps = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
        dep, nwt, n_rounds = deposit_fn, newton_fn, cfg.rounds
        if name == "nodeposit":
            dep = zero_deposit
        elif name == "notex":
            ps = ps.replace(obj_tex=torch.full_like(ps.obj_tex, -1))
        elif name == "nobezier":
            ps = ps.replace(bezier=None)
        elif name == "nonewton":
            nwt = never_hit
        elif name == "eyeonly":
            n_rounds = 1
        elif name != "full":
            raise ValueError(f"unknown variant {name}")

        def one_pass(rng):
            return render_pass(
                scene, org, dirs, rng, hitpoint_capacity=cfg.hitpoint_capacity,
                n_rounds=n_rounds, photons_per_round=cfg.photons_per_round,
                max_depth=cfg.max_depth, update_mode=cfg.update_mode,
                deposit_fn=dep, newton_fn=nwt,
                deposit_compact_frac=cfg.deposit_compact_frac,
                photon_scene=ps, photon_regen=True,
                eye_compact_schedule=cfg.eye_compact_schedule)
        return one_pass

    return {v: variant(v) for v in VARIANTS if v not in NO_COUNTERPART}


def time_variant(fn, passes: int, device) -> dict:
    """The first pass's seconds, each timed pass's, their mean and median,
    the kernels' launches and both drop counters over all the passes (pass
    i draws from ``pass_generator(0, i)``), and on the card the device
    events of one more pass under ``torch.profiler``."""
    from raytrace3_tpu_torch.core.device import device_events
    from raytrace3_tpu_torch.ops.cuda_build import launch_counts, launches_since
    from raytrace3_tpu_torch.render.driver import pass_generator
    from raytrace3_tpu_torch.utils.metrics import DROP_COUNTERS

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    drops = dict.fromkeys(DROP_COUNTERS, 0)
    seconds = []
    sync()
    before = launch_counts()
    for i in range(passes + 1):
        gen = pass_generator(0, i, device)
        t0 = time.perf_counter()
        img, stats = fn(gen)
        sync()
        seconds.append(time.perf_counter() - t0)
        for k in drops:
            drops[k] += int(stats[k])
    events = (device_events(lambda: fn(pass_generator(0, passes + 1, device)))
              if cuda else None)
    return {"first_pass_seconds": seconds[0], "pass_seconds_each": seconds[1:],
            "pass_seconds": float(np.mean(seconds[1:])),
            "pass_seconds_median": float(np.median(seconds[1:])),
            "launches": launches_since(before),
            "device_events_per_pass": events,
            "image_finite": bool(torch.isfinite(img).all()), **drops}


def measure(variants, res: int, rounds: int, photons: int, restarts: int, passes: int,
            device, newton_fn=None) -> dict:
    """{variant: its timings}, in the order asked, ``full`` gated on its
    drops; with ``full`` among them each other variant also gets
    ``share_of_full`` and, on the card, ``event_share_of_full``.
    ``newton_fn``: see :func:`make_variants`."""
    from raytrace3_tpu_torch.utils.metrics import refuse_drops

    fns = make_variants(res, rounds, photons, restarts, device, newton_fn)
    out = {}
    for v in variants:
        if v in NO_COUNTERPART:
            out[v] = {"no_counterpart": NO_COUNTERPART[v]}
            print(f"bisect {v}: no counterpart on the card", file=sys.stderr, flush=True)
            continue
        out[v] = time_variant(fns[v], passes, device)
        print(f"bisect {v}: first {out[v]['first_pass_seconds']:.3f} s, "
              f"{out[v]['pass_seconds']:.4f} s a pass, launches {out[v]['launches']}, "
              f"dropped {out[v]['dropped']}, deposits_dropped {out[v]['deposits_dropped']}",
              file=sys.stderr, flush=True)
        if v == "full":
            refuse_drops(out[v], f"the full pass at {res}^2 over {passes + 1} passes")
    if "full" in out:
        full, events = out["full"]["pass_seconds"], out["full"]["device_events_per_pass"]
        for v, r in out.items():
            if "pass_seconds" in r and v != "full":
                r["share_of_full"] = (full - r["pass_seconds"]) / full
                if events:
                    r["event_share_of_full"] = 1.0 - r["device_events_per_pass"] / events
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--platform", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "PERF_BISECT_PORT.json"))
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    variants = args.variants or list(VARIANTS)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; have {', '.join(VARIANTS)}")
    device = resolve_device(args.platform)
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off)

    res = measure(variants, args.res, args.rounds, args.photons, args.restarts,
                  args.passes, device)
    for v, r in res.items():
        print(json.dumps({"variant": v, **{k: r[k] for k in (
            "pass_seconds", "first_pass_seconds", "share_of_full", "no_counterpart")
            if k in r}, "backend": device.type}), flush=True)
    record = {"what": "the bench pass with one subsystem turned off at a time "
                      "(scripts/perf_bisect.py's variants)",
              "res": args.res, "rounds": args.rounds, "photons": args.photons,
              "newton": (f"kernel #1, {args.restarts} restarts" if device.type == "cuda"
                         else "solve_winner"),
              "deposit": "DepositBlock(tile=512, wchunk=1024, work_cap=16384), kernel #5",
              "timed_passes": args.passes, "variants": res, "torch": torch.__version__,
              **record_fields(device),
              "reduced": [f"{k} {v} -> {getattr(args, k)}" for k, v in JAX_DEFAULTS.items()
                          if getattr(args, k) != v]
              + ([f"variants {','.join(VARIANTS)} -> {','.join(variants)}"]
                 if tuple(variants) != VARIANTS else [])}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
