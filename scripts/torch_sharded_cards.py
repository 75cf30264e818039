#!/usr/bin/env python3
"""The sharded phases of ``chip_smoke.py`` alone on every card of the
machine, then the ``sharded10m`` render at each mesh shape the cards allow.

Run from the repository root on a machine with one or more NVIDIA GPUs:

    python3 scripts/torch_sharded_cards.py [--profile-dir DIR]
        [--out docs/SHARDED_CARDS_PORT.json]

It builds the six kernels (phase 1), then runs phases 16-18 with the world
size the cards give: phase 16's ``sharded10m`` render over NCCL, one rank a
card (1 x N); phase 17's two ranks on one card over gloo, and with two cards
or more the same runs over NCCL, one rank a card (the 1 x 2 pass, the ring,
the sharded train256 step); phase 18's dry run on 8 ranks.  Every rank
holds its kernels to their plain twins on the inputs its run gave them, as
in ``chip_smoke.py``; a phase that fails ends the run with a non-zero exit.

Then the readings: ``render_sharded`` at the ``sharded10m`` preset with the
kernels (``--pallas --deposit tile --regen``) over NCCL, one rank a card,
at every (pass x photon) shape of the N cards (1 x 4, 2 x 2 and 4 x 1 on
four) and at 1 x 1 on one card in the same call: SUPERS super-passes
each (a super-pass renders ``n_pass`` passes at once), rank 0's seconds a
super-pass, the photons a second of the whole mesh, the seconds a pass
(a super-pass over ``n_pass``) and both drop counters summed over the mesh.
With ``--profile-dir`` rank 0 of the 1 x N mesh traces its second
super-pass of a further render under ``torch.profiler``: the Chrome trace
goes to DIR (keep it out of ``chiprun_out/``: a pass's trace is large), the
record keeps its summary (device events, busy and idle share, NCCL's share,
the top kernels and the host calls with the most time of their own).
Writes the record (``device``, ``card``, ``power_limit``, ``reduced``) to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: The preset's passes (``utils/config.PRESETS["sharded10m"]``), cut to
#: SUPERS super-passes a shape.
PRESET_PASSES = 100
SUPERS = 3


def mesh_shapes(world: int) -> list[tuple[int, int]]:
    """Every (n_pass, n_photon) of ``world`` ranks, the photon axis widest
    first."""
    return [(p, world // p) for p in range(1, world + 1) if world % p == 0]


def profile_summary(prof, wall_s: float, top: int = 8) -> dict:
    """Device events, busy seconds, idle share, NCCL's kernels, the ``top``
    kernels by device time and the ``top`` host calls by their own time of
    one profiled super-pass."""
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    nccl = {n: v for n, v in by_name.items() if "nccl" in n.lower()}
    host = sorted((a for a in prof.key_averages() if a.self_cpu_time_total > 0),
                  key=lambda a: -a.self_cpu_time_total)[:top]
    return {"pass_wall_s": wall_s, "device_events": len(dev), "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "nccl_kernels": sum(v[1] for v in nccl.values()),
            "nccl_device_s": sum(v[0] for v in nccl.values()) / 1e6,
            "top_kernels": [{"name": n[:120], "device_ms": v[0] / 1e3, "count": v[1]}
                            for n, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]],
            "top_host_calls": [{"name": a.key[:120], "self_ms": a.self_cpu_time_total / 1e3,
                                "count": a.count} for a in host]}


def shape_rank(n_pass: int, supers: int, profile_dir: str | None) -> dict:
    """One rank of the ``sharded10m`` render on an ``n_pass`` x (world /
    n_pass) mesh: ``supers`` super-passes with the launch counters read
    around them; with ``profile_dir`` rank 0 then traces the second
    super-pass of a further 3."""
    import chip_smoke as cs
    from raytrace3_tpu_torch import cli
    from raytrace3_tpu_torch.parallel.mesh import make_mesh
    from raytrace3_tpu_torch.parallel.shard import render_sharded, shard_generators
    from raytrace3_tpu_torch.render.driver import build_scene

    torch.set_num_threads(4)
    mesh = make_mesh(n_pass)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        cs.SHARDED_FLAGS + ["--passes", str(supers * n_pass)]))
    scene = build_scene(cfg, mesh.device)
    newton_fn, deposit_fn = cli.make_backends(cfg, scene)
    with tempfile.TemporaryDirectory() as tmp:
        jl = os.path.join(tmp, "m.jsonl") if mesh.rank == 0 else None
        cs.zero_counters()
        torch.cuda.synchronize()
        img, metrics = render_sharded(cfg, mesh, scene, deposit_fn, newton_fn,
                                      metrics_jsonl=jl)
        launches = cs.read_counters()
        per_super = [json.loads(line)["pass_seconds"] for line in open(jl)] if jl else None
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape), "per_super_pass_s": per_super,
           "meter": metrics["meter"], "dropped": metrics["dropped"],
           "deposits_dropped": metrics["deposits_dropped"],
           "photons_emitted": metrics["photons_emitted"], "launches": launches,
           "finite": bool(torch.isfinite(torch.as_tensor(img)).all()),
           "peak_gb": torch.cuda.max_memory_allocated(mesh.device) / 1e9}
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        state = {}

        def rngs(i):
            if mesh.rank == 0 and i == 1:
                state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                state["prof"].__enter__()
                state["t0"] = time.perf_counter()
            if mesh.rank == 0 and i == 2:
                torch.cuda.synchronize()
                state["wall"] = time.perf_counter() - state["t0"]
                state["prof"].__exit__(None, None, None)
            return shard_generators(cfg.seed + 1, i, mesh)

        render_sharded(cfg.replace(passes=3 * n_pass), mesh, scene, deposit_fn, newton_fn,
                       pass_rngs=rngs)
        if mesh.rank == 0:
            prof = state["prof"]
            os.makedirs(profile_dir, exist_ok=True)
            trace = os.path.join(profile_dir, f"sharded_{n_pass}x{mesh.n_photon}_rank0.json")
            prof.export_chrome_trace(trace)
            out["profile"] = dict(profile_summary(prof, state["wall"]),
                                  trace=os.path.basename(trace))
    return out


def reading(outs, n_pass: int, world: int) -> dict:
    """A shape's reading from its ranks' results (the drop counters and the
    meter are rank 0's, which ``render_sharded`` sums over the mesh)."""
    o = outs[0]
    per_super = o["per_super_pass_s"]
    return {"mesh": o["mesh"], "cards": world, "backend": "nccl", "super_passes": len(per_super),
            "passes": len(per_super) * n_pass, "per_super_pass_s": per_super,
            "median_s_per_super_pass": statistics.median(per_super),
            "s_per_pass": statistics.median(per_super) / n_pass,
            "photons_per_s_mesh": o["meter"]["photons_per_s"],
            "mrays_per_s_mesh": o["meter"]["mrays_per_s"],
            "dropped": o["dropped"], "deposits_dropped": o["deposits_dropped"],
            "launches_summed": {k: sum(x["launches"][k] for x in outs) for k in o["launches"]},
            "peak_gb_a_rank": max(x["peak_gb"] for x in outs),
            "finite": all(x["finite"] for x in outs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--out", default=str(REPO / "docs" / "SHARDED_CARDS_PORT.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this script needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import chip_smoke as cs
    import raytrace3_tpu_torch  # noqa: F401  (TF32 off before any work)
    from raytrace3_tpu_torch.core.device import card_line, record_fields
    from raytrace3_tpu_torch.parallel.launch import spawn

    card = card_line()
    world = torch.cuda.device_count()
    print(f"{card}; cards: {world}", flush=True)
    t0 = time.perf_counter()
    cs.phase_build(card)
    paths = {"sharded": cs.phase_sharded(card), "sharded_gloo": cs.phase_sharded_gloo(card),
             "dryrun": cs.phase_dryrun(card)}
    print(f"launches by path {paths}")
    print(f"phases 1 and 16-18 done in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    shapes = {}
    for n_pass, n_photon in [(1, 1)] * (world > 1) + mesh_shapes(world):
        w = n_pass * n_photon
        prof = args.profile_dir if (n_pass == 1 and n_photon == world) else None
        t1 = time.perf_counter()
        outs = spawn(shape_rank, w, (n_pass, SUPERS, prof), backend="nccl",
                     timeout=cs.SPAWN_TIMEOUT)
        r = reading(outs, n_pass, w)
        if "profile" in outs[0]:
            r["profile"] = outs[0]["profile"]
        key = f"{n_pass}x{n_photon}"
        shapes[key] = r
        print(f"[shape {key}] {r['per_super_pass_s']} s a super-pass, {r['s_per_pass']:.4f} s "
              f"a pass, {r['photons_per_s_mesh']:.0f} photons/s over the mesh; dropped "
              f"{r['dropped']}, deposits_dropped {r['deposits_dropped']}; "
              f"{time.perf_counter() - t1:.1f} s ({card})", flush=True)
        if "profile" in r:
            p = r["profile"]
            print(f"[shape {key}] rank 0 profiled: {p['pass_wall_s']:.3f} s, "
                  f"{p['device_events']} device events, busy {p['device_busy_s']:.3f} s, idle "
                  f"share {p['device_idle_share']:.3f}, NCCL {p['nccl_kernels']} kernels "
                  f"{p['nccl_device_s']:.3f} s; host {p['top_host_calls'][:4]}", flush=True)
        if not (r["finite"] and r["dropped"] == 0 and r["deposits_dropped"] == 0):
            raise SystemExit(f"the {key} render is not finite or dropped: {r}")
    record = {"what": "sharded10m render_sharded over NCCL at each mesh shape, one rank a card",
              "preset": "sharded10m", "flags": cs.SHARDED_FLAGS, "cards": world,
              "supers": SUPERS, "shapes": shapes, "phases_launches": paths,
              "torch": torch.__version__, **record_fields("cuda"),
              "reduced": [f"passes {PRESET_PASSES} -> {SUPERS} super-passes a shape"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"done in {time.perf_counter() - t0:.1f} s ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
