"""The port's ring (``parallel/ring.py``, hit points sharded over the photon
axis, each round's deposits rotating) on 2 gloo ranks, against JAX's flat
emulation of the same rounds (tests/test_ring.py:23-164: every shard's
photons deposited into all hit points before one update), with the walks
held segment by segment as tests/test_torch_parallel.py holds them: the
counters must equal JAX's, the image agree within ``L1_RTOL`` relative L1,
and a second run on the same inputs equal the first bit for bit (the ring's
schedule fixes each shard's order of additions).

In hit-point space the deposit is the bruteforce one; in layout space the
tile deposit (kernel #2's plain twin on the CPU) runs ``packed_call`` on
every hop.  The static and the regen walk are each covered; the pass
through ``make_sharded_pass_fn(hp_sharded=True)`` takes JAX's ring keys
(shard.py:126).  No JAX import at the top: the ranks import this module.
"""

import pytest
import torch

from test_torch_parallel import (BASE, LOOK, L1_RTOL, TIMEOUT, TINY, _pass_rank, check_held_pass,
                                 held_rank, rel_l1)

from raytrace3_tpu_torch.parallel.launch import spawn

#: test_ring.py's CFG and tile deposit (test_ring.py:15-18, :91-92).
CFG = dict(TINY, passes=1)
TILE = dict(tile=128, chunk=256, bucket2d=False, x_lo=-4.0, x_hi=104.0)


def _ring_rank(settings, paths, packed):
    import torch

    from raytrace3_tpu_torch.ops.deposit_kernel import DepositTile
    from raytrace3_tpu_torch.parallel.mesh import make_mesh
    from raytrace3_tpu_torch.parallel.ring import photon_rounds_ring
    from raytrace3_tpu_torch.render.camera import emit_rays, look_at
    from raytrace3_tpu_torch.render.deposit import deposit_bruteforce
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.render.eye import eye_pass
    from raytrace3_tpu_torch.render.sppm import estimate_image
    from raytrace3_tpu_torch.utils.config import RenderConfig

    mesh = make_mesh(device="cpu")
    cfg = RenderConfig(**settings)
    scene = build_scene(cfg, "cpu")
    org, dirs = emit_rays(look_at(torch.tensor(BASE), torch.tensor(LOOK), cfg.width, cfg.height))
    n = mesh.size("photon")
    R = cfg.n_pixels
    rs, lo = R // n, mesh.photon_index * (R // n)
    dep = DepositTile(**TILE) if packed else deposit_bruteforce

    def run(jitter, photons):
        hp_local, _ = eye_pass(scene, org[lo:lo + rs], dirs[lo:lo + rs],
                               cfg.hitpoint_capacity // n, cfg.max_depth, pixel_offset=lo)
        hp, emitted, drops = photon_rounds_ring(
            scene, photons, hp_local, cfg.rounds, cfg.photons_per_round // n, mesh,
            cfg.max_depth, cfg.update_mode, dep, regen=cfg.photon_regen)
        total = mesh.all_reduce(emitted)
        img = mesh.all_reduce(estimate_image(hp, R, total)).reshape(cfg.height, cfg.width, 3)
        return img.numpy(), {"dropped": 0.0, "deposits_dropped": float(mesh.all_reduce(drops)),
                             "photons_emitted": float(total)}, dict(mesh.shape)

    walk = "photon" if cfg.photon_regen else "static"
    return held_rank(run, paths, walk), held_rank(run, paths, walk)


def write_ring_references(tmp_path, settings, seed, n):
    """JAX's flat emulation of test_ring.py's ring (the fixed camera, shard
    i's photons from ``fold_in(key, i)``), one reference file a rank."""
    import jax
    import jax.numpy as jnp

    from torch_port_util import as_tensors, sharded_emulation
    from raytrace3_tpu.render import driver as jdriver
    from raytrace3_tpu.render.camera import emit_rays, look_at
    from raytrace3_tpu.utils.config import RenderConfig as JaxConfig


    jcfg = JaxConfig(**settings)
    org, dirs = emit_rays(look_at(jnp.asarray(BASE, jnp.float32), jnp.asarray(LOOK, jnp.float32),
                                  jcfg.width, jcfg.height))
    key = jax.random.key(seed)
    groups = sharded_emulation(jdriver.build_scene(jcfg), jcfg,
                               [(org, dirs, [jax.random.fold_in(key, i) for i in range(n)])], n)
    g = groups[0]
    paths = [str(tmp_path / f"rank{i}.pt") for i in range(n)]
    for i, p in enumerate(paths):
        torch.save(as_tensors({"jitter": [], "draws": g["draws"][i], "eye": g["eye"][i],
                           "photon": g["photon"][i]}), p)
    return groups, paths


@pytest.mark.parametrize("walk, packed", [("static", False), ("regen", True)],
                         ids=["static-hp-space", "regen-layout-space"])
def test_ring_rounds_match_jax(tmp_path, walk, packed):
    settings = dict(CFG, photon_regen=walk == "regen")
    groups, paths = write_ring_references(tmp_path, settings, 5, 2)
    outs = spawn(_ring_rank, 2, (settings, paths, packed), backend="gloo", timeout=TIMEOUT)
    first = [o[0] for o in outs]
    check_held_pass(first, groups, settings["rounds"], settings["max_depth"] + 1, 1)
    for a, b in outs:
        assert (a[0][0] == b[0][0]).all() and a[0][1] == b[0][1]      # bit for bit
    print(f"{walk}: relative L1 {rel_l1(first[0][0][0], groups[0]['img']):.3g}")


def test_hp_sharded_pass_matches_jax(tmp_path):
    """``make_sharded_pass_fn(hp_sharded=True)`` on 1 x 2: the jittered
    camera and JAX's ring keys ``fold_in(split(kp)[0], i)``."""
    import jax

    from torch_port_util import as_tensors, jitter_rays, sharded_emulation
    from raytrace3_tpu.render import driver as jdriver
    from raytrace3_tpu.utils.config import RenderConfig as JaxConfig


    jcfg = JaxConfig(**CFG)
    jitter, org, dirs, kp = jitter_rays(jcfg, jax.random.fold_in(jax.random.key(9), 0), BASE,
                                        LOOK)
    ring_key = jax.random.split(kp)[0]
    groups = sharded_emulation(jdriver.build_scene(jcfg), jcfg,
                               [(org, dirs, [jax.random.fold_in(ring_key, i) for i in range(2)])],
                               2)
    g = groups[0]
    paths = [str(tmp_path / f"rank{i}.pt") for i in range(2)]
    for i, p in enumerate(paths):
        torch.save(as_tensors({"jitter": jitter, "draws": g["draws"][i], "eye": g["eye"][i],
                           "photon": g["photon"][i]}), p)
    outs = spawn(_pass_rank, 2, (1, CFG, paths, True), backend="gloo", timeout=TIMEOUT)
    check_held_pass(outs, groups, CFG["rounds"], CFG["max_depth"] + 1, 1)
