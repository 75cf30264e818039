"""Multi-process runs of the port on the CPU over gloo: the sharded train
step against JAX's ``_make_sharded_loss`` on a 1 x 2 CPU mesh, the dry run
on 2 x 2 and 2 x 4 meshes, its train step on 2 x 4 against JAX's (the loss
of MULTICHIP_r05.json), and the sharded CLI under ``torchrun`` (the counterparts
of tests/test_multihost.py's 2-process ``jax.distributed`` run and of
``__graft_entry__.dryrun_multichip``).

The train step's ranks replay JAX's draws and hold their walks to JAX's
single-device emulation of the two shards (recorded; ``shard_map`` runs
cannot be), as tests/test_torch_parallel.py does; their loss and gradients
are compared with JAX's sharded loss itself.  JAX's gradient there (under
``shard_map(check_vma=False)``) is the gradient of the loss itself, not
``n_photon`` times it: it read 1.00 times the gradient of the
single-device emulation of the same shards when this test was written,
and the port's, which sums ``n_photon`` copies through its collectives'
backwards, is divided back to it (``diff.train._make_sharded_loss``).  No
JAX import at the top: the ranks import this module.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import BASE, LOOK, TIMEOUT, TINY, held_rank

from raytrace3_tpu_torch.parallel.launch import spawn

REPO = Path(__file__).resolve().parent.parent
#: Loss within this of JAX's, relative; each gradient within GRAD_ATOL of
#: its parameter's largest (tests/test_torch_train.py's bounds: the deposit
#: sums differ in order, the gradients are taken at each side's values).
LOSS_RTOL = 1e-5
GRAD_ATOL = 2e-3


def _train_rank(settings, paths, target):
    from raytrace3_tpu_torch.diff.train import extract_params, make_train_step
    from raytrace3_tpu_torch.parallel.mesh import make_mesh
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    mesh = make_mesh(device="cpu")
    cfg = RenderConfig(**settings)
    scene = build_scene(cfg, "cpu")
    init_fn, step_fn = make_train_step(scene, cfg, camera_pose=(BASE, LOOK), mesh=mesh)
    params = extract_params(scene)
    opt = init_fn(params)

    def run(jitter, photons):
        _, _, loss, st = step_fn(params, opt, photons, torch.as_tensor(target))
        return (float(loss), {k: v.grad.numpy().copy() for k, v in params.items()},
                {k: int(v) for k, v in st.items()})

    return held_rank(run, paths, "static")


def test_two_rank_sharded_train_step_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from torch_port_util import as_tensors, sharded_emulation
    from raytrace3_tpu.diff import train as jtrain
    from raytrace3_tpu.parallel.mesh import make_mesh as j_make_mesh
    from raytrace3_tpu.render import driver as jdriver
    from raytrace3_tpu.render.camera import emit_rays, look_at
    from raytrace3_tpu.utils.config import RenderConfig as JaxConfig

    from raytrace3_tpu_torch.testing import MAX_FLIPS

    jcfg = JaxConfig(**TINY)
    js = jdriver.build_scene(jcfg)
    key = jax.random.key(4)
    target = np.random.default_rng(0).uniform(0, 0.5, (16, 16, 3)).astype(np.float32)
    params = jtrain.extract_params(js)
    loss_fn = jtrain._make_sharded_loss(js, jcfg, j_make_mesh(1, 2, devices=jax.devices()[:2]),
                                        None, None, None)
    (loss, drops), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, key, jnp.asarray(target))
    assert int(drops) == 0

    org, dirs = emit_rays(look_at(jnp.asarray(BASE, jnp.float32),
                                  jnp.asarray(LOOK, jnp.float32), 16, 16))
    kpass = jax.random.fold_in(key, 0)
    g = sharded_emulation(js, jcfg, [(org, dirs, [jax.random.fold_in(kpass, i)
                                                  for i in range(2)])], 2)[0]
    paths = [str(tmp_path / f"rank{i}.pt") for i in range(2)]
    for i, p in enumerate(paths):
        torch.save(as_tensors({"jitter": [], "draws": g["draws"][i], "eye": g["eye"][i],
                           "photon": g["photon"][i]}), p)
    emu_loss = float(np.mean((g["img"] - target) ** 2))
    assert abs(float(loss) - emu_loss) <= LOSS_RTOL * emu_loss

    outs = spawn(_train_rank, 2, (TINY, paths, target), backend="gloo", timeout=TIMEOUT)
    for (p_loss, p_grads, stats), segments, flips, left in outs:
        assert flips <= MAX_FLIPS and left == 0 and segments["eye"] == 5
        assert stats == {"deposits_dropped": 0, "dropped": 0}
        assert abs(p_loss - float(loss)) <= LOSS_RTOL * float(loss), (p_loss, float(loss))
        assert float(np.abs(np.asarray(grads["diff"])).max()) > 0
        for k, want in grads.items():               # the atlas: none in view, 0
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            err = float(np.abs(p_grads[k] - want).max())
            assert err <= GRAD_ATOL * scale, (k, err / scale)
            np.testing.assert_array_equal(p_grads[k], outs[0][0][1][k])


def _dryrun_train_rank(paths):
    from raytrace3_tpu_torch.diff.train import extract_params
    from raytrace3_tpu_torch.parallel.dryrun import dryrun_mesh, train_step

    mesh = dryrun_mesh("cpu")
    cfg, scene, init_fn, step_fn = train_step(mesh)
    params = extract_params(scene)
    opt = init_fn(params)
    target = torch.zeros((cfg.height, cfg.width, 3))

    def run(jitter, photons):
        _, _, loss, st = step_fn(params, opt, photons, target)
        return (float(loss), {k: v.grad.numpy().copy() for k, v in params.items()},
                {k: int(v) for k, v in st.items()}, dict(mesh.shape))

    return held_rank(run, paths, "static")


def test_dryrun_train_step_on_a_2x4_mesh_matches_multichip_r05(tmp_path):
    """MULTICHIP_r05.json reproduced: the dry run's train step
    (``parallel/dryrun.train_step``: ``full`` at 16^2, 2 rounds x 256
    photons, depth 4, Newton at 2 restarts x 4 iterations, the lane deposit
    at tile 128, chunk 256, work cap 1024) on 8 ranks, a 2 x 4 mesh.  JAX's
    side is ``__graft_entry__.dryrun_multichip(8)``'s own loss,
    ``_make_sharded_loss`` on a 2 x 4 mesh of the conftest's virtual
    devices with its Pallas kernels in interpret mode, which must print
    the record's loss to its six digits.  The ranks replay JAX's draws for
    key(0) (pass group p: ``fold_in(key, p)``, photon rank f: ``fold_in``
    of that by f) and hold their walks to JAX's emulation of the 8 shards;
    the loss must be within LOSS_RTOL of JAX's, every gradient within
    GRAD_ATOL of its parameter's largest, the ranks' gradients equal bit
    for bit and both drop counters 0."""
    import json
    import re

    import jax
    import jax.numpy as jnp

    from torch_port_util import as_tensors, sharded_emulation
    from raytrace3_tpu.diff import train as jtrain
    from raytrace3_tpu.ops.deposit_pallas import PallasDepositLane, world_bounds_from_scene
    from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
    from raytrace3_tpu.parallel.mesh import make_mesh as j_make_mesh
    from raytrace3_tpu.render import driver as jdriver
    from raytrace3_tpu.render.camera import emit_rays, look_at
    from raytrace3_tpu.utils.config import RenderConfig as JaxConfig

    from raytrace3_tpu_torch.testing import MAX_FLIPS

    tail = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
    assert "mesh={'pass': 2, 'photon': 4}" in tail
    record = re.search(r"loss=([0-9.]+)", tail).group(1)
    n_pass, n_photon = 2, 4
    jcfg = JaxConfig(scene="full", width=16, height=16, passes=1, rounds=2,
                     photons_per_round=64 * n_photon, max_depth=4, atlas_res=8,
                     bezier_compact_frac=1.0, newton_restarts=2, newton_iters=4,
                     hitpoint_factor=2.0)
    js = jdriver.build_scene(jcfg)
    bounds = world_bounds_from_scene(js, extra_points=[np.asarray(BASE)])
    b1 = {k: bounds[k] for k in ("x_lo", "x_hi", "y_lo", "y_hi")}
    newton = make_newton_pallas(iters=jcfg.newton_iters, restarts=2, interpret=True)
    lane = PallasDepositLane(tile=128, chunk=256, differentiable=True, interpret=True,
                             bucket2d=False, work_cap=1024, **b1)
    mesh = j_make_mesh(n_pass, n_photon, devices=jax.devices()[:n_pass * n_photon])
    loss_fn = jtrain._make_sharded_loss(js, jcfg, mesh, None, newton, lane)
    key = jax.random.key(0)
    target = np.zeros((16, 16, 3), np.float32)
    args = (jtrain.extract_params(js), key, jnp.asarray(target))
    lowered = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(*args)

    org, dirs = emit_rays(look_at(jnp.asarray(BASE, jnp.float32),
                                  jnp.asarray(LOOK, jnp.float32), 16, 16))
    # XLA compiles and runs JAX's loss, traced above, while the emulation
    # traces its walks (its recording patches lax.scan, so nothing else may
    # trace meanwhile).
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(lambda: lowered.compile()(*args))
        groups = sharded_emulation(
            js, jcfg, [(org, dirs, [jax.random.fold_in(jax.random.fold_in(key, p), f)
                                    for f in range(n_photon)]) for p in range(n_pass)],
            n_photon, newton_fn=newton)
        (loss, drops), grads = jax_run.result()
    loss = float(loss)
    assert f"{loss:.6f}" == record and int(drops) == 0, (loss, record, int(drops))
    emu_loss = float(np.mean([np.mean((g["img"] - target) ** 2) for g in groups]))
    assert abs(loss - emu_loss) <= LOSS_RTOL * emu_loss, (loss, emu_loss)
    assert all(g["dropped"] == 0 for g in groups)
    paths = []
    for r in range(n_pass * n_photon):
        g, f = groups[r // n_photon], r % n_photon
        paths.append(str(tmp_path / f"rank{r}.pt"))
        torch.save(as_tensors({"jitter": [], "draws": g["draws"][f], "eye": g["eye"][f],
                               "photon": g["photon"][f]}), paths[-1])

    outs = spawn(_dryrun_train_rank, n_pass * n_photon, (paths,), backend="gloo",
                 timeout=TIMEOUT)
    print(f"loss: JAX {loss!r}, emulation {emu_loss!r}, port {outs[0][0][0]!r}; gradient "
          f"errors", {k: float(np.abs(outs[0][0][1][k] - np.asarray(v)).max())
                      for k, v in grads.items()})
    for (p_loss, p_grads, stats, shape), segments, flips, left in outs:
        assert shape == {"pass": n_pass, "photon": n_photon}
        assert flips <= MAX_FLIPS and left == 0 and segments["eye"] == jcfg.max_depth + 1
        assert stats == {"deposits_dropped": 0, "dropped": 0}
        assert abs(p_loss - loss) <= LOSS_RTOL * loss, (p_loss, loss)
        for k, want in grads.items():               # 0 where nothing is in view
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            err = float(np.abs(p_grads[k] - want).max())
            assert err <= GRAD_ATOL * scale, (k, err, scale)
            np.testing.assert_array_equal(p_grads[k], outs[0][0][1][k])
        assert float(np.abs(np.asarray(grads["diff"])).max()) > 0


def test_sharded_loss_sizes_the_lane_cap_by_the_rank_share(monkeypatch):
    """The sharded loss sizes the lane deposit's work cap by the per-rank
    share of the hit points (C / n_photon, ADVICE.md:4): at 1024^2 with
    factor 1 (C = 2^20) on 2 photon ranks the share 2^19 takes the small
    cap, where the whole buffer would take the large one."""
    from raytrace3_tpu_torch.diff import train
    from raytrace3_tpu_torch.ops.lane_kernel import DepositLane
    from raytrace3_tpu_torch.parallel.mesh import Mesh
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(scene="cornell_diffuse", width=1024, height=1024, hitpoint_factor=1.0,
                       atlas_res=8)
    scene = build_scene(cfg.replace(width=8, height=8), "cpu")
    seen = []
    real = train.default_deposit_vjp

    def spy(scene_, cfg_, camera_pose=None, capacity=None, device=None):
        dep = real(scene_, cfg_, camera_pose, capacity, device="cuda")
        seen.append((capacity, dep))
        return dep

    monkeypatch.setattr(train, "default_deposit_vjp", spy)
    monkeypatch.setattr(train, "_camera_rays", lambda *a: (None, None))
    mesh = Mesh(n_pass=1, n_photon=2, rank=0, device=torch.device("cpu"))
    train._make_sharded_loss(scene, cfg, mesh, None, None, None)
    (capacity, dep), = seen
    assert capacity == cfg.hitpoint_capacity // 2 == 1 << 19
    assert isinstance(dep, DepositLane) and dep.work_cap == 16384
    assert real(scene, cfg, capacity=cfg.hitpoint_capacity, device="cuda").work_cap == 49152


def test_dryrun_checks_both_drop_counters():
    """The dry run's check refuses an eye drop as it refuses a deposit
    drop (JAX's checks the deposit counter only, ADVICE.md:5)."""
    from raytrace3_tpu_torch.parallel.dryrun import check_drops

    check_drops({"dropped": 0, "deposits_dropped": 0}, "ok")
    for k in ("dropped", "deposits_dropped"):
        with pytest.raises(RuntimeError, match=k):
            check_drops({"dropped": 0, "deposits_dropped": 0, k: 3}, "pass")


@pytest.mark.parametrize("ranks", [4, 8], ids=["2x2", "2x4"])
def test_dryrun_on_ranks(ranks):
    """``parallel/dryrun.py`` on a 2 x 2 and a 2 x 4 mesh of CPU ranks: the
    tuned forward pass (regen, staged eye, layout-space tile deposit,
    Newton) and the train step through the lane deposit, each with both
    drop counters 0, finite gradients; every rank reports the same."""
    from raytrace3_tpu_torch.parallel.dryrun import dryrun_multichip

    outs = dryrun_multichip(ranks, device="cpu", timeout=TIMEOUT)  # gloo, as on the CPU
    assert len(outs) == ranks and outs[0]["mesh"] == {"pass": 2, "photon": ranks // 2}
    assert outs[0]["forward"]["dropped"] == 0 and outs[0]["forward"]["deposits_dropped"] == 0
    assert outs[0]["train"]["dropped"] == 0 and outs[0]["train"]["deposits_dropped"] == 0
    assert all(o == outs[0] for o in outs)
    assert np.isfinite(outs[0]["loss"]) and outs[0]["grad_max"]["diff"] > 0


def test_sharded_cli_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m raytrace3_tpu_torch.cli --sharded``
    on the CPU: one PNG, one metrics line a pass, one report, all from
    rank 0."""
    out, metrics = tmp_path / "o.png", tmp_path / "m.jsonl"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(_port()), "-m", "raytrace3_tpu_torch.cli", "--platform", "cpu",
           "--scene", "cornell_diffuse", "--res", "16", "--passes", "2", "--rounds", "1",
           "--photons", "256", "--depth", "3", "--sharded", "--hp-sharded",
           "--out", str(out), "--metrics-jsonl", str(metrics), "--preview-every", "0"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("wrote ") == 1 and "sharded over 1 x 2 ranks" in proc.stdout
    assert out.exists() and sorted(p.name for p in tmp_path.iterdir()) == ["m.jsonl", "o.png"]
    assert len(metrics.read_text().splitlines()) == 2


def _port():
    from raytrace3_tpu_torch.parallel.launch import free_port

    return free_port()
