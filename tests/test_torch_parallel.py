"""The port's sharded pass (``raytrace3_tpu_torch.parallel``) on the CPU over
gloo, against the JAX package.

Ranks are processes (``parallel.launch.spawn``, a free localhost port, at
most ``TIMEOUT`` seconds a run).  The reference for a sharded pass is JAX's
single-device emulation of each shard (``torch_port_util.sharded_emulation``,
the emulation tests/test_parallel.py:52-116 holds equal to JAX's sharded
run): each rank replays its shard's JAX draws, and its eye and photon walks
are held to that shard's recorded walks segment by segment
(``raytrace3_tpu_torch.testing``).  The recorded steps reach the ranks as
``.npz`` files.  Held so, the deposits, their sums over the photon axis and
the estimate run on JAX's hit points and deposits: the counters
(``photons_emitted`` included) must equal JAX's and the image agree within
``L1_RTOL`` relative L1 (the deposit sums differ in order only).

This module imports no JAX at its top: the ranks import it to find their
functions.
"""

import numpy as np
import pytest
import torch

from raytrace3_tpu_torch.parallel.launch import spawn
from raytrace3_tpu_torch.parallel.mesh import (PASS_AXIS, PHOTON_AXIS, default_backend,
                                               make_mesh, mesh_shape)

#: tests/test_parallel.py:16-20.
TINY = dict(scene="cornell_diffuse", width=16, height=16, passes=2, rounds=2,
            photons_per_round=512, max_depth=4, atlas_res=16, hitpoint_factor=2.0)
BASE = (50.0, 35.0, 230.0)
LOOK = (50.0, 35.042612, 229.0)
L1_RTOL = 1e-5
#: Seconds a spawned run may take before its ranks are terminated.
TIMEOUT = 120


def rel_l1(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).sum() / np.abs(np.asarray(b)).sum())


def held_rank(run, paths, walk):
    """Run ``run(jitter, photons)`` on this rank with its reference
    (``paths[rank]``): JAX's draws replayed, the eye and photon (``walk``:
    "photon" for the regen walk, "static") segments held.  Returns
    (result, report segments, self-hit flips, draws left)."""
    import torch.distributed as dist

    from raytrace3_tpu_torch.core.sampling import ReplayDraws
    from raytrace3_tpu_torch.testing import pinned_segments

    ref = torch.load(paths[dist.get_rank()], weights_only=True)
    jitter, photons = ReplayDraws(ref["jitter"]), ReplayDraws(ref["draws"])
    with pinned_segments(eye_steps=ref["eye"], **{f"{walk}_steps": ref["photon"]}) as report:
        out = run(jitter, photons)
    return (out, dict(report.segments), report.lanes.get("self-hit flip", 0),
            jitter.remaining + photons.remaining)


def _pass_rank(n_pass, settings, paths, hp_sharded):
    from raytrace3_tpu_torch.parallel.shard import make_sharded_pass_fn
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    mesh = make_mesh(n_pass, device="cpu")
    cfg = RenderConfig(**settings)
    fn = make_sharded_pass_fn(build_scene(cfg, "cpu"), cfg, BASE, LOOK, mesh,
                              hp_sharded=hp_sharded)

    def run(jitter, photons):
        img, st = fn(jitter, photons)
        return img.numpy(), {k: float(v) for k, v in st.items()}, dict(mesh.shape)

    walk = "photon" if cfg.photon_regen else "static"
    return held_rank(run, paths, walk)


def write_pass_references(tmp_path, settings, seed, n_pass, n_photon):
    """JAX's emulation of an ``n_pass`` x ``n_photon`` sharded pass of key
    ``seed`` (each pass group's ``fold_in(key, pass index)``, its jitter
    and ``fold_in(kp, photon index)`` photon keys, shard.py:98-166), one
    reference file a rank.  Returns (groups, paths)."""
    import jax

    from torch_port_util import as_tensors, jitter_rays, sharded_emulation
    from raytrace3_tpu.render import driver as jdriver
    from raytrace3_tpu.utils.config import RenderConfig as JaxConfig


    jcfg = JaxConfig(**settings)
    key = jax.random.key(seed)
    specs, jitters = [], []
    for pi in range(n_pass):
        jitter, org, dirs, kp = jitter_rays(jcfg, jax.random.fold_in(key, pi), BASE, LOOK)
        specs.append((org, dirs, [jax.random.fold_in(kp, i) for i in range(n_photon)]))
        jitters.append(jitter)
    groups = sharded_emulation(jdriver.build_scene(jcfg), jcfg, specs, n_photon)
    paths = []
    for r in range(n_pass * n_photon):
        pi, fi = divmod(r, n_photon)
        g = groups[pi]
        paths.append(str(tmp_path / f"rank{r}.pt"))
        torch.save(as_tensors({"jitter": jitters[pi], "draws": g["draws"][fi],
                                   "eye": g["eye"][fi], "photon": g["photon"][fi]}), paths[-1])
    return groups, paths


def check_held_pass(outs, groups, cfg_rounds, segs, n_pass):
    """Every rank: its walks held (all segments, at most MAX_FLIPS flips, no
    draw left), the counters equal to JAX's summed over the mesh, and the
    image, the same on every rank, within L1_RTOL of the mean of the pass
    groups' images."""
    from raytrace3_tpu_torch.testing import MAX_FLIPS

    want = sum(g["img"] for g in groups) / n_pass
    for (img, stats, shape), segments, flips, left in outs:
        assert segments["eye"] == segs and flips <= MAX_FLIPS and left == 0, (segments, flips)
        assert sum(v for k, v in segments.items() if k != "eye") == cfg_rounds * segs
        assert stats == {"dropped": sum(g["dropped"] for g in groups), "deposits_dropped": 0,
                         "photons_emitted": sum(g["emitted"] for g in groups)}, stats
        np.testing.assert_array_equal(img, outs[0][0][0])
        assert rel_l1(img, want) <= L1_RTOL, rel_l1(img, want)
    assert float(want.max()) > 0


def test_mesh_shapes():
    """tests/test_parallel.py:27-33 on the port's mesh: the defaults, and a
    mismatch raises; a process without a group is a 1 x 1 mesh."""
    assert mesh_shape(2, 4, 8) == (2, 4)
    assert mesh_shape(None, 8, 8) == (1, 8)
    assert mesh_shape(None, None, 8) == (1, 8)
    assert mesh_shape(4, None, 8) == (4, 2)
    with pytest.raises(ValueError):
        mesh_shape(3, 3, 8)
    with pytest.raises(ValueError):
        make_mesh(3, 3, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(1, 2, world=2, device="cpu")        # no process group of 2
    m = make_mesh(device="cpu")
    assert m.shape == {PASS_AXIS: 1, PHOTON_AXIS: 1}
    x = torch.arange(6.0).reshape(3, 2)
    assert m.all_reduce(x) is x and m.all_gather(x) is x and m.shift(x) is x
    assert m.reduce_scatter(x) is x
    assert default_backend("cpu") == "gloo"       # a card's rank defaults to NCCL


def _collectives_rank():
    mesh = make_mesh(2, 2, device="cpu")
    r = mesh.rank
    x = torch.full((2,), float(r))
    y = torch.tensor([float(r)], requires_grad=True)
    gathered = mesh.all_gather_grad(y, PHOTON_AXIS)
    summed = mesh.all_reduce_grad(y * 1.0, PASS_AXIS)
    (gathered.sum() * (r + 1) + summed.sum() * 10 * (r + 1)).backward()
    return (mesh.pass_index, mesh.photon_index, mesh.all_reduce(x, PHOTON_AXIS).tolist(),
            mesh.all_reduce(x, (PASS_AXIS, PHOTON_AXIS)).tolist(),
            mesh.all_gather(x[:1], PASS_AXIS).tolist(), mesh.shift(x, PHOTON_AXIS).tolist(),
            gathered.tolist(), float(y.grad))


def test_collectives_on_a_2x2_mesh():
    """Rank r sits at (r // 2, r % 2); psum, tiled all_gather and the ring
    shift act along their axis; the autograd versions' backwards are JAX's
    transposes (psum -> psum, all_gather -> psum_scatter)."""
    out = spawn(_collectives_rank, 4, backend="gloo", timeout=TIMEOUT)
    for r, (pi, fi, ph, both, gath, shifted, g_fwd, grad) in enumerate(out):
        partner = r ^ 1                               # same pass group
        assert (pi, fi) == divmod(r, 2)
        assert ph == [float(r + partner)] * 2 and both == [6.0, 6.0]
        assert gath == [float(fi), float(fi + 2)]
        assert shifted == [float(partner)] * 2
        assert g_fwd == [float(2 * pi), float(2 * pi + 1)]
        # d/dy of sum over the photon group of (rank + 1) * y_fi, plus 10 x
        # the pass group's (rank + 1) times the pass sum
        want = (r + 1) + (partner + 1) + 10 * ((fi + 1) + (fi + 3))
        assert grad == float(want), (r, grad, want)


def _reduce_scatter_rank(rows):
    """This rank's gather gradient three ways: the all-reduce and slice the
    gather's backward took before, the backward itself (with the calls it
    made to each collective counted), and ``Mesh.reduce_scatter``."""
    import torch.distributed as dist

    mesh = make_mesh(1, device="cpu")
    n, i = mesh.size(PHOTON_AXIS), mesh.photon_index
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    g = torch.rand((n * rows, 3), generator=gen) + 0.5
    g = g * 10.0 ** torch.randint(-3, 4, (n * rows, 1), generator=gen)
    old = mesh.all_reduce(g)[i * rows:(i + 1) * rows]
    x = torch.zeros((rows, 3), requires_grad=True)
    gathered = mesh.all_gather_grad(x)
    calls = {"all_reduce": 0, "reduce_scatter_tensor": 0}
    real = {k: getattr(dist, k) for k in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    for k in calls:
        setattr(dist, k, counted(k))
    try:
        gathered.backward(g)
    finally:
        for k, f in real.items():
            setattr(dist, k, f)
    return old.numpy(), x.grad.numpy(), mesh.reduce_scatter(g).numpy(), calls


@pytest.mark.parametrize("ranks", [2, 4])
def test_gather_backward_is_a_reduce_scatter(ranks):
    """The tiled gather's backward is one reduce-scatter over the axis
    (JAX's ``psum_scatter``), no all-reduce, and each rank receives what
    the all-reduce of the whole gathered gradient, sliced to its rows, gave
    it: bit for bit on 2 ranks (a sum of two is one rounding either way),
    within 1e-6 relative on 4 (the backend may add four in another order;
    the gradients are positive, so no sum cancels)."""
    outs = spawn(_reduce_scatter_rank, ranks, (5,), backend="gloo", timeout=TIMEOUT)
    for old, new, direct, calls in outs:
        assert calls == {"all_reduce": 0, "reduce_scatter_tensor": 1}, calls
        assert new.shape == (5, 3)
        np.testing.assert_array_equal(new, direct)
        if ranks == 2:
            np.testing.assert_array_equal(new, old)
        else:
            np.testing.assert_allclose(new, old, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_pass", [1, 2], ids=["1x2", "2x2"])
def test_sharded_pass_matches_jax(tmp_path, n_pass):
    """The photon-axis pass on 2 ranks (1 x 2), and the pass-axis mean on
    a 2 x 2 mesh against the mean of the two pass groups' JAX emulations,
    each a single-device pass: TINY, the slot eye wavefront, the static
    walk, the bruteforce deposit."""
    groups, paths = write_pass_references(tmp_path, TINY, 7, n_pass, 2)
    outs = spawn(_pass_rank, 2 * n_pass, (n_pass, TINY, paths, False), backend="gloo",
                 timeout=TIMEOUT)
    assert outs[0][0][2] == {PASS_AXIS: n_pass, PHOTON_AXIS: 2}
    check_held_pass(outs, groups, TINY["rounds"], TINY["max_depth"] + 1, n_pass)


def _one_rank_pass(cfg, hp_sharded, seed):
    """(sharded 1 x 1 pass, make_pass_fn's pass) from the same generator."""
    from raytrace3_tpu_torch.parallel.shard import make_sharded_pass_fn
    from raytrace3_tpu_torch.render.driver import build_scene, make_pass_fn

    scene = build_scene(cfg, "cpu")
    sharded = make_sharded_pass_fn(scene, cfg, BASE, LOOK, make_mesh(device="cpu"),
                                   hp_sharded=hp_sharded)
    g = torch.Generator().manual_seed(seed)
    a = sharded(g, g)
    b = make_pass_fn(scene, cfg, BASE, LOOK)(torch.Generator().manual_seed(seed))
    return a, b


@pytest.mark.parametrize("hp_sharded", [False, True], ids=["gather", "ring"])
def test_one_rank_sharded_pass_is_the_pass(hp_sharded):
    """On a 1 x 1 mesh the sharded pass, given one generator for its
    jitter and its photons, is ``make_pass_fn``'s pass bit for bit."""
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**dict(TINY, photon_regen=True, eye_compact_schedule=((1, 0.5),)))
    (img, st), (want, st_w) = _one_rank_pass(cfg, hp_sharded, 3)
    assert torch.equal(img, want) and float(want.max()) > 0
    for k, v in st.items():
        assert torch.equal(v, st_w[k]), k


def test_render_sharded_sums_drop_counters_over_passes():
    """Both drop counters are summed over every super-pass (JAX's
    render_sharded keeps the last one's, ADVICE.md:3): with a hit-point
    buffer of half the pixels and a deposit compaction that drops, each of
    the 2 passes drops, and the totals are the sums of the passes' counts."""
    from raytrace3_tpu_torch.parallel.shard import (make_sharded_pass_fn, render_sharded,
                                                    shard_generators)
    from raytrace3_tpu_torch.render.driver import build_scene
    from raytrace3_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**dict(TINY, rounds=1, hitpoint_factor=0.5, deposit_compact_frac=0.05))
    scene = build_scene(cfg, "cpu")
    mesh = make_mesh(device="cpu")
    img, metrics = render_sharded(cfg, mesh, scene, camera_pose=(BASE, LOOK))
    one = make_sharded_pass_fn(scene, cfg, BASE, LOOK, mesh)
    per_pass = [one(*shard_generators(cfg.seed, i, mesh))[1] for i in range(cfg.passes)]
    for k in ("dropped", "deposits_dropped"):
        counts = [int(s[k]) for s in per_pass]
        assert min(counts) > 0 and metrics[k] == sum(counts) > counts[-1], (k, counts)
    assert metrics["meter"]["passes"] == cfg.passes and np.isfinite(img).all()
