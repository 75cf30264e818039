"""Deposit compaction: the port's ``render/photon.compact_deposits`` and
``render/sppm.compact_round`` against the JAX package's
(raytrace3_tpu/render/photon.py:252-272, sppm.py:170-179), exactly (a
gather), and a 24 x 24 two-round pass with a cutting
``deposit_compact_frac`` held to JAX's one walk segment at a time, through
the packed layout-space rounds (the tile deposit) and the hit-point-order
rounds (the bruteforce deposit), both against JAX's pass with the tile
deposit.  The dropped deposits are counted in
``deposits_dropped``: the counters must be equal, the image within 1e-5
relative L1 (tests/test_torch_slice.py).
"""

import jax
import numpy as np
import pytest

from torch_port_util import jax_walk_steps, pass_draws, port_records, random_case
from raytrace3_tpu.ops.deposit_pallas import PallasDepositTile
from raytrace3_tpu.ops.deposit_pallas import world_bounds_from_scene as j_bounds
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.render import photon as jphoton
from raytrace3_tpu.utils.config import RenderConfig as JaxConfig

from raytrace3_tpu_torch.core.sampling import ReplayDraws
from raytrace3_tpu_torch.ops.deposit_kernel import make_tile_deposit, world_bounds_from_scene
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import driver, photon, sppm
from raytrace3_tpu_torch.render.deposit import deposit_bruteforce
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments
from raytrace3_tpu_torch.utils.config import RenderConfig


@pytest.mark.parametrize("frac", [0.05, 0.5, 0.9, 1.0])
def test_compact_deposits_and_drops_match_jax(rng, frac):
    """700 deposits, 80% valid: 0.05 and 0.5 cut (the first at the
    128-record floor), 0.9 keeps every valid one in a smaller buffer, 1.0
    leaves the round as it is."""
    hp, dep = random_case(rng, C=8, D=700)
    _, pdep = port_records(hp, dep)
    D = 700
    cap = max(int(D * frac), 128)
    nv = int(np.asarray(dep.valid).sum())
    want = jphoton.compact_deposits(dep, cap)
    got, dropped = sppm.compact_round(pdep, frac)
    # JAX's count (sppm.py:175-177): max(valid - cap, 0) below a fraction of 1.
    assert int(dropped) == (max(nv - cap, 0) if frac < 1.0 else 0)
    assert (int(dropped) > 0) == (frac <= 0.5)
    for f in ("pos", "n", "flux", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.valid.shape[0] == min(cap, D)
    same = photon.compact_deposits(pdep, cap)
    for f in ("pos", "n", "flux", "valid"):
        assert np.array_equal(getattr(same, f).numpy(), getattr(got, f).numpy())


#: tests/test_torch_slice.py's bench path cut to 24 x 24, with a fraction
#: that keeps ~1/3 of each round's valid deposits (D = 14 x 1024).
SETTINGS = dict(scene="full", width=24, height=24, passes=1, rounds=2,
                photons_per_round=1024, max_depth=13, atlas_res=32,
                bezier_compact_frac=0.09, bezier_compact_frac_photon=0.05,
                newton_iters=10, hitpoint_factor=1.3, photon_regen=True,
                eye_compact_schedule=((1, 0.25), (4, 0.04), (6, 0.02)),
                deposit_compact_frac=0.1)
BASE = np.array([50.0, 35.0, 230.0])
LOOK = BASE + np.array([0.0, 0.042612, -1.0])
BOUNDS = ("x_lo", "x_hi", "y_lo", "y_hi")
L1_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_pass():
    """JAX's pass with the tile deposit (interpret mode), its walks
    recorded; the walks do not depend on the deposit, and JAX's deposits
    agree with each other to summation order."""
    key = jax.random.key(0)
    cfg_j = JaxConfig(**SETTINGS)
    scene_j = jdriver.build_scene(cfg_j)
    b = j_bounds(scene_j, extra_points=[BASE])
    dep_j = PallasDepositTile(tile=256, chunk=2048, bucket2d=False, interpret=True,
                              **{k: b[k] for k in BOUNDS})
    fn_j = jdriver.make_pass_fn(scene_j, cfg_j, BASE, LOOK, deposit_fn=dep_j,
                                newton_fn=make_newton_pallas(iters=10, restarts=8,
                                                             interpret=True))
    with jax_walk_steps() as steps:
        img_j, st_j = fn_j(key)
        jax.block_until_ready(img_j)
    return key, np.asarray(img_j), {k: float(v) for k, v in st_j.items()}, steps


@pytest.mark.parametrize("deposit", ["tile", "bruteforce"])
def test_compacted_pass_matches_jax(jax_pass, deposit):
    key, img_j, st_j, steps = jax_pass
    cfg = RenderConfig(**SETTINGS)
    scene = driver.build_scene(cfg, device="cpu")
    b = world_bounds_from_scene(scene, extra_points=[BASE])
    dep = (make_tile_deposit(**{k: b[k] for k in BOUNDS}) if deposit == "tile"
           else deposit_bruteforce)
    fn = driver.make_pass_fn(scene, cfg, BASE, LOOK, deposit_fn=dep,
                             newton_fn=make_newton(10, 8))
    draws = ReplayDraws(pass_draws(key, cfg.rounds, cfg.photons_per_round, cfg.max_depth + 1))
    with pinned_segments(steps["eye"], steps["photon"]) as report:
        img, st = fn(draws)
    img, st = img.numpy(), {k: float(v) for k, v in st.items()}
    print("jax", st_j, "\nport", st, "\n", report)
    assert draws.remaining == 0
    assert report.segments == {"eye": 14, "photon": 2 * 14}
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    for k in ("count", "dropped", "deposits_dropped", "photons_emitted"):
        assert st[k] == st_j[k], k
    assert st_j["deposits_dropped"] > 0 and st_j["count"] > 500
    np.testing.assert_allclose(st["mean_r2"], st_j["mean_r2"], rtol=1e-6)
    l1 = np.abs(img - img_j).sum() / np.abs(img_j).sum()
    print(f"relative L1 {l1:.3g}")
    assert np.isfinite(img).all() and l1 <= L1_RTOL
