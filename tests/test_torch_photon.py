"""Photon walks: one round of the port's ``photon_trace_regen``, and one
static-walk round (``emit_photons`` + ``photon_trace``), vs the JAX
package's on ``full`` (photon-pass compaction 0.05, the Newton kernel
contract at 8 restarts on both sides), with JAX's own draws replayed into
the port (derived with JAX's split structure, tests/torch_port_util.py).

The walk is held to JAX's one segment at a time
(``raytrace3_tpu_torch.testing``): each of the port's segments runs on
JAX's lane state for that segment (origin, direction, flux, alive, depth,
refill offset, emitted), every decision must agree exactly (deposit
validity, refill, alive, depth, per-light ``emitted``) and every float to
the stated tolerances, lane by lane, and JAX's output is carried on.  The
round's deposits, final state and ``emitted`` then equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (jax_walk_steps, port_scene, regen_round_draws,
                             static_round_draws)
from raytrace3_tpu import scenes as jscenes
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import light as jlight
from raytrace3_tpu.render import photon as jphoton

from raytrace3_tpu_torch.core.sampling import ReplayDraws
from raytrace3_tpu_torch.ops import walk_kernel
from raytrace3_tpu_torch.ops.cuda_build import launch_counts, launches_since
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import light, photon
from raytrace3_tpu_torch.testing import MAX_FLIPS, pinned_segments

N = 1024
SEGS = 14
#: A second light for the round-robin refill (photon.py:186-192).
LIGHTS2 = ([[50.0, 60.0, 85.0], [30.0, 50.0, 120.0]],
           [[2500.0] * 3, [1000.0, 2000.0, 2000.0]])


def _round_matches_jax(light_pos, light_color, n_photons, seed, debias=False):
    """A round through ``photon.regen_segment``, the walk's wrapper, which
    runs its plain twin on CPU tensors (no walk kernel launches), held to
    JAX's round."""
    js = jscenes.full(atlas_res=32).replace(bezier_compact_frac=0.05)
    lp, lc = jnp.asarray(light_pos, jnp.float32), jnp.asarray(light_color, jnp.float32)
    key = jax.random.key(seed)
    with jax_walk_steps() as steps:
        dep_j, st_j, em_j = jax.jit(lambda k: jphoton.photon_trace_regen(
            js, k, lp, lc, n_photons, None, SEGS - 1, debias_roulette=debias,
            newton_fn=make_newton_pallas(interpret=True)))(key)
        jax.block_until_ready(dep_j)
    assert len(steps["photon"]) == SEGS

    ps = port_scene(js)
    draws = ReplayDraws(regen_round_draws(key, lp.shape[0] * n_photons, SEGS))
    plain = photon.regen_segment_plain
    twin_calls = []

    def counted(*a, **k):
        twin_calls.append(1)
        return plain(*a, **k)

    launches = launch_counts()
    photon.regen_segment_plain = counted
    try:
        with pinned_segments(photon_steps=steps["photon"]) as report:
            dep_p, st_p, em_p = photon.photon_trace_regen(
                ps, draws, torch.as_tensor(np.array(lp)), torch.as_tensor(np.array(lc)),
                n_photons, None, SEGS - 1, debias_roulette=debias, newton_fn=make_newton())
    finally:
        photon.regen_segment_plain = plain
    print(report)
    assert draws.remaining == 0
    assert report.segments["photon"] == SEGS
    assert len(twin_calls) == SEGS
    assert all(launches_since(launches).get(k, 0) == 0
               for k in ("walk_refill", "walk_bezier", "walk_shade"))
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    for f in ("pos", "n", "flux", "valid"):
        np.testing.assert_array_equal(getattr(dep_p, f).numpy(),
                                      np.asarray(getattr(dep_j, f)), err_msg=f)
    for i, (got, want) in enumerate(zip(st_p, st_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(i))
    np.testing.assert_array_equal(em_p.numpy(), np.asarray(em_j))
    assert float(em_p.sum()) > lp.shape[0] * n_photons
    assert int(dep_p.valid.sum()) > 4 * n_photons
    return report


def test_regen_round_matches_jax_with_replayed_draws():
    js = jscenes.full(atlas_res=32)
    _round_matches_jax(js.light_pos, js.light_color, N, seed=7)


def test_two_light_round_matches_jax_with_replayed_draws():
    """The round-robin refill of two lights, held the same way."""
    _round_matches_jax(*LIGHTS2, n_photons=512, seed=3)


def test_debiased_regen_round_matches_jax_with_replayed_draws():
    """``debias_roulette``: each continuation's flux divided by its branch
    probability, held the same way."""
    _round_matches_jax(*LIGHTS2, n_photons=256, seed=5, debias=True)


def test_regen_segment_under_autograd_takes_the_op_path(monkeypatch):
    """The kernels have no backward: with autograd on and an input that
    requires grad, the rule (``walk_kernel.kernel_tables``, here with the
    CPU standing in for the card) hands the walk no tables, so it takes the
    op path, and the gradient of the round's deposited flux reaches the
    atlas and the light colour through the segments."""
    from raytrace3_tpu_torch.ops import walk_kernel

    ps = port_scene(jscenes.full(atlas_res=16).replace(bezier_compact_frac=0.05))
    lc = ps.light_color.clone().requires_grad_(True)
    atlas = ps.atlas.clone().requires_grad_(True)
    ps = ps.replace(atlas=atlas)
    carry = (ps.light_pos.new_zeros((64, 3)),) * 3
    table = photon._material_lanes(ps).table
    with monkeypatch.context() as m:
        m.setattr(walk_kernel, "on_card", lambda x: True)
        assert walk_kernel.kernel_tables(ps, table, ps.light_pos, lc, carry) is None
        with torch.no_grad():
            assert walk_kernel.kernel_tables(ps, table, ps.light_pos, lc, carry) is not None
        assert walk_kernel.kernel_tables(ps.replace(atlas=ps.atlas.detach()), table,
                                         ps.light_pos, lc.detach(), carry) is not None
    launches = launch_counts()
    dep, _, _ = photon.photon_trace_regen(ps, torch.Generator().manual_seed(1), ps.light_pos,
                                          lc, 256, None, 4, newton_fn=make_newton())
    dep.flux[dep.valid].sum().backward()
    assert float(atlas.grad.abs().sum()) > 0 and float(lc.grad.abs().sum()) > 0
    assert all(n == 0 for n in launches_since(launches).values())


def test_two_lights_round_robin_balanced():
    """Per-light emitted counts stay within one photon (photon.py:145-155),
    on the port's own generator draws."""
    ps = port_scene(jscenes.full(atlas_res=16).replace(bezier_compact_frac=0.05))
    lp, lc = torch.tensor(LIGHTS2[0]), torch.tensor(LIGHTS2[1])
    gen = torch.Generator().manual_seed(0)
    st, total = None, torch.zeros(2)
    for _ in range(3):
        _, st, e = photon.photon_trace_regen(ps, gen, lp, lc, 256, st, 6)
        total += e
    assert total.sum() > 3 * 2 * 256
    assert abs(float(total[0] - total[1])) <= 1.0


def test_regen_state_init_matches_jax():
    for got, want in zip(photon.regen_state_init(2, 5), jphoton.regen_state_init(2, 5)):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_emit_photons_matches_jax():
    """Two lights, JAX's uniforms replayed: origins and fluxes exactly,
    directions to 1e-6 (sin and cos of another library)."""
    lp, lc = (jnp.asarray(x, jnp.float32) for x in LIGHTS2)
    key = jax.random.key(5)
    want = jlight.emit_photons(jax.random.split(key)[0], lp, lc, 300)
    draws = ReplayDraws(static_round_draws(key, 2, 300, 0))
    got = light.emit_photons(draws, torch.tensor(LIGHTS2[0]), torch.tensor(LIGHTS2[1]), 300)
    assert draws.remaining == 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6)


def test_static_round_matches_jax_with_replayed_draws():
    """The static walk (photon.py:49-119), held segment by segment; the
    round's deposits then equal JAX's exactly."""
    js = jscenes.full(atlas_res=32).replace(bezier_compact_frac=0.05)
    key = jax.random.key(11)

    def jround(k):
        k_e, k_t = jax.random.split(k)
        o, d, f = jlight.emit_photons(k_e, js.light_pos, js.light_color, N)
        return jphoton.photon_trace(js, k_t, o, d, f, SEGS - 1,
                                    newton_fn=make_newton_pallas(interpret=True))

    with jax_walk_steps() as steps:
        dep_j = jax.jit(jround)(key)
        jax.block_until_ready(dep_j)
    assert len(steps["static"]) == SEGS
    ps = port_scene(js)
    draws = ReplayDraws(static_round_draws(key, 1, N, SEGS))
    with pinned_segments(static_steps=steps["static"]) as report:
        o, d, f = light.emit_photons(draws, ps.light_pos, ps.light_color, N)
        dep_p = photon.photon_trace(ps, draws, o, d, f, SEGS - 1, newton_fn=make_newton())
    print(report)
    assert draws.remaining == 0
    assert report.segments["static"] == SEGS
    assert report.lanes["self-hit flip"] <= MAX_FLIPS
    for fld in ("pos", "n", "flux", "valid"):
        np.testing.assert_array_equal(getattr(dep_p, fld).numpy(),
                                      np.asarray(getattr(dep_j, fld)), err_msg=fld)
    assert int(dep_p.valid.sum()) > 2 * N


def test_walk_kernel_structs_match_the_source():
    """``ops/walk_kernel.py``'s ctypes structures lay out csrc/walk.cu's
    ``WalkLanes`` and the ``WalkScene`` of the header it includes
    (csrc/surface.cuh, shared with the eye's kernels) field by field (a
    pointer or an int each, in order), and its threads a block are the
    source's."""
    import re
    from pathlib import Path

    from raytrace3_tpu_torch.ops import walk_kernel
    from test_torch_eye_kernel import c_struct_fields

    csrc = Path(walk_kernel.__file__).parent.parent / "csrc"
    src = (csrc / "walk.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == str(walk_kernel.THREADS)
    assert '#include "surface.cuh"' in src
    header = (csrc / "surface.cuh").read_text()
    for name, cls, text in (("WalkScene", walk_kernel._Scene, header),
                            ("WalkLanes", walk_kernel._Lanes, src)):
        assert c_struct_fields(text, name) == list(cls._fields_), name


def test_walk_compact_constants_match_the_source():
    """The compaction kernel's threads a block and lanes a block in
    csrc/walk.cu are ``ops/walk_kernel.py``'s, and its lanes a block are
    whole blocks of the first kernel, whose gated counts it reads."""
    import re
    from pathlib import Path

    src = (Path(walk_kernel.__file__).parent.parent / "csrc" / "walk.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kThreads"), const("kCompactLanes")) == (walk_kernel.THREADS,
                                                           walk_kernel.COMPACT_LANES)
    assert walk_kernel.COMPACT_LANES % walk_kernel.THREADS == 0
    assert walk_kernel.COMPACT.symbol == "rt3_walk_compact"
    assert walk_kernel.COMPACT.name == "walk_compact"


@pytest.mark.parametrize("n", [1, 255, 256, 3 * walk_kernel.COMPACT_LANES + 77])
def test_block_counts_count_each_blocks_gated_lanes(n):
    """``walk_kernel.block_counts``, the plain twin of the gated lanes a
    block a segment's first kernel writes: one int32 count a block of
    ``THREADS`` lanes, the last block cut at ``n``."""
    gate = torch.rand((n,), generator=torch.Generator().manual_seed(n)) < 0.3
    T = walk_kernel.THREADS
    want = [int(gate[b:b + T].sum()) for b in range(0, n, T)]
    got = walk_kernel.block_counts(gate)
    assert got.dtype == torch.int32 and got.tolist() == want


def test_walk_compact_bytes_count_its_gate_slots_and_rays():
    """``walk_kernel.kernel_bytes``'s ``walk_compact``: a byte a lane of
    gate, 8 + 24 a slot written (its index and ray) and 24 a gathered
    ray."""
    assert walk_kernel.kernel_bytes(131072, 6553, 1000)["walk_compact"] == (
        131072 + 6553 * 32 + 1000 * 24) == walk_kernel.compact_bytes(131072, 6553, 1000)


def test_walk_segment_bytes_count_the_segments_lane_tensors():
    """``walk_kernel.segment_bytes``, the least time's byte count, is the
    bytes of one segment's lane tensors, each once: the carry in, the five
    draws, the carry out and the record's fields beyond the position it
    shares with the carry.  The scene's tables and the per-light scalars
    count nothing."""
    from raytrace3_tpu_torch.ops import walk_kernel

    ps = port_scene(jscenes.full(atlas_res=16).replace(bezier_compact_frac=0.05))
    N = 256
    carry = photon.regen_state_init(1, N, "cpu") + (torch.zeros((1,)),)
    g = torch.Generator().manual_seed(4)
    uni = tuple(torch.rand((N,), generator=g) for _ in range(5))
    c_out, rec = photon.regen_segment_plain(ps, photon._material_lanes(ps), uni, ps.light_pos,
                                            ps.light_color, carry, SEGS, False, make_newton())
    assert torch.equal(rec[0], c_out[0])
    lanes = lambda ts: sum(t.nbytes for t in ts if t.dim() and t.shape[0] == N)
    assert walk_kernel.segment_bytes(N) == lanes(carry) + lanes(uni) + lanes(c_out) + lanes(rec[1:])
    assert walk_kernel.segment_bytes(N) == 127 * N
