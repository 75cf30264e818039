"""The scene registry and the default Bezier solver against the JAX
package's.

Every scene of the registry equals JAX's array for array.  The default
solver (no ``newton_fn``) is JAX's ``solve_winner``: the plain Newton on a
4 x 4 stratified start grid with patch pruning, ported as
``geometry.bezier.solve_winner``; ``build_scene`` carries the config's
``newton_restarts`` into it.  Held on 64 x 64 reference-camera rays of
``full`` and ``bezier_patch`` without compaction: hits and patch ids
exactly, t to rtol 2e-6 and u, v to atol 2e-5, the Newton tests'
tolerances (tests/test_torch_newton.py: XLA fuses multiply-adds that
PyTorch rounds one by one, and ten steps carry the difference on).

A few lanes are ill-conditioned: their nearest accepted iterate is not a
converged root (acceptance takes residual^2 < M_EPS, a residual up to 0.01)
and it moves along the surface from one iteration to the next, so two XLA
compilations of the same JAX solver already disagree there (seen: u by
1.8e-4 on one lane of ``full``).  On such a lane u and v are held to twice
JAX's own spread, measured in the test by a second compilation:
``newton_patch_solve`` jitted alone for one ray at a time, taken at the
winner's patch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu import scenes as jscenes
from raytrace3_tpu.geometry import bezier as jbez
from raytrace3_tpu.geometry.scene import intersect_scene as j_intersect_scene
from raytrace3_tpu.render import camera as jcam
from raytrace3_tpu.render.driver import build_scene as j_build_scene
from raytrace3_tpu.utils.config import RenderConfig as JConfig

from raytrace3_tpu_torch import scenes
from raytrace3_tpu_torch.convert import flatten_to_numpy
from raytrace3_tpu_torch.geometry import bezier
from raytrace3_tpu_torch.geometry.scene import intersect_scene
from raytrace3_tpu_torch.render.driver import build_scene
from raytrace3_tpu_torch.utils.config import RenderConfig

NEW_SCENES = ["cornell_diffuse", "cornell_specular", "bezier_patch",
              "cornell_two_lights", "full_flat", "teapot"]


@pytest.mark.parametrize("name", NEW_SCENES)
def test_scene_equals_jax_array_for_array(name):
    want = flatten_to_numpy(jscenes.get_scene(name, atlas_res=16))
    got = flatten_to_numpy(scenes.get_scene(name, atlas_res=16, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(scenes.REGISTRY) == sorted(jscenes.REGISTRY)


def test_build_scene_carries_the_solver_budget():
    cfg = RenderConfig(scene="bezier_patch", atlas_res=8, newton_iters=7,
                       newton_restarts=3, bezier_compact_frac=0.5)
    s = build_scene(cfg, device="cpu")
    j = j_build_scene(JConfig(scene="bezier_patch", atlas_res=8, newton_iters=7,
                              newton_restarts=3, bezier_compact_frac=0.5))
    assert (s.newton_iters, s.newton_restarts, s.bezier_compact_frac) == \
        (j.newton_iters, j.newton_restarts, j.bezier_compact_frac) == (7, 3, 0.5)


def test_restart_grid_matches_jax():
    for g in (1, 2, 4):
        np.testing.assert_array_equal(bezier.restart_grid(g).numpy(),
                                      np.asarray(jbez.restart_grid(g)))


def _t(x):
    return torch.as_tensor(np.array(x))


def _rays(n=64):
    org, d = jcam.emit_rays(jscenes.reference_camera(n, n))
    return org, d


@pytest.fixture(scope="module", params=["full", "bezier_patch"])
def default_solver_case(request):
    js = jscenes.get_scene(request.param, atlas_res=16)
    org, d = _rays()
    ctrl = js.bezier.ctrl
    want = [np.asarray(x) for x in jax.jit(jbez.solve_winner)(org, d, ctrl)]
    got = [x.numpy() for x in bezier.solve_winner(_t(org), _t(d), _t(ctrl))]
    return request.param, js, org, d, want, got


def test_solve_winner_matches_jax(default_solver_case):
    name, js, org, d, want, got = default_solver_case
    t_j, u_j, v_j, p_j, h_j = want
    t_p, u_p, v_p, p_p, h_p = got
    assert p_p.dtype == np.int32 and h_p.dtype == bool
    np.testing.assert_array_equal(h_p, h_j)
    assert h_p.sum() > (50 if name == "full" else 10)
    np.testing.assert_array_equal(p_p, p_j)
    np.testing.assert_allclose(t_p, t_j, rtol=2e-6, atol=0)
    # u and v: 2e-5, except on at most two lanes per scene whose accepted
    # iterate is not a converged root; those are held to twice JAX's own
    # spread there, the hit rays' roots from a second compilation, one ray
    # at a time, taken at the winner's patch (ROADMAP.md section 3, R1).
    one = jax.jit(jbez.newton_patch_solve)
    u_b, v_b = u_j.copy(), v_j.copy()
    for i in np.flatnonzero(h_j):
        _, u1, v1, _ = one(org[i:i + 1], d[i:i + 1], js.bezier.ctrl)
        u_b[i], v_b[i] = u1[0, p_j[i]], v1[0, p_j[i]]
    for got_x, want_x, other in ((u_p, u_j, u_b), (v_p, v_j, v_b)):
        limit = np.maximum(2e-5, 2 * np.abs(other - want_x))
        err = np.abs(got_x - want_x)
        assert (err[h_p] <= limit[h_p]).all(), (err[h_p].max(), limit[h_p].max())
        assert (limit[h_p] > 2e-5).sum() <= 2          # a few lanes at most


def test_intersect_scene_default_solver_matches_jax(default_solver_case):
    """``intersect_scene`` with no solver at compaction 1.0: the same
    objects hit; on the Bezier object t and the hit point to the Newton
    tolerances, and the rest as tests/test_torch_geometry.py holds them."""
    from torch_port_util import port_scene

    name, js, org, d, _, _ = default_solver_case
    rec_j = jax.jit(lambda o, dd: j_intersect_scene(js, o, dd))(org, d)
    rec_p = intersect_scene(port_scene(js), _t(org), _t(d))
    np.testing.assert_array_equal(rec_p.hit.numpy(), np.asarray(rec_j.hit))
    np.testing.assert_array_equal(rec_p.obj_id.numpy(), np.asarray(rec_j.obj_id))
    on_b = rec_p.obj_id.numpy() == 8
    assert on_b.sum() > (50 if name == "full" else 10)
    np.testing.assert_allclose(rec_p.t.numpy()[on_b], np.asarray(rec_j.t)[on_b],
                               rtol=2e-6, atol=0)
    np.testing.assert_allclose(rec_p.t.numpy(), np.asarray(rec_j.t), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(rec_p.n.numpy(), np.asarray(rec_j.n), atol=1e-3)
    np.testing.assert_allclose(rec_p.color.numpy(), np.asarray(rec_j.color), atol=2e-3)
