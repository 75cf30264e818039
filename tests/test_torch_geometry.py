"""Port geometry vs the JAX package on the same inputs: planes, spheres,
AABB, textures and atlas sampling, the Bezier basis, the scene arrays, the
camera, and ``intersect_bezier`` / ``intersect_scene`` on the ``full``
scene with the Newton kernel contract on both sides (JAX: the Pallas kernel
in interpret mode; port: its plain twin), 8 restarts as on the bench.

Tolerances: elementwise fp32 math 1e-5 relative (a few ulp; sums of three
terms may associate differently); Newton roots t within 1e-3 absolute at
t ~ 200 (the existing Pallas-vs-jnp tolerance, tests/test_pallas.py:66);
positions 2e-3, normals 1e-3, colours 2e-3 (texture lookups amplify root
differences by the texel density); hit flags and object ids exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import port_scene
from raytrace3_tpu.geometry import aabb as jaabb
from raytrace3_tpu.geometry import bezier as jbez
from raytrace3_tpu.geometry import plane as jplane
from raytrace3_tpu.geometry import sphere as jsphere
from raytrace3_tpu.geometry.scene import intersect_scene as j_intersect_scene
from raytrace3_tpu.ops.newton_pallas import make_newton_pallas
from raytrace3_tpu.render import camera as jcam
from raytrace3_tpu.render.driver import build_scene as j_build_scene
from raytrace3_tpu import scenes as jscenes
from raytrace3_tpu.textures import texture as jtx
from raytrace3_tpu.utils.config import RenderConfig

from raytrace3_tpu_torch import scenes
from raytrace3_tpu_torch.convert import flatten_to_numpy
from raytrace3_tpu_torch.geometry import aabb, bezier, plane, sphere
from raytrace3_tpu_torch.geometry.scene import intersect_scene
from raytrace3_tpu_torch.ops.newton_kernel import make_newton
from raytrace3_tpu_torch.render import camera
from raytrace3_tpu_torch.render.driver import build_scene
from raytrace3_tpu_torch.textures import texture as tx


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _rays(rng, n=400):
    org = rng.uniform([5, 5, 5], [95, 75, 200], size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]]    # zero components
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32)


@pytest.fixture(scope="module")
def jax_full():
    return jscenes.full(atlas_res=32)


def test_planes_match(rng, jax_full):
    org, d = _rays(rng)
    jp = jax_full.planes
    pp = scenes.full(atlas_res=32, device="cpu").planes
    for f in ("p0", "normal", "tex_u_mod", "tex_v_mod"):
        np.testing.assert_array_equal(getattr(pp, f).numpy(), np.asarray(getattr(jp, f)))
    tj, hj = jplane.intersect_planes(jnp.asarray(org), jnp.asarray(d), jp)
    tp, hp = plane.intersect_planes(_t(org), _t(d), pp)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    _close(tp, tj)
    idx = rng.integers(0, 5, size=len(org)).astype(np.int32)
    pos = org + 10 * d
    for w, g in zip(jplane.plane_uv(jnp.asarray(pos), jp, jnp.asarray(idx)),
                    plane.plane_uv(_t(pos), pp, _t(idx))):
        _close(g, w)


def test_spheres_match(rng, jax_full):
    org, d = _rays(rng)
    js = jax_full.spheres
    ps = scenes.full(atlas_res=32, device="cpu").spheres
    for w, g in zip(jsphere.intersect_spheres(jnp.asarray(org), jnp.asarray(d), js),
                    sphere.intersect_spheres(_t(org), _t(d), ps)):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, atol=1e-4)
    idx = rng.integers(0, 3, size=len(org)).astype(np.int32)
    c = np.asarray(js.center)[idx]
    pos = (c + np.asarray(js.radius)[idx, None] * d).astype(np.float32)
    for w, g in zip(jsphere.sphere_uv(jnp.asarray(pos), js, jnp.asarray(idx)),
                    sphere.sphere_uv(_t(pos), ps, _t(idx))):
        _close(g, w, atol=1e-5)


def test_slab_test_matches(rng):
    org, d = _rays(rng)
    lo = np.array([20, 0, 100], np.float32)
    hi = np.array([40, 20, 140], np.float32)
    org[4] = [20, 10, 50]                      # on a face, dir along the face
    d[4] = [0, 0, 1]
    for t_eps in (0.0, 1.0):
        want = np.asarray(jaabb.slab_test(jnp.asarray(org), jnp.asarray(d),
                                          jnp.asarray(lo), jnp.asarray(hi), t_eps))
        got = aabb.slab_test(_t(org), _t(d), _t(lo), _t(hi), t_eps)
        np.testing.assert_array_equal(got.numpy(), want)
    pts = rng.normal(size=(5, 16, 3)).astype(np.float32)
    for w, g in zip(jaabb.aabb_from_points(jnp.asarray(pts)), aabb.aabb_from_points(_t(pts))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_textures_and_atlas_sampling(rng):
    for name in ("bricks", "marble", "planet"):
        np.testing.assert_array_equal(getattr(tx, name)(32), getattr(jtx, name)(32))
    np.testing.assert_array_equal(tx.checker(32), jtx.checker(32))
    np.testing.assert_array_equal(tx.flat(8), jtx.flat(8))
    atlas_np = np.asarray(jscenes._atlas(32))
    np.testing.assert_array_equal(scenes._atlas(32).numpy(), atlas_np)
    n = 2000
    u = rng.uniform(-3, 3, n).astype(np.float32)
    v = rng.uniform(-3, 3, n).astype(np.float32)
    u[:3] = [0.0, 1.0, -1e-9]
    tid = rng.integers(-1, 4, n).astype(np.int32)
    want = jtx.sample_atlas(jnp.asarray(atlas_np), jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v))
    _close(tx.sample_atlas(_t(atlas_np), _t(tid), _t(u), _t(v)), want)
    want = jtx.sample_bilinear_wrap(jnp.asarray(atlas_np[2]), jnp.asarray(u), jnp.asarray(v))
    _close(tx.sample_bilinear_wrap(_t(atlas_np[2]), _t(u), _t(v)), want)


def test_bezier_basis_and_patches(rng):
    ctrl = np.asarray(jscenes._teapot_ctrl())
    np.testing.assert_array_equal(scenes._teapot_ctrl().numpy(), ctrl)
    np.testing.assert_array_equal(bezier.teapot_transform(), jbez.teapot_transform())
    s = rng.uniform(0, 1, 300).astype(np.float32)
    _close(bezier.bernstein(_t(s)), jbez.bernstein(jnp.asarray(s)), atol=1e-6)
    _close(bezier.dbernstein(_t(s)), jbez.dbernstein(jnp.asarray(s)), atol=1e-6)
    pid = rng.integers(0, 32, 300)
    u = rng.uniform(0, 1, 300).astype(np.float32)
    v = rng.uniform(0, 1, 300).astype(np.float32)
    cj, cp = jnp.asarray(ctrl[pid]), _t(ctrl[pid])
    _close(bezier.patch_point(cp, _t(u), _t(v)),
           jbez.patch_point(cj, jnp.asarray(u), jnp.asarray(v)), atol=1e-4)
    for w, g in zip(jbez.patch_tangents(cj, jnp.asarray(u), jnp.asarray(v)),
                    bezier.patch_tangents(cp, _t(u), _t(v))):
        _close(g, w, atol=1e-4)


def test_camera_rays_match():
    jc = jscenes.reference_camera(24, 16)
    pc = scenes.reference_camera(24, 16, device="cpu")
    for f in ("pos", "dir", "du", "dv"):
        _close(getattr(pc, f), getattr(jc, f), atol=1e-6)
    for w, g in zip(jcam.emit_rays(jc), camera.emit_rays(pc)):
        _close(g, w, atol=1e-6)


def test_build_scene_equals_jax_array_for_array():
    cfg = RenderConfig(scene="full", atlas_res=32, bezier_compact_frac=0.09,
                       newton_iters=7)
    want = flatten_to_numpy(j_build_scene(cfg))
    port = build_scene(cfg, device="cpu")
    got = flatten_to_numpy(port)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.bezier_compact_frac == 0.09 and port.newton_iters == 7


def _teapot_rays(n, scale, seed):
    ctrl = np.asarray(jscenes._teapot_ctrl())
    rng = np.random.default_rng(seed)
    org = np.tile(np.array([50.0, 35.0, 230.0], np.float32), (n, 1))
    d = (ctrl.reshape(-1, 3).mean(0) + rng.normal(scale=scale, size=(n, 3)) - org)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32)


@pytest.mark.parametrize("compact_frac", [1.0, 0.5])
def test_intersect_bezier_matches(compact_frac):
    org, d = _teapot_rays(64, 8.0, 3)
    obj_j = jbez.BezierObject(ctrl=jscenes._teapot_ctrl())
    obj_p = bezier.BezierObject(ctrl=scenes._teapot_ctrl())
    want = jbez.intersect_bezier(jnp.asarray(org), jnp.asarray(d), obj_j,
                                 newton_fn=make_newton_pallas(interpret=True, tile_r=64),
                                 compact_frac=compact_frac)
    got = bezier.intersect_bezier(_t(org), _t(d), obj_p, newton_fn=make_newton(),
                                  compact_frac=compact_frac)
    t_j, h_j, u_j, v_j, n_j = map(np.asarray, want)
    t_p, h_p, u_p, v_p, n_p = (x.numpy() for x in got)
    np.testing.assert_array_equal(h_p, h_j)
    assert h_p.sum() > 8
    _close(t_p, t_j, atol=1e-3)
    _close(u_p[h_p], u_j[h_p], atol=1e-4)
    _close(v_p[h_p], v_j[h_p], atol=1e-4)
    _close(n_p[h_p], n_j[h_p], atol=1e-3)


def test_intersect_scene_full_reference_camera(jax_full):
    """32 x 32 reference-camera rays on ``full`` with ray compaction."""
    js = jax_full.replace(bezier_compact_frac=0.25)
    ps = port_scene(js)
    org, d = jcam.emit_rays(jscenes.reference_camera(32, 32))
    rec_j = jax.jit(lambda o, dd: j_intersect_scene(
        js, o, dd, newton_fn=make_newton_pallas(interpret=True)))(org, d)
    rec_p = intersect_scene(ps, _t(org), _t(d), newton_fn=make_newton())
    np.testing.assert_array_equal(rec_p.hit.numpy(), np.asarray(rec_j.hit))
    np.testing.assert_array_equal(rec_p.obj_id.numpy(), np.asarray(rec_j.obj_id))
    np.testing.assert_array_equal(rec_p.inside.numpy(), np.asarray(rec_j.inside))
    assert (rec_p.obj_id.numpy() == 8).sum() > 5    # the teapot is in view
    _close(rec_p.t, rec_j.t, rtol=1e-5, atol=1e-3)
    _close(rec_p.pos, rec_j.pos, rtol=1e-5, atol=2e-3)
    _close(rec_p.n, rec_j.n, atol=1e-3)
    _close(rec_p.color, rec_j.color, atol=2e-3)
