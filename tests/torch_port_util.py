"""Shared helpers of the port's tests (tests/test_torch_*.py).

They hand the JAX package and the port identical data: scenes flattened to
numpy, the very uniforms ``jax.random`` draws inside the JAX functions
(derived with JAX's own key-split structure and listed in the order the
port's draws source is asked for them), and the JAX walks' per-segment
states, which ``raytrace3_tpu_torch.testing.pinned_segments`` holds the
port's walks to.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raytrace3_tpu.core.sampling import TWO_PI
from raytrace3_tpu.core.types import Deposits as JDeposits
from raytrace3_tpu.core.types import make_hitpoints as j_make_hitpoints

from raytrace3_tpu_torch.convert import (deposits_from_numpy, flatten_to_numpy,
                                         hitpoints_from_numpy, scene_from_numpy)

#: Few threads per test worker: the suite runs six workers at once.
torch.set_num_threads(2)


def port_scene(jax_scene, device="cpu"):
    """The port's copy of a JAX scene, statics included."""
    return scene_from_numpy(
        flatten_to_numpy(jax_scene), device=device,
        bezier_uv_quirk=jax_scene.bezier_uv_quirk,
        bezier_compact_frac=jax_scene.bezier_compact_frac,
        newton_iters=jax_scene.newton_iters,
        newton_restarts=jax_scene.newton_restarts)


def random_case(rng, C=300, D=700):
    """tests/test_deposit.py:14-35."""
    hp = j_make_hitpoints(C, init_r2=2.0)
    pos = rng.uniform(0, 40, size=(C, 3)).astype(np.float32)
    n = rng.normal(size=(C, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    hp = hp.replace(
        pos=jnp.asarray(pos), n=jnp.asarray(n),
        wgt=jnp.asarray(rng.uniform(0, 1, size=(C, 3)).astype(np.float32)),
        valid=jnp.asarray(rng.uniform(size=C) > 0.1),
        r2=jnp.asarray(rng.uniform(0.5, 2.0, size=C).astype(np.float32)))
    dn = rng.normal(size=(D, 3)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=-1, keepdims=True)
    dep = JDeposits(
        pos=jnp.asarray(rng.uniform(0, 40, size=(D, 3)).astype(np.float32)),
        n=jnp.asarray(dn),
        flux=jnp.asarray(rng.uniform(0, 5, size=(D, 3)).astype(np.float32)),
        valid=jnp.asarray(rng.uniform(size=D) > 0.2))
    return hp, dep


def wall_case(rng, C=500, D=3000):
    """tests/test_deposit.py:129-145: most deposits on an x = 1 wall."""
    hp, dep = random_case(rng, C=C, D=D)
    wallish = rng.uniform(size=D) < 0.6
    pos = np.asarray(dep.pos).copy()
    pos[wallish, 0] = 1.0 + rng.uniform(-0.05, 0.05, wallish.sum())
    pos[wallish, 1] = rng.uniform(0, 80, wallish.sum())
    pos[wallish, 2] = rng.uniform(0, 160, wallish.sum())
    hpp = np.asarray(hp.pos).copy()
    wh = rng.uniform(size=C) < 0.5
    hpp[wh, 0] = 1.0
    hpp[wh, 1] = rng.uniform(0, 80, wh.sum())
    hpp[wh, 2] = rng.uniform(0, 160, wh.sum())
    return hp.replace(pos=jnp.asarray(hpp)), dep.replace(pos=jnp.asarray(pos))


def port_records(hp, dep, device="cpu"):
    return (hitpoints_from_numpy(flatten_to_numpy(hp), device),
            deposits_from_numpy(flatten_to_numpy(dep), device))


def _u(key, shape, lo=0.0, hi=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def regen_round_draws(key, n_lanes: int, segs: int) -> list:
    """The uniforms of one ``photon_trace_regen(key)`` call, in port order.

    photon.py:229 splits ``segs`` keys; each segment splits k_e/k_r/k_d
    (:176); ``uniform_sphere`` and ``cosine_hemisphere`` split once more
    (sampling.py:32-35, :48-51); ``roulette`` draws from k_r directly.
    """
    out = []
    for k in jax.random.split(key, segs):
        k_e, k_r, k_d = jax.random.split(k, 3)
        ku, kv = jax.random.split(k_e)
        out += [_u(ku, (n_lanes,), -1.0, 1.0), _u(kv, (n_lanes,), 0.0, TWO_PI)]
        out.append(_u(k_r, (n_lanes,)))
        ku, kv = jax.random.split(k_d)
        out += [_u(ku, (n_lanes,)), _u(kv, (n_lanes,))]
    return out


def static_round_draws(key, n_lights: int, n_photons: int, segs: int) -> list:
    """The uniforms of one static-walk round of ``photon_rounds`` (key ``k``
    of sppm.py:181), in port order: ``emit_photons`` on k_e
    (sppm.py:212-215; ``uniform_sphere`` splits once more, z then phi,
    each (L, n)), then ``photon_trace`` on k_t, which splits ``segs`` keys
    (photon.py:110), each split into k_r (roulette) and k_d (the two
    hemisphere uniforms, split once more) (photon.py:87-90)."""
    k_e, k_t = jax.random.split(key)
    ku, kv = jax.random.split(k_e)
    shape = (n_lights, n_photons)
    out = [_u(ku, shape, -1.0, 1.0), _u(kv, shape, 0.0, TWO_PI)]
    n = n_lights * n_photons
    for k in jax.random.split(k_t, segs):
        k_r, k_d = jax.random.split(k)
        ku, kv = jax.random.split(k_d)
        out += [_u(k_r, (n,)), _u(ku, (n,)), _u(kv, (n,))]
    return out


def static_rounds_draws(key, n_rounds: int, n_lights: int, n_photons: int,
                        segs: int) -> list:
    """The uniforms of a ``render_pass`` without regen (the train step's
    pass, diff/train.py:106-119): ``photon_rounds`` splits ``n_rounds``
    keys from the pass key (sppm.py:181); the eye pass draws none."""
    out = []
    for k in jax.random.split(key, n_rounds):
        out += static_round_draws(k, n_lights, n_photons, segs)
    return out


def pass_draws(key, n_rounds: int, n_lanes: int, segs: int) -> list:
    """The uniforms of one JAX ``make_pass_fn`` pass, in port order: the
    camera jitter (driver.py:64-65), then ``photon_rounds`` splitting
    ``n_rounds`` keys (sppm.py:181) from the pass key."""
    kj, kp = jax.random.split(key)
    ku, kv = jax.random.split(kj)
    out = [_u(ku, (), -1.0, 1.0), _u(kv, (), 0.0, TWO_PI)]
    for k in jax.random.split(kp, n_rounds):
        out += regen_round_draws(k, n_lanes, segs)
    return out


#: The JAX walks' scan bodies, by qualified name, and the port's walk each
#: corresponds to.
_JAX_STEPS = {"_eye_pass_compact.<locals>.step": "eye",
              "eye_pass.<locals>.step": "eye_slot",
              "photon_trace_regen.<locals>.step": "photon",
              "photon_trace.<locals>.step": "static"}


def as_tensors(tree):
    """``tree`` (dicts, lists and tuples) with every array leaf a tensor, for
    ``torch.save`` to hand to a rank (``torch.load(weights_only=True)``)."""
    if isinstance(tree, dict):
        return {k: as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(as_tensors(x) for x in tree)
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return torch.as_tensor(np.array(tree))


def _torch(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_torch(x) for x in tree)
    return torch.as_tensor(np.array(tree))


@contextlib.contextmanager
def jax_walk_steps(pixel_offset: int = 0):
    """Record every step of the JAX eye and photon walks run within the
    block, as (input, output) pairs in the port's calling convention
    (``raytrace3_tpu_torch.testing``): "eye" (either eye wavefront),
    "photon" (the regen walk) and "static" (the static walk).
    ``pixel_offset``: the slot eye wavefront's ``pixel_offset`` in the
    block (its lanes' global pixel ids start there).

    Each walk's ``lax.scan`` body gets a host callback that hands out its
    carry in and out; the functions stay jitted.  The callback changes how
    XLA fuses the step, so the recorded run's last bits differ from an
    unrecorded run's: the recorded run is the reference.  The dict yielded
    is filled when the block ends.
    """
    raw = {w: [] for w in _JAX_STEPS.values()}
    steps = {"eye": [], "photon": [], "static": []}
    scan = jax.lax.scan

    def recording_scan(f, init, xs=None, length=None, **kw):
        name = getattr(f, "__qualname__", "")
        walk = next((w for n, w in _JAX_STEPS.items() if name.endswith(n)), None)
        if walk is None:
            return scan(f, init, xs, length, **kw)

        def body(carry, x):
            out = f(carry, x)
            jax.debug.callback(lambda c, o: raw[walk].append((c, o)), carry, out,
                               ordered=True)
            return out

        return scan(body, init, xs, length, **kw)

    jax.lax.scan = recording_scan
    try:
        yield steps
    finally:
        jax.lax.scan = scan
    for (lanes, dropped), ((lanes_out, dropped_out), rows) in raw["eye"]:
        steps["eye"].append((_torch(lanes), (
            _torch(lanes_out), _torch(np.asarray(dropped_out) - np.asarray(dropped)),
            _torch(rows))))
    for carry, (carry_out, record) in raw["photon"]:
        steps["photon"].append((_torch(carry), (_torch(carry_out), _torch(record))))
    for carry, (carry_out, record) in raw["static"]:
        steps["static"].append((_torch(carry), (_torch(carry_out), _torch(record))))
    steps["eye"] += [_slot_step(c, o, pixel_offset) for c, o in raw["eye_slot"]]


def _slot_lanes(state, offset):
    R, K = state["active"].shape
    n = R * K
    return (np.asarray(state["org"]).reshape(n, 3), np.asarray(state["dir"]).reshape(n, 3),
            np.asarray(state["wgt"]).reshape(n, 3),
            np.repeat(np.arange(R, dtype=np.int32) + np.int32(offset), K),
            np.asarray(state["active"]).reshape(n))


def _slot_step(carry, out, offset):
    """One step of JAX's slot eye wavefront (eye.py:138-213) in the port's
    ``eye_segment`` convention, lanes pixel-major with K slots a pixel.
    JAX scatters the segment's hit points straight into the buffer, so the
    candidate rows are read back from the slots it filled (slot -> lane by
    the stored pixel, pixel i = lanes iK..iK+K-1, of which one may be
    active); rows that stored nothing get the hit position (the next
    origin of the same lane, as no split moves a continuation to another
    slot) and an unknown (NaN) normal.  Needs a buffer that did not fill
    up and a scene whose materials have at most one specular lobe."""
    (state, (hp, count, dropped)), ((state2, (hp2, count2, dropped2)), _) = carry, out
    lanes, lanes2 = _slot_lanes(state, offset), _slot_lanes(state2, offset)
    c0, c1 = int(count), int(count2)
    assert c1 < np.asarray(hp2.pos).shape[0], "the hit-point buffer filled up"
    R, K = state["active"].shape
    act = lanes[4].reshape(R, K)
    assert (act.sum(1) <= 1).all(), "a pixel holds two active lanes: a split"
    rows = np.zeros((R * K, 11), np.float32)
    rows[:, 0:3] = lanes2[0]
    rows[:, 3:6] = np.nan
    rows[:, 9] = lanes[3]
    slots = np.arange(c0, c1)
    pixel = np.asarray(hp2.pixel)[slots] - offset
    lane = pixel * K + np.argmax(act[pixel], 1)
    rows[lane, 0:3] = np.asarray(hp2.pos)[slots]
    rows[lane, 3:6] = np.asarray(hp2.n)[slots]
    rows[lane, 6:9] = np.asarray(hp2.wgt)[slots]
    rows[lane, 10] = 1.0
    n_dropped = np.asarray(dropped2) - np.asarray(dropped)
    return _torch(lanes), (_torch(lanes2), _torch(n_dropped), _torch(rows))


def regen_rounds_draws(key, n_rounds: int, n_lanes: int, segs: int) -> list:
    """The uniforms of ``n_rounds`` regen rounds from one key (sppm.py:181
    and ring.py:200 split it per round), in port order."""
    out = []
    for k in jax.random.split(key, n_rounds):
        out += regen_round_draws(k, n_lanes, segs)
    return out


def jitter_rays(cfg, key, base, look):
    """(z, phi draws, org, dir) of a pass key's camera jitter, as JAX's
    sharded pass draws it: ``kj, kp = split(key)``, then
    ``uniform_sphere(kj)`` (shard.py:101-107).  Returns kp too."""
    from raytrace3_tpu.core.sampling import uniform_sphere
    from raytrace3_tpu.render.camera import emit_rays, look_at

    kj, kp = jax.random.split(key)
    ku, kv = jax.random.split(kj)
    jitter = [_u(ku, (), -1.0, 1.0), _u(kv, (), 0.0, TWO_PI)]
    pos = jnp.asarray(base, jnp.float32) + cfg.jitter * uniform_sphere(kj)
    org, dirs = emit_rays(look_at(pos, jnp.asarray(look, jnp.float32), cfg.width, cfg.height))
    return jitter, org, dirs, kp


def sharded_emulation(scene, cfg, groups, n_shard: int, deposit_fn=None, newton_fn=None):
    """JAX's photon-sharded rounds emulated on one device, as
    tests/test_parallel.py:52-116 and tests/test_ring.py:23-164 do: for
    each group ``(org, dirs, photon_keys)``, ``n_shard`` eye passes on the
    ray shards (capacity C / n, global pixel ids), their hit points
    concatenated, and per round every shard's photons (``fold``ed keys,
    ``cfg.photons_per_round / n`` a light, static or regen walk) deposited
    into all of them (``deposit_fn``, default the bruteforce) and summed
    before one PPM update.  ``newton_fn``: the Bezier solve of every walk
    (JAX's ``newton_fn``; default its ``solve_winner``).  Each walk is
    recorded (``jax_walk_steps``).

    Returns, per group, the image (H, W, 3), the eye pass's dropped count
    summed over the shards and the emitted photons a light, and per group
    and shard the eye steps, the photon steps and the photon draws in the
    port's order.  One recording serves every group's photon walks (jitted
    once, their steps split by their counts); each eye pass has its own
    (its pixel offset); groups that share their rays (the same ``org`` and
    ``dirs`` objects, as the pass groups of an unjittered train loss do)
    share their eye passes, which draw nothing.
    """
    from raytrace3_tpu.render.deposit import deposit_bruteforce
    from raytrace3_tpu.render.eye import eye_pass
    from raytrace3_tpu.render.light import emit_photons
    from raytrace3_tpu.render.photon import (photon_trace, photon_trace_regen,
                                             regen_state_init)
    from raytrace3_tpu.render.sppm import estimate_image, ppm_update

    deposit_fn = deposit_fn or deposit_bruteforce
    R, segs = cfg.n_pixels, cfg.max_depth + 1
    rs, cap = R // n_shard, cfg.hitpoint_capacity // n_shard
    local = cfg.photons_per_round // n_shard
    L = scene.light_pos.shape[0]
    photon_scene = scene
    if cfg.bezier_compact_frac_photon >= 0.0 and scene.has_bezier:
        photon_scene = scene.replace(bezier_compact_frac=cfg.bezier_compact_frac_photon)
    out = []
    with jax_walk_steps() as steps:
        static = jax.jit(lambda k: photon_trace(
            photon_scene, k[1], *emit_photons(k[0], scene.light_pos, scene.light_color, local),
            cfg.max_depth, newton_fn=newton_fn))
        regen = jax.jit(lambda k, st: photon_trace_regen(
            photon_scene, k, scene.light_pos, scene.light_color, local, st, cfg.max_depth,
            newton_fn=newton_fn))
        depo = jax.jit(lambda hp, dep: deposit_fn(hp, dep)[:2])
        update = jax.jit(lambda hp, dn, dt: ppm_update(hp, dn, dt, cfg.update_mode))
        eyes = {}
        for org, dirs, photon_keys in groups:
            if (id(org), id(dirs)) not in eyes:
                hps, dropped, eye_steps = [], 0, []
                for i in range(n_shard):
                    # A new function each time: a cached trace would report
                    # to the recording it was traced in.
                    eye = jax.jit(lambda o, d, off=i * rs: eye_pass(
                        scene, o, d, cap, cfg.max_depth, cfg.slots, cfg.init_r2,
                        newton_fn=newton_fn, pixel_offset=off,
                        compact_schedule=cfg.eye_compact_schedule))
                    with jax_walk_steps(pixel_offset=i * rs) as eye_rec:
                        hp_i, st_i = eye(org[i * rs:(i + 1) * rs], dirs[i * rs:(i + 1) * rs])
                        jax.block_until_ready(hp_i)
                    hps.append(hp_i)
                    dropped += int(st_i["dropped"])
                    eye_steps.append(eye_rec["eye"])
                eyes[id(org), id(dirs)] = (hps, dropped, eye_steps)
            hps, dropped, eye_steps = eyes[id(org), id(dirs)]
            hp = jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *hps)
            rkeys = [jax.random.split(k, cfg.rounds) for k in photon_keys]
            pstates = [regen_state_init(L, local) for _ in range(n_shard)]
            emitted = 0.0
            for r in range(cfg.rounds):
                d_n = jnp.zeros(hp.capacity)
                d_t = jnp.zeros((hp.capacity, 3))
                for i in range(n_shard):
                    if cfg.photon_regen:
                        dep, pstates[i], e = regen(rkeys[i][r], pstates[i])
                        emitted += float(jnp.mean(e))
                    else:
                        dep = static(jax.random.split(rkeys[i][r]))
                        emitted += local
                    dn_i, dt_i = depo(hp, dep)
                    d_n = d_n + dn_i
                    d_t = d_t + dt_i
                hp = update(hp, d_n, d_t)
            img = estimate_image(hp, R, emitted)
            if cfg.photon_regen:
                draws = [regen_rounds_draws(k, cfg.rounds, L * local, segs) for k in photon_keys]
            else:
                draws = [static_rounds_draws(k, cfg.rounds, L, local, segs) for k in photon_keys]
            out.append(dict(img=np.asarray(img).reshape(cfg.height, cfg.width, 3),
                            dropped=dropped, emitted=emitted, draws=draws, eye=eye_steps))
    walk = "photon" if cfg.photon_regen else "static"
    photon_steps = iter(steps[walk])
    for g in out:
        assert all(len(e) == segs for e in g["eye"])
        per_round = [[[next(photon_steps) for _ in range(segs)] for _ in range(n_shard)]
                     for _ in range(cfg.rounds)]
        g["photon"] = [sum((per_round[r][i] for r in range(cfg.rounds)), [])
                       for i in range(n_shard)]
    assert next(photon_steps, None) is None
    return out
