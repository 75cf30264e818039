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
import numpy as np
import torch

from raytrace3_tpu.core.sampling import TWO_PI

from raytrace3_tpu_torch.convert import flatten_to_numpy, scene_from_numpy

#: Few threads per test worker: the suite runs six workers at once.
torch.set_num_threads(2)


def port_scene(jax_scene, device="cpu"):
    """The port's copy of a JAX scene, statics included."""
    return scene_from_numpy(
        flatten_to_numpy(jax_scene), device=device,
        bezier_uv_quirk=jax_scene.bezier_uv_quirk,
        bezier_compact_frac=jax_scene.bezier_compact_frac,
        newton_iters=jax_scene.newton_iters)


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
              "photon_trace_regen.<locals>.step": "photon"}


def _torch(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_torch(x) for x in tree)
    return torch.as_tensor(np.array(tree))


@contextlib.contextmanager
def jax_walk_steps():
    """Record every step of the JAX eye and photon walks run within the
    block, as (input, output) pairs in the port's calling convention
    (``raytrace3_tpu_torch.testing``).

    Each walk's ``lax.scan`` body gets a host callback that hands out its
    carry in and out; the functions stay jitted.  The callback changes how
    XLA fuses the step, so the recorded run's last bits differ from an
    unrecorded run's: the recorded run is the reference.  The dict yielded
    is filled when the block ends.
    """
    raw = {"eye": [], "photon": []}
    steps = {"eye": [], "photon": []}
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
