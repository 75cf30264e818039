"""The train-state checkpoint: the port's ``utils.checkpoint.save_tree`` /
``load_tree`` and ``diff.train``'s Adam adapter, after tests/test_driver.py:
193-220 (a train state restores bit for bit, and a step from it repeats
the live one), with JAX's shape and dtype refusals, and a params file
cross-loading both ways with the JAX package's ``save_tree`` / ``load_tree``
(the optimiser state is the port's own: optax's tree differs).
"""

import jax
import numpy as np
import pytest
import torch

from raytrace3_tpu.diff.train import extract_params as j_extract_params
from raytrace3_tpu.render import driver as jdriver
from raytrace3_tpu.utils import checkpoint as jckpt
from raytrace3_tpu.utils.config import RenderConfig as JConfig

from raytrace3_tpu_torch.diff import train
from raytrace3_tpu_torch.render import driver
from raytrace3_tpu_torch.utils import checkpoint
from raytrace3_tpu_torch.utils.config import RenderConfig

#: tests/test_driver.py:200-202.
TINY = dict(scene="cornell_diffuse", width=12, height=12, passes=1, rounds=1,
            photons_per_round=256, max_depth=3, atlas_res=8)


def _train_state():
    cfg = RenderConfig(**TINY)
    scene = driver.build_scene(cfg, device="cpu")
    init_fn, step_fn = train.make_train_step(scene, cfg, train.adam(1e-2))
    target = torch.zeros((cfg.height, cfg.width, 3))
    return scene, init_fn, step_fn, target


def _step(step_fn, params, opt, target, seed=0):
    _, _, loss, _ = step_fn(params, opt, torch.Generator().manual_seed(seed), target)
    return float(loss)


def test_train_state_round_trip_is_bitwise(tmp_path):
    scene, init_fn, step_fn, target = _train_state()
    params = train.extract_params(scene)
    opt = init_fn(params)
    _step(step_fn, params, opt, target)

    path = str(tmp_path / "train.npz")
    live = {"params": params, "opt": train.optimizer_tree(opt, params)}
    checkpoint.save_tree(path, live, step=1)
    assert not any(p.name.endswith(".tmp.npz") for p in tmp_path.iterdir())
    fresh = train.extract_params(scene)
    fresh_opt = init_fn(fresh)
    template = {"params": {k: torch.zeros_like(v) for k, v in fresh.items()},
                "opt": train.optimizer_tree(fresh_opt, fresh)}
    restored, step = checkpoint.load_tree(path, template)
    assert step == 1
    flat_r, flat_l = checkpoint.flatten_tree(restored), checkpoint.flatten_tree(live)
    assert sorted(flat_r) == sorted(flat_l) and "['opt']['diff']['exp_avg']" in flat_r
    for k, v in flat_l.items():
        assert flat_r[k].dtype == v.dtype and torch.equal(flat_r[k], v.detach()), k

    with torch.no_grad():
        for k, v in fresh.items():
            v.copy_(restored["params"][k])
    train.load_optimizer_tree(fresh_opt, fresh, restored["opt"])
    l_live = _step(step_fn, params, opt, target, seed=1)
    l_restored = _step(step_fn, fresh, fresh_opt, target, seed=1)
    assert l_restored == l_live
    for k in params:
        assert torch.equal(fresh[k], params[k]), k


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_load_tree_refuses_mismatches(tmp_path, bad):
    path = str(tmp_path / "t.npz")
    checkpoint.save_tree(path, {"params": {"diff": torch.ones(4, 3)}}, step=2)
    wrong = torch.zeros(5, 3) if bad == "shape" else torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match=f"\\['params'\\]\\['diff'\\] {bad}"):
        checkpoint.load_tree(path, {"params": {"diff": wrong}})
    assert checkpoint.load_tree(str(tmp_path / "none.npz"), {}) is None


def test_params_cross_load_with_jax(tmp_path):
    cfg = JConfig(**TINY)
    j_params = j_extract_params(jdriver.build_scene(cfg))
    rng = np.random.default_rng(5)
    j_params = {k: np.asarray(v) + rng.uniform(0, 1, np.shape(v)).astype(np.float32)
                for k, v in j_params.items()}
    port = {k: torch.as_tensor(v) for k, v in j_params.items()}
    assert sorted(port) == sorted(train.extract_params(
        driver.build_scene(RenderConfig(**TINY), device="cpu")))

    theirs, mine = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jckpt.save_tree(theirs, {"params": j_params}, step=3)
    got, step = checkpoint.load_tree(theirs, {"params": {k: torch.zeros_like(v)
                                                         for k, v in port.items()}})
    assert step == 3
    for k, v in j_params.items():
        np.testing.assert_array_equal(got["params"][k].numpy(), v, err_msg=k)

    checkpoint.save_tree(mine, {"params": port}, step=4)
    got, step = jckpt.load_tree(mine, {"params": jax.tree.map(np.zeros_like, j_params)})
    assert step == 4
    for k, v in j_params.items():
        np.testing.assert_array_equal(np.asarray(got["params"][k]), v, err_msg=k)
