"""Guards of the port's rules: no JAX, no TF32, no silent fallback, the
card by default.

The package and ``chip_smoke.py`` must import without JAX (checked in a
fresh interpreter); TF32 is off after import; the kernel wrappers take
their plain twins only for CPU tensors and raise for other devices; the
entry points default to the card and raise without one; and
``chip_smoke.py`` refuses to run, printing no result, without a GPU or
outside the repository.
"""

import inspect
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytrace3_tpu_torch import scenes
from raytrace3_tpu_torch.ops import cuda_build, deposit_kernel, lane_kernel, newton_kernel
from raytrace3_tpu_torch.render import driver
from raytrace3_tpu_torch.render.driver import build_scene
from raytrace3_tpu_torch.utils.config import RenderConfig

REPO = Path(__file__).resolve().parent.parent


def _python(code: str, cwd=REPO, timeout=120):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, timeout=timeout,
                          capture_output=True, text=True)


def test_package_and_smoke_script_import_no_jax():
    proc = _python(
        "import pkgutil, importlib, sys\n"
        "import raytrace3_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'raytrace3_tpu'))\n"
        "assert len(names) >= 30, names\n"
        "assert {'raytrace3_tpu_torch.cli', 'raytrace3_tpu_torch.ops.grid', "
        "'raytrace3_tpu_torch.utils.image'} <= set(names), names\n"
        "assert {'raytrace3_tpu_torch.parallel.' + m for m in "
        "('mesh', 'shard', 'ring', 'launch', 'dryrun')} <= set(names), names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_bench_and_crossval_scripts_import_no_jax():
    """``bench_torch.py`` and ``scripts/torch_crossval.py`` import the JAX
    package's ``bench.py`` and ``scripts/crossval.py`` for the C++ side,
    which import no JAX at their top."""
    proc = _python(
        "import runpy, sys\n"
        "runpy.run_path('bench_torch.py', run_name='bench_torch')\n"
        "runpy.run_path('scripts/torch_crossval.py', run_name='torch_crossval')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'raytrace3_tpu'))\n"
        "assert {'bench', 'crossval'} <= set(sys.modules), 'bench, crossval not imported'\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_tf32_is_off_after_import():
    proc = _python(
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "import raytrace3_tpu_torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n")
    assert proc.returncode == 0, proc.stderr


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def test_tf32_is_off_in_the_sharded_ranks():
    """The sharded pass runs in processes of its own (``parallel.launch``
    and torchrun's ``python -m raytrace3_tpu_torch.cli``): TF32 is off in
    them too, whatever the parent set."""
    proc = _python(
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "import sys; sys.path.insert(0, 'tests')\n"
        "from raytrace3_tpu_torch.parallel.launch import spawn\n"
        "from test_torch_guards import _tf32_flags\n"
        "if __name__ == '__main__':\n"
        "    assert spawn(_tf32_flags, 2, backend=\"gloo\") == [(False, False)] * 2\n"
        "    import raytrace3_tpu_torch.cli, raytrace3_tpu_torch.parallel.shard\n"
        "    assert _tf32_flags() == (False, False)\n"
        "    print('ok')\n")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


def test_nvcc_flags_keep_ieee_rounding():
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


def _tile_case(rng, tiles=3, tile=32, lanes=200):
    packed = rng.uniform(0, 4, (tiles * tile, 8)).astype(np.float32)
    packed[:, 6] = rng.uniform(-1, 2, tiles * tile)
    dep = np.zeros((16, lanes), np.float32)
    dep[:9] = rng.uniform(0, 4, (9, lanes))
    sk = np.sort(rng.integers(0, lanes, (tiles, 3)), 1).astype(np.int32)
    ek = np.minimum(sk + rng.integers(0, 60, (tiles, 3)), lanes).astype(np.int32)
    return [torch.as_tensor(a) for a in (sk, ek, packed, dep)]


def test_cpu_tensors_take_the_plain_deposit():
    args = _tile_case(np.random.default_rng(0))
    before = deposit_kernel.KERNEL.launches
    got = deposit_kernel.deposit_tile(*args)
    want = deposit_kernel.deposit_tile_plain(*args)
    assert deposit_kernel.KERNEL.launches == before
    assert deposit_kernel.KERNEL._fn is None          # nothing was built
    assert float(want[:, 0].sum()) > 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_other_devices_raise_instead_of_falling_back():
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError):
        deposit_kernel.deposit_tile(*map(meta, _tile_case(np.random.default_rng(1))))
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        newton_kernel.solve(o, o, torch.zeros((2, 4, 4, 3), device="meta"))
    assert newton_kernel.KERNEL._fn is None


def test_lane_wrappers_take_the_plain_twins_on_cpu_and_raise_elsewhere():
    sk, ek, packed, dep = _tile_case(np.random.default_rng(2))
    lo, hi = torch.tensor([0, 2, 3], dtype=torch.int32), torch.tensor([2, 3, 3], dtype=torch.int32)
    wa, wb = sk.reshape(-1)[:3].contiguous(), ek.reshape(-1)[:3].contiguous()
    wt = torch.tensor([0, 1, 2], dtype=torch.int32)
    u = torch.ones((packed.shape[0], 3))
    before = (lane_kernel.FORWARD.launches, lane_kernel.BACKWARD.launches)
    fwd = lane_kernel.deposit_lane(lo, hi, wa, wb, packed, dep)
    assert torch.equal(fwd, lane_kernel.deposit_lane_plain(lo, hi, wa, wb, packed, dep))
    assert float(fwd[:, 0].sum()) > 0 and float(fwd[96 - 32:, 0].abs().sum()) == 0
    run = torch.tensor([0, 3], dtype=torch.int32), torch.tensor([3, 3], dtype=torch.int32)
    dep = torch.cat([dep, torch.zeros((16, 56))], 1)              # 2 chunks of 128
    bwd = lane_kernel.deposit_lane_bwd(*run, wt, wa, wb, packed, u, dep, 32, 128)
    assert bwd.shape == (3, 256) and float(bwd.sum()) > 0
    assert (lane_kernel.FORWARD.launches, lane_kernel.BACKWARD.launches) == before
    assert lane_kernel.FORWARD._fn is None and lane_kernel.BACKWARD._fn is None
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError):
        lane_kernel.deposit_lane(*map(meta, (lo, hi, wa, wb, packed, dep)))
    with pytest.raises(ValueError):
        lane_kernel.deposit_lane_bwd(*map(meta, (*run, wt, wa, wb, packed, u, dep)), 32, 128)


def test_block_and_stream_wrappers_take_the_plain_twins_on_cpu_and_raise_elsewhere():
    sk, ek, packed, dep = _tile_case(np.random.default_rng(3))
    dep = torch.cat([dep, torch.zeros((16, 56))], 1)              # 2 blocks of 128
    wt = torch.tensor([0, 0, 1, 2, 2], dtype=torch.int32)
    blk = torch.tensor([0, 1, 1, 0, 0], dtype=torch.int32)
    wcmp = torch.tensor([1, 1, 1, 1, 0], dtype=torch.int32)
    itf = torch.tensor([0, 128, 0], dtype=torch.int32)
    itab = torch.tensor([(5 << 16) | 90, 40, (3 << 16) | 128], dtype=torch.int32)
    starts, ends = (torch.tensor(x, dtype=torch.int32) for x in ([0, 2, 3], [2, 3, 3]))
    before = (deposit_kernel.BLOCK_KERNEL.launches, lane_kernel.STREAM.launches)
    blk_out = deposit_kernel.deposit_block(wt, blk, wcmp, packed, dep, 32, 128)
    assert torch.equal(blk_out, deposit_kernel.deposit_block_plain(wt, blk, wcmp, packed,
                                                                   dep, 32, 128))
    st_out = lane_kernel.deposit_stream(itf, itab, starts, ends, packed, dep)
    assert torch.equal(st_out, lane_kernel.deposit_stream_plain(itf, itab, starts, ends,
                                                                packed, dep))
    assert float(blk_out[:, 0].sum()) > 0 and float(st_out[:, 0].sum()) > 0
    assert float(st_out[64:].abs().sum()) == 0                    # tile 2: empty run
    assert (deposit_kernel.BLOCK_KERNEL.launches, lane_kernel.STREAM.launches) == before
    assert deposit_kernel.BLOCK_KERNEL._fn is None and lane_kernel.STREAM._fn is None
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError):
        deposit_kernel.deposit_block(*map(meta, (wt, blk, wcmp, packed, dep)), 32, 128)
    with pytest.raises(ValueError):
        lane_kernel.deposit_stream(*map(meta, (itf, itab, starts, ends, packed, dep)))


def test_entry_points_default_to_the_card(monkeypatch):
    """The default device is "cuda"; without a card the entry points raise
    (checked with the card's availability mocked away), never run on the
    CPU unasked.  (The CLI's own check is in tests/test_torch_cli.py.)"""
    for fn in (build_scene, driver.render, scenes.full, scenes.get_scene,
               scenes.reference_camera, *scenes.REGISTRY.values()):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_scene(RenderConfig(scene="full", atlas_res=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenes.reference_camera(8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenes.cornell_two_lights(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.render(RenderConfig(scene="cornell_diffuse", width=4, height=4, passes=1,
                                   atlas_res=8))
    assert build_scene(RenderConfig(scene="full", atlas_res=8), device="cpu").device.type == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a GPU")
def test_smoke_script_refuses_without_gpu(tmp_path):
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
