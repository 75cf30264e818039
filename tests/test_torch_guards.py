"""Guards of the port's rules: no JAX, no TF32, no silent fallback.

The package and ``chip_smoke.py`` must import without JAX (checked in a
fresh interpreter); TF32 is off after import; the kernel wrappers take
their plain twins only for CPU tensors and raise for other devices; and
``chip_smoke.py`` refuses to run, printing no result, without a GPU or
outside the repository.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytrace3_tpu_torch.ops import cuda_build, deposit_kernel, newton_kernel

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
        "assert len(names) >= 25, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
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


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a GPU")
def test_smoke_script_refuses_without_gpu(tmp_path):
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
