"""``scripts/f2_fma.patch``, the repair of fault F2 that the tree does not
carry (ROADMAP section 3), still applies to the files it changes, so that
``scripts/torch_f2_probe.py`` can check it and a later change can take it
up.  A change to one of those files regenerates the patch."""

import importlib.util
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_f2_patch_applies(tmp_path):
    spec = importlib.util.spec_from_file_location("torch_f2_probe",
                                                  ROOT / "scripts" / "torch_f2_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    text = probe.PATCH.read_text()
    changed = [line[len("+++ b/"):] for line in text.splitlines() if line.startswith("+++ b/")]
    assert changed == ["raytrace3_tpu_torch/csrc/newton.cu",
                       "raytrace3_tpu_torch/ops/newton_kernel.py", "tests/test_torch_eye.py",
                       "tests/test_torch_newton.py"]
    for rel in changed:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, tmp_path / rel)
    probe.apply_patch(text, tmp_path)
    kernel = (tmp_path / "raytrace3_tpu_torch/csrc/newton.cu").read_text()
    twin = (tmp_path / "raytrace3_tpu_torch/ops/newton_kernel.py").read_text()
    assert "__fmaf_rn" in kernel and "def fma32(" in twin and "def fma32_card(" in twin
    assert "xfail" not in (tmp_path / "tests/test_torch_eye.py").read_text()
