"""The asset-texture override, ``RT3_ASSET_TEXTURES``, against the JAX
package's.

When the variable (or ``_atlas``'s ``asset_dir``) names a directory, each
atlas slot with a file there (``wall``, ``timg``, ``planet``, ``blue``;
``.jpg``, ``.jpeg``, ``.png`` in that order) is read with PIL's bilinear
resize instead of its procedural texture.  Both packages read the same
files with the same PIL calls, so every atlas value must be equal
(atol 0).  PIL is imported only when a file is read: with PIL missing the
override raises, and without the variable nothing imports PIL.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import torch_port_util  # noqa: F401  (thread count)
from raytrace3_tpu import scenes as jscenes
from raytrace3_tpu.textures import texture as jtx

from raytrace3_tpu_torch import scenes
from raytrace3_tpu_torch.textures import texture as tx

ROOT = Path(__file__).resolve().parent.parent


def _pattern(res, seed):
    """An RGB uint8 image with edges, so a shrinking resize filters."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(res, res, 3), dtype=np.uint8)


def _asset_dir(root: Path) -> Path:
    """A JPEG wall, a PNG planet (larger than the atlas, so it shrinks), a
    .jpeg blue; timg stays procedural.  A ``.png`` beside the ``.jpg`` wall
    shows the extension order."""
    root.mkdir(exist_ok=True)
    Image.fromarray(_pattern(24, 0)).save(root / "wall.jpg", quality=90)
    Image.fromarray(_pattern(8, 9)).save(root / "wall.png")
    Image.fromarray(_pattern(40, 1)).save(root / "planet.png")
    Image.fromarray(_pattern(5, 2)).save(root / "blue.jpeg", quality=75)
    return root


@pytest.mark.parametrize("name, res", [("a.png", 8), ("a.png", 16), ("a.jpg", 8),
                                       ("a.jpg", 32)])
def test_load_image_equals_jax(tmp_path, name, res):
    path = tmp_path / name
    Image.fromarray(_pattern(20, 3)).save(path)
    got = tx.load_image(str(path), res)
    want = jtx.load_image(str(path), res)
    assert got.shape == (res, res, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_atlas_from_asset_dir_equals_jax_slot_by_slot(tmp_path, monkeypatch):
    monkeypatch.delenv("RT3_ASSET_TEXTURES", raising=False)
    d = _asset_dir(tmp_path / "assets")
    got = scenes._atlas(8, device="cpu", asset_dir=str(d)).numpy()
    want = np.asarray(jscenes._atlas(8, asset_dir=str(d)))
    assert got.shape == want.shape == (4, 8, 8, 3)
    for slot in range(4):
        np.testing.assert_array_equal(got[slot], want[slot], err_msg=f"slot {slot}")
    # Read from the files: wall (the .jpg, not the .png), planet, blue.
    np.testing.assert_array_equal(got[0], jtx.load_image(str(d / "wall.jpg"), 8))
    np.testing.assert_array_equal(got[2], jtx.load_image(str(d / "planet.png"), 8))
    np.testing.assert_array_equal(got[3], jtx.load_image(str(d / "blue.jpeg"), 8))
    # timg has no file and stays procedural.
    np.testing.assert_array_equal(got[1], tx.marble(8))


def test_full_scene_reads_the_variable_as_jax_does(tmp_path, monkeypatch):
    """The failing case of the ignored override: ``full`` with
    RT3_ASSET_TEXTURES set renders JAX's atlas, not the procedural one."""
    d = _asset_dir(tmp_path / "assets")
    monkeypatch.setenv("RT3_ASSET_TEXTURES", str(d))
    got = scenes.full(atlas_res=8, device="cpu").atlas.numpy()
    want = np.asarray(jscenes.full(atlas_res=8).atlas)
    np.testing.assert_array_equal(got, want)
    monkeypatch.delenv("RT3_ASSET_TEXTURES")
    procedural = scenes.full(atlas_res=8, device="cpu").atlas.numpy()
    assert not np.array_equal(got[0], procedural[0])
    np.testing.assert_array_equal(procedural, np.asarray(jscenes.full(atlas_res=8).atlas))


def test_override_without_pil_raises(tmp_path, monkeypatch):
    d = _asset_dir(tmp_path / "assets")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setenv("RT3_ASSET_TEXTURES", str(d))
    with pytest.raises(ImportError, match="RT3_ASSET_TEXTURES"):
        scenes.full(atlas_res=8, device="cpu")
    monkeypatch.delenv("RT3_ASSET_TEXTURES")
    atlas = scenes._atlas(8, device="cpu").numpy()
    np.testing.assert_array_equal(atlas[0], tx.bricks(8))


def test_nothing_imports_pil_without_the_variable():
    """The port, its CLI and chip_smoke.py build scenes without PIL."""
    code = ("import sys, chip_smoke, raytrace3_tpu_torch.cli\n"
            "from raytrace3_tpu_torch import scenes\n"
            "for name in scenes.REGISTRY:\n"
            "    scenes.get_scene(name, atlas_res=8, device='cpu')\n"
            "print(sorted(m for m in sys.modules if m == 'PIL' or m.startswith('PIL.')))\n")
    env = {k: v for k, v in os.environ.items() if k != "RT3_ASSET_TEXTURES"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
