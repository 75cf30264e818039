"""Shared fixtures of the benchmark's tests: a render cell at a tiny size on
the CPU (the program's kernels run as their plain twins there)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: A size a test run holds: 24 x 24 pixels, 2 rounds of 512 photons, the
#: eye schedule's last stage at segment 6 so depth 7.
TINY = {"width": 24, "height": 24, "atlas_res": 16, "max_depth": 7}
TINY_PASS = {"rounds": 2, "photons_per_round": 512}
SEED = 4_000_000_007


def tiny_cell(workload: str = "teapot512.render", **settings):
    from benchmark.drivers import render
    from benchmark.harness import spec

    c = spec.cell(workload)
    cfg, tr = copy.deepcopy(c["config"]), copy.deepcopy(c["traffic"])
    cfg["settings"].update(TINY, **settings)
    tr["pass"].update(TINY_PASS)
    return render.build(cfg, tr, "cpu", SEED, lambda m: None), c["workload"]["limits"]


@pytest.fixture(scope="module")
def cell():
    return tiny_cell()


@pytest.fixture
def card():
    """Skip unless an NVIDIA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
