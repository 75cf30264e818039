"""The staged eye's segment kernels (``ops/eye_kernel.py``, ``csrc/eye.cu``)
as far as the CPU can hold them: the ctypes structures against the sources,
the byte counts behind the kernels' bounds against the segment's tensors,
and where ``render/eye.eye_segment`` takes the kernel path.  The kernels
themselves run in tests/test_torch_cuda.py and ``chip_smoke.py`` phase 25.

The dispatch tests stand the CPU in for the card (``eye._on_card``) and make
the first kernel's launch raise, so a segment that would take the kernel
path shows itself.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from raytrace3_tpu_torch.ops import eye_kernel, walk_kernel
from raytrace3_tpu_torch.render import eye
from raytrace3_tpu_torch.render.camera import emit_rays
from raytrace3_tpu_torch.scenes import cornell_specular, full, reference_camera

CSRC = Path(eye_kernel.__file__).parent.parent / "csrc"
#: The render cells' eye schedule (benchmark/configs/teapot512.json).
SCHEDULE = ((1, 0.25), (4, 0.04), (6, 0.02))


def c_struct_fields(src: str, name: str) -> list:
    """``struct <name>``'s fields in ``src`` as ctypes fields: a pointer or
    an int each, in order."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = ctypes.c_void_p if "*" in decl else ctypes.c_int
        if "," in decl:
            head, *rest = decl.split(",")
            names = [head.split()[-1]] + [r.strip() for r in rest]
        else:
            names = [decl.replace("*", " ").split()[-1]]
        fields += [(n, kind) for n in names]
    return fields


def test_eye_kernel_structs_match_the_source():
    """``ops/eye_kernel.py``'s ``EyeLanes`` lays out csrc/eye.cu's field by
    field, the scene's tables are csrc/surface.cuh's ``WalkScene`` (the
    walk's struct), and the threads a block are the source's."""
    src = (CSRC / "eye.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == str(eye_kernel.THREADS)
    assert c_struct_fields(src, "EyeLanes") == list(eye_kernel._Lanes._fields_)
    assert c_struct_fields((CSRC / "surface.cuh").read_text(), "WalkScene") == list(
        walk_kernel._Scene._fields_)
    assert '#include "surface.cuh"' in src
    assert eye_kernel.BEZIER.symbol == walk_kernel.BEZIER.symbol == "rt3_walk_bezier"
    assert eye_kernel.BEZIER is not walk_kernel.BEZIER


def _lanes(n: int, seed: int = 3):
    """``n`` eye lanes toward the room from the reference camera, with
    weights in (0, 1] and a third of them inactive."""
    g = torch.Generator().manual_seed(seed)
    org, d = emit_rays(reference_camera(32, 32, device="cpu"))
    pick = torch.randint(0, org.shape[0], (n,), generator=g)
    wgt = torch.rand((n, 3), generator=g) * 0.9 + 0.1
    act = torch.rand((n,), generator=g) > 1 / 3
    return (org[pick].contiguous(), d[pick].contiguous(), wgt,
            torch.arange(n, dtype=torch.int32), act)


def test_eye_segment_bytes_count_the_segments_lane_tensors():
    """``eye_kernel.eye_segment_bytes``, the least time's byte count, is the
    bytes of one segment's lane tensors, each once: the lanes in, the next
    lanes but the pixel (the input's own tensor) and the hit-point rows.
    ``eye_kernel_bytes`` splits the same segment at the tensors ``hit``
    hands ``shade``."""
    scene = full(atlas_res=16, device="cpu").replace(bezier_compact_frac=0.09)
    N = 256
    lanes = _lanes(N)
    fetch = eye._eye_material_lanes(scene)
    nxt, dropped, rows = eye.eye_segment_plain(scene, fetch, lanes)
    assert nxt[3] is lanes[3] and dropped.dim() == 0 and rows.shape == (N, 11)
    size = lambda ts: sum(t.nbytes for t in ts)
    lanes_in = size(lanes)
    out = size(x for x in nxt if x is not lanes[3]) + rows.nbytes
    assert eye_kernel.eye_segment_bytes(N) == lanes_in + out == 122 * N

    w = eye_kernel.SegmentLanes(eye_kernel.EyeScene(scene, fetch.table), lanes)
    handed = size((w.t_a, w.obj_a, w.ins_a, w.gate, w.rows))
    split = eye_kernel.eye_kernel_bytes(N, 0, 0)
    assert split["eye_hit"] == size(lanes[:2]) + handed
    assert split["eye_shade"] == lanes_in + handed + out
    assert split["eye_bezier"] == 0
    assert eye_kernel.eye_kernel_bytes(N, 16, 10)["eye_bezier"] == 16 * 8 + 10 * 57


@pytest.fixture
def launch_raises(monkeypatch):
    """The eye's first kernel raises at launch, so a segment that takes the
    kernel path shows itself."""
    def refuse(*_):
        raise AssertionError("an eye kernel was launched")

    monkeypatch.setattr(eye_kernel.HIT, "launch", refuse)


def _pass(scene, slots=1, schedule=SCHEDULE, res=16):
    org, d = emit_rays(reference_camera(res, res, device="cpu"))
    return eye.eye_pass(scene, org, d, int(res * res * 1.3), slots=slots,
                        compact_schedule=schedule if slots == 1 else (), grow=True)


def test_the_kernel_path_is_taken_where_it_can_run(monkeypatch, launch_raises):
    """With the CPU standing in for the card, a staged eye at one slot, whose
    scene no gradient reaches, launches the kernels."""
    monkeypatch.setattr(eye, "_on_card", lambda x: True)
    with pytest.raises(AssertionError, match="an eye kernel was launched"):
        _pass(full(atlas_res=16, device="cpu").replace(bezier_compact_frac=0.09))


@pytest.mark.parametrize("case", ["cpu_staged", "cpu_one_slot", "two_slots", "atlas_grad"])
def test_the_op_path_is_taken_where_the_kernels_cannot_run(monkeypatch, launch_raises, case):
    """CPU tensors (the staged eye and the slot wavefront at one slot); with
    the CPU standing in for the card, the slot wavefront at two slots and
    the one-slot eye whose atlas requires grad (its gradient then reaches
    the atlas): every segment runs the op code and the pass counts no
    kernel segment."""
    scene = full(atlas_res=16, device="cpu").replace(bezier_compact_frac=0.09)
    if case in ("two_slots", "atlas_grad"):
        monkeypatch.setattr(eye, "_on_card", lambda x: True)
    if case == "two_slots":
        hp, st = _pass(scene, slots=2)
    elif case == "atlas_grad":
        atlas = scene.atlas.clone().requires_grad_(True)
        hp, st = _pass(scene.replace(atlas=atlas), schedule=())
        hp.wgt.sum().backward()
        assert float(atlas.grad.abs().sum()) > 0
    else:
        hp, st = _pass(scene, schedule=SCHEDULE if case == "cpu_staged" else ())
    assert st["eye_kernel_segments"] == 0
    assert int(st["count"]) > 0 and int(st["dropped"]) == 0


def test_render_pass_reports_the_eye_kernel_segments():
    """``render_pass`` reports ``eye_kernel_segments`` beside
    ``eye_grown_lanes``: 0 on the CPU."""
    from raytrace3_tpu_torch.render import sppm

    scene = cornell_specular(atlas_res=16, device="cpu")
    org, d = emit_rays(reference_camera(16, 16, device="cpu"))
    _, st = sppm.render_pass(scene, org, d, torch.Generator().manual_seed(0), 384, 1, 64,
                             max_depth=3, photon_regen=True, eye_compact_schedule=((1, 0.25),))
    assert st["eye_kernel_segments"] == 0 and "eye_grown_lanes" in st
