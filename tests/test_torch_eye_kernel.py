"""The staged eye's segment kernels (``ops/eye_kernel.py``, ``csrc/eye.cu``)
as far as the CPU can hold them: the ctypes structures against the sources,
the byte counts behind the kernels' bounds against the segment's tensors,
where the eye's and the regen photon walk's segments take the kernel path
(``ops/walk_kernel.kernel_tables``, the rule both share) and where the rule
refuses card lanes the kernels cannot take.  The kernels
themselves run in tests/test_torch_cuda.py and ``chip_smoke.py`` phases
24-25.

The dispatch tests stand the CPU in for the card (``walk_kernel.on_card``)
and make each walk's first kernel's launch raise, so a segment that would
take the kernel path shows itself.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from raytrace3_tpu_torch.geometry.sphere import make_spheres
from raytrace3_tpu_torch.ops import eye_kernel, walk_kernel
from raytrace3_tpu_torch.render import eye, photon
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

    tables = walk_kernel.WalkScene(scene, fetch.table, scene.light_pos, scene.light_color)
    w = eye_kernel.SegmentLanes(tables, lanes)
    handed = size((w.t_a, w.obj_a, w.ins_a, w.gate, w.rows))
    split = eye_kernel.eye_kernel_bytes(N, 0, 0)
    assert split["eye_hit"] == size(lanes[:2]) + handed
    assert split["eye_shade"] == lanes_in + handed + out
    assert split["eye_bezier"] == 0
    assert eye_kernel.eye_kernel_bytes(N, 16, 10)["eye_bezier"] == 16 * 8 + 10 * 57


@pytest.fixture
def launch_raises(monkeypatch):
    """The eye's and the photon walk's first kernels raise at launch, so a
    segment that takes the kernel path shows itself."""
    for kernel in (eye_kernel.HIT, walk_kernel.REFILL):
        def refuse(*_, name=kernel.name):
            raise AssertionError(f"{name} was launched")

        monkeypatch.setattr(kernel, "launch", refuse)


def _scene():
    return full(atlas_res=16, device="cpu").replace(bezier_compact_frac=0.09)


def _pass(scene, slots=1, schedule=SCHEDULE, res=16):
    org, d = emit_rays(reference_camera(res, res, device="cpu"))
    return eye.eye_pass(scene, org, d, int(res * res * 1.3), slots=slots,
                        compact_schedule=schedule if slots == 1 else ())


def _round(scene, light_color=None, state=None):
    """A regen photon round of 256 photons, 4 segments: (deposits, state,
    emitted)."""
    lc = scene.light_color if light_color is None else light_color
    return photon.photon_trace_regen(scene, torch.Generator().manual_seed(1), scene.light_pos,
                                     lc, 256, state, 3)


@pytest.mark.parametrize("walk", ["eye", "photon"])
def test_the_kernel_path_is_taken_where_it_can_run(monkeypatch, launch_raises, walk):
    """With the CPU standing in for the card, a staged eye at one slot and a
    regen photon round, whose scene and lights no gradient reaches, launch
    their kernels."""
    monkeypatch.setattr(walk_kernel, "on_card", lambda x: True)
    first = "eye_hit" if walk == "eye" else "walk_refill"
    with pytest.raises(AssertionError, match=f"{first} was launched"):
        (_pass if walk == "eye" else _round)(_scene())


@pytest.mark.parametrize("case", ["cpu_staged", "cpu_one_slot", "two_slots", "atlas_grad",
                                  "photon_cpu", "photon_grad"])
def test_the_op_path_is_taken_where_the_kernels_cannot_run(monkeypatch, launch_raises, case):
    """CPU tensors (the staged eye, the slot wavefront at one slot and a
    regen photon round); with the CPU standing in for the card, the slot
    wavefront at two slots, the one-slot eye whose atlas requires grad and
    the photon round whose light colour does (their gradients then reach
    them): every segment runs the op code, and an eye pass counts no kernel
    segment."""
    if case not in ("cpu_staged", "cpu_one_slot", "photon_cpu"):
        monkeypatch.setattr(walk_kernel, "on_card", lambda x: True)
    if case.startswith("photon"):
        scene = _scene()
        lc = scene.light_color.clone().requires_grad_(case == "photon_grad")
        dep, _, _ = _round(scene, lc)
        if case == "photon_grad":
            dep.flux[dep.valid].sum().backward()
            assert float(lc.grad.abs().sum()) > 0
        assert int(dep.valid.sum()) > 256
        return
    scene = _scene()
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


@pytest.mark.parametrize("what", ["float64", "no_sphere"])
@pytest.mark.parametrize("walk", ["eye", "photon"])
def test_card_lanes_the_kernels_cannot_take_raise(monkeypatch, launch_raises, walk, what):
    """With the CPU standing in for the card, the staged eye and a regen
    photon round from float64 lanes, or in a scene without a sphere, have
    no kernel path and no gradient to keep: the rule raises ValueError
    rather than run the op code on the card."""
    monkeypatch.setattr(walk_kernel, "on_card", lambda x: True)
    scene = cornell_specular(atlas_res=16, device="cpu")
    state = None
    if what == "no_sphere":
        scene = scene.replace(spheres=make_spheres(torch.zeros((0, 3)), torch.zeros((0,))))
    elif walk == "photon":
        state = tuple(x.double() if x.is_floating_point() else x
                      for x in photon.regen_state_init(1, 256))
    with pytest.raises(ValueError, match="float32 lanes and a scene with a plane and a sphere"):
        if walk == "photon":
            _round(scene, state=state)
        else:
            org, d = emit_rays(reference_camera(16, 16, device="cpu"))
            if what == "float64":
                org, d = org.double(), d.double()
            eye.eye_pass(scene, org, d, 16 * 16 * 2, compact_schedule=SCHEDULE)


def test_render_pass_reports_the_eye_kernel_segments():
    """``render_pass`` reports ``eye_kernel_segments`` beside
    ``eye_grown_lanes``: 0 on the CPU."""
    from raytrace3_tpu_torch.render import sppm

    scene = cornell_specular(atlas_res=16, device="cpu")
    org, d = emit_rays(reference_camera(16, 16, device="cpu"))
    _, st = sppm.render_pass(scene, org, d, torch.Generator().manual_seed(0), 384, 1, 64,
                             max_depth=3, photon_regen=True, eye_compact_schedule=((1, 0.25),))
    assert st["eye_kernel_segments"] == 0 and "eye_grown_lanes" in st
