"""The check follows a staged eye whose stage grew: a 32 x 32 pass on the
CPU with a schedule whose first stage (128 lanes, the floor of a stage's
width) is narrower than the 195 rays that survive to it, so the program
widens the stage to 256 lanes rather than drop them, and the held replay
of that pass finds no fault.  (At the other tests' 24 x 24 only 112 rays
survive to segment 1, so no stage can clip there.)"""

from benchmark.drivers import render
from benchmark.harness import inputs

from .conftest import SEED, tiny_cell

#: 1024 rays, 128 lanes from segment 1 on.
CLIPPING = [[1, 0.02]]


def test_the_check_follows_a_grown_stage():
    c, limits = tiny_cell(eye_compact_schedule=CLIPPING, width=32, height=32)
    img, stats = c.pass_fn(inputs.pass_generator(SEED, 0, c.device))
    assert stats["eye_grown_lanes"] > 0
    assert int(stats["dropped"]) == 0 and int(stats["deposits_dropped"]) == 0
    h = c.hold(SEED, 0, img)
    nums = render.numbers([h])
    assert h.faults == []
    assert nums["stage_faults"] == 0 and nums["image_replay_diff"] == 0
    assert [k for k, v in nums.items() if not v <= limits[k]] == []
