"""The trace arithmetic and each per-layer metric's reader, on a small
synthetic trace whose numbers are counted by hand."""

import pytest

from benchmark.harness import profile, spec

#: Two passes over 0-200 us; device work 15-30, 45-60 and 50-70 (merged
#: 45-70), 150-160: busy 15 + 25 + 10 = 50 us.
RECORDS = [
    ("bench.pass", "cpu", 0, 100), ("bench.pass", "cpu", 100, 200),
    ("aten::add", "cpu", 5, 20), ("cudaLaunchKernel", "runtime", 10, 12),
    ("k1", "device", 15, 30), ("cudaLaunchKernel", "runtime", 40, 42),
    ("(anonymous namespace)::newton_kernel(float const*)", "device", 45, 60),
    ("(anonymous namespace)::deposit_tile_kernel(int const*)", "device", 50, 70),
    ("cudaMemsetAsync", "runtime", 140, 141), ("Memset (Device)", "device", 150, 160),
    ("aten::mul", "cpu", 80, 190), ("cudaLaunchKernel", "runtime", 250, 251),
]


def layer():
    s = profile.summarize(RECORDS)
    s.update(peak_bytes=3 * 2 ** 30, config={"newton_restarts": 8, "newton_iters": 10},
             work={"newton": [(1000, 100, 32)], "deposit": [(10 ** 6, 1000, 20000)]})
    return s


def test_summary_by_hand():
    s = profile.summarize(RECORDS)
    assert s["passes"] == 2
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["runtime_calls"] == 3            # the call at 250 us is outside
    assert s["device_events"] == 4
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 0-15 under aten::add; 30-45 under nothing; 70-150 and 160-200 under aten::mul.
    assert gaps["aten::add"] == pytest.approx(15e-6)
    assert gaps["host: no operation"] == pytest.approx(15e-6)
    assert gaps["aten::mul"] == pytest.approx(120e-6)
    assert profile.kernel_seconds(s, "newton_kernel") == pytest.approx(15e-6)


def test_a_trace_without_the_pass_span_is_refused():
    with pytest.raises(ValueError):
        profile.summarize([("k1", "device", 0, 1)])


@pytest.mark.parametrize("name,want", [
    ("launch_calls_per_pass.render", 1.5),
    ("idle_share.render", 75.0),
    ("peak_mem_gib.render", 3.0),
    # 1000 pairs x 8 x (135 + 10 x 491) flops over 67e12/s vs 15 us.
    ("newton_roofline.render", 100 * 1000 * 8 * (135 + 4910) / 67e12 / 15e-6),
    # max(1e6 x 19 / 67e12, (1000 x 44 + 20000 x 37) / 3.35e12) over 20 us:
    # the operations bind.
    ("tile_deposit_roofline.render", 100 * 10 ** 6 * 19 / 67e12 / 20e-6),
])
def test_readers(name, want):
    assert spec.reader(name)(layer()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["launch_calls_per_pass.render", "idle_share.render",
                                  "peak_mem_gib.render", "newton_roofline.render",
                                  "tile_deposit_roofline.render"])
def test_readers_return_nothing_without_data(name):
    assert spec.reader(name)({}) is None
    if "roofline" in name:
        s = layer()
        s["kernel_s"] = {}
        assert spec.reader(name)(s) is None
