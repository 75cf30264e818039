"""Work counts: by hand on small inputs, and independent of how the
deposit kernel tiles and chunks its work."""

import torch

from benchmark.reference import render_ref as ref
from benchmark.work import least_seconds, newton, tile_deposit

from .conftest import SEED, tiny_cell


def test_deposit_pairs_by_hand():
    # Two hit points with normal +y: at the origin with r2 = 1, and at
    # (0.5, 0, 0) with r2 = 0.25.  Deposits 0 and 1, at (0, 0, 0) and
    # (1, 0, 0), fall inside both radii (d2 = 0 and 1; 0.25 and 0.25);
    # deposit 2 faces the other way; deposit 3 is outside both.
    up = torch.tensor([0.0, 1.0, 0.0])
    h_pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    h_n = up.expand(2, 3)
    r2 = torch.tensor([1.0, 0.25])
    d_pos = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [0.1, 0, 0], [3.0, 0, 0]])
    d_n = torch.stack([up, up, -up, up])
    flux = torch.tensor([[1.0, 2, 3], [10, 20, 30], [100, 0, 0], [5, 5, 5]])
    cnt, raw, inside = ref.deposit(h_pos, h_n, r2, d_pos, d_n, flux, torch.ones(4, dtype=torch.bool))
    assert cnt.tolist() == [2.0, 2.0] and inside == 4
    assert raw.tolist() == [[11.0, 22.0, 33.0], [11.0, 22.0, 33.0]]
    flops, nbytes = tile_deposit.work([(inside, 2, 4)])
    assert flops == 4 * 19 and nbytes == 2 * 44 + 4 * 37


def test_newton_work_by_hand():
    flops, nbytes = newton.work([(3, 2, 32), (1, 1, 32)], restarts=8, iters=10)
    assert flops == 4 * 8 * (135 + 10 * 491)
    assert nbytes == 3 * 41 + 2 * 32 * 192
    assert least_seconds(67e12, 0.0) == (1.0, "compute")
    assert least_seconds(0.0, 3.35e12) == (1.0, "memory")


def test_counts_do_not_depend_on_the_deposit_tiling():
    """The same held pass under two tile / chunk settings of the deposit
    kernel records the same work, and each setting holds."""
    works = []
    for tile, chunk in ((256, 2048), (128, 512)):
        c, limits = tiny_cell(deposit={"kind": "tile", "tile": tile, "chunk": chunk,
                                       "bucket2d": False})
        h = c.hold(SEED, 0, None)
        assert not h.faults and h.slots[0] == 0
        works.append(h.work)
    assert works[0] == works[1]
    assert sum(p for p, _, _ in works[0]["deposit"]) > 0
    assert sum(p for p, _, _ in works[0]["newton"]) > 0
