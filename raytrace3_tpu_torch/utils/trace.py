"""Tracing inside the pass: named stage spans and a tally of the Bezier
compaction.

:func:`span` enters ``torch.profiler.record_function(name)`` only while a
``torch.profiler`` session records, so the span lands in the profiler's
trace beside the card's kernels, copies and fills, on the same clock.
Otherwise it returns one shared no-op context: the cost is the check.  The
pass's spans, each placed with ``with`` at its call site:

=================  ===============================================  ==========
``rt3.eye``        the eye wavefront (``sppm.render_pass``)          1 a pass
``rt3.prepare``    the deposit's ``prepare`` and the scatter into    1 a pass
                   layout space (``sppm.photon_rounds``)
``rt3.walk``       one round's photon walk and its deposit           1 a round
                   compaction (``sppm.run_rounds``)
``rt3.fold``       one round's deposit, flux, optional sum over      1 a round
                   ranks and PPM update (``sppm.run_rounds``)
``rt3.estimate``   the pixel estimate (``sppm.render_pass``)         1 a pass
=================  ===============================================  ==========

:func:`bezier_tally` opens a tally for one pass.  While it is open, each
compacted Bezier call keeps its gated-ray count on the device, with no host
read, in a slot the tally hands out (:meth:`BezierTally.slot`): the op
code's (``geometry.bezier.solve_gated``) writes one search of the
compaction's sorted key there (:meth:`BezierTally.add`), the card's
segment kernels (``ops.walk_kernel.WalkScene.solve``) their compaction's
count (:func:`bezier_count_slot`).  :meth:`BezierTally.fold` folds the
counts into the pass's stats:

* ``bezier_overflow``: sum of max(gated - lanes, 0), the gated rays that
  found no lane and were read as misses;
* ``bezier_lanes_used``: sum of min(gated, lanes);
* ``bezier_lanes``: sum of the lanes.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

#: The counters :meth:`BezierTally.fold` returns.
BEZIER_COUNTERS = ("bezier_overflow", "bezier_lanes_used", "bezier_lanes")

_OFF = contextlib.nullcontext()
_TALLY: contextvars.ContextVar = contextvars.ContextVar("rt3_bezier_tally", default=None)


def span(name: str):
    """A context that records ``name`` as a span while a profiler records,
    and does nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class BezierTally:
    """One pass's counts of the Bezier compaction, kept on the device.

    Each count is written straight into a slot of an int32 buffer (one
    launch a compacted call, nothing to stack at the end); the buffer
    grows by :data:`CHUNK` slots when full."""

    #: Slots a buffer chunk holds (a pass compacts (depth + 1) x (rounds + 1)
    #: times at most).
    CHUNK = 1024

    def __init__(self):
        self.lanes = []
        self._chunks = []
        self._one = None

    def slot(self, lanes: int, device) -> torch.Tensor:
        """The (1,) int32 slot, on ``device``, that one compaction into
        ``lanes`` lanes writes its whole gated count into."""
        i = len(self.lanes) % self.CHUNK
        if i == 0:
            self._chunks.append(torch.empty(self.CHUNK, dtype=torch.int32, device=device))
        self.lanes.append(lanes)
        return self._chunks[-1][i:i + 1]

    def add(self, sorted_key: torch.Tensor, lanes: int) -> None:
        """Count the gated rays of a compaction into ``lanes`` lanes from
        its ascending key (0 for a gated ray, 1 otherwise)."""
        if self._one is None:
            self._one = torch.ones(1, dtype=torch.int32, device=sorted_key.device)
        torch.searchsorted(sorted_key, self._one, out_int32=True,
                           out=self.slot(lanes, sorted_key.device))

    def fold(self, device) -> dict:
        """The counts as :data:`BEZIER_COUNTERS`, int32 device scalars (a
        pass compacts a few hundred times, each into at most a few million
        lanes), in 6 calls on the card: the lanes' copy, through pinned
        memory so that the host does not wait, and 5 int32 kernels."""
        device = torch.device(device)
        n = len(self.lanes)
        if not n:
            z = torch.zeros(3, dtype=torch.int32, device=device)
            return dict(zip(BEZIER_COUNTERS, z.unbind()))
        gated = (self._chunks[0] if len(self._chunks) == 1 else torch.cat(self._chunks))[:n]
        lanes = torch.tensor(self.lanes, dtype=torch.int32)
        if device.type == "cuda":
            lanes = lanes.pin_memory().to(device, non_blocking=True)
        used = torch.minimum(gated, lanes).sum(dtype=torch.int32)
        return {"bezier_overflow": gated.sum(dtype=torch.int32) - used,
                "bezier_lanes_used": used, "bezier_lanes": lanes.sum(dtype=torch.int32)}


@contextlib.contextmanager
def bezier_tally():
    """Open a :class:`BezierTally` for the block and yield it."""
    tally = BezierTally()
    token = _TALLY.set(tally)
    try:
        yield tally
    finally:
        _TALLY.reset(token)


def bezier_count_slot(lanes: int, device) -> torch.Tensor | None:
    """The open tally's slot for a compaction into ``lanes`` lanes
    (:meth:`BezierTally.slot`), or None with no tally open."""
    tally = _TALLY.get()
    return None if tally is None else tally.slot(lanes, device)


def count_bezier_compaction(sorted_key: torch.Tensor, lanes: int) -> None:
    """Add a compaction into ``lanes`` lanes, ranked by ``sorted_key``
    (``ops.compact.compact_indices_keyed``), to the open tally, if any."""
    tally = _TALLY.get()
    if tally is not None:
        tally.add(sorted_key, lanes)
