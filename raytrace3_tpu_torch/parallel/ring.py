"""Hit-point-sharded photon rounds: each round's deposits travel a ring.

Port of ``raytrace3_tpu/parallel/ring.py`` (SURVEY.md section 2, parallel
axis 3: hit points sharded over the photon axis, the renderer's analogue of
ring attention).  Each rank keeps only its shard of the hit points, C / n
records; every round its deposits visit all n ranks, one ``Mesh.shift`` a
hop, and each rank deposits every batch that passes into its own shard.  No
(C,)-sized sum is exchanged: a shard's (count, flux) increments are complete
after the rotation.  The regen walk's lanes stay on their rank; with a
backend that has ``prepare`` and ``packed_call`` (the tile deposit, kernel
#2) the shard's state lives in layout space for the whole pass and every
hop's call adds into it.

The rotation is fixed, so each shard adds the batches in the same order on
every run: the result is bit for bit reproducible for a given mesh size.
"""

from __future__ import annotations

import torch

from ..core.types import Deposits, HitPoints
from ..geometry.scene import Scene
from ..render.deposit import deposit_bruteforce
from ..render.eye import MAX_DEPTH
from ..render.sppm import RoundState, run_rounds
from .mesh import PHOTON_AXIS, Mesh


def _shift_deposits(mesh: Mesh, dep: Deposits, axis: str) -> Deposits:
    """The previous rank's deposits: the four fields travel as one
    (D, 10) message (pos | n | flux | valid as 0 or 1)."""
    packed = torch.cat([dep.pos, dep.n, dep.flux, dep.valid[:, None].to(dep.pos.dtype)], 1)
    got = mesh.shift(packed, axis)
    return Deposits(pos=got[:, 0:3], n=got[:, 3:6], flux=got[:, 6:9], valid=got[:, 9] > 0.5)


def photon_rounds_ring(scene: Scene, rng, hp_local: HitPoints, n_rounds: int,
                       local_photons: int, mesh: Mesh, max_depth: int = MAX_DEPTH,
                       update_mode: str = "sppm", deposit_fn=deposit_bruteforce,
                       newton_fn=None, deposit_compact_frac: float = 1.0,
                       debias_roulette: bool = False, regen: bool = False,
                       axis: str = PHOTON_AXIS):
    """Photon rounds over this rank's hit-point shard ``hp_local``.

    ``rng``: this rank's draws (a ``torch.Generator`` or a draws source);
    each rank traces ``local_photons`` photons a light a round, as
    ``render.sppm.photon_rounds`` traces its batch.  Every round each
    rank's batch passes every shard (own first, then the previous rank's,
    and so on round the ring); each shard adds the hops' raw increments and
    folds them in with one PPM update.  Returns (the updated shard, emitted
    per light on THIS rank, dropped deposits on this rank): the caller sums
    the emission over ``axis`` for the image normaliser (rounds x local
    photons without regen, the refill count with it).
    """
    rs = RoundState(deposit_fn, hp_local)
    state = rs.state

    def fold(dep):
        nonlocal state
        cnt, raw, ovf = rs.deposit(state, dep)
        for _ in range(mesh.size(axis) - 1):
            dep = _shift_deposits(mesh, dep, axis)
            c, r, o = rs.deposit(state, dep)
            cnt, raw, ovf = cnt + c, raw + r, ovf + o
        state = rs.update(state, cnt, rs.flux(raw), update_mode)
        return ovf

    emitted, drops = run_rounds(scene, rng, n_rounds, local_photons, fold, max_depth,
                                newton_fn, debias_roulette, regen, deposit_compact_frac)
    return rs.finish(state), emitted, drops
