"""The renderer's parallel axes on ``torch.distributed``: a (pass, photon)
mesh of processes and the collectives along each axis.

Port of ``raytrace3_tpu/parallel/mesh.py``.  The JAX package lays a device
mesh out and lets XLA insert the collectives from ``shard_map`` specs; here
every process is one rank of the mesh and calls the collectives itself:

  * ``pass``   - independent jittered SPPM passes (the reference's OpenMP
                 pass loop, Raytracer.h:442-458): the canvases are summed;
  * ``photon`` - eye rays and photons sharded within a pass: hit points are
                 all-gathered (or rotated, ``parallel/ring.py``) and each
                 round's deposits summed.

Rank r sits at pass index ``r // n_photon`` and photon index ``r %
n_photon``, JAX's ``devices.reshape(n_pass, n_photon)``.  NCCL carries CUDA
tensors and gloo CPU tensors.  NCCL refuses two ranks on one card; a caller
that puts several ranks on one card picks ``backend="gloo"`` itself, and
the mesh then stages each collective of CUDA tensors through host memory
and says so when it is made.  Nothing falls back from one backend to the
other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

PASS_AXIS = "pass"
PHOTON_AXIS = "photon"
AXES = (PASS_AXIS, PHOTON_AXIS)


def multihost_init(backend: str | None = None, device=None) -> None:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); nothing in a single
    process without that environment (the mesh is then 1 x 1) or when the
    group exists already.  ``backend`` defaults to NCCL for a rank on the
    card and gloo on the CPU."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    dist.init_process_group(default_backend(device) if backend is None else backend,
                            init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))


def default_backend(device=None) -> str:
    """NCCL for ranks on the card (``device``, default the card), gloo for
    CPU ranks."""
    return "nccl" if rank_device(device).type == "cuda" else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` (default the card), and for a card
    given without an index, card ``LOCAL_RANK % cards``.  Raises for a card
    when there is none."""
    from ..core.device import DEFAULT_DEVICE, resolve_device

    dev = resolve_device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


@dataclass
class Mesh:
    """This rank's place in an ``n_pass`` x ``n_photon`` mesh and the
    process group of each axis it belongs to (None for an axis of one
    rank).  The collectives act along one axis, or along several in turn."""

    n_pass: int
    n_photon: int
    rank: int
    device: torch.device
    groups: dict = field(default_factory=dict)
    ranks: dict = field(default_factory=dict)
    staged: bool = False

    @property
    def shape(self) -> dict:
        return {PASS_AXIS: self.n_pass, PHOTON_AXIS: self.n_photon}

    @property
    def pass_index(self) -> int:
        return self.rank // self.n_photon

    @property
    def photon_index(self) -> int:
        return self.rank % self.n_photon

    def index(self, axis: str) -> int:
        return self.pass_index if axis == PASS_AXIS else self.photon_index

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def _host(self, x: torch.Tensor, copy: bool = False) -> torch.Tensor:
        """``x`` where the backend reads it: on the host when staged; a
        copy when the collective writes into it."""
        if self.staged:
            return x.cpu() if x.is_cuda else x.clone()
        return x.clone(memory_format=torch.contiguous_format) if copy else x.contiguous()

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device) if self.staged else h

    def all_reduce(self, x: torch.Tensor, axes=PHOTON_AXIS) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes`` (an axis name or
        a tuple of them): JAX's ``psum``.  Returns a new tensor, or ``x``
        itself when every axis has one rank."""
        for axis in (axes,) if isinstance(axes, str) else axes:
            if self.size(axis) > 1:
                h = self._host(x, copy=True)
                dist.all_reduce(h, group=self.groups[axis])
                x = self._back(h, x)
        return x

    def all_gather(self, x: torch.Tensor, axis: str = PHOTON_AXIS) -> torch.Tensor:
        """The ranks' ``x`` along ``axis``, concatenated on dim 0 in axis
        order: JAX's ``all_gather(tiled=True)``."""
        n = self.size(axis)
        if n == 1:
            return x
        h = self._host(x)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=self.groups[axis])
        return self._back(torch.cat(parts), x)

    def reduce_scatter(self, x: torch.Tensor, axis: str = PHOTON_AXIS) -> torch.Tensor:
        """This rank's part of the sum of ``x`` over the ranks along
        ``axis``: dim 0 cut into as many equal parts as the axis has ranks,
        part i summed onto rank i (JAX's ``psum_scatter(tiled=True)``, the
        transpose of :meth:`all_gather`).  Raises ``ValueError`` when the
        ranks do not divide dim 0."""
        n = self.size(axis)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not cut into {n} parts")
        h = self._host(x).contiguous()
        out = h.new_empty((x.shape[0] // n, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, h, group=self.groups[axis])
        return self._back(out, x)

    def shift(self, x: torch.Tensor, axis: str = PHOTON_AXIS) -> torch.Tensor:
        """``x`` of the previous rank along ``axis``, this rank's ``x`` going
        to the next: JAX's ``ppermute`` by ``(i, i + 1 mod n)``."""
        n = self.size(axis)
        if n == 1:
            return x
        i, peers = self.index(axis), self.ranks[axis]
        h = self._host(x)
        out = torch.empty_like(h)
        ops = [dist.P2POp(dist.isend, h, peers[(i + 1) % n], group=self.groups[axis]),
               dist.P2POp(dist.irecv, out, peers[(i - 1) % n], group=self.groups[axis])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out, x)

    def all_reduce_grad(self, x: torch.Tensor, axes=PHOTON_AXIS) -> torch.Tensor:
        """:meth:`all_reduce` that autograd traces; its backward sums the
        gradient over the same ranks (the transpose JAX's ``shard_map``
        with ``check_vma=False`` takes for ``psum``)."""
        return _AllReduce.apply(x, self, axes)

    def all_gather_grad(self, x: torch.Tensor, axis: str = PHOTON_AXIS) -> torch.Tensor:
        """:meth:`all_gather` that autograd traces; its backward hands each
        rank the sum over the axis of the gradient of its own part by
        :meth:`reduce_scatter` (JAX's transpose, ``psum_scatter``)."""
        return _AllGather.apply(x, self, axis)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(x, axes).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(x, axis).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axis), None, None


def mesh_shape(n_pass: int | None, n_photon: int | None, world: int) -> tuple[int, int]:
    """(n_pass, n_photon) of a mesh over ``world`` ranks: with only one
    count given, the other absorbs the remaining ranks; with neither, every
    rank is on the photon axis (JAX's defaults).  Raises ``ValueError``
    when the counts do not multiply to ``world``."""
    if n_pass is None and n_photon is None:
        n_pass, n_photon = 1, world
    elif n_pass is None:
        n_pass = world // n_photon
    elif n_photon is None:
        n_photon = world // n_pass
    if n_pass * n_photon != world:
        raise ValueError(f"mesh {n_pass}x{n_photon} != {world} ranks")
    return n_pass, n_photon


def make_mesh(n_pass: int | None = None, n_photon: int | None = None,
              world: int | None = None, device=None) -> Mesh:
    """This rank's (pass, photon) mesh over ``world`` ranks (default: the
    process group's size, or 1 without one), shaped by :func:`mesh_shape`.

    Every rank must call it, in the same order as its other group calls:
    it makes one process group per row of each axis.  ``device``: this
    rank's device (:func:`rank_device`).
    """
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    n_pass, n_photon = mesh_shape(n_pass, n_photon, world)
    if world > 1 and not (dist.is_initialized() and dist.get_world_size() == world):
        raise ValueError(f"a mesh of {world} ranks needs a process group of that size")
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)                  # NCCL's communicators use it
    mesh = Mesh(n_pass, n_photon, rank, device)
    rows = {PHOTON_AXIS: [[p * n_photon + f for f in range(n_photon)] for p in range(n_pass)],
            PASS_AXIS: [[p * n_photon + f for p in range(n_pass)] for f in range(n_photon)]}
    for axis in (PHOTON_AXIS, PASS_AXIS):
        if mesh.size(axis) == 1:
            continue
        for ranks in rows[axis]:
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axis], mesh.ranks[axis] = group, ranks
    if world > 1:
        backend = dist.get_backend()
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the NCCL backend carries CUDA tensors: a CPU rank needs gloo")
        if backend == "nccl":
            # NCCL sets a group's communicator up at its first collective:
            # do it here, not inside the first pass.
            for axis in mesh.groups:
                mesh.all_reduce(torch.zeros(1, device=device), axis)
        mesh.staged = backend == "gloo" and device.type == "cuda"
        if mesh.staged and rank == 0:
            print(f"raytrace3_tpu_torch.parallel: gloo with CUDA tensors: every collective "
                  f"of the {n_pass}x{n_photon} mesh is staged through host memory", flush=True)
    return mesh
