"""Meshes of ranks: the port's counterpart of the reference's device mesh.

The reference lays a JAX mesh over devices and lets ``shard_map`` and
GSPMD move data between them.  The port lays a mesh over **ranks**:
processes joined by ``torch.distributed``, each holding only its own part
of every tensor.  Two kinds of mesh carry the same axis names and sizes,
which is all the rules table (``dist.sharding.MeshRules``) reads:

* ``ShapeMesh`` — names and sizes only, no processes (the production
  (16, 16) and (2, 16, 16) meshes whose specs are derived, never run);
* ``RankMesh`` — a ``torch.distributed.device_mesh.DeviceMesh`` over the
  running group, with this rank's coordinate along every axis and a
  process group for every set of axes a collective runs over.  Groups over
  two or more axes (the sequence stripes of ``kv_shard="seq"`` on a
  ("pod", "data") mesh) are built with ``dist.new_group`` on every rank,
  in the same order, when the mesh is made.  A mesh over the first ``n``
  ranks of a larger group (an elastic shrink) builds every group so; a
  rank outside it is not a ``member`` and takes no part.

The port's collectives are ``dist.all_reduce`` (SUM and MAX) and
``dist.broadcast`` only: ``gloo``, the backend of ranks that share one
card (and of the CPU), has no CUDA ``all_gather``, and it takes CUDA
tensors for these two directly, with no staging through the host in the
port (the H100 runs of ``chip_smoke.py`` call both on CUDA tensors).
"""

from __future__ import annotations

import datetime
import itertools
import logging
import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = ["RankMesh", "ShapeMesh", "axis_sizes", "choose_backend",
           "init_ranks"]

log = logging.getLogger("repro_torch.dist")

# a collective that waits longer than this on a missing rank fails instead
# of hanging (the ranks of one test or one chip phase)
DEFAULT_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class ShapeMesh:
    """A mesh of axis names and sizes with no processes behind it.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does, so a spec derived here can be held against the reference's."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    shape: dict = field(init=False, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        object.__setattr__(self, "shape",
                           dict(zip(self.axis_names, self.sizes)))


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``ShapeMesh``, a ``RankMesh`` or any mesh with
    ``axis_names`` and a ``shape`` map (a JAX mesh's)."""
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


class RankMesh:
    """A mesh of ranks: this rank's coordinate along each axis and a
    process group for every non-empty set of axes (in the mesh's axis
    order).

    ``device_mesh`` is a ``DeviceMesh`` over the whole running group.
    ``ranks`` (a tensor of global ranks in the mesh's shape) with
    ``axis_names`` is a mesh over part of the group, as
    ``launch.mesh.make_host_mesh(n)`` lays one over the first ``n`` ranks;
    every rank of the group builds it (``dist.new_group`` needs them all),
    and on a rank outside it ``member`` is False, ``coords`` is ``None``
    and no group is kept: the entry points return at once there."""

    def __init__(self, device_mesh=None, *, ranks: torch.Tensor | None = None,
                 axis_names: tuple[str, ...] | None = None):
        self.device_mesh = device_mesh
        if device_mesh is not None:
            ranks = device_mesh.mesh
            axis_names = device_mesh.mesh_dim_names
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        me = dist.get_rank()
        where = (ranks == me).nonzero().tolist()
        self.member = bool(where)
        self.coords = (dict(zip(self.axis_names, where[0])) if self.member
                       else None)
        self._groups: dict[tuple[str, ...], object] = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                if n == 1 and device_mesh is not None:
                    self._groups[axes] = device_mesh.get_group(axes[0])
                    continue
                # every rank calls new_group for every row, in one order
                dims = [self.axis_names.index(a) for a in axes]
                rest = [d for d in range(ranks.dim()) if d not in dims]
                rows = ranks.permute(*rest, *dims).reshape(
                    -1, math.prod(self.shape[a] for a in axes))
                for row in rows.tolist():
                    g = dist.new_group(row)
                    if me in row:
                        self._groups[axes] = g

    @property
    def size(self) -> int:
        """The mesh's rank count."""
        return self.axes_size(self.axis_names)

    @property
    def rank(self) -> int:
        """This rank's place in the mesh (its flattened coordinate)."""
        return self.index(self.axis_names)

    def all_group(self):
        """The process group of every rank of the mesh."""
        return self.group(self.axis_names)

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's flattened coordinate along ``axes``, row-major in
        the order given (the order of a ``PartitionSpec`` entry)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes``."""
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(tuple(axes)):
            raise ValueError(f"axes {tuple(axes)} not all in mesh "
                             f"{self.axis_names}")
        return self._groups[key]


def choose_backend(world_size: int, device_type: str,
                   backend: str | None = None) -> str:
    """``backend`` when given; else ``nccl`` only when every rank has a
    card of its own, ``gloo`` otherwise (the CPU, and ranks sharing one
    card: NCCL refuses two ranks on one device)."""
    if backend is not None:
        return backend
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_ranks(rank: int, world_size: int, *, init_method: str | None = None,
               device_type: str = "cuda", backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join (or start) the process group; returns the backend chosen.

    ``init_method`` is a ``file://`` or ``tcp://`` address; ``None`` reads
    the group from the environment (``MASTER_ADDR``/``MASTER_PORT``, as
    ``torchrun`` sets them).  On the CPU the rank runs one thread (many
    ranks share the machine's cores).  On the card each rank selects card
    ``LOCAL_RANK`` (or ``rank``) modulo the cards present before the
    group starts, so ranks beyond the card count share the
    cards."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    elif device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    chosen = choose_backend(world_size, device_type, backend)
    dist.init_process_group(
        chosen, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info(f"rank {rank}/{world_size}: backend {chosen} on {device_type}")
    return chosen
