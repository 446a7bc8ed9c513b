"""Mesh construction.

``make_production_mesh`` is the shape-only mesh of the reference's
production layouts: single pod, 256 chips as (data=16, model=16); multi
pod, 2 pods x 256 chips as (pod=2, data=16, model=16).  No process stands
behind it: the ``dist.sharding`` rules and specs are derived on it, and
nothing runs on it.

``make_host_mesh`` is a mesh over the ranks of the running
``torch.distributed`` group (a ``DeviceMesh`` wrapped as
``dist.ranks.RankMesh``), on ``"cuda"`` or ``"cpu"`` as the model's device
is — the counterpart of the reference's mesh over whatever devices exist.
Under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment) it joins
the group the environment names first.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..dist.ranks import RankMesh, ShapeMesh, init_ranks
from ..dist.sharding import _axes_size, _present

__all__ = ["check_executable", "make_host_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         shape: tuple[int, ...] | None = None,
                         axes: tuple[str, ...] | None = None) -> ShapeMesh:
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    if axes is None:
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(tuple(axes), tuple(shape))


def make_host_mesh(n: int | None = None, axes: tuple[str, ...] = ("data",),
                   *, shape: tuple[int, ...] | None = None,
                   device=None) -> RankMesh:
    """A mesh over the running group's ranks: ``(n,)`` along ``axes[0]``
    (``n`` = every rank), or ``shape`` along ``axes``.  ``device`` is the
    model's device (``None`` = the card).  Joins the group named by the
    environment when none is running."""
    dev_type = torch.device("cuda" if device is None else device).type
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "make_host_mesh needs a torch.distributed group: start the "
                "ranks with torchrun, or call dist.ranks.init_ranks first")
        init_ranks(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   device_type=dev_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (n or world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} for axes {axes}")
    if torch.Size(shape).numel() != world:
        raise ValueError(f"a mesh of {tuple(shape)} needs "
                         f"{torch.Size(shape).numel()} ranks; the group "
                         f"has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return RankMesh(init_device_mesh(dev_type, tuple(shape),
                                     mesh_dim_names=tuple(axes)))


def check_executable(scfg, mesh, *, serving: bool = False) -> None:
    """Refuse a layout the port derives but does not run: mesh axes of
    more than one rank that ``scfg`` maps to tensor parallelism (the model
    axes), expert parallelism, or FSDP parameter sharding other than over
    the batch axes (which runs replicated: DP's numbers).  Serving under
    ``kv_shard="batch_seq"`` takes the model axes for the cache's sequence
    stripes and keeps the weights whole on every rank."""
    batch = set(scfg.batch_axes(mesh))
    roles = {"model_axes": _present(scfg.model_axes, mesh),
             "expert_axes": _present(scfg.expert_axes, mesh),
             "fsdp_axes": tuple(a for a in _present(scfg.fsdp_axes, mesh)
                                if a not in batch)}
    if serving and scfg.kv_shard == "batch_seq":
        roles["model_axes"] = ()
    for role, axes in roles.items():
        if _axes_size(mesh, axes) > 1:
            raise NotImplementedError(
                f"{role}={axes} spans {_axes_size(mesh, axes)} ranks: tensor, "
                "expert and FSDP parameter sharding across ranks are derived "
                "(dist.sharding.param_specs) but not run yet (ROADMAP A6b)")
