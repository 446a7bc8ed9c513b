"""Mesh construction.

``make_production_mesh`` is the shape-only mesh of the reference's
production layouts: single pod, 256 chips as (data=16, model=16); multi
pod, 2 pods x 256 chips as (pod=2, data=16, model=16).  No process stands
behind it: the ``dist.sharding`` rules and specs are derived on it, and
nothing runs on it.

``make_host_mesh`` is a mesh over the ranks of the running
``torch.distributed`` group (a ``DeviceMesh`` wrapped as
``dist.ranks.RankMesh``), on ``"cuda"`` or ``"cpu"`` as the model's device
is — the counterpart of the reference's mesh over whatever devices exist;
``make_host_mesh(n)`` with fewer ranks than the group is a mesh over its
first ``n``, as the reference's is over its first ``n`` devices (every
rank calls it; on the others ``mesh.member`` is False, and ``train_loop``
and ``serve_session`` return there at once).
Under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment) it joins
the group the environment names first.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..dist.ranks import RankMesh, ShapeMesh, init_ranks

__all__ = ["add_mesh_args", "axes_arg", "make_host_mesh",
           "make_production_mesh", "mesh_from_args"]


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
    (``n`` = every rank), or ``shape`` along ``axes``.  A mesh of fewer
    ranks than the group lies over its first ranks (each rank of the group
    must call this; ``member`` says whether this one is in it); one of
    more raises.  ``device`` is the model's device (``None`` = the card).
    Joins the group named by the environment when none is running."""
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
    size = torch.Size(shape).numel()
    if size > world:
        raise ValueError(f"a mesh of {tuple(shape)} needs {size} ranks; "
                         f"the group has {world}")
    if size < world:
        return RankMesh(ranks=torch.arange(size).reshape(tuple(shape)),
                        axis_names=tuple(axes))
    from torch.distributed.device_mesh import init_device_mesh

    return RankMesh(init_device_mesh(dev_type, tuple(shape),
                                     mesh_dim_names=tuple(axes)))


def add_mesh_args(ap) -> None:
    """The CLIs' mesh flags (``mesh_from_args``)."""
    ap.add_argument("--mesh", default="",
                    help="under torchrun: the mesh's shape over (data, "
                    "model), e.g. '1,2' (default: every rank over data)")
    ap.add_argument("--model-axes", default="",
                    help="mesh axes of tensor parallelism, e.g. 'model'")


def axes_arg(text: str) -> tuple[str, ...]:
    """``"data,model"`` -> ``("data", "model")``."""
    return tuple(a for a in text.split(",") if a)


def mesh_from_args(args, device):
    """The CLI's mesh of ranks under ``torchrun`` (``WORLD_SIZE`` > 1),
    else ``None``."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if not args.mesh:
        return make_host_mesh(device=device)
    shape = tuple(int(n) for n in args.mesh.split(","))
    return make_host_mesh(axes=("data", "model")[:len(shape)], shape=shape,
                          device=device)
