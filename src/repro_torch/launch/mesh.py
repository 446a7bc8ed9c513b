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

__all__ = ["add_mesh_args", "axes_arg", "check_executable",
           "make_host_mesh", "make_production_mesh", "mesh_from_args"]


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


def check_executable(scfg, mesh, *, serving: bool = False, model=None,
                     moments_dtype: str = "float32") -> None:
    """Refuse, naming ROADMAP A6c, the layouts the port derives but does
    not run; every other layout of ``scfg`` on a decoder ``LM`` runs
    (tensor, expert and FSDP parameter sharding: ``LM.shard``).  Refused
    where the mesh gives the role more than one rank:

    * RWKV-6 layers under the model axes (the ``heads`` rule reaches the
      time mix's r/k/v, which would put B8/B9 on per-rank heads);
    * ``mamba_tp=True`` with mamba layers under the model axes (B6/B7 on
      per-rank channels);
    * an encoder-decoder under the model or expert axes or FSDP over other
      than the batch axes (FSDP over the batch axes keeps its parameters
      whole on every rank: data parallelism's numbers);
    * ``grad_compression`` with a parameter leaf sharded over ranks (the
      reference's stacked leaves are compressed whole);
    * int8 moments where a leaf is sharded along its last axis into blocks
      of other than whole multiples of ``adamw.BLOCK`` (the quantization
      blocks would straddle the ranks).

    Serving under ``kv_shard="batch_seq"`` takes the model axes for the
    cache's sequence stripes and keeps the weights whole on every rank."""
    from ..dist.sharding import _entry_axes, param_specs
    from ..optim.adamw import BLOCK

    batch = set(scfg.batch_axes(mesh))
    model_axes = _present(scfg.model_axes, mesh)
    if serving and scfg.kv_shard == "batch_seq":
        model_axes = ()
    tp = _axes_size(mesh, model_axes) > 1
    ep = _axes_size(mesh, _present(scfg.expert_axes, mesh)) > 1
    fsdp = _present(scfg.fsdp_axes, mesh)
    fsdp_other = _axes_size(mesh, tuple(a for a in fsdp
                                        if a not in batch)) > 1
    sharded = tp or ep or _axes_size(mesh, fsdp) > 1

    def refuse(what: str):
        raise NotImplementedError(
            f"{what} on mesh {dict(mesh.shape)}: not run by the port yet "
            "(ROADMAP A6c)")

    if not serving and scfg.grad_compression != "none" and sharded:
        refuse(f"grad_compression={scfg.grad_compression!r} with parameter "
               "leaves sharded over ranks")
    if model is None:
        return
    cfg = model.cfg
    if cfg.encdec:
        if tp or ep or fsdp_other:
            refuse("an encoder-decoder under model, expert or non-batch "
                   "FSDP axes")
        return
    if tp and "rwkv" in cfg.layer_kinds:
        refuse(f"RWKV-6 layers under model axes {model_axes}")
    if tp and scfg.mamba_tp and "mamba" in cfg.layer_kinds:
        refuse("mamba_tp=True")
    if serving or moments_dtype != "int8" or not sharded:
        return
    params = dict(model.named_parameters())
    for name, spec in param_specs(params, mesh, scfg).items():
        n = _axes_size(mesh, _entry_axes(spec[-1])) if spec else 1
        if n > 1 and (params[name].shape[-1] // n) % BLOCK:
            refuse(f"int8 moments of {name} {tuple(params[name].shape)} "
                   f"sharded {spec}")
