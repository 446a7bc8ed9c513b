"""Differentiable collectives over the axes of a ``RankMesh``.

The reference lets GSPMD insert whatever collectives reconcile a tensor's
layout with the layout its consumer asks for.  The port issues them
itself, at the reference's ``constrain`` sites (``models/``) and where a
parameter leaf moves between its storage block and its compute block
(``dist.sharding.gather_leaf``).  Each op runs over the process group of
the ranks that differ from this one only along ``axes``
(``RankMesh.group``); over one rank it is the identity and issues
nothing.

Gradients follow one convention: **the loss is the sum over all ranks of
each rank's loss.**  A tensor replicated over some ranks then carries, on
each of them, a part of its cotangent, and the parts sum to the true one.
Under it every op's backward is its exact transpose:

* ``all_reduce`` — forward sum, backward sum (the sum is its own
  transpose);
* ``all_gather`` along a dim — backward ``reduce_scatter`` along it;
* ``reduce_scatter`` along a dim — backward ``all_gather`` along it;
* ``all_max`` — forward max, no gradient (the vocab-parallel
  cross-entropy's shift, a constant of its logsumexp).

So the gradient of a parameter block is the sum, over every rank, of what
each rank's compute put into it — one rule for sharded, replicated and
partly replicated blocks (``dist.sharding.gather_leaf``).  The training
step weights each rank's loss by its share of the batch over the number
of ranks that replicate it (``launch.steps``).

Routes of the all-gather and the reduce-scatter (``ROUTE`` forces one):

* ``"allreduce"`` — ``gloo`` (ranks that share one card, and the CPU) has
  only ``all_reduce`` and ``broadcast`` on CUDA tensors (``dist.ranks``),
  so an all-gather is an all-reduce of a zero-filled whole buffer in which
  each rank has written its block (x + 0 = x, exact), and a reduce-scatter
  is an all-reduce followed by taking the rank's block;
* ``"native"`` — ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
  on the tensors as they are: ``nccl``, which ``dist.ranks.choose_backend``
  picks when every rank has a card of its own (unmeasured: one card).

Staging CUDA tensors through the host for gloo's own CPU all-gather and
reduce-scatter moves fewer bytes between the ranks but measured slower on
ranks sharing an H100 (``scripts/torch_collective_probe.py``), so gloo
keeps the all-reduce.

Every call counts itself in ``COUNTERS``: calls, bytes handed to the
backend and host-clock seconds, by op and axes.  Reset it just before a
run and read it just after, as the kernels' ``.launches`` counters are
read; with ``COUNTERS.synchronize`` set, each call's seconds lie between
two device synchronizes.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["COUNTERS", "ROUTE", "all_gather", "all_max", "all_reduce",
           "all_reduce_", "gather_raw", "reduce_scatter", "scatter_raw"]

# None: "native" where the backend is nccl, else "allreduce"; a route name
# forces it (the tests run the native branch on gloo's CPU ops)
ROUTE: list = [None]
# the one-tensor forms (newer PyTorch names them *_single)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Counters:
    """Calls, bytes and host-clock seconds of the collectives, keyed
    ``"<op>@<axis>+<axis>"``."""

    def __init__(self):
        self.synchronize = False
        self.reset()

    def reset(self) -> None:
        self.by: dict[str, dict] = {}

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in sorted(self.by.items())}

    def add(self, op: str, axes, nbytes: int, seconds: float) -> None:
        key = f"{op}@{'+'.join(axes)}"
        rec = self.by.setdefault(key, {"calls": 0, "bytes": 0,
                                       "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds


COUNTERS = Counters()


def _axes(mesh, axes) -> tuple[str, ...]:
    """``axes`` in the mesh's order, those of one rank dropped."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in mesh.axis_names if a in axes
                 and mesh.shape[a] > 1)


def _native(group) -> bool:
    if ROUTE[0] is not None:
        return ROUTE[0] == "native"
    return dist.get_backend(group) == "nccl"


class _Timed:
    """Counts one call of ``op`` over ``axes`` moving tensor ``t``'s bytes,
    timed on the host clock (between synchronizes of ``t``'s card when
    ``COUNTERS.synchronize``)."""

    def __init__(self, op, axes, t: torch.Tensor):
        self.key = (op, axes, t.numel() * t.element_size())
        self.dev = t.device

    def __enter__(self):
        if COUNTERS.synchronize and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if COUNTERS.synchronize and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        COUNTERS.add(*self.key, time.perf_counter() - self.t0)


# -- raw ops (no autograd) ----------------------------------------------------

def all_reduce_(t: torch.Tensor, mesh, axes, op: str = "sum"
                ) -> torch.Tensor:
    """``t`` summed (or maxed) in place over ``axes``; returns ``t``."""
    axes = _axes(mesh, axes)
    if not axes:
        return t
    with _Timed(f"all_reduce_{op}", axes, t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=mesh.group(axes))
    return t


def gather_raw(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of ``axes``' ranks concatenated along ``dim``, block
    ``i`` from the rank at flattened coordinate ``i`` along ``axes`` (in
    the order given: a ``PartitionSpec`` entry's layout)."""
    order = (axes,) if isinstance(axes, str) else tuple(axes)
    order = tuple(a for a in order if mesh.shape[a] > 1)
    if not order:
        return x
    n = mesh.axes_size(order)
    group = mesh.group(order)
    x = x.contiguous()
    shape = list(x.shape)
    shape[dim] *= n
    if _native(group) and order == _axes(mesh, order):
        # group ranks are row-major in the mesh's axis order
        buf = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        with _Timed("all_gather", order, buf):
            _ALL_GATHER(buf, x, group=group)
        return torch.cat(buf.view(n, *x.shape).unbind(0), dim=dim)
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    i = mesh.index(order)
    out.narrow(dim, i * x.shape[dim], x.shape[dim]).copy_(x)
    with _Timed("all_gather", _axes(mesh, order), out):
        dist.all_reduce(out, group=group)
    return out


def scatter_raw(x: torch.Tensor, mesh, axes, dim: int,
                also_sum=()) -> torch.Tensor:
    """``x`` summed over ``axes`` (and over ``also_sum``), this rank's
    block along ``dim`` kept (``gather_raw``'s layout)."""
    order = (axes,) if isinstance(axes, str) else tuple(axes)
    order = tuple(a for a in order if mesh.shape[a] > 1)
    extra = tuple(a for a in _axes(mesh, also_sum) if a not in order)
    if not order:
        return all_reduce_(x.clone(), mesh, extra) if extra else x
    n = mesh.axes_size(order)
    group = mesh.group(order)
    per = x.shape[dim] // n
    i = mesh.index(order)
    if _native(group) and order == _axes(mesh, order):
        if extra:
            x = all_reduce_(x.clone(), mesh, extra)
        src = torch.cat(x.split(per, dim=dim), dim=0)
        out = torch.empty((src.shape[0] // n, *src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with _Timed("reduce_scatter", order, src):
            _REDUCE_SCATTER(out, src, group=group)
        return out
    buf = x.contiguous().clone()
    union = _axes(mesh, order + extra)
    with _Timed("reduce_scatter", union, buf):
        dist.all_reduce(buf, group=mesh.group(union))
    return buf.narrow(dim, i * per, per).clone()


# -- autograd functions -------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_raw(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return scatter_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_raw(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes``' ranks; its backward sums the cotangents."""
    if not _axes(mesh, axes):
        return x
    return _AllReduce.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Concatenate ``axes``' blocks along ``dim``; backward
    reduce-scatter."""
    if not _axes(mesh, axes):
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Sum over ``axes``' ranks and keep this rank's block along ``dim``;
    backward all-gather."""
    if not _axes(mesh, axes):
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)


def all_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The largest over ``axes``' ranks, detached (no gradient)."""
    return all_reduce_(x.detach().clone(), mesh, axes, op="max")
