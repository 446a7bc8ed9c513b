"""The training step: loss and gradients (optionally over microbatches),
data-parallel reduction across ranks, optional error-feedback gradient
compression, global-norm clip, AdamW.

The port of the body of the reference's ``make_train_step``
(``launch/steps.py``).  The rest of that module (``StepBundle``, the
sharding trees, ``make_prefill_step``, ``make_serve_step``) is ``jit`` and
sharding plumbing with no counterpart on one card: PyTorch runs eagerly,
``LM.prefill``/``LM.decode_step`` (an encoder-decoder's
``EncDec.prefill_cross``/``decode_step``) are the serving steps, and the
step below takes either model and updates the parameters and the
optimizer state in place where the reference donates and returns them.

Data parallelism: where GSPMD reduces the gradients of a batch sharded
over the mesh's batch axes, each rank here computes its own rows' loss
and gradients and one ``all_reduce`` over the batch axes' process group
sums them, packed into one flat float32 buffer.  ``LM.loss`` is a masked
mean, so each rank's loss and gradients are weighted by its share of the
loss-mask count: the global mean of a batch whose masks differ by row
(a VLM's patches, an encoder-decoder's) is the reference's.  (An MoE
model's router aux loss is the count-weighted mean of the ranks' aux
losses, not one over the global batch.)

Tensor, expert and FSDP parameter sharding (a model ``LM.shard``-ed over
the ranks, ``model.layout``): the loss of each rank is weighted by its
share of the batch's count over the number of ranks that hold the same
rows, so the loss is the sum over every rank's (``dist.collectives``).
The backward then gathers and reduces each leaf through its layout: a
gradient leaves it summed over every rank that computed with the leaf and
scattered into the rank's storage block (``dist.sharding.gather_leaf``;
for a leaf stored over the batch axes this is DP's reduction too).  The
leaves replicated over batch axes are then summed over those in one flat
all-reduce a set of such axes; the count (before the backward) and the
loss (after it) are each reduced once.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..dist.collectives import all_reduce_
from ..dist.compression import (CompressionConfig, compress_stacked,
                                stack_groups)
from ..models import LM, EncDec
from ..optim.adamw import AdamWConfig, apply_updates

__all__ = ["loss_and_grads", "train_step"]


def _split(batch: dict, n: int) -> list[dict]:
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n} "
                         "microbatches")
    return [{k: v[i * (rows // n):(i + 1) * (rows // n)]
             for k, v in batch.items()} for i in range(n)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _loss_count(batch: dict) -> torch.Tensor:
    """The number of positions ``LM.loss``'s masked mean averages over."""
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.tensor(float(batch["labels"].numel()))
    return mask.detach().float().sum().cpu()


def _reduce_data_parallel(grads: dict, shapes: list, loss: torch.Tensor,
                          count: torch.Tensor, group) -> torch.Tensor:
    """Sum ``count * (grads, loss)`` and ``count`` over ``group`` in one
    all-reduce of a flat float32 buffer; replaces ``grads`` in place by
    the global count-weighted mean (views of the buffer, in the dtypes of
    ``shapes``, the parameters; a missing gradient counts as zeros) and
    returns the global loss."""
    names = list(grads)
    dev = loss.device
    c = count.to(dev, torch.float32)
    flat = torch.cat([torch.zeros(p.numel(), device=dev) if grads[n] is None
                      else grads[n].reshape(-1).float()
                      for n, p in zip(names, shapes)]
                     + [loss.reshape(1).float(), torch.ones(1, device=dev)])
    flat.mul_(c)
    dist.all_reduce(flat, group=group)
    total = flat[-1].clamp_min(1.0)
    flat.div_(total)
    at = 0
    for n, p in zip(names, shapes):
        grads[n] = flat[at:at + p.numel()].view(p.shape).to(p.dtype)
        at += p.numel()
    return flat[at].clone()


def train_step(model: LM | EncDec, opt_state: dict, batch: dict,
               opt_cfg: AdamWConfig, *, microbatches: int = 1,
               remat: bool | str = False,
               grad_compression: str = "none", err: dict | None = None,
               mesh=None, batch_axes: tuple = ()) -> dict:
    """One optimizer step on ``batch`` (tensors on the model's device).

    With ``microbatches > 1`` the batch's rows are split evenly and the
    gradients summed in float32, then averaged, as the reference's scan
    does.  With a ``mesh`` of ranks whose ``batch_axes`` span more than
    one rank, ``batch`` is this rank's rows (microbatches split them), and
    the loss and gradients are reduced to the global batch's mean before
    the update.  ``grad_compression`` ``"int8"`` or ``"topk"`` then passes
    the reduced gradients through ``compress_with_feedback`` with the
    residual ``err`` (``init_error_state``; updated in place), as the
    reference's step does before AdamW, each of the reference's stacked
    leaves (the layers of a scan slot) one tensor.  Updates ``model``'s
    parameters and ``opt_state`` in place and returns ``{"loss", "gnorm",
    "step"}`` (0-dim tensors; ``gnorm`` is the pre-clip global norm of the
    gradients AdamW takes), and ``"allreduce_s"``, the host-clock seconds
    of the gradient all-reduce between two synchronizes, where there is
    one.  The gradient all-reduce runs inside a profiler range named
    ``grad_allreduce``, the AdamW update inside one named ``adamw``.  A
    model sharded over the ranks (``model.layout``) reduces each gradient
    by its leaf's layout (see the module docstring); its ``params``,
    gradients and moments are each rank's blocks.
    """
    ccfg = CompressionConfig(scheme=grad_compression)
    if ccfg.scheme != "none" and err is None:
        raise ValueError(f"grad_compression={grad_compression!r} needs the "
                         "error-feedback state err= (init_error_state)")
    params = dict(model.named_parameters())
    loss, grads, reduce_s = loss_and_grads(
        model, batch, microbatches=microbatches, remat=remat, mesh=mesh,
        batch_axes=batch_axes)
    layout = getattr(model, "layout", None)
    if ccfg.scheme != "none":
        # per tensor as the reference's tensors are: its stacked layers
        # (over ranks: each stacked leaf's statistic over its blocks)
        grads, new_err = compress_stacked(
            grads, err, ccfg,
            stack_groups(grads, len(model.cfg.group_pattern)), layout)
        for n, e in new_err.items():
            err[n].copy_(e)
    with record_function("adamw"):
        gnorm = apply_updates(
            params, grads, opt_state, opt_cfg, decay_mask=model.decay_mask(),
            norm=None if layout is None else layout.global_norm,
            grids=None if layout is None else layout.moment_grids())
    del grads
    model.zero_grad(set_to_none=True)
    out = {"loss": loss, "gnorm": gnorm, "step": opt_state["count"]}
    if reduce_s is not None:
        out["allreduce_s"] = reduce_s
    return out


def loss_and_grads(model: LM | EncDec, batch: dict, *,
                   microbatches: int = 1, remat: bool | str = False,
                   mesh=None, batch_axes: tuple = ()
                   ) -> tuple[torch.Tensor, dict, float | None]:
    """``train_step``'s loss and gradients before compression and the
    update: (the global batch's loss, {name: gradient} (each rank's
    blocks, for a model sharded over the ranks), host-clock seconds of the
    data-parallel reduction or ``None``)."""
    if getattr(model, "layout", None) is not None:
        return _sharded_loss_and_grads(model, batch, microbatches, remat)
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    if microbatches > 1:
        gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in _split(batch, microbatches):
            loss, _ = model.loss(mb, remat=remat)
            loss.backward()
            for n, p in params.items():
                gsum[n] += p.grad.float()
                p.grad = None
            lsum += loss.detach()
        grads = {n: g.div_(microbatches) for n, g in gsum.items()}
        loss = lsum / microbatches
    else:
        loss, _ = model.loss(batch, remat=remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        loss = loss.detach()
    reduce_s = None
    if mesh is not None and mesh.axes_size(tuple(batch_axes)) > 1:
        _sync(loss.device)
        t0 = time.perf_counter()
        with record_function("grad_allreduce"):
            loss = _reduce_data_parallel(
                grads, [params[n] for n in grads], loss, _loss_count(batch),
                mesh.group(tuple(batch_axes)))
        model.zero_grad(set_to_none=True)      # the buffer holds them now
        _sync(loss.device)
        reduce_s = time.perf_counter() - t0
    return loss, grads, reduce_s


def _sharded_loss_and_grads(model: LM | EncDec, batch: dict, microbatches: int,
                            remat) -> tuple[torch.Tensor, dict, float]:
    layout = model.layout
    mesh, bax = layout.mesh, layout.batch_axes
    dev = model.device
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    count = _loss_count(batch).to(dev, torch.float32)
    total = all_reduce_(count.clone(), mesh, bax).clamp_min(1.0)
    replicas = math.prod(mesh.shape.values()) // mesh.axes_size(bax)
    share = count / total
    scale = share / replicas
    gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for n, p in params.items()}
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in _split(batch, microbatches):
        loss, _ = model.loss(mb, remat=remat)
        (loss * scale).backward()
        for n, p in params.items():
            if p.grad is not None:
                gsum[n] += p.grad.float()
                p.grad = None
        lsum += loss.detach()
    grads = {n: g.div_(microbatches) if microbatches > 1 else g
             for n, g in gsum.items()}
    # the leaves not stored over (some) batch axes: one flat sum a set
    _sync(dev)
    t0 = time.perf_counter()
    with record_function("grad_allreduce"):
        by_axes: dict[tuple, list[str]] = {}
        for n in grads:
            by_axes.setdefault(layout.dp_axes(n), []).append(n)
        for axes, names in by_axes.items():
            if not axes:
                continue
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            all_reduce_(flat, mesh, axes)
            at = 0
            for n in names:
                k = grads[n].numel()
                grads[n] = flat[at:at + k].view(grads[n].shape)
                at += k
        loss = all_reduce_(lsum / microbatches * share, mesh, bax)
    _sync(dev)
    reduce_s = time.perf_counter() - t0
    return loss, {n: g.to(params[n].dtype) for n, g in grads.items()}, \
        reduce_s
