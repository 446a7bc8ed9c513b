"""The training step: loss and gradients (optionally over microbatches),
data-parallel reduction across ranks, optional error-feedback gradient
compression, global-norm clip, AdamW; and the step builders.

The port of the reference's ``launch/steps.py``.  PyTorch runs eagerly, so
where the reference binds a jitted function to sharding trees, a builder
here (``make_train_step``, ``make_prefill_step``, ``make_serve_step``)
returns a ``StepBundle``: ``fn``, the eager step on real tensors
(``train_step``, ``LM.prefill``/``EncDec.prefill_cross``,
``decode_step``); the rules it runs under; and ``in_specs``, its
arguments on the **meta** device (the model sharded over the mesh's ranks
as the run would shard it, its state and this rank's rows of the batch).
``StepBundle.dry_run()`` runs the step on them (``launch.meta_trace``):
what takes the place of the reference's ``.lower().compile()``.  The
step updates the parameters and the optimizer state in place where the
reference donates and returns them.

Reads of a value on the host that a meta tensor cannot serve take it from
the shape: ``_loss_count`` counts every position of a meta ``loss_mask``,
and a meta ``pos`` of ``make_serve_step`` is the cache's last position
(``max_len - 1``, the step that reads the whole cache).

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
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.profiler import record_function

from ..dist.api import use_rules
from ..dist.collectives import all_reduce_
from ..dist.compression import (CompressionConfig, compress_stacked,
                                init_error_state, stack_groups)
from ..dist.ranks import RankMesh
from ..dist.sharding import MeshRules, ShardingConfig, batch_specs
from ..models import LM, EncDec, build_model
from ..models.config import ArchConfig
from ..optim.adamw import AdamWConfig, apply_updates, init_opt_state
from .meta_trace import trace

__all__ = ["StepBundle", "decode_position", "loss_and_grads",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "rank_rows", "serving_rules", "shard_for_serving",
           "state_shapes", "train_step"]


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
    if mask is None or mask.device.type == "meta":
        # a meta mask has no values: its every position counts
        return torch.tensor(float(batch["labels"].numel()))
    return mask.detach().float().sum().cpu()


def _reduce_data_parallel(grads: dict, shapes: list, loss: torch.Tensor,
                          count: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``count * (grads, loss)`` and ``count`` over ``axes`` in one
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
    all_reduce_(flat, mesh, axes)
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
                mesh, tuple(batch_axes))
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


# -- step builders ----------------------------------------------------------

def rank_rows(batch: dict, mesh, scfg: ShardingConfig,
              microbatches: int = 1) -> dict:
    """This rank's rows of a global batch: the rank's coordinate along the
    axes ``batch_specs`` gives the leading dimension (all rows where they
    do not divide it).  With ``microbatches`` the rank takes its share of
    each of the global batch's microbatches (contiguous row blocks, as the
    reference splits them), in microbatch order, so its own contiguous
    split is its share of each."""
    spec = batch_specs(batch, mesh, scfg)
    out = {}
    for key, arr in batch.items():
        axes = spec[key][0] if spec[key] else None
        if axes is None:
            out[key] = arr
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        n = mesh.axes_size(axes)
        i = mesh.index(axes)
        if microbatches > 1 and arr.shape[0] % (n * microbatches) == 0:
            blocks = arr.reshape(microbatches, n, -1, *arr.shape[1:])
            out[key] = blocks[:, i].reshape(-1, *arr.shape[1:])
            continue
        per = arr.shape[0] // n
        out[key] = arr[i * per:(i + 1) * per]
    return out


def serving_rules(scfg: ShardingConfig, mesh) -> MeshRules:
    """The rules serving runs under: ``scfg``'s, except that under
    ``kv_shard="batch_seq"`` the model axes stripe the caches and the
    compute stays whole."""
    rules = scfg.rules(mesh)
    if scfg.kv_shard == "batch_seq":
        rules = MeshRules(mesh=mesh, rules={
            **rules.rules, "heads": (), "kv_heads": (), "ff": (),
            "vocab": ()})
    return rules


def shard_for_serving(model: LM | EncDec, scfg: ShardingConfig,
                      mesh) -> MeshRules:
    """Shard a serving model over the ranks of ``mesh`` (once) and return
    the rules it serves under.  Where ``scfg.fsdp_axes`` lie on the mesh
    (more than one rank) each rank stores its ``param_specs`` block of
    every leaf and gathers a layer's compute blocks where the layer runs
    (``resident="storage"``, as training holds them); otherwise it holds
    its compute blocks, gathered once here."""
    rules = serving_rules(scfg, mesh)
    if model.layout is None and mesh.size > 1:
        fsdp = tuple(a for a in scfg.fsdp_axes if a in mesh.axis_names)
        model.shard(rules, "storage" if mesh.axes_size(fsdp) > 1
                    else "compute", scfg)
    return rules


def _tensors(x) -> list:
    """The tensors of a step's argument: a model's parameters, the leaves
    of a dict, list or tuple, or the tensor itself."""
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


@dataclass
class StepBundle:
    """A step with its rules and its arguments on the meta device.

    ``fn`` is the eager step on real tensors; ``run(*args)`` calls it
    under ``rules`` (``None``: the model's own); ``in_specs`` are its
    arguments on the ``meta`` device, as this rank of the mesh would hold
    them; ``dry_run()`` runs it on them (``meta_trace.trace``) and returns
    the trace with the parameter and moment bytes of the rank."""

    fn: Callable
    in_specs: tuple
    rules: Any = None

    def run(self, *args):
        with use_rules(self.rules):
            return self.fn(*args)

    def dry_run(self) -> dict:
        resident = _tensors(self.in_specs)
        out = trace(self.run, self.in_specs, resident)
        model, rest = self.in_specs[0], self.in_specs[1:]
        opt = rest[0] if rest and isinstance(rest[0], dict) \
            and "m" in rest[0] else {}
        out["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in model.parameters())
        out["moment_bytes"] = sum(t.numel() * t.element_size()
                                  for t in _tensors([opt.get("m", {}),
                                                     opt.get("v", {})]))
        return out


def state_shapes(cfg: ArchConfig, opt_cfg: AdamWConfig) -> dict:
    """``{params, opt, step}`` on the meta device: the parameters by name,
    AdamW's state and the step count, without allocation."""
    params = dict(build_model(cfg, device="meta").named_parameters())
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _over_ranks(mesh) -> bool:
    return isinstance(mesh, RankMesh) and mesh.size > 1


def make_train_step(cfg: ArchConfig, scfg: ShardingConfig, mesh,
                    opt_cfg: AdamWConfig, batch_shapes: dict) -> StepBundle:
    """``train_step`` under ``scfg`` over ``mesh`` (a mesh of ranks, or
    ``None`` for one process): ``fn(model, opt_state, batch, err)``, with
    ``in_specs`` the meta model (each rank's ``param_specs`` blocks where
    the layout shards anything), its AdamW state, this rank's rows of
    ``batch_shapes`` (the global batch) and the error-feedback residual
    (``None`` without ``grad_compression``)."""
    model = build_model(cfg, device="meta")
    layout = None
    if _over_ranks(mesh):
        layout = model.shard(scfg.rules(mesh), "storage", scfg)
    params = dict(model.named_parameters())
    opt = init_opt_state(params, opt_cfg,
                         None if layout is None else layout.moment_grids())
    err = (init_error_state(params) if scfg.grad_compression != "none"
           else None)
    batch = (rank_rows(batch_shapes, mesh, scfg, scfg.microbatches)
             if _over_ranks(mesh) else batch_shapes)
    remat = (scfg.remat_policy if scfg.remat and scfg.remat_policy != "full"
             else scfg.remat)
    batch_axes = scfg.batch_axes(mesh) if mesh is not None else ()

    def fn(model, opt_state, batch, err=None):
        return train_step(model, opt_state, batch, opt_cfg,
                          microbatches=scfg.microbatches, remat=remat,
                          grad_compression=scfg.grad_compression, err=err,
                          mesh=mesh if _over_ranks(mesh) else None,
                          batch_axes=batch_axes)

    return StepBundle(fn=fn, in_specs=(model, opt, batch, err))


def _serving_model(cfg: ArchConfig, scfg: ShardingConfig, mesh):
    model = build_model(cfg, device="meta").cast_for_serving()
    rules = None
    if _over_ranks(mesh):
        rules = shard_for_serving(model, scfg, mesh)
    return model, rules


def make_prefill_step(cfg: ArchConfig, scfg: ShardingConfig, mesh,
                      batch_shapes: dict, max_len: int = 0) -> StepBundle:
    """The prefill under ``scfg``'s serving layout: ``LM.prefill`` of the
    tokens (and a VLM's patches) with caches of ``max_len``, or an
    encoder-decoder's ``prefill_cross`` of its frames into caches of
    ``max(max_len, decoder_len)``: ``fn(model, batch)``, with ``in_specs``
    the meta model and this rank's rows of ``batch_shapes``."""
    model, rules = _serving_model(cfg, scfg, mesh)
    batch = (rank_rows(batch_shapes, mesh, scfg) if _over_ranks(mesh)
             else batch_shapes)
    if cfg.encdec:
        def fn(model, batch):
            frames = batch["frame_embeds"]
            state = model.init_decode_state(
                frames.shape[0], max(max_len, cfg.decoder_len),
                cross_len=frames.shape[1])
            return model.prefill_cross(state, frames)
    else:
        def fn(model, batch):
            return model.prefill(batch["tokens"], max_len=max_len,
                                 patch_embeds=batch.get("patch_embeds"))
    return StepBundle(fn=fn, in_specs=(model, batch), rules=rules)


def decode_position(pos, max_len: int) -> int:
    """A decode step's position as a Python int; a meta ``pos`` (no value)
    is the cache's last, ``max_len - 1``."""
    if isinstance(pos, torch.Tensor) and pos.device.type == "meta":
        return max_len - 1
    return int(pos)


def make_serve_step(cfg: ArchConfig, scfg: ShardingConfig, mesh,
                    batch: int, max_len: int) -> StepBundle:
    """One decode step (one token a row) against caches of capacity
    ``max_len`` under ``scfg``'s serving layout: ``fn(model, state,
    tokens, pos)``, with ``in_specs`` the meta model, this rank's decode
    state (its rows and its cache stripe), its tokens and ``pos``."""
    model, rules = _serving_model(cfg, scfg, mesh)
    rows = batch
    if rules is not None:
        n = mesh.axes_size(rules.axes("batch"))
        rows = batch // n if batch % n == 0 else batch
    kw = {"cross_len": 1024} if cfg.encdec else {}
    with use_rules(rules):
        state = model.init_decode_state(rows, max_len, **kw)
    tokens = torch.zeros((rows, 1), dtype=torch.int32, device="meta")
    pos = torch.zeros((), dtype=torch.int32, device="meta")

    def fn(model, state, tokens, pos):
        return model.decode_step(state, tokens, decode_position(pos, max_len))

    return StepBundle(fn=fn, in_specs=(model, state, tokens, pos),
                      rules=rules)
