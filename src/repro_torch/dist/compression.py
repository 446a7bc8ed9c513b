"""Gradient compression substrates with error feedback.

Two wire formats and the error-feedback (EF) wrapper that makes them safe
for SGD/Adam:

  * ``quantize_int8``/``dequantize_int8`` — per-tensor absmax int8; the
    roundtrip error is bounded by ``absmax/254`` per element.
  * ``topk_compress``/``topk_decompress`` — keep the ``frac`` fraction of
    largest-|g| entries as (values, flat indices).

``compress_with_feedback`` implements the standard EF recurrence
(Seide et al. / Karimireddy et al.): the residual of each step's
compression is added back into the next step's gradient, so the scheme
stays unbiased in the long run and convergence matches uncompressed
training closely.

``compressed_allreduce_mean`` is the collective: each rank compresses,
then decompresses, its local block before an ``all_reduce`` over the
axis's process group, modelling an int8-on-the-wire all-reduce;
``wire_bytes`` accounts for exactly what such a transport would move per
step.

Plain PyTorch, as the reference computes all of this outside any kernel.
Trees are dicts, lists and tuples of tensors (a model's
``named_parameters`` dict).

"Per tensor" is the reference's tensor: it stacks the layers that share a
scan slot into one leaf, so one absmax scale (int8) or one top-k spans
every layer of the slot.  ``stack_groups`` lists the port's per-layer
names of each such tensor in stack order, and ``compress_stacked`` runs
``compress_with_feedback`` on those stacks, so the port's train step
compresses what the reference's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "CompressionConfig", "compress_with_feedback", "init_error_state",
    "quantize_int8", "dequantize_int8", "topk_compress", "topk_decompress",
    "compressed_allreduce_mean", "compress_stacked", "stack_groups",
    "wire_bytes",
]


@dataclass(frozen=True)
class CompressionConfig:
    """Wire-format knobs: ``scheme`` in {"none", "int8", "topk"};
    ``topk_frac`` is the kept fraction for the top-k scheme."""

    scheme: str = "none"
    topk_frac: float = 0.25

    def __post_init__(self):
        if self.scheme not in ("none", "int8", "topk"):
            raise ValueError(f"unknown compression scheme {self.scheme!r}")


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# -- int8 ----------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax quantization -> (int8 codes, f32 scale).  Codes
    round half to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = x32.abs().max() / 127.0
    q = torch.round(x32 / scale.clamp_min(1e-30))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple[int, ...]) -> torch.Tensor:
    return (q.float() * scale).reshape(shape)


# -- top-k ----------------------------------------------------------------------

def _topk_k(n: int, frac: float) -> int:
    return max(1, min(n, int(round(n * frac))))


def topk_compress(x: torch.Tensor, frac: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``frac`` largest-|x| entries -> (values, flat int32 idx),
    the largest first.

    Ties break as ``lax.top_k``'s do: of equal magnitudes the lower index
    is kept and listed first.  ``torch.topk`` finds the k-th magnitude; the
    entries above it are kept, then the lowest-indexed entries equal to it
    fill the rest, and a stable sort orders the kept ones.
    """
    flat = x.reshape(-1).float()
    k = _topk_k(flat.numel(), frac)
    mag = flat.abs()
    kth = torch.topk(mag, k, sorted=True).values[-1]
    above = torch.nonzero(mag > kth).flatten()
    ties = torch.nonzero(mag == kth).flatten()[:k - above.numel()]
    idx = torch.cat([above, ties])
    # ``above`` and ``ties`` are each in index order, so the stable sort
    # keeps equal magnitudes in index order
    idx = idx[torch.sort(mag[idx], descending=True, stable=True).indices]
    return flat[idx], idx.to(torch.int32)


def topk_decompress(values: torch.Tensor, idx: torch.Tensor,
                    shape: tuple[int, ...]) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    out = torch.zeros(n, dtype=torch.float32, device=values.device)
    out[idx.long()] = values
    return out.reshape(shape)


# -- error feedback -------------------------------------------------------------

def init_error_state(params: Any) -> Any:
    """Zero EF residual tree, shaped like the params (float32)."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


def _compress_leaf(g: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """Compress-then-decompress one leaf (the EF update needs the
    decompressed representative anyway)."""
    if cfg.scheme == "int8":
        q, s = quantize_int8(g)
        return dequantize_int8(q, s, g.shape)
    v, i = topk_compress(g, cfg.topk_frac)
    return topk_decompress(v, i, g.shape)


def compress_with_feedback(grads: Any, err: Any, cfg: CompressionConfig
                           ) -> tuple[Any, Any]:
    """EF step: compress (grad + residual), carry the new residual.

    Returns ``(compressed_grads, new_err)`` with the same tree structure
    as ``grads``; with ``scheme="none"`` it is the identity.
    """
    if cfg.scheme == "none":
        return grads, err

    def leaf(g, e):
        total = g.float() + e
        c = _compress_leaf(total, cfg)
        return c.to(g.dtype), total - c

    pairs: list = []

    def slot(g, e):
        pairs.append(leaf(g, e))
        return len(pairs) - 1

    slots = _tree_map(slot, grads, err)
    return (_tree_map(lambda i: pairs[i][0], slots),
            _tree_map(lambda i: pairs[i][1], slots))


def stack_groups(names, group_pattern_len: int) -> dict[str, list[str]]:
    """The reference's stacked leaves as lists of the port's parameter
    names, in stack order: layer ``g * P + i`` of ``layers.<layer>.<rest>``
    is entry ``g`` of slot ``i`` (``P`` = ``len(cfg.group_pattern)``), an
    encoder-decoder's ``encoder.<i>.<rest>`` / ``decoder.<i>.<rest>`` entry
    ``i`` of its stack; every other name is a leaf of its own."""
    groups: dict[str, list[tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            g, slot = divmod(int(parts[1]), group_pattern_len)
            key, at = f"layers.slot{slot}." + ".".join(parts[2:]), g
        elif parts[0] in ("encoder", "decoder") and parts[1].isdigit():
            key, at = f"{parts[0]}." + ".".join(parts[2:]), int(parts[1])
        else:
            key, at = name, 0
        groups.setdefault(key, []).append((at, name))
    return {k: [n for _, n in sorted(v)] for k, v in groups.items()}


def compress_stacked(grads: dict, err: dict, cfg: CompressionConfig,
                     groups: dict[str, list[str]]) -> tuple[dict, dict]:
    """``compress_with_feedback`` over the stacks ``groups`` names
    (``stack_groups``), each stack one tensor as in the reference;
    returns per-name ``(compressed_grads, new_err)``."""
    if cfg.scheme == "none":
        return grads, err
    g = {k: torch.stack([grads[n].float() for n in ns])
         for k, ns in groups.items()}
    e = {k: torch.stack([err[n] for n in ns]) for k, ns in groups.items()}
    c, e = compress_with_feedback(g, e, cfg)
    out_g, out_e = {}, {}
    for k, ns in groups.items():
        for i, n in enumerate(ns):
            out_g[n] = c[k][i].to(grads[n].dtype)
            out_e[n] = e[k][i]
    return out_g, out_e


# -- collectives ----------------------------------------------------------------

def compressed_allreduce_mean(x: torch.Tensor, mesh, axis: str,
                              scheme: str = "int8",
                              topk_frac: float = 0.25) -> torch.Tensor:
    """All-reduce-mean of ``x`` over mesh axis ``axis`` with each rank's
    contribution compressed before the reduction.

    ``x`` is this rank's local block (the reference's shard of a leading
    dimension sharded over ``axis``); every rank gets back a block of
    ``x``'s shape holding the mean over the axis of the decompressed
    contributions (what an int8-on-the-wire ring all-reduce delivers,
    error model included).  ``mesh`` is a ``RankMesh``.
    """
    cfg = CompressionConfig(scheme=scheme, topk_frac=topk_frac)
    contrib = x.float()
    if cfg.scheme != "none":
        contrib = _compress_leaf(contrib, cfg)
    else:
        contrib = contrib.clone()
    dist.all_reduce(contrib, group=mesh.group((axis,)))
    return contrib / mesh.shape[axis]


# -- wire accounting ------------------------------------------------------------

def wire_bytes(grads: Any, cfg: CompressionConfig) -> int:
    """Bytes one replica puts on the wire per step under ``cfg``.

    none: raw elements at their dtype width.  int8: one byte per element
    plus a f32 scale per leaf.  topk: (f32 value + int32 index) per kept
    entry.
    """
    total = 0
    for g in _leaves(grads):
        n = g.numel()
        if cfg.scheme == "none":
            total += n * g.element_size()
        elif cfg.scheme == "int8":
            total += n + 4
        else:
            total += _topk_k(n, cfg.topk_frac) * (4 + 4)
    return total
