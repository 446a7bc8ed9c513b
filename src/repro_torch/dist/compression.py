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

Over ranks that each hold a block of a leaf (``dist.sharding.
ParamLayout``), the statistic of a stack is still the whole stacked
leaf's: the int8 absmax is maxed over the ranks of the leaf's storage
axes, and top-k keeps the whole leaf's k largest.  Each rank's own top-k
candidates (ties to the lower index) hold every entry of the whole
leaf's top-k that lies in its block, so the ranks exchange only those,
with their global indices, and each keeps its entries among the first k
in the order of ``lax.top_k`` (magnitude, then the lower global index).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .collectives import gather_raw
from .sharding import Spread

__all__ = [
    "CompressionConfig", "compress_with_feedback", "init_error_state",
    "quantize_int8", "dequantize_int8", "topk_compress", "topk_decompress",
    "topk_spread", "compressed_allreduce_mean", "compress_stacked",
    "stack_groups", "wire_bytes",
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

def quantize_int8(x: torch.Tensor, spread: Spread | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax quantization -> (int8 codes, f32 scale).  Codes
    round half to even, as ``jnp.round`` does.  With ``spread``, ``x`` is
    a block (``dist.sharding.Spread``) and the absmax the whole leaf's."""
    x32 = x.float()
    top = x32.abs().max()
    if spread is not None:
        top = spread.max_(top)
    scale = top / 127.0
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
    return _topk_exact(flat, _topk_k(flat.numel(), frac))


def _topk_exact(flat: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    mag = flat.abs()
    kth = torch.topk(mag, k, sorted=True).values[-1]
    above = torch.nonzero(mag > kth).flatten()
    ties = torch.nonzero(mag == kth).flatten()[:k - above.numel()]
    idx = torch.cat([above, ties])
    # ``above`` and ``ties`` are each in index order, so the stable sort
    # keeps equal magnitudes in index order
    idx = idx[torch.sort(mag[idx], descending=True, stable=True).indices]
    return flat[idx], idx.to(torch.int32)


def _global_index(idx: torch.Tensor, local: tuple, spread: Spread
                  ) -> torch.Tensor:
    """Flat indices of a block of shape ``local`` as the whole leaf's."""
    coords = []
    rest = idx.long()
    for n in reversed(local):
        coords.append(rest % n)
        rest = rest // n
    out = torch.zeros_like(rest)
    for c, s0, n in zip(reversed(coords), spread.start, spread.shape):
        out = out * n + (c + s0)
    return out


def topk_spread(x: torch.Tensor, frac: float, spread: Spread
                ) -> torch.Tensor:
    """The entries of block ``x`` among the whole leaf's ``frac`` largest
    magnitudes (``topk_compress``'s choice, ties to the lower global
    index), the others zeroed: float32, ``x``'s shape."""
    n = 1
    for d in spread.shape:
        n *= d
    k = _topk_k(n, frac)
    flat = x.reshape(-1).float()
    vals, idx = _topk_exact(flat, min(k, flat.numel()))
    gidx = _global_index(idx, tuple(x.shape), spread)
    mags = vals.abs()
    all_m = gather_raw(mags, spread.mesh, spread.axes, 0)
    all_i = gather_raw(gidx, spread.mesh, spread.axes, 0)
    order = torch.sort(all_i).indices
    order = order[torch.sort(all_m[order], descending=True,
                             stable=True).indices]
    kth_m, kth_i = all_m[order[k - 1]], all_i[order[k - 1]]
    keep = (mags > kth_m) | ((mags == kth_m) & (gidx <= kth_i))
    out = torch.zeros_like(flat)
    out[idx.long()[keep]] = vals[keep]
    return out.reshape(x.shape)


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


def _compress_leaf(g: torch.Tensor, cfg: CompressionConfig,
                   spread: Spread | None = None) -> torch.Tensor:
    """Compress-then-decompress one leaf (the EF update needs the
    decompressed representative anyway); with ``spread``, one block of a
    leaf held by ranks, compressed as part of the whole."""
    if cfg.scheme == "int8":
        q, s = quantize_int8(g, spread)
        return dequantize_int8(q, s, g.shape)
    if spread is not None:
        return topk_spread(g, cfg.topk_frac, spread)
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

    pairs: list = []

    def slot(g, e):
        pairs.append(_feedback(g, e, cfg))
        return len(pairs) - 1

    slots = _tree_map(slot, grads, err)
    return (_tree_map(lambda i: pairs[i][0], slots),
            _tree_map(lambda i: pairs[i][1], slots))


def _feedback(g, e, cfg: CompressionConfig, spread: Spread | None = None):
    total = g.float() + e
    c = _compress_leaf(total, cfg, spread)
    return c.to(g.dtype), total - c


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
                     groups: dict[str, list[str]],
                     layout=None) -> tuple[dict, dict]:
    """``compress_with_feedback`` over the stacks ``groups`` names
    (``stack_groups``), each stack one tensor as in the reference;
    returns per-name ``(compressed_grads, new_err)``.  With ``layout``
    (a ``dist.sharding.ParamLayout`` of storage blocks) ``grads`` and
    ``err`` are each rank's blocks, and each stack is compressed as the
    whole stacked leaf."""
    if cfg.scheme == "none":
        return grads, err
    out_g, out_e = {}, {}
    for ns in groups.values():
        spread = None if layout is None else layout.spread(ns[0])
        c, e = _feedback(torch.stack([grads[n].float() for n in ns]),
                         torch.stack([err[n] for n in ns]), cfg,
                         None if spread is None else spread.stacked(len(ns)))
        for i, n in enumerate(ns):
            out_g[n] = c[i].to(grads[n].dtype)
            out_e[n] = e[i]
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
