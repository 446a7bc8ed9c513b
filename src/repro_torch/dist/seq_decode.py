"""Sequence-sharded single-token decode attention.

For long-context decode the KV cache is sharded along its *sequence*
dimension: each rank owns a contiguous stripe of positions.  One decode
step is then:

  1. the rank whose stripe contains ``pos`` writes the new K/V row into
     its stripe in place;
  2. every rank with a valid position in its stripe runs the split-KV
     decode kernel (B4) over the stripe with ``return_lse=True``,
     producing its normalised output and the logsumexp of its scores; a
     rank whose stripe lies wholly beyond ``pos`` launches nothing and
     holds ``out = 0, lse = -1e30``;
  3. the partials combine across the sequence axes by logsumexp: one
     ``all_reduce(MAX)`` of ``lse``, then one ``all_reduce(SUM)`` of
     ``out * w`` and ``w = exp(lse - max)`` packed in one buffer.  Every
     rank joins both collectives, the empty-stripe rank too.

The combine moves (B, H, hd + 1) floats a step, whatever the context
length.  The reference runs the stripe's attention as plain jnp inside a
``shard_map``; the port runs it through B4, whose logsumexp output exists
for this combine, which runs inside a profiler range named
``seq_decode_combine``.  ``models.attention.decode_attention`` dispatches here
for a self-attention cache allocated as a stripe
(``models.attention.init_kv_cache``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..kernels.decode_attention import ops as da_ops
from .collectives import all_reduce_
__all__ = ["NEG_INF", "seq_decode_attention"]

NEG_INF = -1e30


def seq_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, pos: int, *, mesh, seq_axes,
                         batch_axes=()) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """One GQA decode step against a sequence-sharded cache.

    Every tensor is this rank's part: q (B, H, hd) and k_new/v_new
    (B, KV, hd) hold the rank's rows along ``batch_axes``; cache_k/cache_v
    (B, S_local, KV, hd) its stripe along ``seq_axes``.  ``pos`` (a Python
    int) is the global write position; attention spans positions <= pos.
    ``mesh`` is a ``dist.ranks.RankMesh``.  Returns ``(out float32
    (B, H, hd), cache_k, cache_v)``, the caches written in place.
    """
    del batch_axes          # the rows are already this rank's
    b, h, hd = q.shape
    kv = cache_k.shape[2]
    rep = h // kv
    s_local = cache_k.shape[1]
    # the stripe's first position: the rank's flattened coordinate along
    # seq_axes (row-major in the order given, as a PartitionSpec entry
    # lays shards out) times the stripe length
    s0 = mesh.index(tuple(seq_axes)) * s_local

    li = pos - s0
    if 0 <= li < s_local:
        cache_k[:, li] = k_new.to(cache_k.dtype)
        cache_v[:, li] = v_new.to(cache_v.dtype)

    n = min(pos + 1 - s0, s_local)
    if n >= 1:
        out, lse = da_ops.decode_attention(q, cache_k, cache_v, length=n,
                                           tuned=None, return_lse=True)
    else:
        out = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
        lse = torch.full((b, kv, rep), NEG_INF, dtype=torch.float32,
                         device=q.device)
    group = mesh.group(tuple(seq_axes))
    if dist.get_world_size(group) == 1:
        return out, cache_k, cache_v
    with record_function("seq_decode_combine"):
        m = all_reduce_(lse.clone(), mesh, seq_axes, op="max")
        w = torch.exp(lse - m)                             # (B, KV, rep)
        buf = torch.cat([(out.view(b, kv, rep, hd) * w[..., None])
                         .reshape(-1), w.reshape(-1)])
        all_reduce_(buf, mesh, seq_axes)
        acc = buf[:b * h * hd].view(b, kv, rep, hd)
        wsum = buf[b * h * hd:].view(b, kv, rep)
        out = acc / wsum.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, hd), cache_k, cache_v
