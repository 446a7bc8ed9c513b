"""Public wrapper: (B, H, hd) x (B, S, KV, hd) GQA decode attention.

Launch parameters (``splits``/``block_s``/``block_threads``/``stages``)
resolve defaults < tuned store (``tuned=``, see
``repro_torch.tune.kernels``) < explicit overrides, under the reference's
meta keys ``{b, kv, rep, hd, s}``.

The defaults are drawn for the H100, not copied: the whole space's
fastest point at Qwen2.5-3B's decode shape (``scripts/
torch_attention_sweep.py``, PERF.md): 4 splits (a cluster of 4 blocks a
group: 64 blocks at B * KV = 16), 8 warps a block each streaming its own
tiles of 16 keys through a 3-deep ring.
"""

from __future__ import annotations

import torch

from .. import SMEM_LIMIT_BYTES, resolve_launch_params
from .kernel import decode_attention as decode_attention_kernel
from .kernel import smem_bytes

DEFAULTS = {"splits": 4, "block_s": 16, "block_threads": 256,
            "stages": 3}


def fit_launch(launch: dict, rep: int, hd: int, dtype: torch.dtype) -> dict:
    """``launch`` cut until a block's shared memory fits the card: fewer
    ring stages first, then fewer warps (the defaults' ring at hd 192 in
    bfloat16 takes 307 KB), as the reference clamps its blocks to the
    shape."""
    p = dict(launch)

    def need() -> int:
        return smem_bytes(rep, hd, p["block_s"], p["block_threads"],
                          p["stages"], dtype)

    while need() > SMEM_LIMIT_BYTES and p["stages"] > 1:
        p["stages"] -= 1
    while need() > SMEM_LIMIT_BYTES and p["block_threads"] > 32:
        p["block_threads"] //= 2
    return p


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: int | None = None, splits: int | None = None,
                     block_s: int | None = None,
                     block_threads: int | None = None,
                     stages: int | None = None,
                     tuned: bool | None = None, return_lse: bool = False):
    """q: (B, H, hd); k/v: (B, S, KV, hd). Returns (B, H, hd) float32;
    with ``return_lse`` also the logsumexp of each head's scaled scores
    over the attended positions, (B, KV, rep) float32.

    ``length`` (a Python int; ``None`` = all S) masks positions >= length.
    ``tuned=True`` resolves the cached best launch parameters for this
    (shape, dtype, device) with zero measurements; ``tuned=None`` does so
    only when tuning was enabled globally
    (``repro_torch.tune.kernels.configure``).
    """
    b, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    rep = h // kv
    meta = {"b": b, "kv": kv, "rep": rep, "hd": hd, "s": s_len}
    p = resolve_launch_params(
        "decode_attention", meta, q.dtype, defaults=DEFAULTS,
        overrides={"splits": splits, "block_s": block_s,
                   "block_threads": block_threads, "stages": stages},
        tuned=tuned, device=q.device)
    # a segment count above S leaves empty segments; clamp (to a power of
    # two, a cluster's size) as the reference clamps its split count to the
    # cache
    splits = min(p["splits"], 1 << (s_len.bit_length() - 1))
    p = fit_launch(p, rep, hd, q.dtype)
    out = decode_attention_kernel(
        q.reshape(b, kv, rep, hd), k, v, s_len if length is None
        else int(length), splits=splits, block_s=p["block_s"],
        block_threads=p["block_threads"], stages=p["stages"],
        **({"return_lse": True} if return_lse else {}))
    if return_lse:
        return out[0].reshape(b, h, hd), out[1]
    return out.reshape(b, h, hd)
