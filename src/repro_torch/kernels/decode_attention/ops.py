"""Public wrapper: (B, H, hd) x (B, S, KV, hd) GQA decode attention.

Launch parameters (``splits``/``block_s``/``block_threads``) resolve
defaults < tuned store (``tuned=``, see ``repro_torch.tune.kernels``) <
explicit overrides, under the reference's meta keys
``{b, kv, rep, hd, s}``.

The defaults are drawn for the H100, not copied: the reference's one
split would give the serving shape (B * KV = 16) 16 blocks on a card of
132 SMs; 16 splits give 256.
"""

from __future__ import annotations

import torch

from .. import resolve_launch_params
from .kernel import decode_attention as decode_attention_kernel

DEFAULTS = {"splits": 16, "block_s": 64, "block_threads": 128}


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: int | None = None, splits: int | None = None,
                     block_s: int | None = None,
                     block_threads: int | None = None,
                     tuned: bool | None = None) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, S, KV, hd). Returns (B, H, hd) float32.

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
                   "block_threads": block_threads},
        tuned=tuned, device=q.device)
    # a segment count above S leaves empty segments; clamp as the
    # reference clamps its split count to the cache
    out = decode_attention_kernel(
        q.reshape(b, kv, rep, hd), k, v, s_len if length is None
        else int(length), splits=min(p["splits"], s_len),
        block_s=p["block_s"], block_threads=p["block_threads"])
    return out.reshape(b, h, hd)
