"""Plain oracle for single-token GQA decode attention."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, length=None) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, S, KV, hd); length: int or None.

    Attends over positions < length (all S if None). Returns (B, H, hd)
    float32.
    """
    b, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qf = q.float().reshape(b, kv, rep, hd) * hd ** -0.5
    s = torch.einsum("bgrh,bsgh->bgrs", qf, k.float())
    if length is not None:
        valid = torch.arange(s_len, device=q.device) < length
        s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgh->bgrh", p, v.float())
    return out.reshape(b, h, hd)
