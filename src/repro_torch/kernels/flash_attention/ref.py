"""Plain oracle for flash attention (exact softmax in float32)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, H, hd); k, v: (B, Tk, H, hd). Returns (B, Tq, H, hd)."""
    tq, hd = q.shape[1], q.shape[-1]
    tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = torch.arange(tk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
