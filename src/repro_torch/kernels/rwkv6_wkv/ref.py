"""Plain sequential oracle for the RWKV-6 wkv recurrence."""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, T, H, hd) float32 (w = multiplicative decay in
    (0, 1)); u: (H, hd).  Returns (y (B, T, H, hd), s_T (B, H, hd, hd))."""
    b, t, h, hd = r.shape
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for i in range(t):
        r_t, k_t, v_t, w_t = r[:, i], k[:, i], v[:, i], w[:, i]
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, s + u[..., :, None] * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s
