"""Plain sequential oracle for the Mamba-1 selective scan."""

from __future__ import annotations

import torch


def selective_scan_ref(x, delta, a, b, c, d, h0=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, delta: (B, T, dI); a: (dI, S); b, c: (B, T, S); d: (dI,).

    h_t = exp(delta_t * A) h_{t-1} + (delta_t * x_t) B_t
    y_t = C_t . h_t + D * x_t
    Returns (y (B, T, dI) float32, h_T (B, dI, S) float32).
    """
    bt, t, di = x.shape
    s = a.shape[1]
    h = (torch.zeros((bt, di, s), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(t):
        d_t = delta[:, i]
        da = torch.exp(d_t[..., None] * a)
        h = da * h + (d_t * x[:, i])[..., None] * b[:, i, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c[:, i]))
    return torch.stack(ys, dim=1) + x * d, h
