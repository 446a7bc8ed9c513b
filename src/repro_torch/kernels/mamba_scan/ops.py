"""Public wrapper: the Mamba-1 selective scan, ``(y, h_T) = selective_scan(...)``.

Launch parameters (``block_d``/``chunk``/``lanes``) resolve defaults <
tuned store (``tuned=``, see ``repro_torch.tune.kernels``) < explicit
overrides, under the reference's meta keys ``{bt, t, di, s}``.  Every
operand is cast to float32, as the reference's ``ops.selective_scan`` casts
them.  The backward kernel (the reference's ``selective_scan_bwd``) is not
ported yet, so the result carries no gradient.
"""

from __future__ import annotations

import torch

from .. import resolve_launch_params
from .kernel import selective_scan_fwd

# the serial program, 128 channels a block
DEFAULTS = {"block_d": 128, "chunk": 64, "lanes": 0}


def selective_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor | None = None, *,
                   block_d: int | None = None, chunk: int | None = None,
                   lanes: int | None = None, tuned: bool | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, delta: (B, T, dI); a: (dI, S); b, c: (B, T, S); d: (dI,); h0:
    (B, dI, S) or None (zeros).  Returns (y (B, T, dI), h_T (B, dI, S)),
    float32.

    ``tuned=True`` resolves the cached best launch parameters for this
    (shape, dtype, device) with zero measurements; ``tuned=None`` does so
    only when tuning was enabled globally
    (``repro_torch.tune.kernels.configure``).
    """
    bt, t, di = x.shape
    s = a.shape[1]
    meta = {"bt": bt, "t": t, "di": di, "s": s}
    p = resolve_launch_params(
        "mamba_scan", meta, torch.float32, defaults=DEFAULTS,
        overrides={"block_d": block_d, "chunk": chunk, "lanes": lanes},
        tuned=tuned, device=x.device)
    if h0 is None:
        h0 = torch.zeros((bt, di, s), dtype=torch.float32, device=x.device)

    def f32(m: torch.Tensor) -> torch.Tensor:
        return m.to(torch.float32).contiguous()

    return selective_scan_fwd(f32(x), f32(delta), f32(a), f32(b), f32(c),
                              f32(d), f32(h0), block_d=p["block_d"],
                              chunk=p["chunk"], lanes=p["lanes"])
