"""Public wrapper: the RWKV-6 wkv recurrence, ``(y, s_T) = wkv6(...)``.

Launch parameters (``chunk``/``lanes``/``block_h``/``block_threads``)
resolve defaults < tuned store (``tuned=``, see
``repro_torch.tune.kernels``) < explicit overrides, under the reference's
meta keys ``{b, t, h, hd}``.  Every operand is cast to float32, as the
reference's ``ops.wkv6`` casts them.  The backward kernel (the reference's
``wkv6_bwd``) is not ported yet, so the result carries no gradient.
"""

from __future__ import annotations

import torch

from .. import resolve_launch_params
from .kernel import serial_split, wkv6_fwd

# the serial program, four threads per state column of one head at hd 64:
# 256 threads a block (one thread a column, 64 threads, takes ~4x as long
# on the H100 at the RWKV-6 prefill shape)
DEFAULTS = {"chunk": 32, "lanes": 0, "block_h": 1, "block_threads": 256}


def fit_threads(hd: int, block_h: int, block_threads: int) -> int:
    """The serial program's ``block_threads`` for this head size: the
    largest ``block_h * hd * split`` up to the one asked for that the
    kernel is built for (the smallest when none is), as the reference
    clamps its blocks to what the shape allows."""
    fits = [block_h * hd * s for s in (1, 2, 4, 8, 16, 32)
            if serial_split(hd, block_h, block_h * hd * s) is not None
            and block_h * hd * s % 32 == 0]
    under = [n for n in fits if n <= block_threads]
    return max(under) if under else min(fits, default=block_threads)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor | None = None, *,
         chunk: int | None = None, lanes: int | None = None,
         block_h: int | None = None, block_threads: int | None = None,
         tuned: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) or None
    (zeros).  Returns (y (B, T, H, hd), s_T (B, H, hd, hd)), float32.

    ``tuned=True`` resolves the cached best launch parameters for this
    (shape, dtype, device) with zero measurements; ``tuned=None`` does so
    only when tuning was enabled globally
    (``repro_torch.tune.kernels.configure``).
    """
    b, t, h, hd = r.shape
    meta = {"b": b, "t": t, "h": h, "hd": hd}
    p = resolve_launch_params(
        "rwkv6_wkv", meta, torch.float32, defaults=DEFAULTS,
        overrides={"chunk": chunk, "lanes": lanes, "block_h": block_h,
                   "block_threads": block_threads},
        tuned=tuned, device=r.device)
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)

    def f32(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32).contiguous()

    threads = p["block_threads"]
    if p["lanes"] < 2:
        threads = fit_threads(hd, p["block_h"], threads)
    return wkv6_fwd(f32(r), f32(k), f32(v), f32(w), f32(u), f32(s0),
                    chunk=p["chunk"], lanes=p["lanes"], block_h=p["block_h"],
                    block_threads=threads)
