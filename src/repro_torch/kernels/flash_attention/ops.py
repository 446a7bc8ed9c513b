"""Public wrapper: (B, T, H, hd) flash attention over the CUDA kernel.

Launch parameters (``block_q``/``block_k``/``block_threads``) resolve in
three tiers: hardcoded defaults < the tuned-store best config for this
shape/dtype/device (``tuned=``, see ``repro_torch.tune.kernels``) <
explicit keyword overrides.  The meta keys ``{bh, tq, tk, hd, causal}`` are
the reference's, so one shape description names a store record in both
packages.

Forward only: the backward kernels (the reference's
``flash_attention_bwd``) arrive with the training slice.
"""

from __future__ import annotations

import torch

from .. import resolve_launch_params
from .kernel import flash_attention_fwd

DEFAULTS = {"block_q": 64, "block_k": 64, "block_threads": 256}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    block_q: int | None = None, block_k: int | None = None,
                    block_threads: int | None = None,
                    tuned: bool | None = None) -> torch.Tensor:
    """q/k/v: (B, T, H, hd), kv already head-repeated -> (B, Tq, H, hd).

    The heads are folded into the kernel's grid through the views'
    strides, so any (B, T, H, hd) view with a contiguous last dimension
    goes in without a copy.  ``tuned=True`` resolves the cached best
    launch parameters for this (shape, dtype, device) with zero
    measurements (defaults on a miss); ``tuned=None`` does so only when
    tuning was enabled globally (``repro_torch.tune.kernels.configure``).
    """
    b, t, h, hd = q.shape
    meta = {"bh": b * h, "tq": t, "tk": k.shape[1], "hd": hd,
            "causal": bool(causal)}
    p = resolve_launch_params(
        "flash_attention", meta, q.dtype, defaults=DEFAULTS,
        overrides={"block_q": block_q, "block_k": block_k,
                   "block_threads": block_threads},
        tuned=tuned, device=q.device)
    out, _ = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                 block_q=p["block_q"], block_k=p["block_k"],
                                 block_threads=p["block_threads"])
    return out
