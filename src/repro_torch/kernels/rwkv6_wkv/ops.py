"""Public wrapper: the RWKV-6 wkv recurrence, ``(y, s_T) = wkv6(...)``.

Launch parameters resolve defaults < tuned store (``tuned=``, see
``repro_torch.tune.kernels``) < explicit overrides, under the reference's
meta keys ``{b, t, h, hd}``: the forward's chunked route
(``chunk``/``split``/``cols``/``block_h``) as ``rwkv6_wkv`` (its
serial route, decode and T shorter than a chunk, keeps its own launch
point, ``kernel.SERIAL_LAUNCH``), the
backward's (``chunk``/``block_threads``/``cols``/``parts``) as
``rwkv6_wkv_bwd``, from its defaults and the tuned store only (the backward
kernel's own keywords force a configuration).  Every operand is cast to
float32, as the reference's ``ops.wkv6`` casts them.

Differentiable, as the reference's ``jax.custom_vjp`` is: when autograd
records (grad mode on and an operand requiring grad), the call goes through
``Wkv6``, a ``torch.autograd.Function`` whose forward runs the forward
kernel and saves the operands ``(r, k, v, w, u, s0)`` (the reference's
residuals) and whose backward runs the backward kernel (``wkv6_bwd``), which
recomputes the states from them and returns a gradient for every operand,
``s0`` included.
"""

from __future__ import annotations

import torch

from .. import resolve_launch_params
from .kernel import wkv6_bwd, wkv6_fwd

# the chunked route: chunks of 64 tokens, 16 value columns a states thread
# (every head size built divides by 16), one head a chunk block with four
# threads sharing a state column's rows: the fastest point of the H100
# sweep at the RWKV-6 prefill shape that every H takes (PERF.md; two heads
# a block, which needs an even H, was 0.3 % faster)
DEFAULTS = {"chunk": 64, "split": 4, "cols": 16, "block_h": 1}
# chunks of 16 tokens (81 KB of shared memory at hd 64: two blocks an SM),
# sixteen warps a chunk, 16 value columns a scan thread (every head size
# built divides by 16), 32 channels' in-chunk pair sum over 4 warps: the
# fastest pair of programs timed on the H100 at the RWKV-6 training shape
# (PERF.md)
BWD_DEFAULTS = {"chunk": 16, "block_threads": 512, "cols": 16, "parts": 4}


class Wkv6(torch.autograd.Function):
    """(y, s_T) through the forward kernel; the gradients of both through
    the backward kernel, from the saved operands."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, fwd: dict, bwd: dict):
        y, s_t = wkv6_fwd(r, k, v, w, u, s0, **fwd)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.bwd = bwd
        return y, s_t

    @staticmethod
    def backward(ctx, dy, ds_t):
        grads = wkv6_bwd(*ctx.saved_tensors, dy.contiguous(),
                         ds_t.contiguous(), **ctx.bwd)
        return (*grads, None, None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor | None = None, *,
         chunk: int | None = None, split: int | None = None,
         cols: int | None = None, block_h: int | None = None,
         tuned: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd) or None
    (zeros).  Returns (y (B, T, H, hd), s_T (B, H, hd, hd)), float32.

    ``tuned=True`` resolves the cached best launch parameters, forward and
    backward independently, for this (shape, dtype, device) with zero
    measurements; ``tuned=None`` does so only when tuning was enabled
    globally (``repro_torch.tune.kernels.configure``).
    """
    b, t, h, hd = r.shape
    meta = {"b": b, "t": t, "h": h, "hd": hd}
    p = resolve_launch_params(
        "rwkv6_wkv", meta, torch.float32, defaults=DEFAULTS,
        overrides={"chunk": chunk, "split": split, "cols": cols,
                   "block_h": block_h},
        tuned=tuned, device=r.device)
    if s0 is None:
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)

    def f32(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32).contiguous()

    args = (f32(r), f32(k), f32(v), f32(w), f32(u), f32(s0))
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        pb = resolve_launch_params(
            "rwkv6_wkv_bwd", meta, torch.float32, defaults=BWD_DEFAULTS,
            tuned=tuned, device=r.device)
        return Wkv6.apply(*args, p, pb)
    return wkv6_fwd(*args, **p)
