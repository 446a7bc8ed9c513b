"""Public wrapper: the Mamba-1 selective scan, ``(y, h_T) = selective_scan(...)``.

Launch parameters resolve defaults < tuned store (``tuned=``, see
``repro_torch.tune.kernels``) < explicit overrides, under the reference's
meta keys ``{bt, t, di, s}``: the forward's
(``block_d``/``chunk``/``split``, defaults by ``defaults``) as
``mamba_scan``, the backward's
(``block_d``/``chunk``/``split``/``span``) as
``mamba_scan_bwd``, from its defaults and the tuned store only (the
backward kernel's own keywords force a configuration).  Every operand is
cast to float32, as the reference's ``ops.selective_scan`` casts them.

Differentiable, as the reference's ``jax.custom_vjp`` is: when autograd
records (grad mode on and an operand requiring grad), the call goes through
``SelectiveScan``, a ``torch.autograd.Function`` whose forward runs the
forward kernel and saves the operands ``(x, delta, a, b, c, d, h0)`` (the
reference's residuals) and whose backward runs the backward kernel
(``selective_scan_bwd``), which recomputes the states from them and returns
a gradient for every operand, ``h0`` included.
"""

from __future__ import annotations

import torch

from .. import resolve_launch_params
from .kernel import selective_scan_bwd, selective_scan_fwd

# a thread a channel (all 16 state entries), 128 channels a block, chunks
# of 16 tokens: the fastest point of the H100 sweep at the Jamba prefill
# shape (PERF.md); ``defaults`` takes more threads a channel where B * dI
# channels alone would be too few threads
DEFAULTS = {"block_d": 128, "chunk": 16, "split": 1}
# the threads (B * dI * split) ``defaults`` asks for: ~15 warps an SM
FWD_THREADS = 1 << 16
# 32 channels a block, four threads a channel (four state entries each),
# chunks of 16 tokens in spans of 8 chunks: the fastest point of the H100
# sweep at the Jamba training shape (PERF.md); a state of S < 4 takes S
# threads a channel (``bwd_defaults``)
BWD_DEFAULTS = {"block_d": 32, "chunk": 16, "split": 4, "span": 8}


def defaults(meta) -> dict:
    """``DEFAULTS`` at shape ``meta`` (``{bt, t, di, s}``): the fewest
    threads a channel (a power of two, at most S) that give B * dI * split
    at least ``FWD_THREADS`` threads; at two or more, 128 threads a block
    (block_d 128 / split, at least 16) and chunks of 64 tokens (within 0.5
    % of the H100 sweep's best at the Jamba training shape, B 2: split 4).
    The rule was timed at those two shapes only (split 1 at B 8, split 4
    at B 2): the points it gives at split 2, 8 or 16, for other B * dI, are
    untimed."""
    split = 1
    while split < meta["s"] and meta["bt"] * meta["di"] * split < FWD_THREADS:
        split *= 2
    if split == 1:
        return dict(DEFAULTS)
    return {**DEFAULTS, "split": split, "chunk": 64,
            "block_d": max(16, DEFAULTS["block_d"] // split)}


def bwd_defaults(s: int) -> dict:
    """``BWD_DEFAULTS`` at state size ``s``: at most ``s`` threads a
    channel, a power of two that divides every state size the kernel is
    built for."""
    return {**BWD_DEFAULTS, "split": min(BWD_DEFAULTS["split"], s)}


class SelectiveScan(torch.autograd.Function):
    """(y, h_T) through the forward kernel; the gradients of both through
    the backward kernel, from the saved operands."""

    @staticmethod
    def forward(ctx, x, delta, a, b, c, d, h0, fwd: dict, bwd: dict):
        y, h_t = selective_scan_fwd(x, delta, a, b, c, d, h0, **fwd)
        ctx.save_for_backward(x, delta, a, b, c, d, h0)
        ctx.bwd = bwd
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        grads = selective_scan_bwd(*ctx.saved_tensors, dy.contiguous(),
                                   dh_t.contiguous(), **ctx.bwd)
        return (*grads, None, None)


def selective_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor | None = None, *,
                   block_d: int | None = None, chunk: int | None = None,
                   split: int | None = None, tuned: bool | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, delta: (B, T, dI); a: (dI, S); b, c: (B, T, S); d: (dI,); h0:
    (B, dI, S) or None (zeros).  Returns (y (B, T, dI), h_T (B, dI, S)),
    float32.

    ``tuned=True`` resolves the cached best launch parameters, forward and
    backward independently, for this (shape, dtype, device) with zero
    measurements; ``tuned=None`` does so only when tuning was enabled
    globally (``repro_torch.tune.kernels.configure``).
    """
    bt, t, di = x.shape
    s = a.shape[1]
    meta = {"bt": bt, "t": t, "di": di, "s": s}
    p = resolve_launch_params(
        "mamba_scan", meta, torch.float32, defaults=defaults(meta),
        overrides={"block_d": block_d, "chunk": chunk, "split": split},
        tuned=tuned, device=x.device)
    if h0 is None:
        h0 = torch.zeros((bt, di, s), dtype=torch.float32, device=x.device)

    def f32(m: torch.Tensor) -> torch.Tensor:
        return m.to(torch.float32).contiguous()

    args = (f32(x), f32(delta), f32(a), f32(b), f32(c), f32(d), f32(h0))
    if torch.is_grad_enabled() and any(m.requires_grad for m in args):
        pb = resolve_launch_params(
            "mamba_scan_bwd", meta, torch.float32, defaults=bwd_defaults(s),
            tuned=tuned, device=x.device)
        return SelectiveScan.apply(*args, p, pb)
    return selective_scan_fwd(*args, **p)
