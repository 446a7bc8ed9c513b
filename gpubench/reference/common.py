"""Pieces every plain reference shares: float32 with TF32 off, matrix
products that the control rounds to float8, norms, rotary positions, the
cross-entropy, AdamW.

Plain PyTorch only: nothing here imports the program or JAX.  The
control (``quant="fp8"``) is the reference itself computed one precision
below the configuration's bfloat16, rounded to float8 where the program
keeps bfloat16: every matrix product's operands and result, each norm's
output and the residual stream (``q``), forward in e4m3 and the gradient
that flows back through each of those points in e5m2 (the usual float8
training recipe), each with a scale a tensor.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for this block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def round8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with one scale for the
    tensor, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX[dtype]
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round8(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, and the gradient that flows back
    through it to float8 e5m2."""
    return _Fp8.apply(x)


def q(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``x`` as the control stores it: float8 under ``"fp8"``."""
    if quant == "fp8":
        return fp8(x)
    if quant is not None:
        raise ValueError(f"quant={quant!r}")
    return x


def mm(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``x @ w`` in float32, or operands and result in float8 (control)."""
    if quant is None:
        return x @ w
    return q(q(x, quant) @ q(w, quant), quant)


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x, scale, bias, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def norm(p: dict, prefix: str, x, arch: dict):
    """The configuration's norm: LayerNorm where it states one (a scale and
    a bias), else RMSNorm (a scale)."""
    if arch.get("norm_type") == "layernorm":
        return layer_norm(x, p[prefix + "scale"], p[prefix + "bias"],
                          arch["norm_eps"])
    return rms_norm(x, p[prefix + "scale"], arch["norm_eps"])


def norm_leaves(prefix: str, arch: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, value) of a norm's leaves: ones, zeros for a bias."""
    d = arch["d_model"]
    out = [(prefix + "scale", (d,), 1.0)]
    if arch.get("norm_type") == "layernorm":
        out.append((prefix + "bias", (d,), 0.0))
    return out


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..T-1 on (B, T, H, hd), the split-halves form."""
    t, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def xent(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
         quant: str | None, rows: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy of hidden states ``h`` (N, D) under
    the head (D, V), ``rows`` positions at a time, each block's logits
    recomputed in the backward pass rather than kept."""
    def block(hb, lb, w):
        logits = mm(hb, w, quant)
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lb[:, None])[:, 0]).sum()

    total = h.new_zeros(())
    for i in range(0, h.shape[0], rows):
        total = total + checkpoint(block, h[i:i + rows], labels[i:i + rows],
                                   head, use_reentrant=False)
    return total / h.shape[0]


# -- AdamW ---------------------------------------------------------------------------

def decays(name: str, shape) -> bool:
    """The configuration's weight-decay rule: every leaf of two or more
    dimensions, and every leaf of a layer (a layer's leaves are decayed as
    slices of a stack over the layers); not the final norm's."""
    return len(shape) + name.startswith("layers.") >= 2


def adamw_step(params: dict, grads: dict, state: dict, opt: dict) -> dict:
    """One AdamW step in place (float32): global-norm clip, decoupled
    weight decay, bias correction.  Returns the gradient's norm before
    the clip."""
    step = state.setdefault("count", 0) + 1
    state["count"] = step
    gnorm = torch.stack([g.square().sum() for g in grads.values()]).sum() \
        .sqrt()
    clip = torch.clamp(opt["grad_clip"] / gnorm.clamp_min(1e-12), max=1.0)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for n, p in params.items():
        g = grads[n] * clip
        m = state.setdefault("m", {}).setdefault(n, torch.zeros_like(p))
        v = state.setdefault("v", {}).setdefault(n, torch.zeros_like(p))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1) / ((v / bc2).sqrt() + opt["eps"])
        if decays(n, p.shape) and opt["weight_decay"]:
            upd = upd + opt["weight_decay"] * p
        p.sub_(opt["learning_rate"] * upd)
    return gnorm


def leaf_gaps(prog: dict[str, float], ref: dict[str, float],
              names=None) -> dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (some gradients are all but zero)."""
    names = sorted(ref) if names is None else sorted(names)
    med = median(list(ref.values()))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def median(values: list[float]) -> float:
    values = sorted(values)
    return values[len(values) // 2]
