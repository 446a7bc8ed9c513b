"""AdamW from scratch, with optionally int8 block-quantized moments.

The port of the reference's ``optim/adamw.py``: decoupled weight decay,
global-norm gradient clipping, bias correction, and moments either float32
or int8 with per-block scales (``BLOCK`` values along the last axis,
padded; the first moment linear absmax, the second logarithmic, because it
feeds a division).

What differs is the container and the idiom.  The state holds tensors
keyed by the parameters' names (``{"m": {name: ...}, "v": {name: ...},
"count": int32 0-dim}``), not a pytree, and ``apply_updates`` updates the
parameters and the moments in place under ``torch.no_grad()``, in float32,
instead of returning new trees: at 3e9 parameters a second copy of the
parameters and moments would not fit beside the first.  The scalar
factors (learning rate, bias corrections) are float32 values computed on
the host from the count, as the reference computes them in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

__all__ = ["AdamWConfig", "BLOCK", "apply_updates", "dequantize_moment",
           "global_norm", "init_opt_state", "quantize_moment"]

BLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float | Callable[[int], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"   # "float32" | "int8"

    def lr_at(self, step: int) -> float:
        """The learning rate at ``step`` as the float32 value it has in
        the reference (returned as a Python float, exactly)."""
        if callable(self.learning_rate):
            return float(self.learning_rate(step))
        return float(torch.tensor(self.learning_rate, dtype=torch.float32))


# -- int8 block quantization (last-axis blocks) ------------------------------------
#
# First moment m (signed): linear absmax blocks.  Second moment v (>= 0)
# feeds a DIVISION, so linear quantization is catastrophic (small entries
# in a block with one large entry collapse to 0 -> update = m/eps); v is
# quantized LOGARITHMICALLY instead, giving bounded multiplicative error.

def quantize_moment(x: torch.Tensor, log: bool = False) -> dict:
    last = x.shape[-1] if x.dim() else 1
    xe = x.reshape(tuple(x.shape) or (1,)).float()
    pad = (-last) % BLOCK
    if pad:
        xe = F.pad(xe, (0, pad))
    blocks = xe.reshape(*xe.shape[:-1], -1, BLOCK)
    if log:
        # the floor stays in the float32 normal range: log2(0) = -inf
        # would poison the whole block
        l = torch.log2(blocks.clamp_min(1e-30))
        lmin = l.amin(dim=-1)
        lmax = l.amax(dim=-1)
        scale = ((lmax - lmin) / 254.0).clamp_min(1e-9)           # (..., nb)
        q = torch.round((l - lmin[..., None]) / scale[..., None]) - 127.0
        return {"q": q.reshape(xe.shape).to(torch.int8), "scale": scale,
                "minv": lmin}
    scale = blocks.abs().amax(dim=-1) / 127.0                     # (..., nb)
    q = torch.round(blocks / scale[..., None].clamp_min(1e-20))
    return {"q": q.reshape(xe.shape).to(torch.int8), "scale": scale}


def dequantize_moment(d: Mapping[str, torch.Tensor], shape) -> torch.Tensor:
    q = d["q"].float()
    blocks = q.reshape(*q.shape[:-1], -1, BLOCK)
    if "minv" in d:
        l = d["minv"][..., None] + (blocks + 127.0) * d["scale"][..., None]
        blocks = torch.where(l <= -95.0, 0.0, torch.exp2(l))
    else:
        blocks = blocks * d["scale"][..., None]
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    return blocks.reshape(q.shape)[..., :last].reshape(shape)


def _moment_zeros(p: torch.Tensor, dtype: str, log: bool = False):
    zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if dtype == "int8":
        return quantize_moment(zeros, log=log)
    return zeros


# -- optimizer ------------------------------------------------------------------

def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: AdamWConfig) -> dict:
    if cfg.moments_dtype not in ("float32", "int8"):
        raise ValueError(f"moments_dtype={cfg.moments_dtype!r}")
    return {
        "m": {n: _moment_zeros(p, cfg.moments_dtype) for n, p in params.items()},
        "v": {n: _moment_zeros(p, cfg.moments_dtype, log=True)
              for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32),
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.stack([g.float().square().sum()
                        for g in tree.values()]).sum().sqrt()


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: dict,
                  cfg: AdamWConfig, *,
                  decay_mask: Mapping[str, bool] | None = None,
                  norm: Callable[[Mapping], torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """One AdamW step, in place: ``params`` and ``state`` (moments and
    ``count``) are updated; returns the pre-clip global gradient norm.

    ``decay_mask[name]`` says which parameters take weight decay (default:
    those of two or more dimensions, the reference's rule on its own tree;
    ``LM.decay_mask`` gives the leaves that rule picks in the reference's
    stacked tree).  ``norm`` computes the global gradient norm (default
    ``global_norm``); over ranks that hold blocks of the parameters it is
    ``ParamLayout.global_norm``, and ``params``, ``grads`` and the moments
    are each rank's blocks, updated in place: AdamW is elementwise.
    """
    count = int(state["count"]) + 1
    gnorm = (norm or global_norm)(grads)
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-12), max=1.0)
    else:
        clip = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = cfg.lr_at(count)
    c32 = torch.tensor(count, dtype=torch.float32)
    bc1 = float(1.0 - _f32(cfg.b1) ** c32)
    bc2 = float(1.0 - _f32(cfg.b2) ** c32)
    quant = cfg.moments_dtype == "int8"

    for name, p in params.items():
        g32 = grads[name].float() * clip
        m, v = state["m"][name], state["v"][name]
        m32 = dequantize_moment(m, p.shape) if quant else m
        v32 = dequantize_moment(v, p.shape) if quant else v
        m32.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
        v32.mul_(cfg.b2).add_((1.0 - cfg.b2) * g32.square_())
        del g32
        upd = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
        decay = (decay_mask[name] if decay_mask is not None
                 else p.dim() >= 2)
        if decay and cfg.weight_decay:
            upd.add_(cfg.weight_decay * p.float())
        upd.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p.float().sub_(upd))
        if quant:
            state["m"][name] = quantize_moment(m32)
            state["v"][name] = quantize_moment(v32, log=True)
    state["count"] = torch.tensor(count, dtype=torch.int32)
    return gnorm
