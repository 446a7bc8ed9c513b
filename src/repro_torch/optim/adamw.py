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

Over ranks that each hold a block of a leaf cut along its last axis, an
int8 moment is quantized on the whole leaf's grid of ``BLOCK`` columns
(``grid``: the block's ``dist.sharding.Spread`` along that axis): a block
of the grid that straddles ranks takes its scale (and ``minv``) from a
max over the ranks that share it, so the dequantized moments are the
one-process ones.  Such a rank's moment holds
``q`` for its own columns only (no padding) and ``scale``/``minv`` for
every block of the grid along its rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Mapping

import torch
import torch.nn.functional as F

if TYPE_CHECKING:
    from ..dist.sharding import Spread

__all__ = ["AdamWConfig", "BLOCK", "apply_updates",
           "dequantize_moment", "global_norm", "init_opt_state",
           "quantize_moment"]

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

def _span(grid: Spread, width: int) -> tuple[int, int, int]:
    """(first grid block, blocks touched, offset of the block's first
    column in the first) of a block ``width`` columns wide."""
    start = grid.start[-1]
    b0 = start // BLOCK
    b1 = -(-(start + width) // BLOCK)
    return b0, b1 - b0, start - b0 * BLOCK


def _on_grid(x: torch.Tensor, grid: Spread, fill: float
             ) -> torch.Tensor:
    """``x`` (..., w) placed in the grid blocks it touches: (..., nb, BLOCK)
    with ``fill`` in the other columns."""
    w = x.shape[-1]
    b0, nb, off = _span(grid, w)
    buf = x.new_full((*x.shape[:-1], nb * BLOCK), fill)
    buf[..., off:off + w] = x
    return buf.reshape(*x.shape[:-1], nb, BLOCK)


def _off_grid(blocks: torch.Tensor, grid: Spread, w: int
              ) -> torch.Tensor:
    _, _, off = _span(grid, w)
    return blocks.reshape(*blocks.shape[:-2], -1)[..., off:off + w]


def _quantize_on_grid(x: torch.Tensor, log: bool, grid: Spread) -> dict:
    """``quantize_moment`` of a block of a leaf cut along its last axis:
    each element takes the scale of its block of the whole leaf's grid
    (the same arithmetic, so the same codes)."""
    w = x.shape[-1]
    b0, nb, off = _span(grid, w)
    total = grid.shape[-1]
    n_grid = -(-total // BLOCK)
    x32 = x.float()
    stats = x32.new_full((2 if log else 1, *x.shape[:-1], n_grid),
                         -math.inf if log else 0.0)
    if log:
        l = torch.log2(x32.clamp_min(1e-30))
        lo, hi = _on_grid(l, grid, math.inf), _on_grid(l, grid, -math.inf)
        tail = nb * BLOCK - off - w
        if grid.start[-1] + w == total and tail:
            # the whole leaf's zero padding, as quantize_moment pads it
            pad = torch.log2(x32.new_zeros(()).clamp_min(1e-30))
            for t in (lo, hi):
                t.reshape(*t.shape[:-2], -1)[..., -tail:] = pad
        stats[0, ..., b0:b0 + nb] = hi.amax(dim=-1)
        stats[1, ..., b0:b0 + nb] = -lo.amin(dim=-1)
        grid.max_(stats)
        lmax, lmin = stats[0], -stats[1]
        scale = ((lmax - lmin) / 254.0).clamp_min(1e-9)
        blocks = _on_grid(l, grid, 0.0)
        q = torch.round((blocks - lmin[..., b0:b0 + nb, None])
                        / scale[..., b0:b0 + nb, None]) - 127.0
        return {"q": _off_grid(q, grid, w).to(torch.int8), "scale": scale,
                "minv": lmin}
    blocks = _on_grid(x32, grid, 0.0)
    stats[0, ..., b0:b0 + nb] = blocks.abs().amax(dim=-1)
    grid.max_(stats)
    scale = stats[0] / 127.0
    q = torch.round(blocks / scale[..., b0:b0 + nb, None].clamp_min(1e-20))
    return {"q": _off_grid(q, grid, w).to(torch.int8), "scale": scale}


def quantize_moment(x: torch.Tensor, log: bool = False,
                    grid: Spread | None = None) -> dict:
    """Int8 blocks of ``BLOCK`` along the last axis (padded); with
    ``grid``, ``x`` is a rank's block of a leaf cut along that axis."""
    if grid is not None:
        return _quantize_on_grid(x, log, grid)
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


def dequantize_moment(d: Mapping[str, torch.Tensor], shape,
                      grid: Spread | None = None) -> torch.Tensor:
    if grid is not None:
        w = d["q"].shape[-1]
        b0, nb, _ = _span(grid, w)
        blocks = _on_grid(d["q"].float(), grid, 0.0)
        scale = d["scale"][..., b0:b0 + nb, None]
        if "minv" in d:
            l = d["minv"][..., b0:b0 + nb, None] + (blocks + 127.0) * scale
            blocks = torch.where(l <= -95.0, 0.0, torch.exp2(l))
        else:
            blocks = blocks * scale
        return _off_grid(blocks, grid, w).reshape(tuple(shape))
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


def _moment_zeros(p: torch.Tensor, dtype: str, log: bool = False,
                  grid: Spread | None = None):
    zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if dtype == "int8":
        return quantize_moment(zeros, log=log, grid=grid)
    return zeros


# -- optimizer ------------------------------------------------------------------

def init_opt_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                   grids: Mapping[str, Spread] | None = None) -> dict:
    """Zero moments; ``grids`` places the int8 moments of the leaves it
    names on their whole leaves' grids (``ParamLayout.moment_grids``)."""
    if cfg.moments_dtype not in ("float32", "int8"):
        raise ValueError(f"moments_dtype={cfg.moments_dtype!r}")
    grids = grids or {}
    return {
        "m": {n: _moment_zeros(p, cfg.moments_dtype, grid=grids.get(n))
              for n, p in params.items()},
        "v": {n: _moment_zeros(p, cfg.moments_dtype, log=True,
                               grid=grids.get(n))
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
                  norm: Callable[[Mapping], torch.Tensor] | None = None,
                  grids: Mapping[str, Spread] | None = None
                  ) -> torch.Tensor:
    """One AdamW step, in place: ``params`` and ``state`` (moments and
    ``count``) are updated; returns the pre-clip global gradient norm.

    ``decay_mask[name]`` says which parameters take weight decay (default:
    those of two or more dimensions, the reference's rule on its own tree;
    ``LM.decay_mask`` gives the leaves that rule picks in the reference's
    stacked tree).  ``norm`` computes the global gradient norm (default
    ``global_norm``); over ranks that hold blocks of the parameters it is
    ``ParamLayout.global_norm``, and ``params``, ``grads`` and the moments
    are each rank's blocks, updated in place: AdamW is elementwise, and
    ``grids`` (``ParamLayout.moment_grids``) quantizes the int8 moments of
    leaves cut along their last axis on the whole leaves' grids.
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
    grids = grids or {}

    for name, p in params.items():
        g32 = grads[name].float() * clip
        m, v = state["m"][name], state["v"][name]
        grid = grids.get(name)
        m32 = dequantize_moment(m, p.shape, grid) if quant else m
        v32 = dequantize_moment(v, p.shape, grid) if quant else v
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
            state["m"][name] = quantize_moment(m32, grid=grid)
            state["v"][name] = quantize_moment(v32, log=True, grid=grid)
    state["count"] = torch.tensor(count, dtype=torch.int32)
    return gnorm
