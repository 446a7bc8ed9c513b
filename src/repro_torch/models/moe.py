"""Mixture-of-Experts layer: top-k routing, capacity-bounded gather/scatter
dispatch, shared experts, and the Switch load-balancing loss.

Each batch row is a routing group (the reference's GShard/T5X layout):
the (T, k) choices are slotted token-major by an exclusive cumsum per
expert, a choice past an expert's capacity is dropped (its token falls
through to the residual path), and the expert FFNs run on the gathered
(B, E, C, D) rows as batched products.  The reference computes all of
this outside any Pallas kernel, and so does the port: plain PyTorch, with
the expert products left to ``torch.einsum``.

Top-k ties: the router's logits are taken in the compute dtype, so equal
probabilities among the experts happen; ``jax.lax.top_k`` returns the
lower expert index first, and so does the stable descending sort here
(``torch.topk`` promises no order among ties).

The reference's ``constrain`` sharding hints have no effect on one card
and are dropped; expert parallelism is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import ArchConfig
from .layers import apply_mlp, dense_init, init_mlp, param, torch_dtype

__all__ = ["ParamTree", "apply_moe", "capacity", "init_moe", "top_k"]


class ParamTree(nn.Module):
    """Parameters and nested parameter dicts under the reference's keys
    (``p["router"]``, ``p["shared"]["w_in"]``): an ``nn.ParameterDict``
    cannot hold a sub-dict, an ``nn.ModuleDict`` cannot hold a parameter."""

    def __init__(self, entries: dict):
        super().__init__()
        for key, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(key, value)
            else:
                self.register_parameter(key, param(value))

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def items(self):
        return [(k, self[k]) for k in self.keys()]


def init_moe(gen, cfg: ArchConfig, device) -> ParamTree:
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    d, dt = cfg.d_model, cfg.param_dtype
    p: dict = {
        "router": dense_init(gen, (d, m.n_experts), dt, device),
        "w_in": dense_init(gen, (m.n_experts, d, m.d_expert), dt, device,
                           in_axis=1),
        "w_out": dense_init(gen, (m.n_experts, m.d_expert, d), dt, device,
                            in_axis=1),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, (m.n_experts, d, m.d_expert), dt,
                                 device, in_axis=1)
    if m.n_shared:
        shared_cfg = dataclasses.replace(cfg, d_ff=m.d_shared)
        p["shared"] = init_mlp(gen, shared_cfg, device, d_ff=m.d_shared)
        p["shared_gate"] = dense_init(gen, (d, 1), dt, device)
    return ParamTree(p)


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last dim, the lower index first among
    equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), aux loss scalar)."""
    m = cfg.moe
    b, t, d = x.shape
    e = m.n_experts
    cap = capacity(t, cfg)                                      # per group
    dt = torch_dtype(cfg.compute_dtype)
    xf = x.to(dt)

    logits = (xf @ p["router"].to(dt)).float()                  # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, m.top_k)                        # (B, T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # slotting within each group, token-major over (T, k)
    flat_e = top_e.reshape(b, t * m.top_k)                      # (B, Tk)
    onehot = F.one_hot(flat_e, e)
    ranks = torch.cumsum(onehot, dim=1) - onehot                # exclusive
    pos = torch.gather(ranks, 2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))           # (B, Tk)

    # dispatch: per-group scatter of token ids (the slot e * cap takes the
    # dropped choices and is cut off), then gather rows
    token_id = torch.arange(t, device=x.device).repeat_interleave(
        m.top_k).expand(b, -1)
    token_of_slot = torch.zeros((b, e * cap + 1), dtype=torch.long,
                                device=x.device).scatter(1, slot, token_id)
    occupied = torch.zeros((b, e * cap + 1), dtype=torch.bool,
                           device=x.device).scatter(
        1, slot, torch.ones_like(slot, dtype=torch.bool))
    token_of_slot, occupied = token_of_slot[:, :-1], occupied[:, :-1]
    xe = torch.gather(xf, 1, token_of_slot[..., None].expand(b, e * cap, d))
    xe = torch.where(occupied[..., None], xe, torch.zeros_like(xe))
    xe = xe.reshape(b, e, cap, d)

    # expert FFNs
    h = torch.einsum("gecd,edf->gecf", xe, p["w_in"].to(dt))
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt))
        h = F.silu(g) * h
    elif cfg.mlp_type == "squared_relu":
        h = F.relu(h).square()
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("gecf,efd->gecd", h, p["w_out"].to(dt))

    # combine: per-group gather of expert outputs back to (token, choice)
    ye_pad = torch.cat([ye.reshape(b, e * cap, d),
                        torch.zeros((b, 1, d), dtype=ye.dtype,
                                    device=ye.device)], dim=1)
    back = torch.gather(ye_pad, 1, slot[..., None].expand(b, t * m.top_k, d))
    back = back.reshape(b, t, m.top_k, d)
    weights = top_p * keep.reshape(b, t, m.top_k)
    out = torch.einsum("gtkd,gtk->gtd", back.float(), weights).to(dt)

    if m.n_shared:
        gate = torch.sigmoid((xf @ p["shared_gate"].to(dt)).float()).to(dt)
        out = out + gate * apply_mlp(p["shared"], xf, cfg)

    # load-balance aux (Switch eq. 4-6), over the whole batch
    frac = torch.zeros((b, e), dtype=torch.float32, device=x.device)
    frac = frac.scatter_add(1, flat_e, keep.float()).sum(0)
    frac = frac / keep.sum().float().clamp_min(1.0)
    aux = e * (frac * probs.mean(dim=(0, 1))).sum()
    return out, aux
