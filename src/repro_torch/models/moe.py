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

Expert parallelism (``dist.sharding.compute_layout``): where the rules
split the experts over ranks, ``p["w_in"]``/``p["w_gate"]``/``p["w_out"]``
hold this rank's ``E / n`` experts.  Every rank routes every token (the
router, the top-k, the capacity slots and the aux loss are the reference's),
gathers into its own experts' slots only, runs their products, combines
from those slots only, and the ranks' partial outputs are summed over the
expert axes: the reference's all-to-all dispatch (``constrain(xe, "batch",
"expert", None, None)``) realised as an all-reduce of the combine.  Where
the expert axes include batch axes, the rows of those ranks are gathered
first and the sum is scattered back to each rank's rows.  Over ranks
that split the batch the training aux loss is the whole batch's, as the
reference's: the ranks' routing statistics are summed.  The shared expert
is tensor-parallel over the ``ff`` rule like any MLP.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import (all_gather, all_reduce, all_reduce_,
                                reduce_scatter)
from ..dist.sharding import compute_layout
from .config import ArchConfig
from .layers import dense_init, init_mlp, mlp_partial, param, torch_dtype

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


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig, *,
              seq_dim: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), aux loss scalar).  Under a mesh of
    ranks see the module docstring (``seq_dim``: each rank keeps its rows
    of the summed output, ``seq_parallel``)."""
    m = cfg.moe
    b, t, d = x.shape
    e = m.n_experts
    cap = capacity(t, cfg)                                      # per group
    dt = torch_dtype(cfg.compute_dtype)
    xf = x.to(dt)
    cl = compute_layout()
    mine = None if cl is None else cl.experts(e)
    eb = rest = ()
    if mine is None:
        mine = slice(0, e)
    else:
        eb = tuple(a for a in cl.expert.axes if a in cl.batch_axes)
        rest = tuple(a for a in cl.expert.axes if a not in eb)
    own = xf
    if eb:
        xf = all_gather(xf, cl.mesh, eb, 0)
        b = xf.shape[0]
    probs, top_p, flat_e, keep, slot = _route(p, xf, cfg, cap)

    # dispatch into this rank's experts' slots: a per-group scatter of
    # token ids (the slot n * cap takes the dropped choices and the other
    # ranks' slots, and is cut off), then a gather of rows
    lo, hi = mine.start * cap, mine.stop * cap
    n_mine = mine.stop - mine.start
    local = torch.where((slot >= lo) & (slot < hi), slot - lo,
                        torch.full_like(slot, n_mine * cap))     # (B, Tk)
    token_id = torch.arange(t, device=x.device).repeat_interleave(
        m.top_k).expand(b, -1)
    token_of_slot = torch.zeros((b, n_mine * cap + 1), dtype=torch.long,
                                device=x.device).scatter(1, local, token_id)
    occupied = torch.zeros((b, n_mine * cap + 1), dtype=torch.bool,
                           device=x.device).scatter(
        1, local, torch.ones_like(local, dtype=torch.bool))
    token_of_slot, occupied = token_of_slot[:, :-1], occupied[:, :-1]
    xe = torch.gather(xf, 1, token_of_slot[..., None].expand(
        b, n_mine * cap, d))
    xe = torch.where(occupied[..., None], xe, torch.zeros_like(xe))
    ye = _expert_ffn(p, xe.reshape(b, n_mine, cap, d), cfg)

    # combine: per-group gather of expert outputs back to (token, choice),
    # from this rank's slots (the others' are the zero row)
    ye_pad = torch.cat([ye.reshape(b, n_mine * cap, d),
                        torch.zeros((b, 1, d), dtype=ye.dtype,
                                    device=ye.device)], dim=1)
    back = torch.gather(ye_pad, 1, local[..., None].expand(b, t * m.top_k, d))
    back = back.reshape(b, t, m.top_k, d)
    weights = top_p * keep.reshape(b, t, m.top_k)
    out = torch.einsum("gtkd,gtk->gtd", back.float(), weights).to(dt)

    if eb:
        # the ranks' sum, each keeping its own rows; the aux loss over them
        out = reduce_scatter(out, cl.mesh, eb, 0)
        n = own.shape[0]
        rows = slice(cl.mesh.index(eb) * n, (cl.mesh.index(eb) + 1) * n)
        probs, flat_e, keep = probs[rows], flat_e[rows], keep[rows]

    # load-balance aux (Switch eq. 4-6), over the whole batch
    frac = torch.zeros((flat_e.shape[0], e), dtype=torch.float32,
                       device=x.device)
    frac = frac.scatter_add(1, flat_e, keep.float()).sum(0)
    if cl is not None and cl.batch_axes and torch.is_grad_enabled():
        # the batch's statistics are the sums of the ranks' rows (only
        # training reads the aux loss)
        frac = all_reduce_(torch.cat([frac, keep.sum().float()[None]]),
                           cl.mesh, cl.batch_axes)
        frac = frac[:e] / frac[e].clamp_min(1.0)
        mean = all_reduce(torch.cat([probs.sum(dim=(0, 1)), probs.new_full(
            (1,), probs.shape[0] * probs.shape[1])]), cl.mesh,
            cl.batch_axes)
        aux = e * (frac * (mean[:e] / mean[e])).sum()
    else:
        frac = frac / keep.sum().float().clamp_min(1.0)
        aux = e * (frac * probs.mean(dim=(0, 1))).sum()

    if m.n_shared:
        gate = torch.sigmoid((own @ p["shared_gate"].to(dt)).float()).to(dt)
        shared, partial = mlp_partial(p["shared"], own, cfg, m.d_shared)
        shared = gate * shared
        if cl is None:
            return out + shared, aux
        if set(partial) != set(rest):
            return (cl.reduce(out, rest, seq_dim)
                    + cl.reduce(shared, partial, seq_dim)), aux
        out = out + shared
    return (out if cl is None else cl.reduce(out, rest, seq_dim)), aux


def _route(p, xf: torch.Tensor, cfg: ArchConfig, cap: int):
    """The reference's routing of every row of ``xf``: (probs, top_p,
    flat_e, keep, slot)."""
    m = cfg.moe
    b, t, _ = xf.shape
    e = m.n_experts
    dt = xf.dtype
    logits = (xf @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, m.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(b, t * m.top_k)
    onehot = F.one_hot(flat_e, e)
    ranks = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(ranks, 2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))
    return probs, top_p, flat_e, keep, slot


def _expert_ffn(p, xe: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, p["w_in"].to(dt))
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt))
        h = F.silu(g) * h
    elif cfg.mlp_type == "squared_relu":
        h = F.relu(h).square()
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, p["w_out"].to(dt))
