"""RWKV-6 "Finch" mixer: data-dependent token shift (ddlerp), data-dependent
per-channel decay, and the wkv matrix-state recurrence.

Per head with state S (hd x hd, key dim x value dim):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,     w_t = exp(-exp(decay_t))

The recurrence runs in the wkv kernel (``repro_torch.kernels.rwkv6_wkv``)
for prefill and for every decode step: decode is the same time mix at
T = 1, carrying ``{"tmix_prev", "cmix_prev", "wkv"}``, as in the
reference.  The reference's XLA ``wkv_scan`` has no counterpart: in the
port ``attn_impl`` ``"auto"`` and ``"pallas"`` both mean the kernel, whose
plain PyTorch version runs for tensors on the CPU.  Training runs the same
``apply_rwkv_tmix`` and ``apply_rwkv_cmix`` with autograd recording: the
recurrence's gradient comes from the wkv backward kernel (``Wkv6``).

Over ranks whose rules split the heads (``dist.sharding.compute_layout``,
the reference's ``constrain`` of r/k/v on ``"heads"`` and of the channel
mix's hidden on ``"ff"``): ddlerp runs whole on every rank; each rank
projects r/k/v/g and the decay on the channels of its heads, runs the wkv
kernels and the per-head group norm on them, and the ranks' output
projections are summed (with ``seq_dim``, each keeps its rows of the sum:
``seq_parallel``).  The channel mix computes its ``ff`` columns, sums
``vv`` over the ranks and gates it with the whole ``r``.  The decode
state's ``wkv`` holds the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import ComputeLayout, compute_layout, region
from ..kernels.rwkv6_wkv import ops as wkv_ops
from .config import ArchConfig, RwkvConfig
from .layers import (dense_init, finish, group_norm, param, rand_init,
                     torch_dtype)

__all__ = ["apply_rwkv_cmix", "apply_rwkv_tmix", "cmix_region",
           "init_rwkv_cmix", "init_rwkv_state", "init_rwkv_tmix",
           "n_rwkv_heads", "tmix_region"]


def _rcfg(cfg: ArchConfig) -> RwkvConfig:
    return cfg.rwkv or RwkvConfig()


def n_rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // _rcfg(cfg).head_dim


def _rank_heads(cfg: ArchConfig) -> tuple[int, tuple]:
    """(the wkv heads this rank computes, the mesh axes over which the
    ranks' time-mix outputs are summed: ``()`` where it computes them
    all)."""
    h = n_rwkv_heads(cfg)
    cl = compute_layout()
    mine = None if cl is None else cl.heads(h)
    if mine is None:
        return h, ()
    return mine.stop - mine.start, cl.model.axes


def tmix_region(leaf: str, shape, cfg: ArchConfig,
                cl: ComputeLayout) -> tuple:
    """The compute region of a time-mix leaf: the channels of this rank's
    heads in r/k/v/g's and the decay LoRA's columns, in the decay base,
    the group norm's affine and the output projection's rows, its heads'
    rows of ``u``; ddlerp's leaves whole."""
    h = n_rwkv_heads(cfg)
    ch = cl.head_channels(h, _rcfg(cfg).head_dim)
    if leaf in ("wr", "wk", "wv", "wg", "decay_lora_b"):
        return region(shape, 1, ch, cl.model)
    if leaf in ("decay_base", "ln_scale", "ln_bias", "wo"):
        return region(shape, 0, ch, cl.model)
    if leaf == "u":
        return region(shape, 0, cl.heads(h), cl.model)
    return region(shape)


def cmix_region(leaf: str, shape, cfg: ArchConfig,
                cl: ComputeLayout) -> tuple:
    """The compute region of a channel-mix leaf: this rank's ``ff``
    columns of ``wk_ff`` and rows of ``wv_ff``; ``wr_ff`` whole."""
    if leaf == "wk_ff":
        return region(shape, 1, cl.ff(cfg.d_ff), cl.ff_split)
    if leaf == "wv_ff":
        return region(shape, 0, cl.ff(cfg.d_ff), cl.ff_split)
    return region(shape)




def init_rwkv_tmix(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    d, dt = cfg.d_model, cfg.param_dtype
    r = _rcfg(cfg)
    h = n_rwkv_heads(cfg)
    p = {
        "mu_base": rand_init(gen, (d,), dt, device, uniform=True, scale=0.5),
        "mix_lora_a": dense_init(gen, (d, 5 * r.lora_rank_mix), dt, device),
        "mix_lora_b": rand_init(gen, (5, r.lora_rank_mix, d), dt, device,
                                uniform=False, scale=0.01),
        "mu": rand_init(gen, (5, d), dt, device, uniform=True, scale=0.5),
        "decay_base": torch.full((d,), -4.0, dtype=torch.float32,
                                 device=device),
        "decay_lora_a": dense_init(gen, (d, r.lora_rank_decay), dt, device),
        "decay_lora_b": rand_init(gen, (r.lora_rank_decay, d), dt, device,
                                  uniform=False, scale=0.01),
    }
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, (d, d), dt, device)
    p["u"] = rand_init(gen, (h, r.head_dim), "float32", device,
                       uniform=False, scale=0.1)
    pdt = torch_dtype(dt)
    p["ln_scale"] = torch.ones(d, dtype=pdt, device=device)
    p["ln_bias"] = torch.zeros(d, dtype=pdt, device=device)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """The x_{t-1} stream; ``prev`` is the last token of the previous
    segment (zeros at the start)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, shifted: torch.Tensor,
            cfg: ArchConfig) -> list[torch.Tensor]:
    """Data-dependent interpolation producing the 5 mixed streams."""
    dtc = torch_dtype(cfg.compute_dtype)
    dx = (shifted - x).to(dtc)
    xc = x.to(dtc)
    base = xc + dx * p["mu_base"].to(dtc)
    lora = torch.tanh(base @ p["mix_lora_a"].to(dtc))          # (B, T, 5R)
    lora = lora.reshape(*lora.shape[:-1], 5, -1)
    adj = torch.einsum("btfr,frd->btfd", lora, p["mix_lora_b"].to(dtc))
    mixes = p["mu"].to(dtc) + adj                               # (B, T, 5, D)
    return [xc + dx * mixes[..., i, :] for i in range(5)]


def apply_rwkv_tmix(p, x: torch.Tensor, cfg: ArchConfig,
                    state: dict | None = None, return_state: bool = False,
                    seq_dim: int | None = None
                    ) -> tuple[torch.Tensor, dict | None]:
    """Time mix over a segment. x: (B, T, D); ``state`` carries the
    previous segment's last token and wkv state (decode).  Over ranks
    ``p`` holds the rank's heads (see the module docstring)."""
    b, t, _ = x.shape
    hd = _rcfg(cfg).head_dim
    h, partial = _rank_heads(cfg)
    d = h * hd
    dtc = torch_dtype(cfg.compute_dtype)
    prev = state["tmix_prev"][:, None] if state is not None else None
    xr, xk, xv, xg, xw = _ddlerp(p, x, _token_shift(x, prev), cfg)

    r = (xr @ p["wr"].to(dtc)).reshape(b, t, h, hd)
    k = (xk @ p["wk"].to(dtc)).reshape(b, t, h, hd)
    v = (xv @ p["wv"].to(dtc)).reshape(b, t, h, hd)
    g = xg @ p["wg"].to(dtc)
    decay = p["decay_base"].float() + (
        torch.tanh(xw @ p["decay_lora_a"].to(dtc))
        @ p["decay_lora_b"].to(dtc)).float()
    w = torch.exp(-torch.exp(decay)).reshape(b, t, h, hd)

    # tuned=None: the cached best launch parameters when kernel tuning is
    # enabled (repro_torch.tune.kernels.configure), the defaults otherwise
    s0 = state["wkv"] if state is not None else None
    y, s_t = wkv_ops.wkv6(r.float(), k.float(), v.float(), w, p["u"], s0,
                          tuned=None)

    y = group_norm(y.reshape(b, t, d), h)
    y = y * p["ln_scale"].to(y.dtype) + p["ln_bias"].to(y.dtype)
    out = finish((y.to(dtc) * F.silu(g)) @ p["wo"].to(dtc), partial, seq_dim)
    new_state = None
    if state is not None or return_state:
        new_state = {"tmix_prev": x[:, -1], "wkv": s_t}
    return out, new_state


# -- channel mix ----------------------------------------------------------------

def init_rwkv_cmix(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    """The reference draws ``mu_k``, ``mu_r`` and ``wr_ff`` from one key
    (so ``mu_k == mu_r`` there at init); here each has its own draws."""
    d, dt = cfg.d_model, cfg.param_dtype
    return nn.ParameterDict({
        "mu_k": param(rand_init(gen, (d,), dt, device, uniform=True,
                                scale=0.5)),
        "mu_r": param(rand_init(gen, (d,), dt, device, uniform=True,
                                scale=0.5)),
        "wk_ff": param(dense_init(gen, (d, cfg.d_ff), dt, device)),
        "wv_ff": param(dense_init(gen, (cfg.d_ff, d), dt, device)),
        "wr_ff": param(dense_init(gen, (d, d), dt, device)),
    })


def apply_rwkv_cmix(p, x: torch.Tensor, cfg: ArchConfig,
                    state: dict | None = None, return_state: bool = False,
                    seq_dim: int | None = None
                    ) -> tuple[torch.Tensor, dict | None]:
    dtc = torch_dtype(cfg.compute_dtype)
    prev = state["cmix_prev"][:, None] if state is not None else None
    dx = (_token_shift(x, prev) - x).to(dtc)
    xc = x.to(dtc)
    xk = xc + dx * p["mu_k"].to(dtc)
    xr = xc + dx * p["mu_r"].to(dtc)
    k = F.relu(xk @ p["wk_ff"].to(dtc)).square()
    cl = compute_layout()
    split = cl is not None and cl.ff(cfg.d_ff) is not None
    vv = finish(k @ p["wv_ff"].to(dtc), cl.ff_split.axes if split else (),
                seq_dim)
    r = finish(torch.sigmoid(xr @ p["wr_ff"].to(dtc)), (), seq_dim)
    new_state = ({"cmix_prev": x[:, -1]}
                 if (state is not None or return_state) else None)
    return r * vv, new_state


def init_rwkv_state(cfg: ArchConfig, batch: int, device) -> dict:
    """Zero decode state; ``wkv`` holds the heads this rank computes."""
    hd = _rcfg(cfg).head_dim
    h, _ = _rank_heads(cfg)
    dtc = torch_dtype(cfg.compute_dtype)
    return {
        "tmix_prev": torch.zeros((batch, cfg.d_model), dtype=dtc,
                                 device=device),
        "cmix_prev": torch.zeros((batch, cfg.d_model), dtype=dtc,
                                 device=device),
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
    }
