"""Mamba-1 selective-state-space mixer (Jamba's SSM layers).

Prefill runs the selective scan in the scan kernel
(``repro_torch.kernels.mamba_scan``) with a float32 (B, d_inner, d_state)
state; the (B, T, d_inner, d_state) discretised tensors are never
materialised.  Decode keeps a (conv window, ssm state) pair per layer and
advances one token in O(d_inner * d_state) in plain PyTorch, as the
reference computes it outside any Pallas kernel.  In the port
``attn_impl`` ``"auto"`` and ``"pallas"`` both mean the kernel, whose plain
PyTorch version runs for tensors on the CPU.  Training runs the same
``apply_mamba`` with autograd recording: the scan's gradient comes from its
backward kernel (``SelectiveScan``).

Under ``mamba_tp`` over ranks (the reference's ``"mamba_ff"`` rule at its
``constrain`` of ``xs``; ``dist.sharding.compute_layout``) each rank runs
its channels of ``d_inner``: ``in_proj`` holds the rank's columns of the
``xs`` half and the same columns of the ``z`` half, the conv, ``dt_proj``,
the scan and ``D`` its channels, and ``x_proj`` its rows, so ``dbc`` is a
partial sum, summed over the ranks before ``dt_proj``; the ranks' output
projections are summed (with ``seq_dim``, each keeps its rows of the sum:
``seq_parallel``).  The decode state holds the rank's channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.collectives import all_reduce
from ..dist.sharding import ComputeLayout, compute_layout, region
from ..kernels.mamba_scan import ops as ms_ops
from .config import ArchConfig, MambaConfig
from .layers import dense_init, finish, param, rand_init, torch_dtype

__all__ = ["apply_mamba", "decode_mamba", "init_mamba", "init_mamba_state",
           "mamba_region"]


def _dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    m = cfg.mamba or MambaConfig()
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_in, m.d_state, m.d_conv, dt_rank


def _rank_split(cfg: ArchConfig) -> tuple[int, tuple]:
    """(the ``d_inner`` channels this rank computes, the mesh axes its
    partial sums are summed over: ``()`` where it computes them all)."""
    d_in = _dims(cfg)[0]
    cl = compute_layout()
    mine = None if cl is None else cl.mamba_channels(d_in)
    if mine is None:
        return d_in, ()
    return mine.stop - mine.start, cl.mamba.axes


def mamba_region(leaf: str, shape, cfg: ArchConfig,
                 cl: ComputeLayout) -> tuple:
    """The compute region of a mixer leaf under ``mamba_tp``: this rank's
    channels (``in_proj``: of both halves, two ranges), ``x_proj``'s and
    ``out_proj``'s rows of them; every leaf whole without it."""
    d_in = _dims(cfg)[0]
    c = cl.mamba_channels(d_in)
    if c is None:
        return region(shape)
    if leaf == "in_proj":
        return region(shape, 1, (c, slice(d_in + c.start, d_in + c.stop)),
                      cl.mamba, even=False)
    if leaf in ("conv_w", "dt_proj"):
        return region(shape, 1, c, cl.mamba)
    return region(shape, 0, c, cl.mamba)


def init_mamba(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    d, dt = cfg.d_model, cfg.param_dtype
    d_in, d_state, d_conv, dt_rank = _dims(cfg)
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1] (mamba init)
    u = rand_init(gen, (d_in,), "float32", device, uniform=True, scale=1.0)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device))
    p = {
        "in_proj": dense_init(gen, (d, 2 * d_in), dt, device),
        "conv_w": rand_init(gen, (d_conv, d_in), dt, device, uniform=False,
                            scale=d_conv ** -0.5),
        "conv_b": torch.zeros(d_in, dtype=torch_dtype(dt), device=device),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * d_state), dt, device),
        "dt_proj": dense_init(gen, (dt_rank, d_in), dt, device),
        "dt_bias": dt_bias.to(torch_dtype(dt)),
        "A_log": a_log[None, :].repeat(d_in, 1),
        "D": torch.ones(d_in, dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (d_in, d), dt, device),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along time. x: (B, T, C), w: (K, C); the
    ``prefix`` (B, K-1, C) holds the K-1 inputs before x (zeros at the
    start)."""
    k = w.shape[0]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i] for i in range(k))
    return out + b


def _ssm_inputs(p, xc: torch.Tensor, cfg: ArchConfig, partial: tuple = ()):
    """(delta, A, B, C): the ``x_proj`` product in compute dtype (summed
    in float32 over ``partial``, the ranks' channels), then ``dt_proj``,
    softplus and ``A = -exp(A_log)`` in float32."""
    _, d_state, _, dt_rank = _dims(cfg)
    dtc = torch_dtype(cfg.compute_dtype)
    dbc = (xc.to(dtc) @ p["x_proj"].to(dtc)).float()
    if partial:
        cl = compute_layout()
        dbc = all_reduce(dbc, cl.mesh, partial)
    dt_r, b_ssm, c_ssm = torch.split(dbc, [dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())                  # (d_in, d_state)
    return delta, a, b_ssm, c_ssm


def _conv_state(xs: torch.Tensor, d_conv: int) -> torch.Tensor:
    """The last ``d_conv - 1`` pre-activation inputs (zeros before the
    start, so a prompt shorter than the window still gives a full one)."""
    pad = torch.zeros((xs.shape[0], d_conv - 1, xs.shape[2]), dtype=xs.dtype,
                      device=xs.device)
    return torch.cat([pad, xs], dim=1)[:, -(d_conv - 1):]


def apply_mamba(p, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False, seq_dim: int | None = None):
    """Full-sequence path. x: (B, T, D); with ``return_state`` also the
    decode state ``{"conv", "ssm"}``.  Under ``mamba_tp`` ``p`` holds the
    rank's channels (see the module docstring)."""
    dtc = torch_dtype(cfg.compute_dtype)
    _, partial = _rank_split(cfg)
    xz = x.to(dtc) @ p["in_proj"].to(dtc)
    xs, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xs, p["conv_w"].to(dtc), p["conv_b"].to(dtc)))
    delta, a, b_ssm, c_ssm = _ssm_inputs(p, xc, cfg, partial)
    # tuned=None: the cached best launch parameters when kernel tuning is
    # enabled (repro_torch.tune.kernels.configure), the defaults otherwise
    y, h_final = ms_ops.selective_scan(xc.float(), delta, a, b_ssm, c_ssm,
                                       p["D"], tuned=None)
    y = y.to(dtc) * F.silu(z)
    out = finish(y @ p["out_proj"].to(dtc), partial, seq_dim)
    if return_state:
        return out, {"conv": _conv_state(xs, p["conv_w"].shape[0]),
                     "ssm": h_final}
    return out


# -- decode -------------------------------------------------------------------

def init_mamba_state(cfg: ArchConfig, batch: int, device) -> dict:
    """Zero decode state of the channels this rank computes."""
    _, d_state, d_conv, _ = _dims(cfg)
    d_in, _ = _rank_split(cfg)
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_in),
                            dtype=torch_dtype(cfg.compute_dtype),
                            device=device),
        "ssm": torch.zeros((batch, d_in, d_state), dtype=torch.float32,
                           device=device),
    }


def decode_mamba(p, x: torch.Tensor, state: dict, cfg: ArchConfig
                 ) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D)."""
    dtc = torch_dtype(cfg.compute_dtype)
    _, partial = _rank_split(cfg)
    xz = x.to(dtc) @ p["in_proj"].to(dtc)
    xs, z = xz.chunk(2, dim=-1)                         # (B, 1, d_in)
    xc = F.silu(_causal_conv(xs, p["conv_w"].to(dtc), p["conv_b"].to(dtc),
                             prefix=state["conv"]))
    new_conv = torch.cat([state["conv"], xs], dim=1)[:, 1:]
    delta, a, b_ssm, c_ssm = _ssm_inputs(p, xc, cfg, partial)
    xf = xc.float()
    da = torch.exp(delta[:, 0, :, None] * a)
    h = da * state["ssm"] + (delta[:, 0, :, None] * b_ssm[:, 0, None, :]
                             * xf[:, 0, :, None])
    y = torch.einsum("bds,bs->bd", h, c_ssm[:, 0]) + xf[:, 0] * p["D"]
    y = y[:, None].to(dtc) * F.silu(z)
    return (finish(y @ p["out_proj"].to(dtc), partial),
            {"conv": new_conv, "ssm": h})
