"""RWKV-6 "Finch" (arXiv:2404.05892) in plain PyTorch, float32.

A layer, on the residual stream x (B, T, D):

    h = norm1(x);  dx = shift(h) - h                 (shift: the previous
                                                      token, zeros first)
    base = h + dx * mu_base
    m_i = mu_i + tanh(base @ A_mix)_i @ B_mix_i       i in r, k, v, g, w
    x_i = h + dx * m_i
    r, k, v, g = x_r @ W_r, x_k @ W_k, x_v @ W_v, x_g @ W_g
    log w = -exp(decay_base + tanh(x_w @ A_decay) @ B_decay)
    y_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t,  S_t = diag(w_t) S_{t-1}
                                                        + k_t v_t^T
    x = x + (GroupNorm_H(y) * ln_scale + ln_bias) * silu(g) @ W_o
    h = norm2(x);  dx = shift(h) - h
    x = x + sigmoid((h + dx * mu_r) @ W_rff) * (relu((h + dx * mu_k)
                                                      @ W_kff)^2 @ W_vff)

then the final norm and the head.  The norms are LayerNorms (RWKV's);
GroupNorm's eps is 64e-5.  As run, the stack has no LayerNorm on the
embeddings (Finch's ``ln0``), and the recurrence starts from a zero state.

The recurrence runs in chunks of ``CHUNK`` tokens: inside a chunk every
pair (t, s < t) carries exp of the summed log decays between them (never
above 1, whatever the decays), and the state passes from chunk to chunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..weights import Leaf
from .common import mm, norm, norm_leaves, q, xent

CHUNK = 16
# Finch normalizes the embeddings (ln0) before the first layer, so its
# stack sees a unit-scale stream; the port has no ln0, so the embeddings
# themselves are drawn at unit scale.  The projections that write to the
# residual stream (W_o, W_vff) are drawn 1/sqrt(2 n_layers) smaller, as
# GPT-2's init draws them (Finch's zeroes them): with fan-in scale alone
# the 24 layers' backward pass amplifies rounding, and any two float32
# runs' gradient norms part by whole factors (PERF.md)
EMBED_STD = 1.0
F32_LEAVES = ("decay_base", "u", "ln_scale", "ln_bias")


def leaves(arch: dict, serving: bool = False) -> list[Leaf]:
    """The parameters, named as the port names them.  Training holds them
    in the configuration's parameter type; serving in its compute type,
    but for the norms and the recurrence's float32 leaves."""
    d, ff, v = arch["d_model"], arch["d_ff"], arch["vocab_size"]
    r = arch["rwkv"]
    hd, mix, dec = r["head_dim"], r["lora_rank_mix"], r["lora_rank_decay"]
    h = d // hd

    def dt(name: str) -> str:
        if not serving:
            return arch["param_dtype"]
        last = name.rsplit(".", 1)[-1]
        return "float32" if "norm" in name or last in F32_LEAVES \
            else arch["compute_dtype"]

    out: list[Leaf] = []
    resid = (2 * arch["n_layers"]) ** -0.5

    def normal(name, shape, std):
        out.append(Leaf(name, shape, dt(name), "normal", std))

    def uniform(name, shape, lo, hi):
        out.append(Leaf(name, shape, dt(name), "uniform", lo, hi))

    def const(name, shape, value):
        out.append(Leaf(name, shape, dt(name), "const", value))

    normal("embed.tokens", (v, d), EMBED_STD)
    if not arch.get("tie_embeddings"):
        normal("embed.lm_head", (d, v), d ** -0.5)
    for i in range(arch["n_layers"]):
        pre = f"layers.{i}."
        for n, shape, value in (norm_leaves(pre + "norm1.", arch)
                                + norm_leaves(pre + "norm2.", arch)):
            const(n, shape, value)
        m = pre + "mixer."
        uniform(m + "mu_base", (d,), 0.0, 0.5)
        normal(m + "mix_lora_a", (d, 5 * mix), d ** -0.5)
        normal(m + "mix_lora_b", (5, mix, d), 0.01)
        uniform(m + "mu", (5, d), 0.0, 0.5)
        uniform(m + "decay_base", (d,), -6.0, -1.0)
        normal(m + "decay_lora_a", (d, dec), d ** -0.5)
        normal(m + "decay_lora_b", (dec, d), 0.01)
        for w in ("wr", "wk", "wv", "wg"):
            normal(m + w, (d, d), d ** -0.5)
        normal(m + "wo", (d, d), d ** -0.5 * resid)
        normal(m + "u", (h, hd), 0.1)
        const(m + "ln_scale", (d,), 1.0)
        const(m + "ln_bias", (d,), 0.0)
        c = pre + "channel."
        uniform(c + "mu_k", (d,), 0.0, 0.5)
        uniform(c + "mu_r", (d,), 0.0, 0.5)
        normal(c + "wk_ff", (d, ff), d ** -0.5)
        normal(c + "wv_ff", (ff, d), ff ** -0.5 * resid)
        normal(c + "wr_ff", (d, d), d ** -0.5)
    for n, shape, value in norm_leaves("final_norm.", arch):
        const(n, shape, value)
    return out


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """(y (B, T, H, hd), S_T (B, H, hd, hd)) of the recurrence from a zero
    state; ``logw`` = log w_t (<= 0)."""
    b, t, h, hd = r.shape
    pad = (-t) % chunk
    if pad:
        # padded tokens carry no key and no decay: S_T is unchanged
        r, k, v, logw = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v, logw))
    n = r.shape[1] // chunk

    def split(x):                               # (B, H, N, C, hd)
        return x.view(b, n, chunk, h, hd).permute(0, 3, 1, 2, 4)

    r, k, v, logw = split(r), split(k), split(v), split(logw)
    incl = logw.cumsum(3)                       # sum of log w_1..t in a chunk
    excl = incl - logw                          # sum of log w_1..t-1
    # pairs s < t: exp(excl_t - incl_s) = the decay of steps s+1 .. t-1
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)
    gap = excl[..., :, None, :] - incl[..., None, :, :]
    decay = torch.where(lower[:, :, None], gap, -torch.inf).exp()
    att = torch.einsum("bhntsd,bhnsd->bhnts", r[..., :, None, :] * decay, k)
    bonus = (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True)
    y = att @ v + bonus * v
    # chunk to chunk: what each chunk adds to the state and how it decays
    last = incl[..., -1:, :]                    # (B, H, N, 1, hd)
    adds = (k * (last - incl).exp()).transpose(-1, -2) @ v
    carry = last[..., 0, :].exp()               # (B, H, N, hd)
    s = r.new_zeros(b, h, hd, hd)
    entering = []
    for i in range(n):
        entering.append(s)
        s = carry[:, :, i, :, None] * s + adds[:, :, i]
    s_in = torch.stack(entering, 2)             # (B, H, N, hd, hd)
    y = y + (r * excl.exp()) @ s_in
    y = y.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, hd)
    return y[:, :t], s


def _shift(h):
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def time_mix(p: dict, pre: str, h, arch: dict, quant):
    b, t, d = h.shape
    hd = arch["rwkv"]["head_dim"]
    nh = d // hd
    dx = _shift(h) - h
    base = h + dx * p[pre + "mu_base"]
    lora = torch.tanh(mm(base, p[pre + "mix_lora_a"], quant))
    lora = lora.view(b, t, 5, -1).transpose(1, 2)        # (B, 5, T, R)
    adj = mm(lora, p[pre + "mix_lora_b"][None], quant)   # (B, 5, T, D)
    mixes = p[pre + "mu"][None, :, None, :] + adj
    xr, xk, xv, xg, xw = (h + dx * mixes[:, i] for i in range(5))
    r = mm(xr, p[pre + "wr"], quant).view(b, t, nh, hd)
    k = mm(xk, p[pre + "wk"], quant).view(b, t, nh, hd)
    v = mm(xv, p[pre + "wv"], quant).view(b, t, nh, hd)
    g = mm(xg, p[pre + "wg"], quant)
    decay = p[pre + "decay_base"] + mm(
        torch.tanh(mm(xw, p[pre + "decay_lora_a"], quant)),
        p[pre + "decay_lora_b"], quant)
    logw = -decay.exp().view(b, t, nh, hd)
    y, s = wkv(r, k, v, logw, p[pre + "u"])
    y = y.reshape(b, t, nh, hd)
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, t, d)
    y = y * p[pre + "ln_scale"] + p[pre + "ln_bias"]
    return mm(y * F.silu(g), p[pre + "wo"], quant), s


def channel_mix(p: dict, pre: str, h, quant):
    dx = _shift(h) - h
    xk = h + dx * p[pre + "mu_k"]
    xr = h + dx * p[pre + "mu_r"]
    kk = torch.relu(mm(xk, p[pre + "wk_ff"], quant)).square()
    return torch.sigmoid(mm(xr, p[pre + "wr_ff"], quant)) \
        * mm(kk, p[pre + "wv_ff"], quant)


def layer(p: dict, i: int, x, arch: dict, quant, states: list | None = None):
    pre = f"layers.{i}."
    h = q(norm(p, pre + "norm1.", x, arch), quant)
    out, s = time_mix(p, pre + "mixer.", h, arch, quant)
    x = q(x + out, quant)
    h2 = q(norm(p, pre + "norm2.", x, arch), quant)
    x = q(x + channel_mix(p, pre + "channel.", h2, quant), quant)
    if states is not None:
        states.append({"tmix_prev": h[:, -1], "cmix_prev": h2[:, -1],
                       "wkv": s})
    return x


def _f32(p: dict) -> dict:
    return {n: t.float() for n, t in p.items()}


def _head(p: dict, arch: dict):
    return p["embed.tokens"].T if arch.get("tie_embeddings") \
        else p["embed.lm_head"]


def loss(p: dict, tokens, labels, arch: dict, quant=None):
    """Mean next-token cross-entropy; each layer recomputed in the
    backward pass (only its input is kept)."""
    x = q(p["embed.tokens"][tokens].float(), quant)
    for i in range(arch["n_layers"]):
        x = checkpoint(layer, p, i, x, arch, quant, use_reentrant=False)
    h = q(norm(p, "final_norm.", x, arch), quant)
    return xent(h.reshape(-1, h.shape[-1]), _head(p, arch),
                labels.reshape(-1), quant)


@torch.no_grad()
def prefill(p: dict, tokens, arch: dict, quant=None):
    """(last-position logits (B, V), each layer's state as the port keeps
    it: {"tmix_prev", "cmix_prev", "wkv"}, and the final norm's output at
    every position (B, T, D))."""
    p = _f32(p)
    x = q(p["embed.tokens"][tokens], quant)
    states: list = []
    for i in range(arch["n_layers"]):
        x = layer(p, i, x, arch, quant, states)
    h = q(norm(p, "final_norm.", x, arch), quant)
    return logits(p, h[:, -1], arch, quant), states, h


def logits(p: dict, h, arch: dict, quant=None):
    """The head's logits of final hidden states ``h`` (..., D)."""
    return mm(h, _head(p, arch).float(), quant)
