"""A dense decoder (Qwen2.5's) in plain PyTorch, float32.

A layer, on the residual stream x (B, T, D), positions 0..T-1:

    h = RMSNorm(x)
    q, k, v = h @ W_q + b_q, h @ W_k + b_k, h @ W_v + b_v   (H q heads,
                                                           KV kv heads)
    q, k = RoPE(q), RoPE(k)                               (split halves)
    o = softmax(q k^T / sqrt(hd) + causal mask) v          (q head j reads
                                                           kv head j // (H/KV))
    x = x + o @ W_o
    h = RMSNorm(x)
    x = x + (silu(h @ W_gate) * (h @ W_in)) @ W_out

then the final RMSNorm and the head (the embedding's transpose where the
configuration ties them).  Attention runs ``BLOCK`` query rows at a time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..weights import Leaf
from .common import mm, norm, norm_leaves, q, rope, xent

BLOCK = 512


def _hd(arch: dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def leaves(arch: dict, serving: bool = False) -> list[Leaf]:
    """The parameters, named as the port names them; served in the
    compute type but for the norms."""
    d, ff, v = arch["d_model"], arch["d_ff"], arch["vocab_size"]
    h, kv, hd = arch["n_heads"], arch["n_kv_heads"], _hd(arch)

    def dt(name: str) -> str:
        if not serving:
            return arch["param_dtype"]
        return "float32" if "norm" in name else arch["compute_dtype"]

    out: list[Leaf] = []

    def normal(name, shape, std):
        out.append(Leaf(name, shape, dt(name), "normal", std))

    normal("embed.tokens", (v, d), 0.02)
    if not arch.get("tie_embeddings"):
        normal("embed.lm_head", (d, v), d ** -0.5)
    for i in range(arch["n_layers"]):
        pre = f"layers.{i}."
        for n, shape, value in (norm_leaves(pre + "norm1.", arch)
                                + norm_leaves(pre + "norm2.", arch)):
            out.append(Leaf(n, shape, dt(n), "const", value))
        m = pre + "mixer."
        normal(m + "wq", (d, h, hd), d ** -0.5)
        normal(m + "wk", (d, kv, hd), d ** -0.5)
        normal(m + "wv", (d, kv, hd), d ** -0.5)
        normal(m + "wo", (h, hd, d), (h * hd) ** -0.5)
        if arch.get("qkv_bias"):
            normal(m + "bq", (h, hd), 0.1)
            normal(m + "bk", (kv, hd), 0.1)
            normal(m + "bv", (kv, hd), 0.1)
        c = pre + "channel."
        normal(c + "w_in", (d, ff), d ** -0.5)
        normal(c + "w_gate", (d, ff), d ** -0.5)
        normal(c + "w_out", (ff, d), ff ** -0.5)
    for n, shape, value in norm_leaves("final_norm.", arch):
        out.append(Leaf(n, shape, dt(n), "const", value))
    return out


def attention(q, k, v, quant, block: int = BLOCK):
    """Causal attention of q (B, T, H, hd) over k, v (B, T, KV, hd)."""
    b, t, h, hd = q.shape
    rep = h // k.shape[2]
    q = q.transpose(1, 2) * hd ** -0.5                     # (B, H, T, hd)
    k = k.repeat_interleave(rep, 2).transpose(1, 2)
    v = v.repeat_interleave(rep, 2).transpose(1, 2)
    out = []
    for i0 in range(0, t, block):
        i1 = min(i0 + block, t)
        s = mm(q[:, :, i0:i1], k[:, :, :i1].transpose(-1, -2), quant)
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        cols = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, -torch.inf)
        out.append(mm(torch.softmax(s, -1), v[:, :, :i1], quant))
    return torch.cat(out, 2).transpose(1, 2)               # (B, T, H, hd)


def layer(p: dict, i: int, x, arch: dict, quant, states: list | None = None):
    pre = f"layers.{i}."
    m, c = pre + "mixer.", pre + "channel."
    b, t, d = x.shape
    hd = _hd(arch)
    h = q(norm(p, pre + "norm1.", x, arch), quant)

    def proj(name, bias):
        w = p[m + name]
        y = mm(h, w.reshape(d, -1), quant).view(b, t, w.shape[1], hd)
        return y + p[m + bias] if m + bias in p else y

    qh = rope(proj("wq", "bq"), arch["rope_theta"])
    k = rope(proj("wk", "bk"), arch["rope_theta"])
    v = proj("wv", "bv")
    if states is not None:
        states.append({"k": k, "v": v})
    o = attention(qh, k, v, quant).reshape(b, t, -1)
    x = q(x + mm(o, p[m + "wo"].reshape(-1, d), quant), quant)
    h = q(norm(p, pre + "norm2.", x, arch), quant)
    gate = F.silu(mm(h, p[c + "w_gate"], quant))
    return q(x + mm(gate * mm(h, p[c + "w_in"], quant), p[c + "w_out"],
                    quant), quant)


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
    """(last-position logits (B, V), each layer's {"k", "v"} (B, T, KV,
    hd) after RoPE, as the prefill writes them into its cache, and the
    final norm's output at every position (B, T, D)).  Each layer's
    weights are taken to float32 where it runs."""
    x = q(p["embed.tokens"][tokens].float(), quant)
    states: list = []
    for i in range(arch["n_layers"]):
        pre = f"layers.{i}."
        mine = {n: t.float() for n, t in p.items() if n.startswith(pre)}
        x = layer(mine, i, x, arch, quant, states)
    h = q(norm({n: t.float() for n, t in p.items()
                if n.startswith("final_norm.")}, "final_norm.", x, arch),
          quant)
    return logits(p, h[:, -1], arch, quant), states, h


def logits(p: dict, h, arch: dict, quant=None):
    """The head's logits of final hidden states ``h`` (..., D)."""
    return mm(h, _head(p, arch).float(), quant)
