"""The yardstick: the card's peaks, and the operations and bytes of the
kernels and of a whole step, counted from shapes alone.

No count reads a launch parameter (a chunk, a split, a block size): a
redesigned kernel changes its time, never the work it is held to, so no
faster design can push a share past 100 %.  Bytes count each input read
once and each output written once; operations count the algorithm's own
work (the recurrences' serial form, causal attention's two products).
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12        # tensor cores, bf16 in, float32 accumulate
PEAK_F32_FLOPS = 67e12          # CUDA cores, float32 (an FMA is two)
PEAK_HBM_BYTES = 3.35e12        # bytes/s

F32 = 4
BF16 = 2


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of operations over
    their peak and bytes over the memory's."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


# -- RWKV-6 wkv recurrence (B8 forward, B9 backward) ------------------------------
#
# Per head, state S (hd x hd), every token t:
#     y_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t
#     S_t = diag(w_t) S_{t-1} + k_t v_t^T
# The serial form touches each state cell once a token: S's update is a
# multiply and an FMA (3 FLOPs), r^T S an FMA (2).  The bonus term is O(hd).

def wkv6_fwd(b: int, t: int, h: int, hd: int) -> tuple[float, float]:
    """(FLOPs, bytes) of ``(y, s_T) = wkv6(r, k, v, w, u, s0)``, float32."""
    cells = b * t * h * hd * hd
    flops = 5 * cells + 4 * b * t * h * hd
    seq = b * t * h * hd
    state = b * h * hd * hd
    nbytes = F32 * (4 * seq + h * hd + state      # r, k, v, w, u, s0
                    + seq + state)                 # y, s_T
    return float(flops), float(nbytes)


def wkv6_bwd(b: int, t: int, h: int, hd: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the gradients of every operand of ``wkv6`` for
    the cotangents ``dy``, ``ds_T``.  Serial form, a state cell a token:
    S_{t-1} again (3 FLOPs), dr (2), the adjoint G_{t-1} = diag(w_t) G_t +
    r_t dy_t^T (3), dk (2), dv (2), dw (2)."""
    cells = b * t * h * hd * hd
    flops = 14 * cells + 8 * b * t * h * hd
    seq = b * t * h * hd
    state = b * h * hd * hd
    nbytes = F32 * (5 * seq + h * hd + 2 * state    # r, k, v, w, dy, u, s0, ds_T
                    + 4 * seq + h * hd + state)     # dr, dk, dv, dw, du, ds0
    return float(flops), float(nbytes)


# -- causal attention (B3 forward) ---------------------------------------------------

def causal_pairs(t: int) -> int:
    """Query-key pairs a causal mask keeps over ``t`` positions."""
    return t * (t + 1) // 2


def attention_fwd(b: int, t: int, h: int, hd: int,
                  elem: int = BF16) -> tuple[float, float]:
    """(FLOPs, bytes) of causal self-attention's forward over (B, T, H, hd)
    q, k, v (k and v as the kernel reads them, one per q head): q k^T and
    p v over the kept pairs; o written in the inputs' type and the
    log-sum-exp (B, H, T) in float32."""
    flops = 4 * b * h * hd * causal_pairs(t)
    seq = b * t * h * hd
    nbytes = elem * 4 * seq + F32 * b * h * t
    return float(flops), float(nbytes)


# -- whole steps: model FLOPs ----------------------------------------------------------

def matrix_params(cfg: dict) -> int:
    """Parameters that take part in a matrix product at every position of
    a layer stack (the embedding lookup does not; the head is counted
    apart, by ``head_params``)."""
    d, ff, n = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    if cfg.get("rwkv"):
        r = cfg["rwkv"]
        mix, dec = r["lora_rank_mix"], r["lora_rank_decay"]
        tmix = 5 * d * d + d * 5 * mix + 5 * mix * d + d * dec + dec * d
        cmix = 2 * d * ff + d * d
        return n * (tmix + cmix)
    if cfg["family"] == "dense":
        hd = cfg.get("head_dim") or d // cfg["n_heads"]
        q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
        attn = d * (q + 2 * kv) + q * d
        mlp = (3 if cfg.get("mlp_type", "swiglu") == "swiglu" else 2) * d * ff
        return n * (attn + mlp)
    raise ValueError(f"no count for family {cfg['family']!r}")


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def mixer_fwd_flops(cfg: dict, rows: int, t: int) -> float:
    """The sequence mixers' own forward FLOPs over ``rows`` sequences of
    ``t`` tokens, every layer: the wkv recurrence's serial form, or causal
    attention's two products."""
    n = cfg["n_layers"]
    if cfg.get("rwkv"):
        hd = cfg["rwkv"]["head_dim"]
        return n * wkv6_fwd(rows, t, cfg["d_model"] // hd, hd)[0]
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    return n * attention_fwd(rows, t, cfg["n_heads"], hd)[0]


def train_step_flops(cfg: dict, rows: int, t: int) -> float:
    """Model FLOPs of one training step: 2 a parameter a token forward and
    4 backward for every matrix-multiplied parameter, the head at every
    position; the mixers' forward and twice it backward.  No recompute."""
    tokens = rows * t
    dense = 6.0 * (matrix_params(cfg) + head_params(cfg)) * tokens
    return dense + 3.0 * mixer_fwd_flops(cfg, rows, t)


def prefill_flops(cfg: dict, rows: int, t: int) -> float:
    """Model FLOPs of a prefill of ``rows`` prompts of ``t`` tokens: every
    position through the stack, the head at the last position only."""
    return (2.0 * matrix_params(cfg) * rows * t
            + 2.0 * head_params(cfg) * rows
            + mixer_fwd_flops(cfg, rows, t))
