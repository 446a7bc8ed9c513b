"""Roofline analysis: compute / memory / collective terms per (arch x cell).

The port of the reference's ``roofline/analysis.py``: the analytic ledger
(``Ledger``, ``model_flops``, ``analytic_cost``,
``analytic_collective_bytes``, ``roofline_terms``) line for line, so the
port's numbers equal the reference's for the same configuration, and the
hardware model of an NVIDIA H100 SXM (``H100_SXM``) in place of the
reference's chip:

* ``peak_flops`` 989e12 bf16 FLOP/s dense and ``hbm_bw`` 3.35e12 B/s, 80 GB
  of HBM3 (NVIDIA H100 Tensor Core GPU datasheet, SXM column);
* ``link_bw`` 50e9 B/s a GPU: one 400 Gb/s NDR InfiniBand port a GPU
  (DGX H100 user guide: eight ConnectX-7 ports for eight GPUs).  Every
  group of the production 16 x 16 mesh spans 8-GPU nodes, so the
  inter-node rate sets the pace.  Inside a node NVLink gives 900 GB/s
  bidirectional a GPU; groups that fit in a node (the tuner's (64, 4)
  and (32, 8) factorings) are still reckoned at ``link_bw``.

FLOPs and HBM bytes come from the analytic ledger below (the dry run's
counted FLOPs check its forward term, ``tests/test_torch_roofline.py``);
collective bytes from the dry run's counter census
(``roofline.census``) or ``analytic_collective_bytes``.

Terms:
    compute term    = FLOPs / (chips * peak)
    memory term     = HBM bytes / hbm_bw                [per-chip bytes]
    collective term = collective bytes / link_bw        [per-chip bytes]

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); the ratio
MODEL_FLOPS / ledger FLOPs flags remat/redundancy waste.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..dist.sharding import ShardingConfig
from ..launch.shapes import ShapeCell
from ..models.config import ArchConfig, MambaConfig, RwkvConfig

__all__ = ["H100_SXM", "HW", "Ledger", "analytic_collective_bytes",
           "analytic_cost", "model_flops", "roofline_terms"]


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12        # bf16 dense FLOP/s a GPU
    hbm_bw: float = 3.35e12           # B/s a GPU
    link_bw: float = 50e9             # B/s a GPU between nodes
    hbm_gb: float = 80.0


H100_SXM = HW()


@dataclass
class Ledger:
    """Per-step cost breakdown. FLOPs are GLOBAL; bytes are PER-CHIP."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    model_flops: float = 0.0
    detail: dict = field(default_factory=dict)

    def add(self, name: str, flops: float = 0.0, hbm: float = 0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        d = self.detail.setdefault(name, {"flops": 0.0, "hbm": 0.0})
        d["flops"] += flops
        d["hbm"] += hbm


def _bytes_of(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}[dtype]


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """6*N_active*tokens (train) / 2*N_active*tokens (inference).

    Enc-dec splits N over the two streams (encoder params see encoder
    tokens, decoder params see decoder tokens); prefill excludes the
    unembedding (logits are computed for the last position only).
    """
    n = cfg.active_param_count()
    emb = cfg.vocab_size * cfg.d_model
    if cfg.encdec:
        breakdown = cfg.param_breakdown()
        n_enc = sum(c for k, c in breakdown if k.startswith("enc_"))
        n_dec = n - n_enc - emb * (1 if cfg.tie_embeddings else 2)
        mult = 6.0 if cell.kind == "train" else 2.0
        # the encoder runs at train/prefill; decode touches decoder params only
        enc_tokens = (0 if cell.kind == "decode"
                      else cell.global_batch * cell.seq_len)
        dec_tokens = (cell.global_batch * cfg.decoder_len
                      if cell.kind == "train"
                      else (0 if cell.kind == "prefill"
                            else cell.global_batch))
        return mult * (n_enc * enc_tokens + n_dec * dec_tokens)
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        # unembedding runs once per sequence, not per token
        return 2.0 * (n - emb) * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # decode: one token per sequence


# -- per-layer forward FLOPs (global, per `tokens` new tokens) -----------------

def _attn_flops(cfg: ArchConfig, tokens: float, ctx: float,
                causal: bool) -> tuple[float, float]:
    """(projection flops, attention-matmul flops)."""
    d, hd = cfg.d_model, cfg.head_dim
    proj = 2.0 * tokens * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + 2.0 * tokens * cfg.n_heads * hd * d
    eff_ctx = ctx / 2.0 if (causal and tokens == ctx) else ctx
    attn = 2.0 * 2.0 * tokens * eff_ctx * cfg.n_heads * hd
    return proj, attn


def _mlp_flops(cfg: ArchConfig, tokens: float, d_ff: int | None = None) -> float:
    w = 3 if cfg.mlp_type == "swiglu" else 2
    return 2.0 * tokens * w * cfg.d_model * (d_ff or cfg.d_ff)


def _moe_flops(cfg: ArchConfig, tokens: float) -> float:
    m = cfg.moe
    w = 3 if cfg.mlp_type == "swiglu" else 2
    routed = 2.0 * tokens * m.top_k * m.capacity_factor * w * cfg.d_model \
        * m.d_expert
    shared = _mlp_flops(cfg, tokens, m.d_shared) if m.n_shared else 0.0
    router = 2.0 * tokens * cfg.d_model * m.n_experts
    return routed + shared + router


def _mamba_flops(cfg: ArchConfig, tokens: float) -> float:
    m = cfg.mamba or MambaConfig()
    d = cfg.d_model
    d_in = m.expand * d
    r = m.dt_rank or -(-d // 16)
    proj = 2.0 * tokens * (d * 2 * d_in + d_in * (r + 2 * m.d_state)
                           + r * d_in + d_in * d)
    conv = 2.0 * tokens * m.d_conv * d_in
    scan = 6.0 * tokens * d_in * m.d_state
    return proj + conv + scan


def _rwkv_flops(cfg: ArchConfig, tokens: float) -> float:
    r = cfg.rwkv or RwkvConfig()
    d = cfg.d_model
    proj = 2.0 * tokens * 5 * d * d                      # r,k,v,g,o
    lora = 2.0 * tokens * (d * 5 * r.lora_rank_mix + 5 * r.lora_rank_mix * d
                           + d * r.lora_rank_decay + r.lora_rank_decay * d)
    wkv = 4.0 * tokens * d * r.head_dim                  # state update + read
    cmix = 2.0 * tokens * (2 * d * cfg.d_ff + d * d)
    return proj + lora + wkv + cmix


def _layers_fwd_flops(cfg: ArchConfig, tokens: float, ctx: float,
                      ledger: Ledger, causal: bool = True,
                      include_encoder: bool = True) -> None:
    moe_mask = cfg.moe_layer_mask()
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "attn":
            proj, attn = _attn_flops(cfg, tokens, ctx, causal)
            ledger.add("attn_proj", flops=proj)
            ledger.add("attn_matmul", flops=attn)
        elif kind == "mamba":
            ledger.add("mamba", flops=_mamba_flops(cfg, tokens))
        else:
            ledger.add("rwkv", flops=_rwkv_flops(cfg, tokens))
        if kind == "rwkv":
            pass                                          # cmix inside rwkv
        elif moe_mask[i]:
            ledger.add("moe", flops=_moe_flops(cfg, tokens))
        else:
            ledger.add("mlp", flops=_mlp_flops(cfg, tokens))
    if cfg.encdec:
        if include_encoder:
            for _ in range(cfg.n_encoder_layers):
                proj, attn = _attn_flops(cfg, ctx, ctx, causal=False)
                ledger.add("enc_attn", flops=proj + attn)
                ledger.add("enc_mlp", flops=_mlp_flops(cfg, ctx))
        # decoder cross attention (precomputed cross-KV at decode: 1024 ctx)
        cross_ctx = ctx if include_encoder else 1024
        for _ in range(cfg.n_layers):
            proj, attn = _attn_flops(cfg, tokens, cross_ctx, causal=False)
            ledger.add("cross_attn", flops=proj + attn)


# -- HBM traffic model (documented coefficients) -------------------------------

_ACT_COEF = 12.0   # reads+writes of qkv/mlp/norm intermediates per token-layer
_REMAT_COEF = 1.5  # remat recompute multiplies forward activation traffic


def _train_hbm_bytes(cfg: ArchConfig, cell: ShapeCell, scfg: ShardingConfig,
                     n_chips: int, ledger: Ledger) -> None:
    pb = _bytes_of(cfg.param_dtype)
    params = cfg.param_count()
    n_model = n_chips // _data_shards(scfg, n_chips)
    local_params = params / n_chips
    n_micro = scfg.microbatches
    # weights: full (per model shard) read fwd+bwd each microbatch
    ledger.add("w_read", hbm=2.0 * n_micro * params * pb / n_model)
    # optimizer: read g,m,v,p + write p,m,v on local shards
    mb = 1 if scfg.moments_dtype == "int8" else 4
    ledger.add("opt", hbm=local_params * (4 + pb + 2 * mb + 4 + pb + 2 * mb))
    # activations
    tokens_local = cell.global_batch * cell.seq_len / _data_shards(
        scfg, n_chips)
    act = _ACT_COEF * _REMAT_COEF * 3.0 * tokens_local * cfg.d_model * 2 \
        * cfg.n_layers / n_model
    ledger.add("activations", hbm=act)
    if getattr(scfg, "remat_policy", "full") == "save_dots":
        # saved qkv / mlp-hidden / layer outputs: one write + one read
        w_ff = 3 if cfg.mlp_type == "swiglu" else 2
        per_tok = ((w_ff - 1) * cfg.d_ff
                   + (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                   + 2 * cfg.d_model)
        ledger.add("saved_dots",
                   hbm=2.0 * tokens_local * per_tok * 2 * cfg.n_layers
                   / n_model)
    # attention KV streaming (flash blocks re-read K/V per q block)
    s = cell.seq_len
    n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
    if n_attn:
        q_block = 512
        kv_bytes = s * cfg.n_kv_heads * cfg.head_dim * 2 * 2  # k+v bf16
        reads = (tokens_local / q_block) * kv_bytes / n_model
        ledger.add("attn_kv_stream", hbm=3.0 * n_attn * reads)
    # logits chunks
    v_local = cfg.vocab_size / n_model
    ledger.add("logits", hbm=3.0 * 2.0 * tokens_local * v_local * 2)


def _data_shards(scfg: ShardingConfig, n_chips: int) -> int:
    # data axes hold batch; single-pod (16,16) -> 16, multi-pod -> 32
    return max(1, int(round(n_chips / 16)))


def analytic_cost(cfg: ArchConfig, cell: ShapeCell, scfg: ShardingConfig,
                  n_chips: int = 256) -> Ledger:
    """Global FLOPs + per-chip HBM bytes for one step of this cell."""
    ledger = Ledger()
    ledger.model_flops = model_flops(cfg, cell)
    pb = _bytes_of("bfloat16" if cell.kind != "train" else cfg.param_dtype)
    n_model = max(1, n_chips // _data_shards(scfg, n_chips))

    if cell.kind == "train":
        tokens = cell.global_batch * (cell.seq_len if not cfg.encdec
                                      else cfg.decoder_len)
        ctx = cell.seq_len
        _layers_fwd_flops(cfg, tokens, ctx, ledger)
        emb_tokens = tokens + (cell.global_batch * cell.seq_len
                               if cfg.encdec else 0)
        ledger.add("logits", flops=2.0 * tokens * cfg.d_model
                   * cfg.vocab_size)
        # bwd = 2x fwd; remat recompute depends on the policy:
        #   full      -> +1.0 fwd (recompute everything)
        #   save_dots -> re-run only attention matmuls + elementwise
        fwd = ledger.flops
        if scfg.remat and getattr(scfg, "remat_policy", "full") == "save_dots":
            recompute = (ledger.detail.get("attn_matmul",
                                           {"flops": 0.0})["flops"]
                         + 0.05 * fwd)           # elementwise/norm replay
        elif scfg.remat:
            recompute = fwd
        else:
            recompute = 0.0
        ledger.add("bwd_and_remat", flops=fwd * 2.0 + recompute)
        _train_hbm_bytes(cfg, cell, scfg, n_chips, ledger)
        return ledger

    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        if cfg.encdec:
            # encoder + cross-kv precompute only
            for _ in range(cfg.n_encoder_layers):
                proj, attn = _attn_flops(cfg, tokens, cell.seq_len, False)
                ledger.add("enc_attn", flops=proj + attn)
                ledger.add("enc_mlp", flops=_mlp_flops(cfg, tokens))
            ledger.add("cross_kv", flops=2.0 * tokens * cfg.d_model
                       * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers)
        else:
            _layers_fwd_flops(cfg, tokens, cell.seq_len, ledger)
            ledger.add("logits", flops=2.0 * cell.global_batch * cfg.d_model
                       * cfg.vocab_size)
        tokens_local = tokens / _data_shards(scfg, n_chips)
        ledger.add("w_read", hbm=cfg.param_count() * pb / n_model)
        ledger.add("activations",
                   hbm=_ACT_COEF * tokens_local * cfg.d_model * 2
                   * cfg.n_layers / n_model)
        n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
        if n_attn:
            kv_bytes = cell.seq_len * cfg.n_kv_heads * cfg.head_dim * 4
            reads = (tokens_local / 512) * kv_bytes / n_model
            ledger.add("attn_kv_stream", hbm=n_attn * reads)
        ledger.add("kv_write", hbm=_decode_state_bytes(cfg, cell) / n_chips)
        return ledger

    # decode: one token per sequence (enc-dec: decoder-side work only)
    b = cell.global_batch
    _layers_fwd_flops(cfg, b, cell.seq_len, ledger, causal=True,
                      include_encoder=False)
    ledger.add("logits", flops=2.0 * b * cfg.d_model * cfg.vocab_size)
    ledger.add("w_read", hbm=cfg.param_count() * pb / n_model)
    ledger.add("cache_read", hbm=_decode_state_bytes(cfg, cell) / n_chips)
    return ledger


def _decode_state_bytes(cfg: ArchConfig, cell: ShapeCell) -> float:
    """Global decode-state footprint (KV caches + SSM/RWKV states)."""
    b, s = cell.global_batch, cell.seq_len
    total = 0.0
    m = cfg.mamba or MambaConfig()
    r = cfg.rwkv or RwkvConfig()
    for kind in cfg.layer_kinds:
        if kind == "attn":
            total += 2 * b * s * cfg.n_kv_heads * cfg.head_dim * 2
        elif kind == "mamba":
            d_in = m.expand * cfg.d_model
            total += b * d_in * m.d_state * 4 + b * (m.d_conv - 1) * d_in * 2
        else:
            h = cfg.d_model // r.head_dim
            total += b * h * r.head_dim ** 2 * 4 + 2 * b * cfg.d_model * 2
    if cfg.encdec:
        total += 2 * b * 1024 * cfg.n_kv_heads * cfg.head_dim * 2  # cross
    return total


def analytic_collective_bytes(cfg: ArchConfig, cell: ShapeCell,
                              scfg: ShardingConfig, n_chips: int = 256
                              ) -> float:
    """Per-chip collective traffic estimate (ring models) for one step.

    Used by the sharding tuner's fast evaluator; the dry run's counter
    census (``roofline.census``) is what it is held against.
    """
    pb = _bytes_of("bfloat16" if cell.kind != "train" else cfg.param_dtype)
    n_data = _data_shards(scfg, n_chips)
    n_model = max(1, n_chips // n_data)
    params = cfg.param_count()
    total = 0.0
    if cell.kind == "train":
        n_micro = scfg.microbatches
        if scfg.fsdp_axes:
            # per-microbatch fwd + bwd re-gather of the fsdp-sharded params
            total += 2.0 * n_micro * params * pb / n_model
        # grad reduction over data axis (f32 if accumulated)
        total += 2.0 * params * 4 / n_model
        # TP activation reductions: 2 per layer per microbatch
        tokens_local = cell.global_batch * cell.seq_len / n_data
        total += (2.0 * cfg.n_layers * n_micro
                  * (tokens_local / n_micro) * cfg.d_model * 2 * 2)
        if cfg.moe is not None:
            cap_frac = cfg.moe.top_k * cfg.moe.capacity_factor
            n_moe = sum(cfg.moe_layer_mask())
            total += 2.0 * n_moe * tokens_local * cap_frac * cfg.d_model * 2
    elif cell.kind == "prefill":
        tokens_local = cell.global_batch * cell.seq_len / n_data
        total += params * pb / n_model if scfg.fsdp_axes else 0.0
        total += 2.0 * cfg.n_layers * tokens_local * cfg.d_model * 2 * 2
    else:
        b_local = max(1.0, cell.global_batch / n_data)
        total += 2.0 * cfg.n_layers * b_local * cfg.d_model * 4 * 2
        if scfg.fsdp_axes:
            total += params * pb / n_model / max(n_data, 1) * 2
    return total


# -- roofline -------------------------------------------------------------------

def roofline_terms(ledger: Ledger, collective_bytes_per_chip: float,
                   n_chips: int, hw: HW = H100_SXM) -> dict:
    t_compute = ledger.flops / (n_chips * hw.peak_flops)
    t_memory = ledger.hbm_bytes / hw.hbm_bw
    t_coll = collective_bytes_per_chip / hw.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "step_time_bound_s": bound,
        "roofline_fraction": t_compute / bound if bound else 0.0,
        "model_flops": ledger.model_flops,
        "hlo_flops": ledger.flops,
        "useful_flops_ratio": (ledger.model_flops / ledger.flops
                               if ledger.flops else 0.0),
        "mfu_bound": (ledger.model_flops / (n_chips * hw.peak_flops) / bound
                      if bound else 0.0),
    }
