"""Architecture configuration schema (framework-free; a copy of the JAX
package's ``models/config.py``).

One frozen dataclass describes every architecture in the assigned pool
(dense / MoE / SSM / hybrid / enc-dec audio / VLM).  ``layer_kinds`` gives
the per-layer mixer type; homogeneous stacks scan over single layers,
heterogeneous stacks (Jamba) scan over repeating groups.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

__all__ = ["ArchConfig", "MoEConfig", "MambaConfig", "RwkvConfig"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0             # hidden size of the fused shared expert
    layer_period: int = 1         # MoE every `period` layers ...
    layer_offset: int = 0         # ... starting at `offset`
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    def is_moe_layer(self, idx: int) -> bool:
        return idx % self.layer_period == self.layer_offset % self.layer_period


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RwkvConfig:
    head_dim: int = 64
    lora_rank_decay: int = 64
    lora_rank_mix: int = 32
    gate_rank: int = 0            # 0 -> full projection for the gate


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    mlp_type: Literal["swiglu", "squared_relu", "gelu"] = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # per-layer mixer kinds; () -> ("attn",) * n_layers
    layer_kinds: tuple[str, ...] = ()
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RwkvConfig | None = None
    # encoder-decoder (whisper-style): encoder layers are bidirectional attn
    encdec: bool = False
    n_encoder_layers: int = 0
    decoder_len: int = 448               # training target length for enc-dec
    # modality frontend: "tokens" | "stub_frames" | "stub_patches"
    frontend: str = "tokens"
    n_patches: int = 1024                # VLM stub: patch embeddings per sample
    # positions: "rope" | "sinusoidal" | "none"
    positions: str = "rope"
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # implementation switches; in the port "auto" and "pallas" both mean
    # the CUDA kernels and "xla" is refused (models/attention.py)
    attn_impl: Literal["auto", "xla", "pallas"] = "auto"
    logit_chunk: int = 256               # chunked vocab-parallel xent
    # source tag [citation; verification tier] from the assignment
    source: str = ""

    # -- derived ------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.layer_kinds:
            object.__setattr__(self, "layer_kinds", ("attn",) * self.n_layers)
        if len(self.layer_kinds) != self.n_layers:
            raise ValueError(
                f"{self.name}: layer_kinds has {len(self.layer_kinds)} entries "
                f"for {self.n_layers} layers"
            )
        if self.family in ("ssm",) and "attn" in self.layer_kinds:
            raise ValueError(f"{self.name}: ssm family must be attention-free")

    @property
    def is_attention_free(self) -> bool:
        return "attn" not in self.layer_kinds

    @property
    def supports_long_context(self) -> bool:
        """True if decode state does not grow quadratically-costly with
        context — SSM / linear-attention / hybrid families."""
        n_attn = sum(1 for k in self.layer_kinds if k == "attn")
        return n_attn == 0 or (self.family == "hybrid")

    @property
    def group_pattern(self) -> tuple[str, ...]:
        """Smallest repeating block of layer kinds (scan group)."""
        n = self.n_layers
        kinds = self.layer_kinds
        for size in range(1, n + 1):
            if n % size:
                continue
            if all(kinds[i] == kinds[i % size] for i in range(n)):
                # MoE interleave must also repeat with this period
                if self.moe and size % self.moe.layer_period:
                    continue
                return kinds[:size]
        return kinds

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.group_pattern)

    def moe_layer_mask(self) -> tuple[bool, ...]:
        if self.moe is None:
            return (False,) * self.n_layers
        return tuple(self.moe.is_moe_layer(i) for i in range(self.n_layers))

    # -- parameter counting (used by roofline MODEL_FLOPS) --------------------
    def param_count(self) -> int:
        return sum(c for _, c in self.param_breakdown())

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts top_k + shared experts)."""
        total = 0
        for name, c in self.param_breakdown():
            if name.startswith("moe_experts"):
                assert self.moe is not None
                total += c * self.moe.top_k // self.moe.n_experts
            else:
                total += c
        return total

    def param_breakdown(self) -> list[tuple[str, int]]:
        d, hd = self.d_model, self.head_dim
        out: list[tuple[str, int]] = [("embed", self.vocab_size * d)]
        if not self.tie_embeddings:
            out.append(("lm_head", d * self.vocab_size))
        moe_mask = self.moe_layer_mask()
        n_dec = self.n_layers
        for i in range(n_dec):
            kind = self.layer_kinds[i]
            if kind == "attn":
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
                out.append((f"attn[{i}]", qkv + self.n_heads * hd * d))
            elif kind == "mamba":
                m = self.mamba or MambaConfig()
                d_in = m.expand * d
                dt_rank = m.dt_rank or -(-d // 16)
                c = (d * 2 * d_in              # in_proj (x and gate)
                     + m.d_conv * d_in          # depthwise conv
                     + d_in * (dt_rank + 2 * m.d_state)   # x_proj
                     + dt_rank * d_in + d_in    # dt_proj (+bias)
                     + d_in * m.d_state         # A_log
                     + d_in                     # D
                     + d_in * d)                # out_proj
                out.append((f"mamba[{i}]", c))
            elif kind == "rwkv":
                r = self.rwkv or RwkvConfig()
                c = (4 * d * d                  # r, k, v, output
                     + d * d                    # gate
                     + 5 * (d * r.lora_rank_mix + r.lora_rank_mix * d)
                     + d * r.lora_rank_decay + r.lora_rank_decay * d
                     + 8 * d)                   # mixes, decay bias, bonus u, ln
                out.append((f"rwkv_tmix[{i}]", c))
            else:
                raise ValueError(f"unknown layer kind {kind}")
            # channel path
            if kind == "rwkv":
                out.append((f"rwkv_cmix[{i}]", 2 * d * self.d_ff + d * d + 2 * d))
            elif moe_mask[i]:
                assert self.moe is not None
                w_per_ff = 3 if self.mlp_type == "swiglu" else 2
                out.append((f"moe_experts[{i}]",
                            self.moe.n_experts * w_per_ff * d * self.moe.d_expert))
                out.append((f"moe_router[{i}]", d * self.moe.n_experts))
                if self.moe.n_shared:
                    out.append((f"moe_shared[{i}]", w_per_ff * d * self.moe.d_shared))
            else:
                w_per_ff = 3 if self.mlp_type == "swiglu" else 2
                out.append((f"mlp[{i}]", w_per_ff * d * self.d_ff))
            out.append((f"norms[{i}]", 2 * d))
        if self.encdec:
            for i in range(self.n_encoder_layers):
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
                out.append((f"enc_attn[{i}]", qkv + self.n_heads * hd * d))
                w_per_ff = 3 if self.mlp_type == "swiglu" else 2
                out.append((f"enc_mlp[{i}]", w_per_ff * d * self.d_ff))
                out.append((f"enc_norms[{i}]", 2 * d))
            # decoder cross-attention (one per decoder layer)
            for i in range(n_dec):
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
                out.append((f"cross_attn[{i}]", qkv + self.n_heads * hd * d))
                out.append((f"cross_norm[{i}]", d))
        out.append(("final_norm", d))
        return out

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        scale: dict = dict(
            n_layers=min(self.n_layers, 2 * len(self.group_pattern)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            logit_chunk=64,
            n_patches=8,
        )
        nl = scale["n_layers"]
        if self.layer_kinds and len(set(self.layer_kinds)) > 1:
            scale["layer_kinds"] = self.layer_kinds[:nl]
        elif self.layer_kinds:
            scale["layer_kinds"] = (self.layer_kinds[0],) * nl
        if self.moe is not None:
            scale["moe"] = replace(
                self.moe, n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2), d_expert=64,
                d_shared=128 if self.moe.n_shared else 0,
            )
        if self.mamba is not None:
            scale["mamba"] = replace(self.mamba, d_state=8, dt_rank=16)
        if self.encdec:
            scale["n_encoder_layers"] = min(self.n_encoder_layers, 2)
            scale["decoder_len"] = 16
        return replace(self, name=self.name + "-smoke", **scale)
