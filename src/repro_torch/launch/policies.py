"""Default per-(arch x cell) distribution policies.

The *paper-faithful baseline* configurations: sensible static choices an
engineer would write down before running the autotuner.  The sharding
tuner (``core.sharding_tuner``) then searches around them.

The thresholds are the reference's (``repro/launch/policies.py``),
unchanged, so that the dry run and the tuner compare with the reference's
one for one; they were drawn for the reference's chip and are not
re-derived for the H100 here.
"""

from __future__ import annotations

import dataclasses

from ..dist.sharding import ShardingConfig
from ..models.config import ArchConfig
from ..optim.adamw import AdamWConfig
from .shapes import ShapeCell

__all__ = ["arch_for_cell", "default_microbatches", "default_opt",
           "default_sharding"]

# param_dtype: bf16 above 30e9 parameters (training at that scale is
# mixed-precision); int8 moments above 150e9 (the reference's thresholds)
_BIG = 30e9
_HUGE = 150e9


def arch_for_cell(cfg: ArchConfig, cell: ShapeCell) -> ArchConfig:
    n = cfg.param_count()
    upd: dict = {}
    if n > _BIG:
        upd["param_dtype"] = "bfloat16"
    if cell.kind != "train":
        upd["param_dtype"] = "bfloat16"     # serving always bf16 weights
    return dataclasses.replace(cfg, **upd) if upd else cfg


def default_opt(cfg: ArchConfig) -> AdamWConfig:
    return AdamWConfig(
        learning_rate=3e-4,
        moments_dtype="int8" if cfg.param_count() > _HUGE else "float32",
    )


def default_microbatches(cfg: ArchConfig, cell: ShapeCell) -> int:
    if cell.kind != "train":
        return 1
    if cfg.d_model >= 16384:
        return 8
    if cfg.d_model >= 8192:
        return 4
    return 1


def default_sharding(cfg: ArchConfig, cell: ShapeCell,
                     multi_pod: bool = False) -> ShardingConfig:
    kv = "heads"
    if cell.kind in ("decode", "prefill"):
        if cell.global_batch == 1:
            kv = "seq"
        elif cfg.n_kv_heads < 16:
            kv = "batch_seq"
    # serving keeps the FSDP axes on the parameters too: each rank stores
    # its block and gathers a layer's at use (launch.serve)
    return ShardingConfig(
        data_axes=("data",),
        model_axes=("model",),
        fsdp_axes=("data",),
        expert_axes=("model",),
        kv_shard=kv,
        seq_parallel=cell.kind == "train",
        microbatches=default_microbatches(cfg, cell),
        remat=cell.kind == "train",
        moments_dtype=default_opt(cfg).moments_dtype,
    )
