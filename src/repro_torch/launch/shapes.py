"""Assigned input-shape cells and meta-tensor input specs.

Four cells per architecture (where applicable):

  train_4k      seq 4,096   global_batch 256   -> train_step
  prefill_32k   seq 32,768  global_batch 32    -> serve prefill
  decode_32k    seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                  KV cache of seq_len)
  long_500k     seq 524,288 global_batch 1     -> serve_step; only for
                                                  sub-quadratic families
                                                  (rwkv6, jamba)

``batch_specs_for`` gives **meta tensors** of the reference's shapes and
dtypes where the reference gives ``ShapeDtypeStruct``s: shape-only
stand-ins that allocate nothing and that the dry run
(``launch.dryrun``) traces a step on.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ArchConfig

__all__ = ["ShapeCell", "SHAPE_CELLS", "applicable", "batch_specs_for",
           "all_cells"]


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# Whisper decode cells: fixed-length precomputed encoder state.
WHISPER_CROSS_LEN = 1024


def applicable(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(is_applicable, reason-if-not)."""
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention: 500k decode cache skipped"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs_for(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Meta tensors for the data batch of one cell (the global batch)."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        if cfg.encdec:
            return {
                "frame_embeds": _meta((b, s, cfg.d_model), torch.bfloat16),
                "tokens": _meta((b, cfg.decoder_len), torch.int32),
                "labels": _meta((b, cfg.decoder_len), torch.int32),
            }
        out = {"tokens": _meta((b, s), torch.int32),
               "labels": _meta((b, s), torch.int32)}
        if cfg.frontend == "stub_patches":
            out["patch_embeds"] = _meta((b, cfg.n_patches, cfg.d_model),
                                        torch.bfloat16)
        return out
    if cell.kind == "prefill":
        if cfg.encdec:
            return {"frame_embeds": _meta((b, s, cfg.d_model),
                                          torch.bfloat16)}
        out = {"tokens": _meta((b, s), torch.int32)}
        if cfg.frontend == "stub_patches":
            out["patch_embeds"] = _meta((b, cfg.n_patches, cfg.d_model),
                                        torch.bfloat16)
        return out
    # decode: one new token; the KV cache (capacity seq_len) is state
    return {"tokens": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def all_cells(cfg: ArchConfig) -> list[ShapeCell]:
    return [c for c in SHAPE_CELLS.values() if applicable(cfg, c)[0]]
