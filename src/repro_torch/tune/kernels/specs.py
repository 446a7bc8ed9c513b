"""Launch-parameter spaces for the CUDA kernel suite.

Candidate values are shape-independent power-of-two ladders — the same
space structure the paper tunes over (Table I lists raw combinations;
invalid rows are never measured).  Validity is checked per shape: chunks
must divide their extent, chunked passes must nest, and a block's
shared-memory footprint must fit.  The spaces are drawn for Hopper, not
copied from the reference's TPU ones: the grid-layout variant ``dims``
(Mosaic ``dimension_semantics``) has no CUDA meaning and gives way to
``block_threads``, the number of threads in a block.

Every spec's ``run`` drives the kernel path directly with explicit
launch parameters (never through the ``tuned=`` resolution path), and
``ref`` is the same function through the kernels' plain PyTorch
versions.

Only the ``dna_automaton`` spec exists so far; the other kernels' specs
arrive with their kernels.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ...convert import dfa_to_device
from ...core.space import ConfigSpace, Param
from ...kernels.dna_automaton.ops import (DEFAULTS as DNA_DEFAULTS,
                                          build_motif_dfa, fa_match,
                                          fa_match_plain, random_dna_text)
from .evaluate import SMEM_LIMIT_BYTES
from .registry import KernelSpec, register_kernel

__all__ = ["BLOCK_THREADS", "TEXT_CHUNKS"]

TEXT_CHUNKS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)
BLOCK_THREADS = (64, 128, 256, 512, 1024)

# what a block gets without opting in to more dynamic shared memory
SMEM_DEFAULT_BYTES = 48 * 1024


def _divides(extent: int, block: int, name: str) -> str | None:
    if block > extent:
        return f"{name}={block} exceeds extent {extent}"
    if extent % block:
        return f"{name}={block} does not divide {extent}"
    return None


def _smem(block_bytes: int, limit: int = SMEM_LIMIT_BYTES) -> str | None:
    """Shared memory one block asks for, against what it may use."""
    if block_bytes > limit:
        return (f"shared-memory overflow: {block_bytes} bytes per block "
                f"(limit {limit})")
    return None


# -- DNA automaton --------------------------------------------------------------

def _dna_space(meta: Mapping[str, Any]) -> ConfigSpace:
    return ConfigSpace([
        Param("map_chunk", TEXT_CHUNKS),
        Param("count_chunk", TEXT_CHUNKS),
        Param("block_threads", BLOCK_THREADS),
    ])


def _dna_validate(cfg, meta) -> str | None:
    mc, cc, t = cfg["map_chunk"], cfg["count_chunk"], meta["t"]
    err = (_divides(t, mc, "map_chunk") or _divides(t, cc, "count_chunk")
           or _smem(16 * meta["s"], SMEM_DEFAULT_BYTES))
    if err:
        return err
    if cc % mc:
        return (f"count_chunk={cc} is not a multiple of map_chunk={mc} "
                "(count start states live at map-chunk boundaries)")
    return None


def _dna_inputs(meta, dtype, rng, device):
    table, accept = build_motif_dfa(meta.get("motif", "ACGTAC"))
    if device.type == "cpu":
        # the reference's numpy stream, so both packages time one text
        text = torch.from_numpy(rng.integers(0, 4, meta["t"]).astype(np.uint8))
    else:
        # a full-size text is made on the card: on the host numpy would
        # draw it as int64, eight times its size
        text = random_dna_text(meta["t"], seed=int(rng.integers(2 ** 31)),
                               device=device)
    return (text, *dfa_to_device(table, accept, device))


def _dna_run(cfg, inputs):
    text, table, accept = inputs
    return fa_match(text, table, accept, map_chunk=cfg["map_chunk"],
                    count_chunk=cfg["count_chunk"],
                    block_threads=cfg["block_threads"], tuned=False)


def _dna_ref(inputs):
    text, table, accept = inputs
    return fa_match_plain(text, table, accept)


register_kernel(KernelSpec(
    name="dna_automaton",
    defaults=DNA_DEFAULTS,
    space_fn=_dna_space, validate_fn=_dna_validate,
    make_inputs=_dna_inputs, run=_dna_run, ref=_dna_ref,
    default_shape={"t": 3 * 2 ** 30, "s": 7},
    smoke_shape={"t": 4096, "s": 7},
    dtype="uint8",
    atol=0.0, rtol=0.0,
))
