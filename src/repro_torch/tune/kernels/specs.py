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

Seven specs exist: ``dna_automaton``, ``flash_attention``,
``decode_attention``, ``mamba_scan``, ``mamba_scan_bwd``, ``rwkv6_wkv`` and
``rwkv6_wkv_bwd``.  The attention specs keep the reference's meta keys
(``{bh, tq, tk, hd, causal}`` and ``{b, kv, rep, hd, s}``), so a store
record resolves from the same shape description in both packages; their
default shapes are the serving shapes of ``qwen2.5-3b`` at batch 8 with a
2048-token prompt and 128 generated tokens.  The scan specs keep the reference's ``{bt, t, di, s}`` and
``{b, t, h, hd}``; their default shapes are the prefill shapes of
``jamba-v0.1-52b`` and ``rwkv6-1.6b`` at batch 8 with a 2048-token prompt.
The selective scan's space is channels a block (``block_d``) x tokens a
staged chunk (``chunk``) x threads a channel (``split``); the reference's ``lanes`` switch (its chunked form) has
no counterpart, and its defaults follow the shape (``ops.defaults``: more
threads a channel where B * dI is small, as at the training shape).  The wkv
forward's space is its chunked route's (chunk x threads a state column
in the chunk program (``split``) x value columns a states thread carries
(``cols``) x heads a chunk-program block walks (``block_h``)); its serial
route, for decode and short T, keeps its own launch point.  These kernels
mask the ragged edge, so a block or chunk need not divide its extent, only
not exceed it.  The scans' backward specs keep the same names and meta
keys as the reference's (``mamba_scan_bwd``, ``rwkv6_wkv_bwd``); their
default shapes are the training shapes (Jamba batch 2 x 2048, RWKV-6 batch
8 x 2048), their inputs add the cotangents ``dy`` and ``dh_T`` / ``ds_T``,
and their oracles are the plain backward versions.  The selective-scan
backward's space is block_d x chunk x threads a channel (``split``) x
chunks a span (``span``), a chunk bounded by the registers its kept states
take and a span by the shared memory its chunks' summaries take; the wkv backward's is chunk x the
chunk program's threads x value columns a scan thread carries (``cols``)
x warps 32 channels' in-chunk pair sum takes (``parts``), a chunk bounded
by the shared memory its tiles, entry state and exit adjoint take.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ...convert import dfa_to_device
from ...core.space import ConfigSpace, Param
from ...kernels.decode_attention import kernel as da_kernel
from ...kernels.decode_attention.ops import DEFAULTS as DA_DEFAULTS
from ...kernels.dna_automaton import kernel as dna_kernel
from ...kernels.dna_automaton.ops import (DEFAULTS as DNA_DEFAULTS,
                                          build_motif_dfa, fa_match,
                                          fa_match_plain, random_dna_text)
from ...kernels.flash_attention import kernel as fa_kernel
from ...kernels.flash_attention.ops import DEFAULTS as FA_DEFAULTS
from ...kernels.mamba_scan import kernel as ms_kernel
from ...kernels.mamba_scan.ops import BWD_DEFAULTS as MSB_DEFAULTS
from ...kernels.mamba_scan.ops import defaults as ms_defaults
from ...kernels.rwkv6_wkv import kernel as wkv_kernel
from ...kernels.rwkv6_wkv.ops import BWD_DEFAULTS as WKVB_DEFAULTS
from ...kernels.rwkv6_wkv.ops import DEFAULTS as WKV_DEFAULTS
from .evaluate import SMEM_LIMIT_BYTES
from .registry import KernelSpec, dtype_name, register_kernel

__all__ = ["ATTN_BLOCKS", "ATTN_BLOCKS_Q", "ATTN_STAGES", "ATTN_THREADS",
           "BLOCK_THREADS", "BWD_SPLITS",
           "DECODE_BLOCK_S", "DECODE_SPLITS", "DECODE_STAGES",
           "DECODE_THREADS", "GRAMS",
           "SCAN_BLOCK_D", "SCAN_BWD_BLOCK_D", "SCAN_BWD_CHUNKS",
           "SCAN_BWD_SPANS", "SCAN_CHUNKS", "SCAN_SPLITS",
           "TEXT_CHUNKS", "WKV_BWD_CHUNKS", "WKV_BWD_COLS", "WKV_BWD_PARTS",
           "WKV_BLOCK_H", "WKV_BWD_THREADS", "WKV_CHUNKS", "WKV_COLS",
           "WKV_SPLITS"]

# the DNA kernels: map and count chunks, threads a block (at most 256, so a
# thread may hold 255 registers; a warp's ring of text slots takes 13.5
# KB), symbols a lookup
TEXT_CHUNKS = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
BLOCK_THREADS = (64, 128, 256)
GRAMS = dna_kernel.GRAMS
# flash attention (the bfloat16 build): key blocks, query blocks, threads
# (a warp per 16 or 32 query rows, at most 8 warps), and the depth of the
# ring that brings k and v in
ATTN_BLOCKS = (16, 32, 64, 128, 256)
ATTN_BLOCKS_Q = ATTN_BLOCKS
ATTN_THREADS = (32, 64, 128, 256)
ATTN_STAGES = fa_kernel.STAGES
# split-KV decode: splits (a group's blocks form one cluster: a power of
# two up to 16), keys a warp's tile, threads (a ring per warp) and ring depth
DECODE_SPLITS = (1, 2, 4, 8, 16)
DECODE_BLOCK_S = da_kernel.BLOCK_S
DECODE_THREADS = (32, 64, 128, 256)
DECODE_STAGES = da_kernel.STAGES
# the selective scan: channels a block, tokens a staged chunk, threads a
# channel
SCAN_BLOCK_D = (16, 32, 64, 128, 256)
SCAN_CHUNKS = (8, 16, 32, 64)
SCAN_SPLITS = (1, 2, 4, 8, 16)
# the wkv forward's chunked route: chunk length, threads a state column in
# the chunk program, value columns a states thread carries, heads a
# chunk-program block walks
WKV_CHUNKS = wkv_kernel.CHUNKS
WKV_SPLITS = wkv_kernel.SPLITS
WKV_COLS = wkv_kernel.COLS
WKV_BLOCK_H = wkv_kernel.BLOCK_H
# the selective-scan backward: channels a block, chunk length, threads a
# channel, chunks a span
SCAN_BWD_BLOCK_D = (16, 32, 64, 128, 256)
SCAN_BWD_CHUNKS = ms_kernel.BWD_CHUNKS
BWD_SPLITS = (1, 2, 4, 8, 16)
SCAN_BWD_SPANS = ms_kernel.BWD_SPANS
# the wkv backward: chunk length, the chunk program's threads, value
# columns a scan thread carries, warps 32 channels' in-chunk pair sum takes
WKV_BWD_CHUNKS = wkv_kernel.BWD_CHUNKS
WKV_BWD_THREADS = (64, 128, 256, 512)
WKV_BWD_COLS = wkv_kernel.BWD_COLS
WKV_BWD_PARTS = wkv_kernel.BWD_PARTS

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
        Param("gram", GRAMS),
    ])


def _dna_validate(cfg, meta) -> str | None:
    mc, cc, t, s = cfg["map_chunk"], cfg["count_chunk"], meta["t"], meta["s"]
    bt, gram = cfg["block_threads"], cfg["gram"]
    err = _divides(t, mc, "map_chunk") or _divides(t, cc, "count_chunk")
    if err:
        return err
    if cc % mc:
        return (f"count_chunk={cc} is not a multiple of map_chunk={mc} "
                "(count start states live at map-chunk boundaries)")
    if s > dna_kernel.MAX_STATES:
        return f"S={s} states above {dna_kernel.MAX_STATES}"
    # a walker's range (a count chunk; a state-map slice, whole 16-byte
    # units of its chunk) is a whole number of 16-byte copies and k-grams
    if mc % 16 or cc % 16:
        return (f"map_chunk={mc} or count_chunk={cc} is not a whole number "
                "of 16-byte copies")
    return (_smem(dna_kernel.smem_bytes(dna_kernel.route_of(s), s, bt, gram))
            or _smem(dna_kernel.smem_bytes("count", s, bt, gram)))


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
                    block_threads=cfg["block_threads"], gram=cfg["gram"],
                    tuned=False)


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


# -- flash attention --------------------------------------------------------------

def _not_above(extent: int, block: int, smallest: int, name: str) -> str | None:
    """A masked block need not divide its extent, but a block larger than
    the extent (past the smallest candidate) only computes padding."""
    if block > extent and block > smallest:
        return f"{name}={block} exceeds extent {extent}"
    return None


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype_name(dtype))


def _fa_space(meta: Mapping[str, Any]) -> ConfigSpace:
    return ConfigSpace([
        Param("block_q", ATTN_BLOCKS_Q),
        Param("block_k", ATTN_BLOCKS),
        Param("block_threads", ATTN_THREADS),
        Param("stages", ATTN_STAGES),
    ])


def _fa_validate(cfg, meta) -> str | None:
    """The space is the bfloat16 build's (the serving and training path):
    a template for the head_dim, a warp per 16 or 32 query rows (32 up to
    hd 128: two row tiles' accumulators do not fit the registers at hd
    192), and the q tile and the ring's k and v tiles within the shared
    memory a block may have.  The float32
    build, the parity path, keeps its own launch point (``F32_DEFAULTS``)
    and is not tuned: requiring that a point fit both builds would cut
    the bfloat16 blocks to the float32 tiles' footprint."""
    bq, bk, hd = cfg["block_q"], cfg["block_k"], meta["hd"]
    try:                     # the wrapper's own rule for the bfloat16 build
        fa_kernel._check_bf16_launch(hd, bq, bk, cfg["block_threads"],
                                     fa_kernel.BF16_HEAD_DIMS, two_tiles=True)
    except ValueError as exc:
        return str(exc)
    return (_not_above(meta["tq"], bq, ATTN_BLOCKS_Q[0], "block_q")
            or _not_above(meta["tk"], bk, ATTN_BLOCKS[0], "block_k")
            or _smem(fa_kernel.smem_bytes(bq, bk, hd, torch.bfloat16,
                                          cfg["stages"])))


def _fa_inputs(meta, dtype, rng, device):
    if _torch_dtype(dtype) != torch.bfloat16:
        raise ValueError(
            f"flash_attention: the launch space is the bfloat16 build's; "
            f"the {dtype_name(dtype)} build keeps its own launch point "
            "(ops.F32_DEFAULTS) and is not tuned")
    # the reference's numpy stream and (bh, t, hd) shapes; the port's
    # kernel takes (B, T, H, hd), here with the heads as the batch
    shapes = [(meta["bh"], meta["tq"], meta["hd"]),
              (meta["bh"], meta["tk"], meta["hd"])]
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).to(
        device=device, dtype=_torch_dtype(dtype))[:, :, None]
        for s in (shapes[0], shapes[1], shapes[1]))
    return q, k, v, bool(meta["causal"])


def _fa_run(cfg, inputs):
    q, k, v, causal = inputs
    o, _ = fa_kernel.flash_attention_fwd(
        q, k, v, causal=causal, block_q=cfg["block_q"],
        block_k=cfg["block_k"], block_threads=cfg["block_threads"],
        stages=cfg["stages"])
    return o


def _fa_ref(inputs):
    q, k, v, causal = inputs
    return fa_kernel.flash_attention_fwd_plain(q, k, v, causal=causal)[0]


register_kernel(KernelSpec(
    name="flash_attention",
    defaults=FA_DEFAULTS,
    space_fn=_fa_space, validate_fn=_fa_validate,
    make_inputs=_fa_inputs, run=_fa_run, ref=_fa_ref,
    default_shape={"bh": 128, "tq": 2048, "tk": 2048, "hd": 128,
                   "causal": True},
    smoke_shape={"bh": 2, "tq": 128, "tk": 128, "hd": 32, "causal": True},
    dtype="bfloat16",
    atol=2e-4, rtol=2e-4,
))


# -- decode attention ----------------------------------------------------------------

def _da_space(meta: Mapping[str, Any]) -> ConfigSpace:
    return ConfigSpace([
        Param("splits", DECODE_SPLITS),
        Param("block_s", DECODE_BLOCK_S),
        Param("block_threads", DECODE_THREADS),
        Param("stages", DECODE_STAGES),
    ])


def _da_validate(cfg, meta) -> str | None:
    sp, bs, nt = cfg["splits"], cfg["block_s"], cfg["block_threads"]
    s, hd, rep = meta["s"], meta["hd"], meta["rep"]
    if hd not in da_kernel.HEAD_DIMS:
        return f"head_dim={hd} not in {da_kernel.HEAD_DIMS}"
    if rep > da_kernel.MAX_REP:
        return f"rep={rep} exceeds {da_kernel.MAX_REP}"
    if sp > s:
        return f"splits={sp} exceeds extent {s}"
    seg = da_kernel.segment_length(s, sp)
    if (sp - 1) * seg >= s:
        return f"splits={sp} leaves segments past the cache ({s} positions)"
    # either build may take the point: the larger of their footprints
    need = max(da_kernel.smem_bytes(rep, hd, bs, nt, cfg["stages"], dtype)
               for dtype in da_kernel.DTYPES)
    return _not_above(seg, bs, DECODE_BLOCK_S[0], "block_s") or _smem(need)


def _da_inputs(meta, dtype, rng, device):
    b, kv, rep, hd, s = (meta[k] for k in ("b", "kv", "rep", "hd", "s"))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=_torch_dtype(dtype))
        for shape in ((b, kv, rep, hd), (b, s, kv, hd), (b, s, kv, hd)))
    return q, k, v, s


def _da_run(cfg, inputs):
    q, k, v, length = inputs
    return da_kernel.decode_attention(q, k, v, length, splits=cfg["splits"],
                                      block_s=cfg["block_s"],
                                      block_threads=cfg["block_threads"],
                                      stages=cfg["stages"])


def _da_ref(inputs):
    q, k, v, length = inputs
    return da_kernel.decode_attention_plain(q, k, v, length)


register_kernel(KernelSpec(
    name="decode_attention",
    defaults=DA_DEFAULTS,
    space_fn=_da_space, validate_fn=_da_validate,
    make_inputs=_da_inputs, run=_da_run, ref=_da_ref,
    default_shape={"b": 8, "kv": 2, "rep": 8, "hd": 128, "s": 2176},
    smoke_shape={"b": 1, "kv": 2, "rep": 4, "hd": 32, "s": 512},
    atol=2e-4, rtol=2e-4,
))


# -- mamba selective scan ------------------------------------------------------------

def _ms_space(meta: Mapping[str, Any]) -> ConfigSpace:
    return ConfigSpace([
        Param("block_d", SCAN_BLOCK_D),
        Param("chunk", SCAN_CHUNKS),
        Param("split", SCAN_SPLITS),
    ])


def _ms_validate(cfg, meta) -> str | None:
    bd, chunk = cfg["block_d"], cfg["chunk"]
    if meta["s"] not in ms_kernel.STATE_SIZES:
        return f"state size {meta['s']} not in {ms_kernel.STATE_SIZES}"
    # the kernel's own rules: threads (block_d x split), chunk a multiple
    # of the tokens a thread takes at once, the ring's shared memory
    return (ms_kernel.launch_error(meta["s"], bd, chunk, cfg["split"])
            or _not_above(meta["di"], bd, SCAN_BLOCK_D[0], "block_d")
            or _not_above(meta["t"], chunk, SCAN_CHUNKS[0], "chunk"))


def _randn(rng, shape, device, gen=None) -> torch.Tensor:
    """Standard normals: the reference's numpy stream on the CPU; on the
    card drawn there (a full-size host copy would take seconds)."""
    if device.type == "cpu":
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return torch.randn(shape, generator=gen, device=device)


def _card_generator(rng, device):
    if device.type == "cpu":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    return gen


def _ms_inputs(meta, dtype, rng, device):
    # the reference's distributions (repro/tune/kernels/specs.py _ms_inputs)
    bt, t, di, s = (meta[k] for k in ("bt", "t", "di", "s"))
    gen = _card_generator(rng, device)
    x = _randn(rng, (bt, t, di), device, gen)
    delta = _randn(rng, (bt, t, di), device, gen).abs() * 0.1
    a = -(_randn(rng, (di, s), device, gen).abs() + 0.5)
    b = _randn(rng, (bt, t, s), device, gen)
    c = _randn(rng, (bt, t, s), device, gen)
    d = _randn(rng, (di,), device, gen)
    h0 = torch.zeros((bt, di, s), dtype=torch.float32, device=device)
    return tuple(m.to(device) for m in (x, delta, a, b, c, d, h0))


def _ms_run(cfg, inputs):
    return ms_kernel.selective_scan_fwd(*inputs, **cfg)


def _ms_ref(inputs):
    return ms_kernel.selective_scan_fwd_plain(*inputs)


register_kernel(KernelSpec(
    name="mamba_scan",
    defaults=ms_defaults,
    space_fn=_ms_space, validate_fn=_ms_validate,
    make_inputs=_ms_inputs, run=_ms_run, ref=_ms_ref,
    default_shape={"bt": 8, "t": 2048, "di": 8192, "s": 16},
    smoke_shape={"bt": 1, "t": 64, "di": 64, "s": 4},
    atol=2e-4, rtol=2e-3,
))


# -- mamba selective scan: backward ------------------------------------------------

def _msb_space(meta: Mapping[str, Any]) -> ConfigSpace:
    return ConfigSpace([
        Param("block_d", SCAN_BWD_BLOCK_D),
        Param("chunk", SCAN_BWD_CHUNKS),
        Param("split", BWD_SPLITS),
        Param("span", SCAN_BWD_SPANS),
    ])


def _msb_validate(cfg, meta) -> str | None:
    bd, chunk, s = cfg["block_d"], cfg["chunk"], meta["s"]
    split, span = cfg["split"], cfg["span"]
    if s not in ms_kernel.STATE_SIZES:
        return f"state size {s} not in {ms_kernel.STATE_SIZES}"
    # shared memory bounds block_d x chunk and block_d x span; the chunk
    # program keeps chunk x (S / split + 1) floats of each kind a thread in
    # registers
    return (_smem(max(ms_kernel.smem_bytes_bwd(s, bd, chunk, split, span),
                      ms_kernel.smem_bytes_bwd_summaries(s, bd, chunk)))
            or ms_kernel.bwd_launch_error(s, bd, chunk, split, span)
            or _not_above(meta["di"], bd, SCAN_BWD_BLOCK_D[0], "block_d")
            or _not_above(meta["t"], chunk, SCAN_BWD_CHUNKS[0], "chunk"))


def _msb_inputs(meta, dtype, rng, device):
    inputs = _ms_inputs(meta, dtype, rng, device)
    bt, t, di, s = (meta[k] for k in ("bt", "t", "di", "s"))
    gen = _card_generator(rng, device)
    dy = _randn(rng, (bt, t, di), device, gen)
    dh = _randn(rng, (bt, di, s), device, gen)
    return inputs + (dy.to(device), dh.to(device))


def _msb_run(cfg, inputs):
    return ms_kernel.selective_scan_bwd(*inputs, **cfg)


def _msb_ref(inputs):
    return ms_kernel.selective_scan_bwd_plain(*inputs)


register_kernel(KernelSpec(
    name="mamba_scan_bwd",
    defaults=MSB_DEFAULTS,
    space_fn=_msb_space, validate_fn=_msb_validate,
    make_inputs=_msb_inputs, run=_msb_run, ref=_msb_ref,
    default_shape={"bt": 2, "t": 2048, "di": 8192, "s": 16},
    smoke_shape={"bt": 1, "t": 64, "di": 64, "s": 4},
    atol=2e-4, rtol=2e-3,
))


# -- rwkv6 wkv ---------------------------------------------------------------------------

def _wkv_space(meta: Mapping[str, Any]) -> ConfigSpace:
    return ConfigSpace([
        Param("chunk", WKV_CHUNKS),
        Param("split", WKV_SPLITS),
        Param("cols", WKV_COLS),
        Param("block_h", WKV_BLOCK_H),
    ])


def _wkv_validate(cfg, meta) -> str | None:
    """The chunked route's space: a head size it is built for, a T that
    fills the chunk, and the states and chunk programs' shared memory
    (the serial route keeps its own launch point and is not tuned)."""
    chunk, t, hd = cfg["chunk"], meta["t"], meta["hd"]
    if hd not in wkv_kernel.CHUNKED_HEAD_DIMS:
        return (f"hd={hd} not built for the chunked route "
                f"({wkv_kernel.CHUNKED_HEAD_DIMS})")
    return (_not_above(t, chunk, WKV_CHUNKS[0], "chunk")
            or wkv_kernel.launch_error(t, meta["h"], hd, chunk, cfg["split"],
                                       cfg["cols"], cfg["block_h"]))


def _wkv_inputs(meta, dtype, rng, device):
    # the reference's distributions (repro/tune/kernels/specs.py
    # _wkv_inputs): decays w = sigmoid(N(0, 1) + 2)
    b, t, h, hd = (meta[k] for k in ("b", "t", "h", "hd"))
    gen = _card_generator(rng, device)
    r, k, v = (_randn(rng, (b, t, h, hd), device, gen) * 0.5
               for _ in range(3))
    w = torch.sigmoid(_randn(rng, (b, t, h, hd), device, gen) + 2)
    u = _randn(rng, (h, hd), device, gen) * 0.1
    s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=device)
    return tuple(m.to(device) for m in (r, k, v, w, u, s0))


def _wkv_run(cfg, inputs):
    return wkv_kernel.wkv6_fwd(*inputs, **cfg)


def _wkv_ref(inputs):
    return wkv_kernel.wkv6_fwd_plain(*inputs)


register_kernel(KernelSpec(
    name="rwkv6_wkv",
    defaults=WKV_DEFAULTS,
    space_fn=_wkv_space, validate_fn=_wkv_validate,
    make_inputs=_wkv_inputs, run=_wkv_run, ref=_wkv_ref,
    default_shape={"b": 8, "t": 2048, "h": 32, "hd": 64},
    smoke_shape={"b": 1, "t": 64, "h": 1, "hd": 16},
    atol=2e-4, rtol=2e-3,
))


# -- rwkv6 wkv: backward -----------------------------------------------------------------

def _wkvb_space(meta: Mapping[str, Any]) -> ConfigSpace:
    return ConfigSpace([
        Param("chunk", WKV_BWD_CHUNKS),
        Param("block_threads", WKV_BWD_THREADS),
        Param("cols", WKV_BWD_COLS),
        Param("parts", WKV_BWD_PARTS),
    ])


def _wkvb_validate(cfg, meta) -> str | None:
    chunk, cols = cfg["chunk"], cfg["cols"]
    t, hd = meta["t"], meta["hd"]
    if hd not in wkv_kernel.BWD_HEAD_DIMS:
        return f"hd={hd} not built ({wkv_kernel.BWD_HEAD_DIMS})"
    if hd % cols:
        return f"cols={cols} does not divide hd={hd}"
    # a chunk's tiles, S0 and G: shared memory bounds the chunk
    return (_not_above(t, chunk, WKV_BWD_CHUNKS[0], "chunk")
            or _smem(wkv_kernel.smem_bytes_bwd(chunk, hd)))


def _wkvb_inputs(meta, dtype, rng, device):
    inputs = _wkv_inputs(meta, dtype, rng, device)
    b, t, h, hd = (meta[k] for k in ("b", "t", "h", "hd"))
    gen = _card_generator(rng, device)
    dy = _randn(rng, (b, t, h, hd), device, gen)
    ds = _randn(rng, (b, h, hd, hd), device, gen)
    return inputs + (dy.to(device), ds.to(device))


def _wkvb_run(cfg, inputs):
    return wkv_kernel.wkv6_bwd(*inputs, **cfg)


def _wkvb_ref(inputs):
    return wkv_kernel.wkv6_bwd_plain(*inputs)


register_kernel(KernelSpec(
    name="rwkv6_wkv_bwd",
    defaults=WKVB_DEFAULTS,
    space_fn=_wkvb_space, validate_fn=_wkvb_validate,
    make_inputs=_wkvb_inputs, run=_wkvb_run, ref=_wkvb_ref,
    default_shape={"b": 8, "t": 2048, "h": 32, "hd": 64},
    smoke_shape={"b": 1, "t": 64, "h": 1, "hd": 16},
    atol=2e-4, rtol=2e-3,
))
