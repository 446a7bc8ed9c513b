"""Split-KV decode attention: the CUDA kernel's wrapper and its plain version.

``decode_attention`` replaces the Pallas kernel ``decode_attention_kernel``
(``repro/kernels/decode_attention/kernel.py``: ``_kernel`` plus the combine
after its ``pallas_call``).  One query token per (batch, head) attends to a
fixed-capacity cache ``(B, S, KV, hd)``; the ``rep = H / KV`` heads that
share a kv head form one group, so each cached row is read once for all of
them.  The cache is cut into ``splits`` segments of ``ceil(S / splits)``
positions; each (batch, kv head, segment) forms an unnormalised partial
``(acc, m, l)`` over its positions below ``length``, and the partials are
merged with one logsumexp rescale.  A segment that lies wholly at or beyond
``length`` holds ``m = -1e30, l = 0, acc = 0`` and weighs exactly 0.

The kernel is CUDA C++ in ``kernels/csrc/decode_attention.cu`` (float32 and
bfloat16 caches; hd in {32, 64, 96, 128, 192}; rep <= 16), compiled at first
use and bound with ``ctypes``.  It computes the whole function in one
launch: the ``splits`` blocks of a group form a thread block cluster and
merge their partials through distributed shared memory, in split order, so
two runs give the same bits.  The bfloat16 build streams k and v through
``cp.async`` rings (``stages`` deep, ``block_s`` keys a tile, a ring per
warp of ``block_threads / 32``) into ``mma.sync`` products; the float32
build is the parity path on the CUDA cores.  ``length`` is a plain integer
handed to the kernel, so one build serves every fill level.

The wrapper, ``decode_attention``, launches the kernel for a CUDA tensor,
or raises; it takes the plain PyTorch version (``decode_attention_plain``:
``decode_partials_plain``, which materialises the float32 scores, then
``combine_splits``) only for tensors on the CPU.  Launches are counted in
``decode_attention.launches``.  For a meta tensor (a dry run) it allocates
its outputs as the CUDA path does and records the call in
``kernels.census.CENSUS`` instead of launching.

``return_lse=True`` also returns the logsumexp of the scaled scores over
the positions below ``length`` (``m_tot + ln l_tot``; the bfloat16 build
keeps its maxima in log2 units and writes ``(m_tot + log2 l_tot) ln 2``),
the cluster's leader writing it after the merge: still one launch a call,
and the same output bits as without it.  The sequence-sharded decode
(``dist.seq_decode``) combines stripes with it.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import SMEM_LIMIT_BYTES, KernelLaunchError
from ..census import CENSUS

__all__ = ["BLOCK_S", "DTYPES", "HEAD_DIMS", "MAX_REP", "MAX_SPLITS",
           "NEG_INF", "STAGES", "combine_splits", "decode_attention",
           "decode_attention_plain", "decode_partials_plain",
           "segment_length", "smem_bytes"]

NEG_INF = -1e30
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64, 96, 128, 192)
MAX_REP = 16
# a group's splits form one cluster: a power of two, at most 16 (above 8
# through the non-portable cluster size)
MAX_SPLITS = 16
# keys a tile (the bfloat16 build's template lengths; the float32 build
# takes the same), ring depths, threads a block per build
BLOCK_S = (16, 32, 64)
STAGES = (1, 2, 3, 4)
MAX_THREADS = {"f32": 512, "bf16": 256}

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("decode_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for suffix in DTYPES.values():
            fn = getattr(lib, f"decode_attention_{suffix}")
            fn.argtypes = [ptr] * 5 + [i32] * 10 + [ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(rep: int, hd: int, block_s: int, block_threads: int,
               stages: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory one block asks for (the kernel's ``*_smem_*``).

    bfloat16: the warps' rings of k and v tiles (pitch hd + 8), reused for
    the warps' float32 partials (16 rows each) after the main loop, plus the
    block's m and l.  float32: scaled queries, a tile of scores, three
    per-head carries and one accumulator per warp."""
    warps = block_threads // 32
    if dtype == torch.bfloat16:
        ring = warps * stages * 2 * block_s * (hd + 8) * 2
        part = warps * (16 * hd + 32) * 4
        return max(ring, part) + 2 * 16 * 4
    return 4 * (rep * hd + rep * block_s + 3 * rep + warps * rep * hd)


def segment_length(s_len: int, splits: int) -> int:
    return -(-s_len // splits)


def _check(q, k, v, length, splits: int, block_s: int, block_threads: int,
           stages: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
            raise TypeError(f"{name} must be a float32 or bfloat16 tensor")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, rep, hd), got {tuple(q.shape)}")
    b, kv, rep, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2:] != (kv, hd):
        raise ValueError(f"k/v must be (B, S, KV, hd) = ({b}, S, {kv}, {hd}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not 1 <= rep <= MAX_REP:
        raise ValueError(f"rep={rep} query heads per kv head outside "
                         f"[1, {MAX_REP}]")
    if isinstance(length, bool) or not isinstance(length, int) or length < 1:
        raise ValueError(f"length must be a positive int, got {length!r}")
    s_len = k.shape[1]
    if not 1 <= splits <= min(s_len, MAX_SPLITS) or splits & (splits - 1):
        raise ValueError(f"splits={splits} must be a power of two in "
                         f"[1, min(S={s_len}, {MAX_SPLITS})] (one cluster)")
    if block_s not in BLOCK_S:
        raise ValueError(f"block_s={block_s} not in {BLOCK_S}")
    limit = MAX_THREADS[DTYPES[q.dtype]]
    if not 32 <= block_threads <= limit or block_threads % 32:
        raise ValueError("block_threads must be a multiple of 32 in "
                         f"[32, {limit}], got {block_threads}")
    if stages not in STAGES:
        raise ValueError(f"stages={stages} not in {STAGES}")
    need = smem_bytes(rep, hd, block_s, block_threads, stages, q.dtype)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"block_s={block_s}, block_threads={block_threads}, "
                         f"stages={stages} need {need} bytes of shared "
                         f"memory (limit {SMEM_LIMIT_BYTES})")


def combine_splits(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, *,
                   return_lse: bool = False):
    """Merge per-split partials with one logsumexp rescale.

    acc: (B, splits, KV, rep, hd); m, l: (B, splits, KV, rep), all float32.
    Returns (B, KV, rep, hd) float32, and with ``return_lse`` also the
    natural log of the summed exponentials, ``m_tot + log(l_tot)``
    (B, KV, rep) float32.
    """
    m_tot = m.amax(dim=1)
    w = torch.exp(m - m_tot[:, None])
    l_tot = (l * w).sum(dim=1)
    o = (acc * w[..., None]).sum(dim=1)
    out = o / l_tot.clamp_min(1e-30)[..., None]
    if return_lse:
        return out, m_tot + torch.log(l_tot)
    return out


def decode_partials_plain(q, k, v, length: int, *, splits: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-split partials ``(acc, m, l)`` from the materialised float32
    scores, with the kernel's rule for positions at or beyond ``length``
    (they take no part)."""
    b, kv, rep, hd = q.shape
    s_len = k.shape[1]
    seg = segment_length(s_len, splits)
    pad = splits * seg - s_len
    s = torch.einsum("bgrh,bsgh->bgrs", q.float() * hd ** -0.5, k.float())
    valid = torch.arange(splits * seg, device=q.device) < min(length, s_len)
    s = torch.nn.functional.pad(s, (0, pad)).masked_fill(~valid, NEG_INF)
    s = s.view(b, kv, rep, splits, seg)
    m = s.amax(dim=-1)                                   # (b, kv, rep, sp)
    p = torch.exp(s - m[..., None]) * valid.view(splits, seg)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("bgrpj,bpjgh->bpgrh", p, vf.view(b, splits, seg, kv, hd))
    return acc, m.permute(0, 3, 1, 2), p.sum(dim=-1).permute(0, 3, 1, 2)


def decode_attention_plain(q, k, v, length: int, *, splits: int = 1,
                           return_lse: bool = False):
    """Plain version of :func:`decode_attention`: partials, then combine."""
    return combine_splits(*decode_partials_plain(q, k, v, length,
                                                 splits=splits),
                          return_lse=return_lse)


def decode_attention(q, k, v, length: int, *, splits: int = 4,
                     block_s: int = 16, block_threads: int = 256,
                     stages: int = 3, return_lse: bool = False):
    """The kernel: q (B, KV, rep, hd); k, v (B, S, KV, hd); attends to
    positions ``< length``.  Returns (B, KV, rep, hd) float32, the splits
    merged inside the launch; with ``return_lse`` also the logsumexp of
    the scaled scores over those positions, (B, KV, rep) float32, which
    the cluster's leader writes in the same launch."""
    splits, block_s = int(splits), int(block_s)
    block_threads, stages = int(block_threads), int(stages)
    _check(q, k, v, length, splits, block_s, block_threads, stages)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length, splits=splits,
                                      return_lse=return_lse)
    b, kv, rep, hd = q.shape
    s_len = k.shape[1]
    out = torch.empty((b, kv, rep, hd), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, kv, rep), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.device.type == "meta":
        n = min(int(length), s_len)
        CENSUS.add("decode_attention", ("decode",),
                   4 * b * kv * rep * hd * n,
                   2 * b * n * kv * hd * k.element_size()
                   + q.numel() * q.element_size() + 4 * out.numel()
                   + (0 if lse is None else 4 * lse.numel()))
        return (out, lse) if return_lse else out
    lib = _library()
    fn = getattr(lib, f"decode_attention_{DTYPES[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s_len, kv, rep,
                hd, length, splits, block_s, block_threads, stages,
                hd ** -0.5, stream)
    if rc != 0:
        raise KernelLaunchError(
            f"decode_attention(splits={splits}, block_s={block_s}, "
            f"block_threads={block_threads}, stages={stages}): launch refused "
            f"({rc}: {lib.decode_attention_error_string(rc).decode()})")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
