"""FlashAttention-2 forward: the CUDA kernel's wrapper and its plain version.

``flash_attention_fwd`` replaces the Pallas kernel of the same name
(``repro/kernels/flash_attention/kernel.py``, ``_fwd_kernel``): per (batch,
head) and query block it walks the key blocks with the running online-
softmax state (acc, m, l), masks causally with ``q_offset``, and returns
``o`` in q's dtype and ``lse = m + log l`` in float32.  The kernel is CUDA
C++ in ``kernels/csrc/flash_attention.cu``, compiled at first use and bound
with ``ctypes``: its bfloat16 build multiplies on the tensor cores
(``mma.sync``, float32 accumulation), its float32 build on the CUDA cores in
float32 (no TF32, so it meets the float32 parity gate).

Layout: the TPU kernel takes heads folded into the batch, ``(B*H, T, hd)``.
Here q, k and v are ``(B, T, H, hd)`` views whose last dimension is
contiguous; the kernel folds by index arithmetic through the views'
strides, so nothing is copied.  ``o`` is ``(B, Tq, H, hd)`` and ``lse`` is
``(B, H, Tq)`` (the reference's ``(B*H, Tq)`` unflattened).

A wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version (``flash_attention_fwd_plain``, which materialises
the scores in float32) only for tensors on the CPU.  Launches are counted
in ``flash_attention_fwd.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import SMEM_LIMIT_BYTES, KernelLaunchError

__all__ = ["DTYPES", "NEG_INF", "flash_attention_fwd",
           "flash_attention_fwd_plain", "smem_bytes"]

NEG_INF = -1e30
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for suffix in DTYPES.values():
            fn = getattr(lib, f"flash_attention_fwd_{suffix}")
            fn.argtypes = [ptr] * 6 + [i32] * 10 + [ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


def smem_bytes(block_q: int, block_k: int, hd: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one block of the kernel's ``dtype`` build asks for.

    float32 (``smem_floats_f32``): transposed q and k tiles, the v tile, the
    scores, the output accumulator and three per-row carries, all float32,
    rows padded by one word.  bfloat16 (``MmaLayout``): q, k, v transposed
    and p tiles in bf16 with rows padded by 8 elements, blocks padded to 16
    rows/keys for the mma; scores, output accumulator and carries float32.
    """
    bq, bk = block_q, block_k
    if dtype == torch.bfloat16:
        BQ, BK = _pad16(bq), _pad16(bk)
        bf16 = BQ * (hd + 8) + bk * (hd + 8) + hd * (BK + 8) + BQ * (BK + 8)
        f32 = BQ * (bk + 4) + BQ * (hd + 4) + 3 * BQ
        return 2 * bf16 + 4 * f32
    return 4 * (hd * (bq + 1) + hd * (bk + 1) + bk * hd + bq * (bk + 1)
                + bq * (hd + 1) + 3 * bq)


def _check(q, k, v, block_q: int, block_k: int, block_threads: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
            raise TypeError(f"{name} must be a float32 or bfloat16 tensor")
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, T, H, hd), got "
                             f"{tuple(x.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along hd")
    b, tq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, hd):
        raise ValueError(f"k/v must be (B, Tk, H, hd) = ({b}, Tk, {h}, {hd}) "
                         f"with kv heads already repeated, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if tq < 1 or k.shape[1] < 1:
        raise ValueError("q and k must hold at least one position each")
    if hd % 4:
        raise ValueError(f"head_dim {hd} must be a multiple of 4")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk < 4 or blk % 4:
            raise ValueError(f"{name}={blk} must be a positive multiple of 4")
    if not 32 <= block_threads <= 1024 or block_threads % 32:
        raise ValueError("block_threads must be a multiple of 32 in "
                         f"[32, 1024], got {block_threads}")
    need = smem_bytes(block_q, block_k, hd, q.dtype)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"block_q={block_q}, block_k={block_k}, hd={hd} need "
                         f"{need} bytes of shared memory (limit "
                         f"{SMEM_LIMIT_BYTES})")


def _check_mma(block_q: int, block_k: int, *tensors) -> None:
    """What the bfloat16 (tensor-core) build needs beyond ``_check``: it
    moves bf16 in pairs and tiles by the mma's 8 keys and 16 dims."""
    hd = tensors[0].shape[-1]
    if hd % 16:
        raise ValueError(f"bfloat16: head_dim {hd} must be a multiple of 16")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk % 8:
            raise ValueError(f"bfloat16: {name}={blk} must be a multiple of 8")
    for x in tensors:
        if x.data_ptr() % 4 or any(x.stride(i) % 2 for i in range(3)):
            raise ValueError("bfloat16: q, k, v and o need even strides and "
                             "4-byte aligned storage")


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              q_offset: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_attention_fwd`: the same float32
    arithmetic with the whole ``(B, H, Tq, Tk)`` score tensor materialised."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, k.float())
    if causal:
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = torch.arange(tk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    del s
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.transpose(1, 2)[..., None]
    return o.to(q.dtype), m + torch.log(l)


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        block_q: int = 64, block_k: int = 64,
                        block_threads: int = 256
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Tq, H, hd); k, v: (B, Tk, H, hd), kv heads already repeated.

    Returns ``o`` (B, Tq, H, hd) in q's dtype and ``lse`` (B, H, Tq)
    float32.  Neither ``Tq`` nor ``Tk`` needs to be a multiple of a block:
    the kernel masks the ragged edge.
    """
    block_q, block_k = int(block_q), int(block_k)
    block_threads, q_offset = int(block_threads), int(q_offset)
    _check(q, k, v, block_q, block_k, block_threads)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         q_offset=q_offset)
    b, tq, h, hd = q.shape
    o = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        _check_mma(block_q, block_k, q, k, v, o)
    strides = (ctypes.c_int64 * 12)(*(x.stride(i) for x in (q, k, v, o)
                                      for i in range(3)))
    lib = _library()
    fn = getattr(lib, f"flash_attention_fwd_{DTYPES[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), ctypes.addressof(strides), b, h, tq,
                k.shape[1], hd, block_q, block_k, block_threads, int(causal),
                q_offset, hd ** -0.5, stream)
    if rc != 0:
        raise KernelLaunchError(
            f"flash_attention_fwd(block_q={block_q}, block_k={block_k}, "
            f"block_threads={block_threads}): launch refused ({rc}: "
            f"{lib.flash_attention_error_string(rc).decode()})")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
