"""FlashAttention-2 forward and backward: the CUDA kernels' wrappers and
their plain versions.

``flash_attention_fwd`` replaces the Pallas kernel of the same name
(``repro/kernels/flash_attention/kernel.py``, ``_fwd_kernel``): per (batch,
head) and query block it walks the key blocks with the running online-
softmax state (acc, m, l), masks causally with ``q_offset``, and returns
``o`` in q's dtype and ``lse = m + log l`` in float32.  The kernel is CUDA
C++ in ``kernels/csrc/flash_attention.cu``, compiled at first use and bound
with ``ctypes``: its bfloat16 build is FA-2's register-resident forward on
the tensor cores (``mma.sync``, float32 accumulation; a warp per 16 or 32
query rows, so ``block_threads`` is ``2 * block_q`` or ``block_q``; k and
v through a ring of ``stages`` shared slots filled by ``cp.async``), its
float32 build the
parity path on the CUDA cores in float32 (no TF32, so it meets the
float32 parity gate; it stages its tiles synchronously: ``stages = 1``).

Layout: the TPU kernel takes heads folded into the batch, ``(B*H, T, hd)``.
Here q, k and v are ``(B, T, H, hd)`` views whose last dimension is
contiguous; the kernel folds by index arithmetic through the views'
strides, so nothing is copied.  ``o`` is ``(B, Tq, H, hd)`` and ``lse`` is
``(B, H, Tq)`` (the reference's ``(B*H, Tq)`` unflattened).

``flash_attention_bwd`` replaces the reference's ``flash_attention_bwd``
(``_dq_kernel`` and ``_dkv_kernel``): two programs in
``kernels/csrc/flash_attention_bwd.cu``, one per (batch, head) and query
block for dq, one per (batch, head) and key block for dk and dv, each
recomputing ``p = exp(s - lse)`` from the forward's ``lse``.  The bfloat16
build does all seven products on the tensor cores (``mma.sync``, float32
accumulators in registers; a warp per 16 query rows or keys, so
``block_q = block_k = block_threads / 2``); the float32 build, the parity
path, computes in float32 on the CUDA cores.  ``delta = rowsum(do * o)``
is plain PyTorch, as the reference computes it outside its Pallas calls.

Each build has its own launch point (``FWD_LAUNCH``, ``BWD_LAUNCH``),
taken for any launch parameter left ``None``, its own shared-memory
layout (``smem_bytes``, ``smem_bytes_bwd``) and its own checks; the
bfloat16 builds are compiled for the head_dims the repo's configs carry
(``BF16_HEAD_DIMS``, ``BWD_BF16_HEAD_DIMS``; at hd 192 the backward keeps
dq's do rows in shared memory and splits the dk/dv program's blocks into
dv and dk halves of one grid, since its fragments and two accumulators
would pass 255 registers, and its launch point is cut to the card's
shared memory: ``fit_bwd_launch``), and an unbuilt head_dim is refused
before any launch, on the CPU too.

A wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version (``flash_attention_fwd_plain``,
``flash_attention_bwd_plain``, which materialise the scores in float32)
only for tensors on the CPU.  For meta tensors (a dry run) it allocates
its outputs and scratch as the CUDA path does and records the call in
``kernels.census.CENSUS`` instead of launching.  Launches are counted in
``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches`` (the
latter per program too: ``program_launches["dq"]``, ``["dkv"]``).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import SMEM_LIMIT_BYTES, KernelLaunchError
from ..census import CENSUS, causal_pairs

__all__ = ["BF16_HEAD_DIMS", "BWD_BF16_HEAD_DIMS", "BWD_LAUNCH", "DTYPES",
           "FWD_LAUNCH", "MAX_BWD_THREADS", "MAX_HD_TWO_TILES",
           "MMA_MAX_THREADS", "NEG_INF", "STAGES", "fit_bwd_launch",
           "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain", "smem_bytes", "smem_bytes_bwd"]

NEG_INF = -1e30
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the float32 backward kernels are compiled for at most 512 threads a
# block, which leaves each thread 128 registers for its two 4 x 4
# micro-tiles
MAX_BWD_THREADS = 512
# the bfloat16 kernels: a warp per 16 rows (the forward: or 32) with up to
# 255 registers, so at most 8 warps a block; templates per head_dim (the
# forward's two row tiles do not fit 255 registers at hd 192; the
# backward's hd 192 build holds one accumulator a block, see the top)
MMA_MAX_THREADS = 256
MAX_HD_TWO_TILES = 128
BF16_HEAD_DIMS = (32, 64, 96, 128, 192)
BWD_BF16_HEAD_DIMS = (32, 64, 96, 128, 192)
STAGES = (1, 2, 3, 4)
# each build's launch point, for launch parameters left None
FWD_LAUNCH = {
    torch.bfloat16: {"block_q": 128, "block_k": 64, "block_threads": 128,
                     "stages": 2},
    torch.float32: {"block_q": 64, "block_k": 64, "block_threads": 256,
                    "stages": 1},
}
BWD_LAUNCH = {
    torch.bfloat16: {"block_q": 128, "block_k": 128, "block_threads": 256},
    torch.float32: {"block_q": 32, "block_k": 64, "block_threads": 256},
}

_lib: ctypes.CDLL | None = None
_lib_bwd: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for suffix, n_int in (("f32", 10), ("bf16", 11)):
            fn = getattr(lib, f"flash_attention_fwd_{suffix}")
            fn.argtypes = [ptr] * 6 + [i32] * n_int + [ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _library_bwd() -> ctypes.CDLL:
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load_library("flash_attention_bwd")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for suffix in DTYPES.values():
            getattr(lib, f"flash_attention_bwd_dq_{suffix}").argtypes = (
                [ptr] * 8 + [i32] * 10 + [ctypes.c_float, ptr])
            getattr(lib, f"flash_attention_bwd_dkv_{suffix}").argtypes = (
                [ptr] * 9 + [i32] * 10 + [ctypes.c_float, ptr])
            for prog in ("dq", "dkv"):
                getattr(lib, f"flash_attention_bwd_{prog}_{suffix}"
                        ).restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def smem_bytes(block_q: int, block_k: int, hd: int,
               dtype: torch.dtype = torch.float32, stages: int = 2) -> int:
    """Shared memory one block of the forward kernel's ``dtype`` build asks
    for.

    float32 (``smem_floats_f32``): transposed q and k tiles, the v tile, the
    scores, the output accumulator and three per-row carries, all float32,
    rows padded by one word.  bfloat16 (``smem_bytes_bf16``): the q tile
    and the ring's ``stages`` slots, each a k and a v tile of ``block_k``
    rows, bf16 at a pitch of ``hd + 8`` (the scores and the accumulator
    live in registers).
    """
    bq, bk = block_q, block_k
    if dtype == torch.bfloat16:
        return (bq + stages * 2 * bk) * (hd + 8) * 2
    return 4 * (hd * (bq + 1) + hd * (bk + 1) + bk * hd + bq * (bk + 1)
                + bq * (hd + 1) + 3 * bq)


def smem_bytes_bwd(block_q: int, block_k: int, hd: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one block of the larger backward program asks for.

    float32 (``smem_floats_dq``/``smem_floats_dkv``): dq, q (scaled) and do
    transposed, k and v transposed, ds, the dq accumulator, lse and delta;
    dk/dv, k, v, q and do transposed, p and ds, both accumulators, lse and
    delta; transposed rows padded by one word.  bfloat16
    (``smem_bytes_dq_bf16``/``smem_bytes_dkv_bf16``; the fragments and
    accumulators live in registers): dq, a two-slot ring of k and v tiles
    (above hd 128 also the block's do rows); dk/dv, the block's v tile and
    a two-slot ring of q and do tiles with their rows' lse and delta; bf16
    rows at a pitch of ``hd + 8``.
    """
    bq, bk = block_q, block_k
    if dtype == torch.bfloat16:
        ld = hd + 8
        dq = 2 * 2 * bk * ld * 2
        dkv = bk * ld * 2 + 2 * (2 * bq * ld * 2 + 2 * bq * 4)
        if hd > MAX_HD_TWO_TILES:
            dq += bq * ld * 2        # the block's do rows
        return max(dq, dkv)
    dq = 2 * hd * (bq + 1) + 2 * hd * (bk + 1) + bq * (bk + 1) + bq * hd + 2 * bq
    dkv = (2 * hd * (bk + 1) + 2 * hd * (bq + 1) + 2 * bq * (bk + 1)
           + 2 * bk * hd + 2 * bq)
    return 4 * max(dq, dkv)


def fit_bwd_launch(dtype: torch.dtype, hd: int) -> dict:
    """The backward's launch point for ``dtype`` at ``hd``: ``BWD_LAUNCH``,
    the bfloat16 blocks halved while their tiles pass the card's shared
    memory (hd 192: 64 x 64 at 128 threads); the other head_dims keep it."""
    p = dict(BWD_LAUNCH.get(dtype, BWD_LAUNCH[torch.float32]))
    while (dtype == torch.bfloat16 and p["block_q"] > 16
           and smem_bytes_bwd(p["block_q"], p["block_k"], hd, dtype)
           > SMEM_LIMIT_BYTES):
        p = {k: v // 2 for k, v in p.items()}
    return p


def _check_tensors(q, k, v) -> None:
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


def _check_launch(block_q: int, block_k: int, block_threads: int,
                  max_threads: int) -> None:
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk < 4 or blk % 4:
            raise ValueError(f"{name}={blk} must be a positive multiple of 4")
    if not 32 <= block_threads <= max_threads or block_threads % 32:
        raise ValueError("block_threads must be a multiple of 32 in "
                         f"[32, {max_threads}], got {block_threads}")


def _check_bf16_launch(hd: int, block_q: int, block_k: int,
                       block_threads: int, head_dims: tuple,
                       two_tiles: bool = False) -> None:
    """What a bfloat16 (tensor-core) build takes: a template for ``hd``,
    blocks of the mma's 16 rows, and a warp per 16 rows (the forward, with
    ``two_tiles``: or per 32, up to hd 128)."""
    if hd not in head_dims:
        raise ValueError(f"bfloat16: head_dim {hd} is not built (the "
                         f"templates are {head_dims})")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk < 16 or blk % 16:
            raise ValueError(f"bfloat16: {name}={blk} must be a positive "
                             "multiple of 16")
    allowed = [2 * block_q]
    if two_tiles and hd <= MAX_HD_TWO_TILES:
        allowed.append(block_q)
    if block_threads not in allowed or block_threads > MMA_MAX_THREADS:
        rule = ("2 * block_q or block_q (a warp per 16 or 32 rows)"
                if len(allowed) == 2 else "2 * block_q (a warp per 16 rows)")
        raise ValueError(f"bfloat16: block_threads={block_threads} must be "
                         f"{rule} and at most {MMA_MAX_THREADS}")


def _launch(table: dict, q, **given) -> dict:
    """The launch point of ``q``'s build with the given (not None) values
    put in; a bfloat16 block's threads follow from its rows unless given.
    (A ``q`` of no build gets float32's; ``_check_tensors`` refuses it.)"""
    dtype = getattr(q, "dtype", None)
    if dtype not in table:
        dtype = torch.float32
    out = dict(table[dtype])
    out.update({k: int(v) for k, v in given.items() if v is not None})
    if (dtype == torch.bfloat16 and given.get("block_threads") is None
            and given.get("block_q") is not None):
        out["block_threads"] = 2 * out["block_q"]
    return out


def _check(q, k, v, block_q: int, block_k: int, block_threads: int,
           stages: int) -> None:
    _check_tensors(q, k, v)
    hd = q.shape[-1]
    if q.dtype == torch.bfloat16:
        _check_bf16_launch(hd, block_q, block_k, block_threads,
                           BF16_HEAD_DIMS, two_tiles=True)
        if stages not in STAGES:
            raise ValueError(f"bfloat16: stages={stages} not in {STAGES}")
    else:
        _check_launch(block_q, block_k, block_threads, 1024)
        if stages != 1:
            raise ValueError(f"float32: stages={stages}; the float32 build "
                             "stages its tiles synchronously (stages=1)")
    need = smem_bytes(block_q, block_k, hd, q.dtype, stages)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"block_q={block_q}, block_k={block_k}, hd={hd}, "
                         f"stages={stages} need {need} bytes of shared "
                         f"memory (limit {SMEM_LIMIT_BYTES})")


def _check_aligned(*tensors) -> None:
    """The bfloat16 kernels move rows in 16-byte copies."""
    for x in tensors:
        if x.data_ptr() % 16 or any(x.stride(i) % 8 for i in range(3)):
            raise ValueError("bfloat16: q, k, v, o, do and the gradients "
                             "need strides that are multiples of 8 and "
                             "16-byte aligned storage")


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
                        block_q: int | None = None,
                        block_k: int | None = None,
                        block_threads: int | None = None,
                        stages: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Tq, H, hd); k, v: (B, Tk, H, hd), kv heads already repeated.

    Returns ``o`` (B, Tq, H, hd) in q's dtype and ``lse`` (B, H, Tq)
    float32.  Neither ``Tq`` nor ``Tk`` needs to be a multiple of a block:
    the kernel masks the ragged edge.  Launch parameters left ``None``
    take the build's (``FWD_LAUNCH``).
    """
    p = _launch(FWD_LAUNCH, q, block_q=block_q, block_k=block_k,
                block_threads=block_threads, stages=stages)
    block_q, block_k = p["block_q"], p["block_k"]
    block_threads, stages = p["block_threads"], p["stages"]
    q_offset = int(q_offset)
    _check(q, k, v, block_q, block_k, block_threads, stages)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         q_offset=q_offset)
    b, tq, h, hd = q.shape
    o = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        CENSUS.add("flash_attention_fwd", ("fwd",),
                   4 * b * h * hd * causal_pairs(tq, k.shape[1], causal,
                                                 q_offset),
                   q.element_size() * (2 * q.numel() + k.numel()
                                       + v.numel()) + 4 * b * h * tq)
        return o, lse
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_aligned(q, k, v, o)
    strides = (ctypes.c_int64 * 12)(*(x.stride(i) for x in (q, k, v, o)
                                      for i in range(3)))
    lib = _library()
    fn = getattr(lib, f"flash_attention_fwd_{DTYPES[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), ctypes.addressof(strides), b, h, tq,
                k.shape[1], hd, block_q, block_k, block_threads,
                *((stages,) if bf16 else ()), int(causal), q_offset,
                hd ** -0.5, stream)
    if rc != 0:
        raise KernelLaunchError(
            f"flash_attention_fwd(block_q={block_q}, block_k={block_k}, "
            f"block_threads={block_threads}, stages={stages}): launch "
            f"refused ({rc}: {lib.flash_attention_error_string(rc).decode()})")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


# -- backward ---------------------------------------------------------------------

def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in float32 from the inputs' dtype, as (B, H, Tq)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _check_bwd(q, k, v, o, lse, do, block_q: int, block_k: int,
               block_threads: int) -> None:
    _check_tensors(q, k, v)
    b, tq, h, hd = q.shape
    for name, x in (("o", o), ("do", do)):
        if not isinstance(x, torch.Tensor) or x.shape != q.shape \
                or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be like q: {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
        if hd > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along hd")
    if not isinstance(lse, torch.Tensor) or lse.shape != (b, h, tq) \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be ({b}, {h}, {tq}) float32 on "
                         f"{q.device}, as flash_attention_fwd returns it")
    if q.dtype == torch.bfloat16:
        _check_bf16_launch(hd, block_q, block_k, block_threads,
                           BWD_BF16_HEAD_DIMS)
        if block_k != block_q:
            raise ValueError(f"bfloat16 backward: block_k={block_k} must "
                             f"equal block_q={block_q} (a warp per 16 "
                             "query rows in dq, per 16 keys in dk/dv)")
    else:
        _check_launch(block_q, block_k, block_threads, MAX_BWD_THREADS)
    need = smem_bytes_bwd(block_q, block_k, hd, q.dtype)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"backward: block_q={block_q}, block_k={block_k}, "
                         f"hd={hd} need {need} bytes of shared memory (limit "
                         f"{SMEM_LIMIT_BYTES})")


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              q_offset: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of :func:`flash_attention_bwd`: the same float32
    arithmetic with the whole ``(B, H, Tq, Tk)`` score tensor materialised."""
    tq, hd = q.shape[1], q.shape[-1]
    tk = k.shape[1]
    scale = hd ** -0.5
    qs, kf, vf, dof = q.float() * scale, k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    p = torch.exp(s - lse[..., None])
    del s
    if causal:
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = torch.arange(tk, device=q.device)
        p = p.masked_fill(qpos[:, None] < kpos[None, :], 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p.mul_(ds.sub_(_delta(o, do)[..., None]))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        q_offset: int = 0, block_q: int | None = None,
                        block_k: int | None = None,
                        block_threads: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``o = attention(q, k, v)`` for the cotangent ``do``.

    q, o, do: (B, Tq, H, hd); k, v: (B, Tk, H, hd), kv heads already
    repeated; ``lse`` (B, H, Tq) float32 as :func:`flash_attention_fwd`
    returns it.  Returns dq, dk, dv in the inputs' dtype, each written by
    exactly one block (no atomics: the same inputs give the same bits).
    Launch parameters left ``None`` take the build's (``BWD_LAUNCH``, cut
    to the card's shared memory at hd 192: ``fit_bwd_launch``).
    """
    hd = q.shape[-1] if isinstance(q, torch.Tensor) else 0
    p = _launch({dt: fit_bwd_launch(dt, hd) for dt in BWD_LAUNCH}, q,
                block_q=block_q, block_k=block_k,
                block_threads=block_threads)
    block_q, block_k, block_threads = (p["block_q"], p["block_k"],
                                       p["block_threads"])
    q_offset = int(q_offset)
    _check_bwd(q, k, v, o, lse, do, block_q, block_k, block_threads)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         q_offset=q_offset)
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    delta = _delta(o, do)
    lse = lse.contiguous()
    dq = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, tk, h, hd), dtype=v.dtype, device=q.device)
    if q.device.type == "meta":
        CENSUS.add("flash_attention_bwd", ("dq", "dkv"),
                   10 * b * h * hd * causal_pairs(tq, tk, causal, q_offset),
                   q.element_size() * 4 * (q.numel() + k.numel())
                   + 4 * b * h * tq)
        return dq, dk, dv
    strides = (ctypes.c_int64 * 21)(*(x.stride(i)
                                      for x in (q, k, v, do, dq, dk, dv)
                                      for i in range(3)))
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v, do, dq, dk, dv)
    lib = _library_bwd()
    suffix = DTYPES[q.dtype]
    tail = (ctypes.addressof(strides), b, h, tq, tk, hd, block_q, block_k,
            block_threads, int(causal), q_offset, hd ** -0.5)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for prog, outs in (("dq", (dq,)), ("dkv", (dk, dv))):
            fn = getattr(lib, f"flash_attention_bwd_{prog}_{suffix}")
            rc = fn(*inputs, *(x.data_ptr() for x in outs), *tail, stream)
            if rc != 0:
                raise KernelLaunchError(
                    f"flash_attention_bwd {prog} (block_q={block_q}, "
                    f"block_k={block_k}, block_threads={block_threads}): "
                    f"launch refused ({rc}: "
                    f"{lib.flash_attention_bwd_error_string(rc).decode()})")
            flash_attention_bwd.program_launches[prog] += 1
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.program_launches = {"dq": 0, "dkv": 0}
