"""RWKV-6 wkv recurrence: the CUDA kernels' wrappers and their plain versions.

``wkv6_fwd`` replaces the Pallas kernel ``wkv6_kernel``
(``repro/kernels/rwkv6_wkv/kernel.py``: ``_serial_kernel`` and
``_chunked_kernel``).  Per (batch, head) it carries an (hd x hd) float32
state S through the tokens:

    y_t = r_t (S + diag(u) k_t v_t^T),    S <- diag(w_t) S + k_t v_t^T

It has two routes, picked from T and hd (``route_of``):

* ``"serial"`` (decode, T = 1; any T shorter than a chunk; a head size the
  chunked route is not built for): a token loop with the state in
  registers, at its own launch point (``SERIAL_LAUNCH``);
* ``"chunked"`` (prefill, training): two programs, ``states`` (the state
  entering every chunk of ``chunk`` tokens, a thread carrying ``cols``
  value columns of one row: the program the backward's ``scans`` runs in
  both directions) and ``chunks`` (the serial program over every chunk at
  once, a block ``block_h`` heads of one chunk with ``split`` threads
  sharing a state column's rows, walking its chunk's tokens from the
  chunk's entry state),
  every decay factor a product of w's, so any w in [0, 1] gives finite
  results.

The kernels are CUDA C++ in ``kernels/csrc/rwkv6_wkv.cu`` (and
``wkv_chunk_scan.cuh``), compiled at first use and bound with ``ctypes``;
they compute in float32 on the CUDA cores.  T need not divide into
chunks: the ragged edge is masked (tokens past T count as r = k = v = 0,
w = 1, which leave the state as it is) where the reference clamps its
chunk to a divisor of T.

The wrapper launches the kernels for a CUDA tensor, or raises; it takes
the plain version ``wkv6_fwd_plain`` (the serial recurrence, the oracle)
only for tensors on the CPU.  ``wkv6_fwd_chunked_plain`` computes the
chunked route's formulation in PyTorch.  Launches are counted in
``wkv6_fwd.launches`` (calls) and ``wkv6_fwd.program_launches`` (each
program: ``serial``, ``states``, ``chunks``).

``wkv6_bwd`` replaces the Pallas backward ``wkv6_bwd`` (the spans pre-pass
and the reverse sweep).  Its kernel is CUDA C++ in
``kernels/csrc/rwkv6_wkv_bwd.cu``, a chunked form stable for every decay in
[0, 1], two programs: ``scans`` stores the state entering and the adjoint
leaving every chunk of ``chunk`` tokens (a thread carries ``cols`` value
columns of one row), ``chunks`` computes every chunk's gradients at once
from them, one block a (batch, head, chunk), every decay factor a product
of w's.  ``du`` comes back as per-(batch, head, chunk) partials that the
wrapper sums.  ``wkv6_bwd_plain`` (the oracle, the CPU branch) is the
serial reverse recurrence; ``wkv6_bwd_chunked_plain`` computes the
kernel's chunked form in PyTorch.  Launches are counted in
``wkv6_bwd.launches`` (calls) and ``wkv6_bwd.program_launches`` (each
program).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import SMEM_LIMIT_BYTES, KernelLaunchError

__all__ = ["BLOCK_H", "BWD_CHUNKS", "BWD_COLS", "BWD_HEAD_DIMS",
           "BWD_MAX_THREADS", "BWD_PARTS", "CHUNKED_HEAD_DIMS", "CHUNKS",
           "CHUNKS_STAGE", "COLS", "SERIAL_LAUNCH", "SERIAL_MAX_THREADS", "SPLITS",
           "SERIAL_ROWS", "launch_error", "route_of", "serial_launch",
           "serial_tile", "smem_bytes", "smem_bytes_bwd",
           "smem_bytes_states", "wkv6_bwd", "wkv6_bwd_chunked_plain",
           "wkv6_bwd_plain", "wkv6_fwd", "wkv6_fwd_chunked_plain",
           "wkv6_fwd_plain"]

SERIAL_MAX_THREADS = 512
# state rows a serial thread holds in registers (the kernel's templates;
# 12, 24 and 48 serve head size 48)
SERIAL_ROWS = (4, 8, 12, 16, 24, 32, 48, 64)
# the serial route's own launch point: one head a block, four threads a
# state column's rows (fitted to the head size and H by ``serial_launch``)
SERIAL_LAUNCH = {"chunk": 32, "block_h": 1, "split": 4}

# the chunked route: head sizes the states program is built for, chunk
# lengths, value columns a states thread carries, heads a chunk-program
# block walks and threads a state column there (the serial program's
# layout), and the tokens the chunk program stages in shared memory at a
# time (the kernel's CHUNKS_STAGE)
CHUNKED_HEAD_DIMS = (16, 32, 48, 64)
CHUNKS = (16, 32, 64, 128, 256)
COLS = (4, 8, 16, 32)
BLOCK_H = (1, 2, 4)
SPLITS = (1, 2, 4, 8)
CHUNKS_STAGE = 32

# the backward kernel's builds: head sizes, chunk lengths (templates),
# value columns a scan thread carries, warps 32 channels' in-chunk pair sum
# is split over, and the chunk program's block size
BWD_HEAD_DIMS = CHUNKED_HEAD_DIMS
BWD_CHUNKS = (8, 16, 32, 64)
BWD_COLS = COLS
BWD_PARTS = (1, 2, 3, 4)
BWD_MAX_THREADS = 512

_lib: ctypes.CDLL | None = None
_lib_bwd: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("rwkv6_wkv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_wkv_fwd_serial.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        lib.rwkv6_wkv_fwd_serial.restype = ctypes.c_int
        lib.rwkv6_wkv_fwd_states.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.rwkv6_wkv_fwd_states.restype = ctypes.c_int
        lib.rwkv6_wkv_fwd_chunks.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.rwkv6_wkv_fwd_chunks.restype = ctypes.c_int
        lib.rwkv6_wkv_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_wkv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _library_bwd() -> ctypes.CDLL:
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load_library("rwkv6_wkv_bwd")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_wkv_bwd_scans.argtypes = [ptr] * 10 + [i32] * 8 + [ptr]
        lib.rwkv6_wkv_bwd_scans.restype = ctypes.c_int
        lib.rwkv6_wkv_bwd_chunks.argtypes = [ptr] * 13 + [i32] * 8 + [ptr]
        lib.rwkv6_wkv_bwd_chunks.restype = ctypes.c_int
        lib.rwkv6_wkv_bwd_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_wkv_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def route_of(t: int, hd: int, chunk: int) -> str:
    """The forward's route: ``"chunked"`` where the head size is built for
    it and T fills a chunk, ``"serial"`` otherwise (decode steps)."""
    return "chunked" if hd in CHUNKED_HEAD_DIMS and t >= chunk else "serial"


def smem_bytes(chunk: int, block_h: int, hd: int) -> int:
    """Shared memory one block of the serial program asks for (the
    kernel's ``serial_smem_floats``): r, k, v, w of ``chunk`` tokens, the
    bonus sums, u."""
    return 4 * (4 * chunk * block_h * hd + chunk * block_h + block_h * hd)


def smem_bytes_states(chunk: int, hd: int) -> int:
    """The states (and the backward's scans) program's block
    (``scan_smem_floats``): two buffers of three (chunk, hd) tiles, the
    state on its way out (hd, hd + 4)."""
    return 4 * (6 * chunk * hd + hd * (hd + 4))


def serial_tile(hd: int, split: int, block_h: int
                ) -> tuple[int, int] | None:
    """The serial program's column tile and block size at (hd, split,
    block_h) (the kernel's ``serial_tile``): the widest of 4, 2, 1 columns a
    thread that keeps ROWS x JC <= 64 registers of state (ROWS = hd /
    split, one of ``SERIAL_ROWS``) and gives a block a whole number of
    warps up to 512 threads, with the block's threads; None when none
    does."""
    if split < 1 or split & (split - 1) or hd % split \
            or hd // split not in SERIAL_ROWS:
        return None
    for jc in (4, 2, 1):
        if hd // split * jc > 64 or hd % jc:
            continue
        threads = block_h * (hd // jc) * split
        if threads % 32 == 0 and threads <= SERIAL_MAX_THREADS:
            return jc, threads
    return None


def serial_launch(hd: int, h: int) -> dict:
    """``SERIAL_LAUNCH`` fitted to the head size and head count: the first
    (split, block_h) from it that the kernel takes (block_h dividing H), as
    the reference clamps its blocks to what the shape allows."""
    for split in (SERIAL_LAUNCH["split"], 2, 8, 1, 16):
        for block_h in (SERIAL_LAUNCH["block_h"], 2, 4, 8):
            if h % block_h == 0 and serial_tile(hd, split, block_h):
                return {**SERIAL_LAUNCH, "split": split, "block_h": block_h}
    return dict(SERIAL_LAUNCH)


def _check_operands(r, k, v, w, u, s0) -> None:
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, hd), got {tuple(r.shape)}")
    b, t, h, hd = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} is {tuple(x.shape)}, r {tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"u must be (H, hd) = ({h}, {hd}), got "
                         f"{tuple(u.shape)}")
    if s0.shape != (b, h, hd, hd):
        raise ValueError(f"s0 must be (B, H, hd, hd) = ({b}, {h}, {hd}, "
                         f"{hd}), got {tuple(s0.shape)}")


def launch_error(t: int, h: int, hd: int, chunk: int, split: int, cols: int,
                 block_h: int) -> str | None:
    """Why the forward cannot launch these parameters at (T, H, hd), or
    None: the chunked route's builds, block shape and shared memory, or, on
    the serial route, its own launch point."""
    if chunk not in CHUNKS:
        return f"chunk={chunk} not built ({CHUNKS})"
    if split not in SPLITS:
        return f"split={split} not in {SPLITS}"
    if cols not in COLS:
        return f"cols={cols} not in {COLS}"
    if block_h not in BLOCK_H:
        return f"block_h={block_h} not in {BLOCK_H}"
    if route_of(t, hd, chunk) == "chunked":
        if hd % cols:
            return f"cols={cols} does not divide hd={hd}"
        if h % block_h:
            return f"block_h={block_h} must divide H={h}"
        if serial_tile(hd, split, block_h) is None:
            return (f"block_h={block_h}, hd={hd}, split={split}: no column "
                    f"tile gives whole warps up to {SERIAL_MAX_THREADS} "
                    f"threads with hd / split in {SERIAL_ROWS}")
        need = max(smem_bytes_states(chunk, hd),
                   smem_bytes(min(chunk, CHUNKS_STAGE), block_h, hd))
    else:
        launch = serial_launch(hd, h)
        if serial_tile(hd, launch["split"], launch["block_h"]) is None:
            return (f"hd={hd}, H={h}: the serial program has no split and "
                    f"block_h it takes (hd / split in {SERIAL_ROWS})")
        need = smem_bytes(launch["chunk"], launch["block_h"], hd)
    if need > SMEM_LIMIT_BYTES:
        return (f"chunk={chunk} at hd={hd} needs {need} bytes of shared "
                f"memory (limit {SMEM_LIMIT_BYTES})")
    return None


def wkv6_fwd_plain(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels, the oracle: the serial recurrence in
    the operands' dtype, with the state as a Python loop's carry."""
    ys, s = [], s0
    for i in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, i], k[:, i], v[:, i], w[:, i]
        kv = k_t[..., :, None] * v_t[..., None, :]
        bonus = (r_t * u * k_t).sum(-1, keepdim=True) * v_t
        ys.append((r_t[..., None, :] @ s)[..., 0, :] + bonus)
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_fwd_chunked_plain(r, k, v, w, u, s0, *, chunk: int = 32
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked route's formulation in plain PyTorch (for the tests and
    ``chip_smoke.py``; the wrapper's CPU branch takes
    :func:`wkv6_fwd_plain`): the state entering every chunk, one product a
    chunk with every decay factor a product of w's (program ``states``),
    then every chunk at once stepped token by token from its entry state
    (program ``chunks``), as ``kernels/csrc/rwkv6_wkv.cu`` computes them.
    Tokens past T count as r = k = v = 0, w = 1."""
    b, t, h, hd = r.shape
    n = -(-t // chunk)
    pad = n * chunk - t

    def chunks(x, fill):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=fill)
        return x.view(b, n, chunk, h, hd).permute(0, 3, 1, 2, 4)

    rr, kk, vv = (chunks(x, 0.0) for x in (r, k, v))
    ww = chunks(w, 1.0)                                # (b, h, n, chunk, hd)
    ones = torch.ones_like(ww[..., :1, :])
    suf = torch.cumprod(torch.cat([ones, ww.flip(-2)[..., :-1, :]], -2),
                        -2).flip(-2)                   # prod_{s>t} w_s
    whole = suf[..., 0, :] * ww[..., 0, :]             # the chunk's product
    local = torch.einsum("bhnti,bhntj->bhnij", suf * kk, vv)
    s, entry = s0, []
    for c in range(n):                                 # program "states"
        entry.append(s)
        s = whole[:, :, c, :, None] * s + local[:, :, c]
    st, ys = torch.stack(entry, 2), []                 # (b, h, n, hd, hd)
    uu = u[None, :, None, :]
    for i in range(chunk):                             # program "chunks"
        r_t, k_t, v_t = rr[..., i, :], kk[..., i, :], vv[..., i, :]
        bonus = (r_t * uu * k_t).sum(-1, keepdim=True) * v_t
        ys.append((r_t[..., None, :] @ st)[..., 0, :] + bonus)
        st = ww[..., i, :, None] * st + k_t[..., :, None] * v_t[..., None, :]
    y = torch.stack(ys, 3)                             # (b, h, n, chunk, hd)
    return y.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, hd)[:, :t], s


def _raise_if(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{what}: launch refused ({rc}: "
                                f"{lib.rwkv6_wkv_error_string(rc).decode()})")


def wkv6_fwd(r, k, v, w, u, s0, *, chunk: int = 64, split: int = 4,
             cols: int = 16, block_h: int = 1
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels: r, k, v, w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd),
    all float32 -> (y (B, T, H, hd), s_T (B, H, hd, hd)) float32.  The
    route is ``route_of(T, hd, chunk)``; the serial route runs at
    ``SERIAL_LAUNCH`` whatever the chunked route's parameters."""
    chunk, split = int(chunk), int(split)
    cols, block_h = int(cols), int(block_h)
    _check_operands(r, k, v, w, u, s0)
    b, t, h, hd = r.shape
    err = launch_error(t, h, hd, chunk, split, cols, block_h)
    if err:
        raise ValueError(err)
    if r.device.type == "cpu":
        return wkv6_fwd_plain(r, k, v, w, u, s0)
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    lib = _library()
    ptrs = [x.data_ptr() for x in (r, k, v, w, u)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route_of(t, hd, chunk) == "serial":
            sl = serial_launch(hd, h)
            rc = lib.rwkv6_wkv_fwd_serial(
                *ptrs, s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t, h,
                hd, sl["chunk"], sl["block_h"], sl["split"], stream)
            _raise_if(rc, lib, f"rwkv6_wkv serial ({sl})")
            wkv6_fwd.program_launches["serial"] += 1
        else:
            n = -(-t // chunk)
            states = torch.empty((b, h, n, hd, hd), dtype=torch.float32,
                                 device=r.device)
            rc = lib.rwkv6_wkv_fwd_states(
                k.data_ptr(), v.data_ptr(), w.data_ptr(), s0.data_ptr(),
                states.data_ptr(), s_out.data_ptr(), b, t, h, hd, chunk, cols,
                stream)
            _raise_if(rc, lib, f"rwkv6_wkv states (chunk={chunk}, "
                               f"cols={cols})")
            wkv6_fwd.program_launches["states"] += 1
            rc = lib.rwkv6_wkv_fwd_chunks(
                *ptrs, states.data_ptr(), y.data_ptr(), b, t, h, hd, chunk,
                block_h, split, stream)
            _raise_if(rc, lib, f"rwkv6_wkv chunks (chunk={chunk}, "
                               f"block_h={block_h}, split={split})")
            wkv6_fwd.program_launches["chunks"] += 1
    wkv6_fwd.launches += 1
    return y, s_out


wkv6_fwd.launches = 0
wkv6_fwd.program_launches = {"serial": 0, "states": 0, "chunks": 0}


# -- backward ---------------------------------------------------------------------

def smem_bytes_bwd(chunk: int, hd: int) -> int:
    """Shared memory one block of the backward's chunk program asks for
    (the kernel's ``chunks_smem_floats``): ten (chunk, hd + 4) tiles (r, k,
    v, w, dy, the prefix and suffix decay products, their suffix product
    times k, S0 dy, G v), S0 and G (hd, hd + 4; dw's two scanned terms
    reuse S0's, or take two tiles of their own when 2 chunk > hd), M and Q
    (chunk, chunk + 4), u, rowsum(G * S0) and the per-token bonus sums."""
    pitch = hd + 4
    return 4 * (10 * chunk * pitch + 2 * hd * pitch
                + (2 * chunk * pitch if 2 * chunk > hd else 0)
                + 2 * chunk * (chunk + 4) + 2 * hd + chunk)


def _check_bwd(r, k, v, w, u, s0, dy, ds_t, chunk: int, block_threads: int,
               cols: int, parts: int) -> None:
    _check_operands(r, k, v, w, u, s0)
    for name, x, like in (("dy", dy, r), ("ds_t", ds_t, s0)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.shape != like.shape or x.device != r.device:
            raise ValueError(f"{name} must be float32 {tuple(like.shape)} on "
                             f"{r.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hd = r.shape[3]
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"backward: hd={hd} not built ({BWD_HEAD_DIMS})")
    if chunk not in BWD_CHUNKS:
        raise ValueError(f"backward: chunk={chunk} not built ({BWD_CHUNKS})")
    if block_threads % 32 or not 32 <= block_threads <= BWD_MAX_THREADS:
        raise ValueError(f"backward: block_threads={block_threads} must be a "
                         f"multiple of 32 up to {BWD_MAX_THREADS}")
    if cols not in BWD_COLS or hd % cols:
        raise ValueError(f"backward: cols={cols} not in {BWD_COLS} or does "
                         f"not divide hd={hd}")
    if parts not in BWD_PARTS:
        raise ValueError(f"backward: parts={parts} not in {BWD_PARTS}")
    need = smem_bytes_bwd(chunk, hd)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"backward: chunk={chunk} at hd={hd} needs {need} "
                         f"bytes of shared memory (limit {SMEM_LIMIT_BYTES})")


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds_t, *, span: int = 32):
    """Plain version of :func:`wkv6_bwd`, the oracle: the serial reverse
    recurrence in the operands' dtype (float32, or float64 for a reference
    pass), token by token, with ``S_{t-1}`` recomputed from the state
    entering each span of ``span`` tokens (so memory stays at one span's
    states) and the adjoint ``G`` carried as a Python loop's carry."""
    t = r.shape[1]

    def step(s, i):
        return w[:, i, ..., None] * s + k[:, i, ..., None] * v[:, i, :, None, :]

    starts = []
    s = s0
    for i in range(t):
        if i % span == 0:
            starts.append(s)
        s = step(s, i)
    g = ds_t.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(r[:, 0])
    for j in reversed(range(len(starts))):
        s, ss = starts[j], []
        for i in range(j * span, min((j + 1) * span, t)):
            ss.append(s)
            s = step(s, i)
        for i in reversed(range(j * span, min((j + 1) * span, t))):
            sp = ss[i - j * span]
            r_t, k_t, v_t, w_t, dy_t = (m[:, i] for m in (r, k, v, w, dy))
            vdy = (v_t * dy_t).sum(-1, keepdim=True)
            dr[:, i] = (sp @ dy_t[..., None])[..., 0] + u * k_t * vdy
            du += r_t * k_t * vdy
            dk[:, i] = u * r_t * vdy + (g @ v_t[..., None])[..., 0]
            dv[:, i] = (k_t[..., None, :] @ g)[..., 0, :] \
                + (u * r_t * k_t).sum(-1, keepdim=True) * dy_t
            dw[:, i] = (g * sp).sum(-1)
            g = w_t[..., None] * g + r_t[..., None] * dy_t[..., None, :]
    return dr, dk, dv, dw, du.sum(0), g


def wkv6_bwd_chunked_plain(r, k, v, w, u, s0, dy, ds_t, *, chunk: int = 16):
    """The kernel's chunked formulation in plain PyTorch (for the tests and
    ``chip_smoke.py``; the wrapper's CPU branch takes
    :func:`wkv6_bwd_plain`): the state entering and the adjoint leaving
    every chunk by serial scans, then every chunk's gradients at once from
    them, every decay factor a running product of w's (nothing divided or
    exponentiated), as ``kernels/csrc/rwkv6_wkv_bwd.cu`` derives them.
    Tokens past T count as r = k = v = dy = 0, w = 1."""
    b, t, h, hd = r.shape
    n = -(-t // chunk)
    pad = n * chunk - t
    c_ = chunk

    def chunks(x, fill):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=fill)
        return x.view(b, n, c_, h, hd).permute(0, 3, 1, 2, 4)

    rr, kk, vv, dd = (chunks(x, 0.0) for x in (r, k, v, dy))
    ww = chunks(w, 1.0)                                # (b, h, n, chunk, hd)
    s, entry = s0, []
    for c in range(n):                                 # program "scans"
        entry.append(s)
        for i in range(c_):
            s = ww[:, :, c, i, :, None] * s \
                + kk[:, :, c, i, :, None] * vv[:, :, c, i, None, :]
    g, leave = ds_t, [None] * n
    for c in reversed(range(n)):
        leave[c] = g
        for i in reversed(range(c_)):
            g = ww[:, :, c, i, :, None] * g \
                + rr[:, :, c, i, :, None] * dd[:, :, c, i, None, :]
    s0c, gc = torch.stack(entry, 2), torch.stack(leave, 2)
    ones = torch.ones_like(ww[..., :1, :])
    pre = torch.cumprod(torch.cat([ones, ww[..., :-1, :]], -2), -2)
    suf = torch.cumprod(torch.cat([ones, ww.flip(-2)[..., :-1, :]], -2),
                        -2).flip(-2)
    x1 = torch.einsum("bhnij,bhntj->bhnti", s0c, dd)   # S0 dy_t
    x2 = torch.einsum("bhnij,bhntj->bhnti", gc, vv)    # G v_t
    x3 = torch.einsum("bhnti,bhnij->bhntj", suf * kk, gc)
    m = torch.einsum("bhnti,bhnsi->bhnts", dd, vv)     # dy_t . v_s
    vdy = m.diagonal(dim1=-2, dim2=-1)[..., None]
    uu = u[None, :, None, None, :]
    dr = pre * x1 + uu * kk * vdy
    dk = suf * x2 + uu * rr * vdy
    dv = x3 + (uu * rr * kk).sum(-1, keepdim=True) * dd
    du = (rr * kk * vdy).sum((0, 2, 3))
    coef = torch.ones_like(ww)           # c(s, s + d) = prod_{s<σ<s+d} w_σ
    for d in range(1, c_):
        cd = coef[..., :c_ - d, :]
        md = m.diagonal(offset=-d, dim1=-2, dim2=-1)[..., None]  # m[s+d][s]
        dr[..., d:, :] += cd * kk[..., :c_ - d, :] * md
        a = cd * rr[..., d:, :]
        dk[..., :c_ - d, :] += a * md
        dv[..., :c_ - d, :] += (a * kk[..., :c_ - d, :]).sum(-1, keepdim=True) \
            * dd[..., d:, :]
        coef = cd[..., :c_ - d - 1, :] * ww[..., d:c_ - 1, :]
    dw = pre * suf * (gc * s0c).sum(-1)[..., None, :]
    p = torch.zeros_like(ww[..., 0, :])
    for i in range(c_):                  # decayed prefix scan of k * (G v)
        dw[..., i, :] += suf[..., i, :] * p
        p = ww[..., i, :] * p + kk[..., i, :] * x2[..., i, :]
    p = torch.zeros_like(p)
    for i in reversed(range(c_)):        # decayed suffix scan of r * (S0 dy)
        dw[..., i, :] += pre[..., i, :] * p
        p = ww[..., i, :] * p + rr[..., i, :] * x1[..., i, :]
    y = torch.zeros_like(ww)             # the in-chunk x in-chunk term
    for i in range(c_ - 1):
        ci = torch.cumprod(torch.cat([ones, ww[..., i + 1:c_ - 1, :]], -2), -2)
        dw[..., i, :] += (ci * rr[..., i + 1:, :] * y[..., i + 1:, :]).sum(-2)
        y = ww[..., i:i + 1, :] * y + kk[..., i:i + 1, :] * m[..., :, i, None]

    def back(x):
        return x.permute(0, 2, 3, 1, 4).reshape(b, n * c_, h, hd)[:, :t]

    return back(dr), back(dk), back(dv), back(dw), du, g


def wkv6_bwd(r, k, v, w, u, s0, dy, ds_t, *, chunk: int = 16,
             block_threads: int = 512, cols: int = 16, parts: int = 4):
    """Gradients of ``(y, s_T) = wkv6_fwd(r, k, v, w, u, s0)`` for the
    cotangents ``dy`` (B, T, H, hd) and ``ds_t`` (B, H, hd, hd), all float32:
    returns (dr, dk, dv, dw, du, ds0) in the operands' shapes.  Every element
    is written by one thread and ``du``'s partials are summed here, so the
    same inputs give the same bits."""
    chunk, block_threads = int(chunk), int(block_threads)
    cols, parts = int(cols), int(parts)
    _check_bwd(r, k, v, w, u, s0, dy, ds_t, chunk, block_threads, cols, parts)
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds_t)
    b, t, h, hd = r.shape
    n = -(-t // chunk)
    states = torch.empty((b, h, n, hd, hd), dtype=torch.float32,
                         device=r.device)
    adj = torch.empty_like(states)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((b, h, n, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0)
    lib = _library_bwd()
    tail = (b, t, h, hd, chunk, block_threads, cols, parts)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        for prog in ("scans", "chunks"):
            if prog == "scans":
                rc = lib.rwkv6_wkv_bwd_scans(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    dy.data_ptr(), s0.data_ptr(), ds_t.data_ptr(),
                    states.data_ptr(), adj.data_ptr(), ds0.data_ptr(), *tail,
                    stream)
            else:
                rc = lib.rwkv6_wkv_bwd_chunks(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), dy.data_ptr(), states.data_ptr(),
                    adj.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), dw.data_ptr(), du.data_ptr(), *tail,
                    stream)
            if rc != 0:
                raise KernelLaunchError(
                    f"rwkv6_wkv_bwd {prog} (chunk={chunk}, block_threads="
                    f"{block_threads}, cols={cols}, parts={parts}): launch "
                    f"refused ({rc}: "
                    f"{lib.rwkv6_wkv_bwd_error_string(rc).decode()})")
            wkv6_bwd.program_launches[prog] += 1
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du.sum((0, 2)), ds0


wkv6_bwd.launches = 0
wkv6_bwd.program_launches = {"scans": 0, "chunks": 0}
