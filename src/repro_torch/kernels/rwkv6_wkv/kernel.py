"""RWKV-6 wkv recurrence: the CUDA kernel's wrapper and its plain version.

``wkv6_fwd`` replaces the Pallas kernel ``wkv6_kernel``
(``repro/kernels/rwkv6_wkv/kernel.py``: ``_serial_kernel`` and
``_chunked_kernel``).  Per (batch, head) it carries an (hd x hd) float32
state S through the tokens:

    y_t = r_t (S + diag(u) k_t v_t^T),    S <- diag(w_t) S + k_t v_t^T

``lanes < 2`` is the serial program: a token loop with the state in
registers, ``block_threads / (block_h * hd)`` threads per state column.
``lanes >= 2`` is the matrix form: chunks of ``chunk <= 64`` tokens, each a
masked (chunk x chunk) score product plus a product against its entry
state, the chunk summaries threaded through a ``lanes``-step combine.  The
kernel is CUDA C++ in ``kernels/csrc/rwkv6_wkv.cu``, compiled at first use
and bound with ``ctypes``; it computes in float32 on the CUDA cores.

T need not divide into chunks: the ragged edge is masked (tokens past T
count as r = k = v = 0, w = 1, which leave the state as it is) where the
reference clamps its chunk to a divisor of T.  T = 1 is a decode step.

The wrapper launches the kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version (``wkv6_fwd_plain``, which computes the same form,
serial or matrix, with the state as a Python loop's carry) only for
tensors on the CPU.  Launches are counted in ``wkv6_fwd.launches``.

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

__all__ = ["BWD_CHUNKS", "BWD_COLS", "BWD_HEAD_DIMS", "BWD_MAX_THREADS",
           "BWD_PARTS", "MATRIX_MAX_CHUNK", "MATRIX_MAX_THREADS",
           "SERIAL_MAX_THREADS", "SERIAL_ROWS", "serial_split", "smem_bytes",
           "smem_bytes_bwd", "wkv6_bwd", "wkv6_bwd_chunked_plain",
           "wkv6_bwd_plain", "wkv6_fwd", "wkv6_fwd_plain"]

SERIAL_MAX_THREADS = 512
MATRIX_MAX_THREADS = 1024
# state rows a serial thread holds in registers (the kernel's templates)
SERIAL_ROWS = (4, 8, 16, 32, 64)
# exp(-cumsum(log w)) overflows float32 past about this many tokens of small
# decays: the reference's cap on matrix-form chunks
MATRIX_MAX_CHUNK = 64

# the backward kernel's builds: head sizes, chunk lengths (templates),
# value columns a scan thread carries, warps 32 channels' in-chunk pair sum
# is split over, and the chunk program's block size
BWD_HEAD_DIMS = (16, 32, 48, 64)
BWD_CHUNKS = (8, 16, 32, 64)
BWD_COLS = (4, 8, 16, 32)
BWD_PARTS = (1, 2, 3, 4)
BWD_MAX_THREADS = 512

_lib: ctypes.CDLL | None = None
_lib_bwd: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("rwkv6_wkv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_wkv_fwd.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
        lib.rwkv6_wkv_fwd.restype = ctypes.c_int
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


def smem_bytes(chunk: int, lanes: int, block_h: int, hd: int) -> int:
    """Shared memory one block asks for (the kernel's ``*_smem_floats``)."""
    if lanes >= 2:
        floats = (4 * chunk * hd + chunk * chunk + chunk
                  + block_h * lanes * hd * hd + block_h * lanes * hd
                  + block_h * hd * hd + block_h * hd)
    else:
        floats = 4 * chunk * block_h * hd + chunk * block_h + block_h * hd
    return 4 * floats


def serial_split(hd: int, block_h: int, block_threads: int) -> int | None:
    """Threads per state column of the serial program, or None when
    ``block_threads`` gives no split the kernel is built for."""
    per = block_h * hd
    if block_threads % per:
        return None
    split = block_threads // per
    if split > 32 or split & (split - 1) or hd % split \
            or hd // split not in SERIAL_ROWS:
        return None
    return split


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


def _check(r, k, v, w, u, s0, chunk: int, lanes: int, block_h: int,
           block_threads: int) -> None:
    _check_operands(r, k, v, w, u, s0)
    h, hd = r.shape[2], r.shape[3]
    if chunk < 1 or block_h < 1 or h % block_h:
        raise ValueError(f"chunk={chunk} must be positive and block_h="
                         f"{block_h} must divide H={h}")
    if block_threads % 32 or not 32 <= block_threads <= (
            MATRIX_MAX_THREADS if lanes >= 2 else SERIAL_MAX_THREADS):
        raise ValueError(f"block_threads={block_threads} must be a multiple "
                         "of 32 up to the program's limit")
    if lanes >= 2:
        if chunk > MATRIX_MAX_CHUNK:
            raise ValueError(f"chunk={chunk} exceeds the matrix form's "
                             f"stability cap {MATRIX_MAX_CHUNK}")
    elif serial_split(hd, block_h, block_threads) is None:
        raise ValueError(
            f"block_threads={block_threads} is not block_h * hd * split "
            f"({block_h} * {hd} * split) with hd / split in {SERIAL_ROWS}")
    need = smem_bytes(chunk, lanes, block_h, hd)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"chunk={chunk}, lanes={lanes}, block_h={block_h} "
                         f"need {need} bytes of shared memory (limit "
                         f"{SMEM_LIMIT_BYTES})")


def _serial_plain(r, k, v, w, u, s):
    ys = []
    for i in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, i], k[:, i], v[:, i], w[:, i]
        kv = k_t[..., :, None] * v_t[..., None, :]
        bonus = (r_t * u * k_t).sum(-1, keepdim=True) * v_t
        ys.append((r_t[..., None, :] @ s)[..., 0, :] + bonus)
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _matrix_plain(r, k, v, w, u, s, chunk: int):
    b, t, h, hd = r.shape
    n = -(-t // chunk)
    pad = n * chunk - t

    def chunks(x, fill):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=fill)
        return x.view(b, n, chunk, h, hd)

    rr, kk, vv = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0)
    logw = torch.log(chunks(w, 1.0))
    g = torch.cumsum(logw, dim=2)                      # inclusive, in-chunk
    aa = rr * torch.exp(g - logw)                      # r * exp(g_excl)
    bb = kk * torch.exp(-g)
    scores = torch.einsum("bnthi,bnshi->bnhts", aa, bb)
    scores = torch.tril(scores, diagonal=-1)
    bonus = (rr * u * kk).sum(-1, keepdim=True) * vv
    y = torch.einsum("bnhts,bnshj->bnthj", scores, vv) + bonus
    d_tot = torch.exp(g[:, :, -1])                     # (b, n, h, hd)
    s_loc = torch.einsum("bnshi,bnshj->bnhij", bb, vv) * d_tot[..., None]
    starts = []
    for c in range(n):                                 # the combine
        starts.append(s)
        s = d_tot[:, c, ..., None] * s + s_loc[:, c]
    y = y + torch.einsum("bnthi,bnhij->bnthj", aa, torch.stack(starts, 1))
    return y.reshape(b, n * chunk, h, hd)[:, :t], s


def wkv6_fwd_plain(r, k, v, w, u, s0, *, chunk: int = 64, lanes: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the serial recurrence (``lanes < 2``)
    or the matrix form over chunks of ``chunk`` tokens (``lanes >= 2``;
    the combine runs chunk after chunk, as the kernel's lanes-step combine
    and span carry do), in float32."""
    if lanes >= 2:
        return _matrix_plain(r, k, v, w, u, s0, chunk)
    return _serial_plain(r, k, v, w, u, s0)


def wkv6_fwd(r, k, v, w, u, s0, *, chunk: int = 64, lanes: int = 0,
             block_h: int = 1, block_threads: int = 64
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: r, k, v, w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd),
    all float32 -> (y (B, T, H, hd), s_T (B, H, hd, hd)) float32."""
    chunk, lanes, block_h = int(chunk), int(lanes), int(block_h)
    block_threads = int(block_threads)
    _check(r, k, v, w, u, s0, chunk, lanes, block_h, block_threads)
    if r.device.type == "cpu":
        return wkv6_fwd_plain(r, k, v, w, u, s0, chunk=chunk, lanes=lanes)
    b, t, h, hd = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    lib = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rwkv6_wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t,
            h, hd, chunk, lanes, block_h, block_threads, stream)
    if rc != 0:
        raise KernelLaunchError(
            f"rwkv6_wkv(chunk={chunk}, lanes={lanes}, block_h={block_h}, "
            f"block_threads={block_threads}): launch refused ({rc}: "
            f"{lib.rwkv6_wkv_error_string(rc).decode()})")
    wkv6_fwd.launches += 1
    return y, s_out


wkv6_fwd.launches = 0


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
