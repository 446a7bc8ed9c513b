"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain version.

``selective_scan_fwd`` replaces the Pallas kernel ``selective_scan_kernel``
(``repro/kernels/mamba_scan/kernel.py``: ``_serial_kernel`` and
``_chunked_kernel``).  Per (batch, channel) it carries an S-entry float32
state through the tokens:

    h_t = exp(delta_t A) h_{t-1} + (delta_t x_t) B_t,   y_t = C_t . h_t + D x_t

The kernel is CUDA C++ in ``kernels/csrc/mamba_scan.cu``, compiled at
first use and bound with ``ctypes``; it computes in float32 on the CUDA
cores.  ``split`` adjacent threads share a channel, each carrying S /
split state entries; a block of ``block_d`` channels stages its x, delta,
B and C in a ring of two chunks of ``chunk`` tokens by cp.async; a
thread takes ``token_group(split)`` tokens at once; each lane sums its
entries of y_t in order and the ``split`` parts are folded by halves (a
butterfly reduce-scatter once every ``split`` tokens).  T need not divide
into chunks: the ragged edge is masked where the reference clamps its
chunk to a divisor of T.  The reference's ``lanes`` switch (its chunked
form, two exps a cell) has no counterpart here.

The wrapper launches the kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version (``selective_scan_fwd_plain``: the serial recurrence
with the state as a Python loop's carry, never a (B, T, dI, S) tensor)
only for tensors on the CPU.  With ``split`` given, the plain version
takes y_t's sum as the kernel takes it (the tests hold that form against
the reference beside the wrapper; the CPU branch stays the oracle, whose
order the reference's training tests were set against).  Launches are
counted in ``selective_scan_fwd.launches``.

``selective_scan_bwd`` replaces the Pallas backward ``selective_scan_bwd``
(the spans pre-pass and the reverse sweep).  Its kernel is CUDA C++ in
``kernels/csrc/mamba_scan_bwd.cu``, a chunk-parallel form over chunks of
``chunk`` tokens grouped in spans of ``span`` chunks, in three programs:
``summaries`` (per chunk and (batch, channel, state entry) the decay
product and the local state from zero; per span those and the local
adjoint from zero), ``carry`` (the state entering and the adjoint leaving
every span) and ``chunks`` (a block a span: its chunks' entry states, then
the chunks last to first, each chunk's forward recomputed from its entry
state and walked back with the adjoint carried from chunk to chunk; two
exps a cell in all), ``split`` threads a channel in both.  Only
products of decays appear, so an ``exp(delta A)`` that underflows to 0
gives finite gradients.  The reduced operands (A, B, C, D) come back as
partials that the wrapper sums, as the reference does.
``selective_scan_bwd_plain`` (the oracle, the CPU branch) is the serial
reverse recurrence over spans; ``selective_scan_bwd_chunked_plain``
computes the kernel's chunk-parallel form in PyTorch.  Launches are
counted in ``selective_scan_bwd.launches`` (calls) and
``selective_scan_bwd.program_launches`` (each program).

For meta tensors (a dry run) the wrappers allocate their outputs and
scratch as the CUDA path does and record the call in
``kernels.census.CENSUS`` instead of launching.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import SMEM_LIMIT_BYTES, KernelLaunchError
from ..census import CENSUS

__all__ = ["BWD_CHUNKS", "BWD_MAX_KEPT", "BWD_MAX_THREADS", "BWD_SPANS",
           "MAX_THREADS", "STAGES", "STATE_SIZES", "bwd_launch_error",
           "bwd_splits", "launch_error", "selective_scan_bwd",
           "selective_scan_bwd_chunked_plain", "selective_scan_bwd_plain",
           "selective_scan_fwd", "selective_scan_fwd_plain", "smem_bytes",
           "smem_bytes_bwd", "smem_bytes_bwd_summaries", "token_group",
           "y_pad"]

MAX_THREADS = 512
STATE_SIZES = (4, 8, 16)          # the kernel's templates
# the forward's ring of staged chunks (the kernel's constant)
STAGES = 2
# the backward's chunk lengths (templates) and chunks a span; a
# chunk-program thread keeps chunk x S / split floats of each of
# a_t h_{t-1} and a_t and two per-token sums in registers: chunk x
# (S / split + 1) at most BWD_MAX_KEPT; both programs take at most
# BWD_MAX_THREADS threads a block
BWD_CHUNKS = (8, 16, 32, 64)
BWD_SPANS = (1, 2, 4, 8, 16)
BWD_MAX_KEPT = 80
BWD_MAX_THREADS = 256

_lib: ctypes.CDLL | None = None
_lib_bwd: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("mamba_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_fwd.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
        lib.mamba_scan_fwd.restype = ctypes.c_int
        lib.mamba_scan_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _library_bwd() -> ctypes.CDLL:
    global _lib_bwd
    if _lib_bwd is None:
        lib = _build.load_library("mamba_scan_bwd")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_bwd_summaries.argtypes = [ptr] * 11 + [i32] * 8 + [ptr]
        lib.mamba_scan_bwd_summaries.restype = ctypes.c_int
        lib.mamba_scan_bwd_carry.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.mamba_scan_bwd_carry.restype = ctypes.c_int
        lib.mamba_scan_bwd_chunks.argtypes = [ptr] * 17 + [i32] * 8 + [ptr]
        lib.mamba_scan_bwd_chunks.restype = ctypes.c_int
        lib.mamba_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.mamba_scan_bwd_error_string.restype = ctypes.c_char_p
        _lib_bwd = lib
    return _lib_bwd


def y_pad(split: int) -> int:
    """The x (then y) tile's row pitch past block_d (the kernel's
    ``y_pad``): split consecutive tokens of 32 / split channels land in
    distinct banks, rows stay 16-byte."""
    return 4 if split == 1 else max(4, 32 // split)


def smem_bytes(s: int, block_d: int, chunk: int, split: int) -> int:
    """Shared memory one block asks for (the kernel's ``stage_floats``
    times ``STAGES``): per stage the x / y tile (chunk x (block_d +
    ``y_pad``)), the delta tile (chunk x block_d) and B_t, C_t (chunk x S
    each)."""
    return 4 * STAGES * (chunk * (block_d + y_pad(split)) + chunk * block_d
                         + 2 * chunk * s)


def token_group(split: int) -> int:
    """Tokens a thread takes at once (the kernel's ``token_group``): a
    chunk is a whole number of them."""
    return max(8, split) if split >= 4 else 4


def launch_error(s: int, block_d: int, chunk: int,
                 split: int) -> str | None:
    """Why the forward cannot launch these parameters at state size ``s``,
    or None."""
    if split not in bwd_splits(s):
        return f"split={split} not in {bwd_splits(s)} for S={s}"
    n = block_d * split
    if block_d < 4 or block_d % 4 or n % 32 or n > MAX_THREADS:
        return (f"block_d={block_d} x split={split} = {n} threads: block_d a "
                f"multiple of 4, threads a multiple of 32 up to {MAX_THREADS}")
    if chunk < 1 or chunk % token_group(split):
        return (f"chunk={chunk} must be a positive multiple of "
                f"{token_group(split)} (the tokens a thread takes at once "
                f"at split={split})")
    need = smem_bytes(s, block_d, chunk, split)
    if need > SMEM_LIMIT_BYTES:
        return (f"block_d={block_d}, chunk={chunk}, split={split} need "
                f"{need} bytes of shared memory (limit {SMEM_LIMIT_BYTES})")
    return None


def _check(x, delta, a, b, c, d, h0) -> None:
    for name, t in (("x", x), ("delta", delta), ("a", a), ("b", b), ("c", c),
                    ("d", d), ("h0", h0)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 3 or delta.shape != x.shape:
        raise ValueError(f"x and delta must be (B, T, dI), got "
                         f"{tuple(x.shape)} and {tuple(delta.shape)}")
    bt, t, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"a must be (dI, S) = ({di}, S), got {tuple(a.shape)}")
    s = a.shape[1]
    for name, m in (("b", b), ("c", c)):
        if m.shape != (bt, t, s):
            raise ValueError(f"{name} must be (B, T, S) = ({bt}, {t}, {s}), "
                             f"got {tuple(m.shape)}")
    if d.shape != (di,):
        raise ValueError(f"d must be (dI,) = ({di},), got {tuple(d.shape)}")
    if h0.shape != (bt, di, s):
        raise ValueError(f"h0 must be (B, dI, S) = ({bt}, {di}, {s}), got "
                         f"{tuple(h0.shape)}")
    if s not in STATE_SIZES:
        raise ValueError(f"state size {s} not in {STATE_SIZES}")


def _split_sum(prod: torch.Tensor, split: int) -> torch.Tensor:
    """sum_s of prod (..., S) as the kernel takes it: ``split`` parts of S
    / split consecutive entries, each summed in order, then the parts
    folded by halves (part i with part i + split / 2, and so on: the
    butterfly's pairs)."""
    parts = prod.unflatten(-1, (split, prod.shape[-1] // split))
    acc = parts[..., 0]
    for j in range(1, parts.shape[-1]):
        acc = acc + parts[..., j]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def selective_scan_fwd_plain(x, delta, a, b, c, d, h0, *,
                             split: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, the oracle: the serial recurrence in
    the operands' dtype, the state a Python loop's carry.  y_t's sum over
    the state is one einsum, or with ``split`` given the kernel's order
    (``_split_sum``)."""
    ys = []
    h = h0
    for i in range(x.shape[1]):
        d_t, x_t = delta[:, i], x[:, i]
        h = (torch.exp(d_t[..., None] * a) * h
             + (d_t * x_t)[..., None] * b[:, i, None, :])
        if split is None:
            y = torch.einsum("bds,bs->bd", h, c[:, i])
        else:
            y = _split_sum(h * c[:, i, None, :], split)
        ys.append(y + d * x_t)
    return torch.stack(ys, dim=1), h


def selective_scan_fwd(x, delta, a, b, c, d, h0, *, block_d: int = 128,
                       chunk: int = 16, split: int = 1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: x, delta (B, T, dI); a (dI, S); b, c (B, T, S); d (dI,);
    h0 (B, dI, S), all float32 -> (y (B, T, dI), h_T (B, dI, S))."""
    block_d, chunk, split = int(block_d), int(chunk), int(split)
    _check(x, delta, a, b, c, d, h0)
    err = launch_error(a.shape[1], block_d, chunk, split)
    if err:
        raise ValueError(err)
    if x.device.type == "cpu":
        return selective_scan_fwd_plain(x, delta, a, b, c, d, h0)
    bt, t, di = x.shape
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    if x.device.type == "meta":
        s = a.shape[1]
        CENSUS.add("selective_scan_fwd", ("scan",), 4 * bt * t * di * s,
                   4 * (3 * bt * t * di + 2 * bt * t * s + di * s + di
                        + 2 * bt * di * s))
        return y, h_out
    lib = _library()
    vec = di % 4 == 0 and all(m.data_ptr() % 16 == 0
                              for m in (x, delta, b, c, y))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mamba_scan_fwd(
            x.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), bt, t, di, a.shape[1], block_d, chunk, split,
            int(vec), stream)
    if rc != 0:
        raise KernelLaunchError(
            f"mamba_scan(block_d={block_d}, chunk={chunk}, split={split}): "
            f"launch refused ({rc}: "
            f"{lib.mamba_scan_error_string(rc).decode()})")
    selective_scan_fwd.launches += 1
    return y, h_out


selective_scan_fwd.launches = 0


# -- backward ---------------------------------------------------------------------

def bwd_splits(s: int) -> tuple[int, ...]:
    """Threads per channel either kernel is built for at state size ``s``:
    the powers of two that divide it."""
    return tuple(p for p in (1, 2, 4, 8, 16) if p <= s and s % p == 0)


def smem_bytes_bwd(s: int, block_d: int, chunk: int, split: int,
                   span: int) -> int:
    """Shared memory one block of the backward's chunk program asks for
    (the kernel's ``chunks_smem_floats``): two buffers of a chunk's x,
    delta, dy (chunk x block_d each) and B_t, C_t (chunk x S each); the
    span's chunks' P and h_loc (span x block_d x S each); the reduced
    sum_s g B and sum_s q A (chunk x block_d each); the warps' dC/dB
    partials (chunk x 2S each)."""
    warps = block_d * split // 32
    return 4 * (2 * (3 * chunk * block_d + 2 * chunk * s)
                + 2 * span * block_d * s + 2 * chunk * block_d
                + warps * chunk * 2 * s)


def smem_bytes_bwd_summaries(s: int, block_d: int, chunk: int) -> int:
    """The summaries program's block (``summaries_smem_floats``): two
    buffers of the chunk's x, delta, dy, B_t and C_t, and three (block_d x
    S) tiles of results on their way out."""
    return 4 * (2 * (3 * chunk * block_d + 2 * chunk * s) + 3 * block_d * s)


def bwd_launch_error(s: int, block_d: int, chunk: int, split: int,
                     span: int) -> str | None:
    """Why the backward cannot launch these parameters at state size
    ``s``, or None."""
    if split not in bwd_splits(s):
        return f"split={split} not in {bwd_splits(s)} for S={s}"
    if chunk not in BWD_CHUNKS:
        return f"backward: chunk={chunk} not built ({BWD_CHUNKS})"
    if span not in BWD_SPANS:
        return f"backward: span={span} not in {BWD_SPANS}"
    need = max(smem_bytes_bwd(s, block_d, chunk, split, span),
               smem_bytes_bwd_summaries(s, block_d, chunk))
    if need > SMEM_LIMIT_BYTES:
        return (f"backward: block_d={block_d}, chunk={chunk}, split={split}, "
                f"span={span} need {need} bytes of shared memory (limit "
                f"{SMEM_LIMIT_BYTES})")
    kept = chunk * (s // split + 1)
    if kept > BWD_MAX_KEPT:
        return (f"backward: chunk={chunk} x (S/split + 1) = {kept} kept "
                f"values a thread (registers: at most {BWD_MAX_KEPT})")
    threads = block_d * split
    if block_d < 1 or threads % 32 or threads > BWD_MAX_THREADS:
        return (f"backward: block_d={block_d} x split={split} = {threads} "
                f"threads: a multiple of 32 up to {BWD_MAX_THREADS}")
    return None


def _check_bwd(x, delta, a, b, c, d, h0, dy, dh_t, block_d: int, chunk: int,
               split: int, span: int) -> None:
    _check(x, delta, a, b, c, d, h0)
    for name, t, like in (("dy", dy, x), ("dh_t", dh_t, h0)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.shape != like.shape or t.device != x.device:
            raise ValueError(f"{name} must be float32 {tuple(like.shape)} on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    err = bwd_launch_error(a.shape[1], block_d, chunk, split, span)
    if err:
        raise ValueError(err)


def selective_scan_bwd_plain(x, delta, a, b, c, d, h0, dy, dh_t, *,
                             chunk: int = 16):
    """Plain version of :func:`selective_scan_bwd`, the oracle: the
    reference's scheme (the state entering every span of ``chunk`` tokens,
    each span's states recomputed, the serial reverse recurrence) in the
    operands' dtype, with the (B, dI, S) state as a Python loop's carry."""
    bt, t, di = x.shape
    starts = []
    h = h0
    for i in range(t):                                 # the spans pre-pass
        if i % chunk == 0:
            starts.append(h)
        h = (torch.exp(delta[:, i, :, None] * a) * h
             + (delta[:, i] * x[:, i])[..., None] * b[:, i, None, :])
    g = dh_t.clone()
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros_like(h0)
    dd = torch.zeros_like(x[:, 0])
    for j in reversed(range(len(starts))):
        t0, t1 = j * chunk, min((j + 1) * chunk, t)
        h = starts[j]
        hs = []
        for i in range(t0, t1):                        # the span's states
            hs.append(h)
            h = (torch.exp(delta[:, i, :, None] * a) * h
                 + (delta[:, i] * x[:, i])[..., None] * b[:, i, None, :])
        for i in reversed(range(t0, t1)):
            hp, dt, xv, dyv = hs[i - t0], delta[:, i], x[:, i], dy[:, i]
            ea = torch.exp(dt[..., None] * a)
            ht = ea * hp + (dt * xv)[..., None] * b[:, i, None, :]
            g = g + dyv[..., None] * c[:, i, None, :]
            dc[:, i] = torch.einsum("bds,bd->bs", ht, dyv)
            db[:, i] = torch.einsum("bds,bd->bs", g, dt * xv)
            dd += dyv * xv
            dx[:, i] = d * dyv + dt * torch.einsum("bds,bs->bd", g, b[:, i])
            q = g * ea * hp
            ddt[:, i] = (q * a).sum(-1) + xv * torch.einsum("bds,bs->bd", g,
                                                            b[:, i])
            da += q * dt[..., None]
            g = g * ea
    return dx, ddt, da.sum(0), db, dc, dd.sum(0), g


def selective_scan_bwd_chunked_plain(x, delta, a, b, c, d, h0, dy, dh_t, *,
                                     chunk: int = 16, span: int = 8):
    """The kernel's chunk-parallel formulation in plain PyTorch (for the
    tests and ``chip_smoke.py``; the wrapper's CPU branch takes
    :func:`selective_scan_bwd_plain`): each chunk's decay product and local
    state, each span's and its local adjoint (program ``summaries``), the
    state entering and the adjoint leaving every span (``carry``), then
    per span its chunks' entry states and the chunks last to first, each
    recomputed from its entry state and walked back with the adjoint
    carried from chunk to chunk (``chunks``), as
    ``kernels/csrc/mamba_scan_bwd.cu`` derives them: only products of
    decays, nothing divided.  Tokens past T count as x = delta = dy = 0."""
    bt, t, di = x.shape
    s = a.shape[1]
    n = -(-t // chunk)
    ns = -(-n // span)
    pad = ns * span * chunk - t

    def chunks(m):
        m = torch.nn.functional.pad(m, (0, 0, 0, pad))
        return m.view(bt, ns, span, chunk, m.shape[-1])

    xs, ds, ys, bs, cs = (chunks(m) for m in (x, delta, dy, b, c))
    hl = torch.zeros((bt, ns, span, di, s), dtype=x.dtype, device=x.device)
    p = torch.ones_like(hl)
    hs, ps = torch.zeros_like(hl[:, :, 0]), torch.ones_like(hl[:, :, 0])
    gs = torch.zeros_like(hs)
    for k in range(span):                              # program "summaries"
        for i in range(chunk):
            at = torch.exp(ds[:, :, k, i, :, None] * a)
            hl[:, :, k] = at * hl[:, :, k] \
                + (ds[:, :, k, i] * xs[:, :, k, i])[..., None] \
                * bs[:, :, k, i, None, :]
            p[:, :, k] = p[:, :, k] * at
            ps = ps * at
            gs = gs + ps * (ys[:, :, k, i, :, None] * cs[:, :, k, i, None, :])
        hs = p[:, :, k] * hs + hl[:, :, k]
    h, entry = h0, []
    for j in range(ns):                                # program "carry"
        entry.append(h)
        h = ps[:, j] * h + hs[:, j]
    g, leave = dh_t, [None] * ns
    for j in reversed(range(ns)):
        leave[j] = g
        g = gs[:, j] + ps[:, j] * g
    dh0 = g
    h, g = torch.stack(entry, 1), torch.stack(leave, 1)
    starts = []                                        # program "chunks"
    for k in range(span):
        starts.append(h)
        h = p[:, :, k] * h + hl[:, :, k]
    dx, ddt = torch.empty_like(xs), torch.empty_like(xs)
    db, dc = torch.empty_like(bs), torch.empty_like(cs)
    da = torch.zeros_like(hs)
    for k in reversed(range(span)):
        h, hps, ats = starts[k], [], []
        for i in range(chunk):
            at = torch.exp(ds[:, :, k, i, :, None] * a)
            hps.append(h)
            ats.append(at)
            h = at * h + (ds[:, :, k, i] * xs[:, :, k, i])[..., None] \
                * bs[:, :, k, i, None, :]
        for i in reversed(range(chunk)):
            dt, xv, dyv = ds[:, :, k, i], xs[:, :, k, i], ys[:, :, k, i]
            hp, at = hps[i], ats[i]
            b_t, c_t = bs[:, :, k, i, None, :], cs[:, :, k, i, None, :]
            ht = at * hp + (dt * xv)[..., None] * b_t
            gr = g + dyv[..., None] * c_t
            dc[:, :, k, i] = torch.einsum("bnds,bnd->bns", ht, dyv)
            db[:, :, k, i] = torch.einsum("bnds,bnd->bns", gr, dt * xv)
            sx = (gr * b_t).sum(-1)
            dx[:, :, k, i] = d * dyv + dt * sx
            q = gr * at * hp
            ddt[:, :, k, i] = (q * a).sum(-1) + xv * sx
            da = da + q * dt[..., None]
            g = gr * at

    def back(m):
        return m.reshape(bt, ns * span * chunk, m.shape[-1])[:, :t]

    return (back(dx), back(ddt), da.sum((0, 1)), back(db), back(dc),
            (dy * x).sum((0, 1)), dh0)


def selective_scan_bwd(x, delta, a, b, c, d, h0, dy, dh_t, *,
                       block_d: int = 32, chunk: int = 16, split: int = 4,
                       span: int = 8):
    """Gradients of ``(y, h_T) = selective_scan_fwd(x, delta, a, b, c, d,
    h0)`` for the cotangents ``dy`` (B, T, dI) and ``dh_t`` (B, dI, S), all
    float32: returns (dx, ddelta, dA, dB, dC, dD, dh0) in the operands'
    shapes.  Every element is written by one thread and the partials are
    summed here, so the same inputs give the same bits."""
    block_d, chunk, split = int(block_d), int(chunk), int(split)
    span = int(span)
    _check_bwd(x, delta, a, b, c, d, h0, dy, dh_t, block_d, chunk, split,
               span)
    if x.device.type == "cpu":
        return selective_scan_bwd_plain(x, delta, a, b, c, d, h0, dy, dh_t,
                                        chunk=chunk)
    bt, t, di = x.shape
    s = a.shape[1]
    n = -(-t // chunk)
    ns = -(-n // span)
    n_db = -(-di // block_d)
    f32 = dict(dtype=torch.float32, device=x.device)
    prod_c, hloc_c = (torch.empty((bt, n, di, s), **f32) for _ in range(2))
    prod_s, hloc_s, gloc_s, da = (torch.empty((bt, ns, di, s), **f32)
                                  for _ in range(4))
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db = torch.empty((n_db, bt, t, s), **f32)
    dc = torch.empty((n_db, bt, t, s), **f32)
    dd = torch.empty((bt, ns, di), **f32)
    dh0 = torch.empty_like(h0)
    if x.device.type == "meta":
        CENSUS.add("selective_scan_bwd", ("summaries", "carry", "chunks"),
                   8 * bt * t * di * s,
                   4 * (5 * bt * t * di + 4 * bt * t * s + 2 * di * s
                        + 2 * di + 3 * bt * di * s))
        return _bwd_result(dx, ddt, da, db, dc, dd, dh0)
    lib = _library_bwd()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for prog in ("summaries", "carry", "chunks"):
            if prog == "summaries":
                rc = lib.mamba_scan_bwd_summaries(
                    x.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), dy.data_ptr(), prod_c.data_ptr(),
                    hloc_c.data_ptr(), prod_s.data_ptr(), hloc_s.data_ptr(),
                    gloc_s.data_ptr(), bt, t, di, s, block_d, chunk, split,
                    span, stream)
            elif prog == "carry":
                rc = lib.mamba_scan_bwd_carry(
                    h0.data_ptr(), dh_t.data_ptr(), prod_s.data_ptr(),
                    hloc_s.data_ptr(), gloc_s.data_ptr(), dh0.data_ptr(), bt,
                    di, s, ns, stream)
            else:
                rc = lib.mamba_scan_bwd_chunks(
                    x.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), d.data_ptr(), dy.data_ptr(),
                    prod_c.data_ptr(), hloc_c.data_ptr(), hloc_s.data_ptr(),
                    gloc_s.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                    da.data_ptr(), db.data_ptr(), dc.data_ptr(), dd.data_ptr(),
                    bt, t, di, s, block_d, chunk, split, span, stream)
            if rc != 0:
                raise KernelLaunchError(
                    f"mamba_scan_bwd {prog} (block_d={block_d}, chunk={chunk}, "
                    f"split={split}, span={span}): launch refused ({rc}: "
                    f"{lib.mamba_scan_bwd_error_string(rc).decode()})")
            selective_scan_bwd.program_launches[prog] += 1
    selective_scan_bwd.launches += 1
    return _bwd_result(dx, ddt, da, db, dc, dd, dh0)


selective_scan_bwd.launches = 0
selective_scan_bwd.program_launches = {"summaries": 0, "carry": 0,
                                       "chunks": 0}


def _bwd_result(dx, ddt, da, db, dc, dd, dh0):
    """The gradients from the programs' partials."""
    return (dx, ddt, da.sum((0, 1)), db.sum(0), dc.sum(0), dd.sum((0, 1)),
            dh0)
