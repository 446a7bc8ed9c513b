"""Chunk-parallel finite-automaton matching: CUDA kernels and plain versions.

The paper's application is DFA-based DNA motif search (PaREM).  A DFA is
sequential per symbol, but transition functions COMPOSE: processing a
chunk from every possible start state yields a state-map vector
m: S -> S, and m_ab = m_b[m_a].  That composition is associative — the
classic parallel-FA-matching decomposition, and the reason this workload
is "divisible" in the paper's sense (any chunk boundary works).

``state_map``   replaces the Pallas kernel ``state_map_kernel``
    (``repro/kernels/dna_automaton/kernel.py``): per text chunk, the end
    state for every start state.
``count_hits``  replaces the Pallas kernel ``count_hits_kernel`` (same
    file): per chunk, from its true start state, the accepting-state
    visits and the end state.

Both are CUDA C++ kernels in ``kernels/csrc/dna_automaton.cu``, compiled
at first use and bound with ``ctypes``.  On this card both are bound by
bytes: the ``T`` bytes of text are read once per pass and everything
else is negligible.  The text therefore stays ``uint8`` on the device
(the reference widens it to int32 first, which would quadruple the only
traffic that matters), the transition table sits in shared memory, and
each thread reads its chunk 16 bytes at a time with 64-bit offsets.

A wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version (``state_map_plain`` / ``count_hits_plain``) only
for a tensor that lies on the CPU.  Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import KernelLaunchError

__all__ = ["MAX_STATES", "N_SYM", "count_hits", "count_hits_plain",
           "state_map", "state_map_plain"]

N_SYM = 4
# shared memory holds S * 4 int32 entries within the 48 KB a block gets
# without opting in to more
MAX_STATES = 3072

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("dna_automaton")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.dna_state_map.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, ptr]
        lib.dna_state_map.restype = ctypes.c_int
        lib.dna_count_hits.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                       i64, i64, i32, i32, ptr]
        lib.dna_count_hits.restype = ctypes.c_int
        lib.dna_error_string.argtypes = [ctypes.c_int]
        lib.dna_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_int32(name: str, x: torch.Tensor, like: torch.Tensor,
                 shape: tuple) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor")
    if x.device != like.device:
        raise ValueError(f"{name} lies on {x.device}, text on {like.device}")
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous with shape {shape}, "
                         f"got {tuple(x.shape)}")


def _check(text: torch.Tensor, table: torch.Tensor, chunk: int) -> int:
    """Validate text/table/chunk; returns the number of chunks."""
    if not isinstance(text, torch.Tensor) or text.dtype != torch.uint8:
        raise TypeError("text must be a uint8 tensor (one byte per symbol)")
    if text.dim() != 1 or not text.is_contiguous():
        raise ValueError("text must be a contiguous 1-d tensor")
    if text.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {text.device}")
    chunk = int(chunk)
    t = text.shape[0]
    if chunk < 1 or t % chunk:
        raise ValueError(f"chunk={chunk} does not divide the text length {t}")
    if not isinstance(table, torch.Tensor):
        raise TypeError("table must be an int32 tensor")
    if table.dim() != 2 or table.shape[1] != N_SYM:
        raise ValueError(f"table must be (S, {N_SYM}), got {tuple(table.shape)}")
    s = table.shape[0]
    if not 1 <= s <= MAX_STATES:
        raise ValueError(f"S={s} states outside [1, {MAX_STATES}]")
    _check_int32("table", table, text, (s, N_SYM))
    return t // chunk


def _check_block_threads(block_threads: int) -> int:
    block_threads = int(block_threads)
    if not 32 <= block_threads <= 1024 or block_threads % 32:
        raise ValueError("block_threads must be a multiple of 32 in "
                         f"[32, 1024], got {block_threads}")
    return block_threads


def _raise_if_refused(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dna_error_string(rc).decode()
        raise KernelLaunchError(f"{what}: launch refused ({rc}: {msg})")


# -- plain PyTorch versions ------------------------------------------------------

def state_map_plain(text: torch.Tensor, table: torch.Tensor, *,
                    chunk: int) -> torch.Tensor:
    """Plain version of :func:`state_map`: all chunks x all start states
    advance together, one gather on the flattened table per position.

    Only one column of the ``(n_chunks, chunk)`` view is widened at a
    time, so the text is never materialised as int64 and the function is
    usable at full width on the card.
    """
    n_chunks = _check(text, table, chunk)
    s = table.shape[0]
    flat = table.reshape(-1).to(torch.int64)
    rows = text.view(n_chunks, chunk)
    states = torch.arange(s, device=text.device).repeat(n_chunks, 1)
    for t in range(chunk):
        sym = rows[:, t].to(torch.int64)
        states = flat[states * N_SYM + sym[:, None]]
    return states.to(torch.int32)


def count_hits_plain(text: torch.Tensor, table: torch.Tensor,
                     accept: torch.Tensor, starts: torch.Tensor, *,
                     chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`count_hits`: all chunks advance together
    from their start states, one gather per position."""
    n_chunks = _check(text, table, chunk)
    _check_int32("accept", accept, text, (table.shape[0],))
    _check_int32("starts", starts, text, (n_chunks,))
    flat = table.reshape(-1).to(torch.int64)
    acc = accept.to(torch.int64)
    rows = text.view(n_chunks, chunk)
    states = starts.to(torch.int64)
    hits = torch.zeros_like(states)
    for t in range(chunk):
        states = flat[states * N_SYM + rows[:, t].to(torch.int64)]
        hits += acc[states]
    return hits.to(torch.int32), states.to(torch.int32)


# -- the kernels' wrappers -------------------------------------------------------

def state_map(text: torch.Tensor, table: torch.Tensor, *, chunk: int,
              block_threads: int = 256) -> torch.Tensor:
    """text: (T,) uint8; table: (S, 4) int32 -> maps (T/chunk, S) int32."""
    n_chunks = _check(text, table, chunk)
    block_threads = _check_block_threads(block_threads)
    if text.device.type == "cpu":
        return state_map_plain(text, table, chunk=chunk)
    lib = _library()
    s = table.shape[0]
    maps = torch.empty((n_chunks, s), dtype=torch.int32, device=text.device)
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dna_state_map(text.data_ptr(), table.data_ptr(),
                               maps.data_ptr(), n_chunks, int(chunk), s,
                               block_threads, stream)
    _raise_if_refused(lib, rc, f"dna_state_map(block_threads={block_threads})")
    state_map.launches += 1
    return maps


def count_hits(text: torch.Tensor, table: torch.Tensor, accept: torch.Tensor,
               starts: torch.Tensor, *, chunk: int, block_threads: int = 256
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per chunk, from ``starts[chunk]``: (accepting visits, end state),
    each (T/chunk,) int32."""
    n_chunks = _check(text, table, chunk)
    block_threads = _check_block_threads(block_threads)
    s = table.shape[0]
    _check_int32("accept", accept, text, (s,))
    _check_int32("starts", starts, text, (n_chunks,))
    if text.device.type == "cpu":
        return count_hits_plain(text, table, accept, starts, chunk=chunk)
    lib = _library()
    counts = torch.empty((n_chunks,), dtype=torch.int32, device=text.device)
    ends = torch.empty((n_chunks,), dtype=torch.int32, device=text.device)
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dna_count_hits(text.data_ptr(), table.data_ptr(),
                                accept.data_ptr(), starts.data_ptr(),
                                counts.data_ptr(), ends.data_ptr(),
                                n_chunks, int(chunk), s, block_threads,
                                stream)
    _raise_if_refused(lib, rc,
                      f"dna_count_hits(block_threads={block_threads})")
    count_hits.launches += 1
    return counts, ends


state_map.launches = 0
count_hits.launches = 0
