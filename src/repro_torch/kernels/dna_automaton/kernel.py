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
bytes: the ``T`` bytes of text are read once per pass.  The text stays
``uint8`` on the device; each warp stages its walkers' text through a
ring of shared-memory slots with coalesced 16-byte ``cp.async`` copies;
one lookup in a table over ``gram`` = k symbols (k = 1, 2, 4, built in
shared memory) advances k symbols.  ``state_map`` has two routes, picked
from S: ``"vector"`` (S <= 16: a block per map chunk, a thread per slice
walking every start state at once as a vector of nibbles stepped by byte
permutes, the slices' maps composed in the block) and ``"gather"`` (S >
16: a lane per (chunk, start state)).  ``count_hits`` walks each count
chunk with one thread through k-gram entries that pack the next state and
the accepting visits.  Neither needs an aligned text or a chunk that is a
multiple of 16: a 16-byte unit a range cuts is walked a symbol at a time.

``state_map_gram_plain`` and ``count_hits_gram_plain`` are the kernels'
formulation in plain PyTorch (k-gram tables from ``gram_tables``, slices
composed in slice order), held against the oracles in the tests;
``state_map_plain`` and ``count_hits_plain`` (one symbol a step) stay the
oracles the kernels are held to.

A wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version (``state_map_plain`` / ``count_hits_plain``) only
for a tensor that lies on the CPU.  Each wrapper counts its launches in
``<wrapper>.launches``; ``state_map.route_launches`` splits them by route
and ``state_map.last_route`` names the route of the last call.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .. import SMEM_LIMIT_BYTES, KernelLaunchError

__all__ = ["GRAMS", "GRAM_TABLE_BYTES", "MAX_STATES", "MAX_THREADS", "N_SYM",
           "ROUTES", "SEGMENT", "VEC_MAX_STATES", "count_hits",
           "count_hits_gram_plain", "count_hits_plain", "effective_gram",
           "gram_tables", "reckonings", "route_of", "slice_length",
           "smem_bytes",
           "state_map", "state_map_gram_plain", "state_map_plain"]

N_SYM = 4
# the largest motif automaton a table may hold (fa_match's public bound)
MAX_STATES = 3072
# the vector route keeps a start state in a nibble: 16 states at most
VEC_MAX_STATES = 16
ROUTES = ("vector", "gather")
GRAMS = (1, 2, 4)
# a walker's text a ring slot holds, the slot row's pitch, the ring's depth
# and the gather route's slot (must match dna_automaton.cu)
SEGMENT = 128
PITCH = SEGMENT + 16
STAGES = 3
WIDE = 512
MAX_THREADS = 256
# the k-gram tables of the gather and count kernels take the largest k whose
# table fits this (several blocks then share an SM)
GRAM_TABLE_BYTES = 64 * 1024

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("dna_automaton")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.dna_state_map_vec, lib.dna_state_map_gather):
            fn.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
            fn.restype = ctypes.c_int
        lib.dna_count_hits.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                       i64, i64, i32, i32, i32, ptr]
        lib.dna_count_hits.restype = ctypes.c_int
        lib.dna_error_string.argtypes = [ctypes.c_int]
        lib.dna_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def route_of(s: int) -> str:
    """The state-map route for ``s`` states: ``"vector"`` up to 16 (a
    state a nibble), ``"gather"`` above."""
    return "vector" if s <= VEC_MAX_STATES else "gather"


def effective_gram(kind: str, s: int, gram: int) -> int:
    """The k a kernel runs for ``gram``: the vector route takes it as it
    is (its columns are 16 bytes a k-gram); the gather route (uint16
    entries, so ``next << 2k`` stays below 2^16) and the count kernel
    (int32 entries) the largest k <= gram whose table of S * 4^k entries
    fits ``GRAM_TABLE_BYTES``."""
    if kind == "vector":
        return gram
    width = 2 if kind == "gather" else 4
    k = gram
    while k > 1 and width * s * 4 ** k > GRAM_TABLE_BYTES:
        k //= 2
    return k


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(kind: str, s: int, threads: int, gram: int) -> int:
    """Shared memory one block of ``kind`` (``"vector"``, ``"gather"``,
    ``"count"``) asks for at its effective k (``dna_automaton.cu``'s
    ``smem_vec``/``smem_gather``/``smem_count``): the k-gram table (and
    the one-symbol table), the vector route's slice maps, and a ring of
    ``STAGES`` slots a warp."""
    k = effective_gram(kind, s, gram)
    ng = 4 ** k
    warps = threads // 32
    if kind == "vector":
        return 16 * (ng + N_SYM + threads) + warps * STAGES * 32 * PITCH
    if kind == "gather":
        return 2 * (_up(s * N_SYM, 8) + _up(s * ng, 8)) + warps * STAGES * WIDE
    tables = 4 * _up(s * N_SYM, 4) + (0 if k == 1 else 4 * _up(s * ng, 4))
    return tables + warps * STAGES * 32 * PITCH


def slice_length(chunk: int, slices: int) -> int:
    """The vector route's slice: ``chunk`` cut into ``slices`` pieces of
    whole 16-byte units, the last ones shorter or empty."""
    return 16 * -(-chunk // (16 * slices))


# The reckonings of the design on an H100 SXM (132 SMs at the 1.98 GHz boost
# clock): HBM at 3.35e12 B/s (data sheet); the issue rate of 128 thread
# instructions a clock per SM, 33.5e12/s (the logic pipe that runs prmt,
# lop3 and shifts takes 64 a clock); shared memory serving one 128-byte
# wavefront a clock per SM, where 32 lanes' lookups at random banks take
# the expected largest of 32 bins over 32 draws, about 3.5 wavefronts.
H100_HBM_BYTES_PER_S = 3.35e12
H100_INSTR_PER_S = 33.5e12
H100_WAVEFRONTS_PER_S = 132 * 1.98e9
RANDOM_BANK_WAYS = 3.5
# integer instructions a lane spends, counted from dna_automaton.cu: a
# k-gram step (index from the masked word, address, lookup; the count
# kernel also unpacks and adds the visits), a 16-byte unit (its LDS.128,
# four masks, the range test) and a 128-byte slot row (eight cp.async with
# their addresses and tests, the ring's wait and barrier); the vector
# route's step before its start states meet, by live groups of four
# states (permutes, the bit-3 OR, the nibble packing, the column load)
INSTR_STEP = {"vector": 5, "gather": 4, "count": 7}
INSTR_UNIT, INSTR_ROW = 10, 50
INSTR_VEC_STEP = {1: 8, 2: 11, 3: 26, 4: 30}


def reckonings(kind: str, t: int, s: int, gram: int, *, chunk: int,
               threads: int) -> dict:
    """The three least times (ms) of one pass of ``kind`` (``"vector"``,
    ``"gather"``, ``"count"``) over ``t`` symbols on an H100: the bytes
    (the text once, the maps or counts written), the shared-memory
    wavefronts (the text written by cp.async and read back, 128 bytes a
    wavefront; one table lookup a k-gram at ``RANDOM_BANK_WAYS``
    wavefronts a warp), and the integer instructions at the issue rate
    (``INSTR_*`` counts).  The vector route counts the first 16-byte unit
    of each slice at its vector step (a KMP automaton's start states meet
    within len(motif) <= 16 symbols) and the rest at the single state's step;
    the gather route walks every start state (32 lanes a warp)."""
    k = effective_gram(kind, s, gram)
    n_out = t // chunk
    if kind == "vector":
        out_bytes = 4 * n_out * s
        lanes = t
        vec_steps = min(t, n_out * threads * 16) // k
        instr = ((t // k - vec_steps) * INSTR_STEP[kind]
                 + vec_steps * INSTR_VEC_STEP[-(-s // 4)])
    elif kind == "gather":
        out_bytes = 4 * n_out * s
        lanes = t * -(-s // 32) * 32           # every lane walks the text
        instr = lanes // k * INSTR_STEP[kind]
    else:
        out_bytes = 3 * 4 * n_out             # starts read; counts, ends
        lanes = t
        instr = t // k * INSTR_STEP[kind]
    instr += lanes // 16 * INSTR_UNIT + lanes // SEGMENT * INSTR_ROW
    wavefronts = (t + lanes) / 128 + lanes // k / 32 * RANDOM_BANK_WAYS
    return {"gram": k,
            "bytes_ms": (t + out_bytes) / H100_HBM_BYTES_PER_S * 1e3,
            "smem_ms": wavefronts / H100_WAVEFRONTS_PER_S * 1e3,
            "instr_ms": instr / H100_INSTR_PER_S * 1e3,
            "instr_per_symbol": instr / t}


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


def _check_launch(kind: str, s: int, block_threads: int, gram: int
                  ) -> tuple[int, int]:
    block_threads, gram = int(block_threads), int(gram)
    if not 32 <= block_threads <= MAX_THREADS or block_threads % 32:
        raise ValueError("block_threads must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}], got {block_threads}")
    if gram not in GRAMS:
        raise ValueError(f"gram={gram} not in {GRAMS}")
    need = smem_bytes(kind, s, block_threads, gram)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"{kind}: block_threads={block_threads}, gram={gram} "
                         f"need {need} bytes of shared memory (limit "
                         f"{SMEM_LIMIT_BYTES})")
    return block_threads, effective_gram(kind, s, gram)


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


# -- the kernels' formulation, plain -----------------------------------------------

def _clamped(table: torch.Tensor) -> torch.Tensor:
    return table.to(torch.int64).clamp(0, table.shape[0] - 1)


def gram_tables(table: torch.Tensor, accept: torch.Tensor | None, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tables over ``k`` symbols the kernels build in shared memory:
    ``next[s, g]`` (int64, (S, 4^k)), the state after the k symbols of
    k-gram ``g = b0 | b1 << 2 | ...`` (b0 the first) from state ``s``, and
    ``hits[s, g]``, the accepting states among the k visited (``accept``
    None: zeros).  Table entries are clamped into [0, S), as the kernels
    read them."""
    flat = _clamped(table)
    s = table.shape[0]
    g = torch.arange(4 ** k, device=table.device)
    state = torch.arange(s, device=table.device)[:, None].expand(s, 4 ** k)
    hits = torch.zeros_like(state)
    acc = None if accept is None else (accept != 0).to(torch.int64)
    for i in range(k):
        state = flat[state, (g >> (2 * i)) & 3]
        if acc is not None:
            hits = hits + acc[state]
    return state.contiguous(), hits


def _grams(piece: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, L) symbols as (n, L // k) k-gram indices and the (n, L % k)
    symbols left over."""
    n, length = piece.shape
    whole = length // k * k
    sym = piece[:, :whole].to(torch.int64) & 3
    g = (sym.view(n, whole // k, k) << (2 * torch.arange(k, device=piece.device))
         ).sum(-1)
    return g, piece[:, whole:].to(torch.int64) & 3


def state_map_gram_plain(text: torch.Tensor, table: torch.Tensor, *,
                         chunk: int, gram: int = 4, slices: int = 1
                         ) -> torch.Tensor:
    """:func:`state_map` in the vector route's formulation: each chunk
    cut into ``slices`` slices (``slice_length``: whole 16-byte units, the
    last ones shorter or empty), each slice walked from every start state
    one k-gram a step (its last ``len % k`` symbols one a step), and the
    slices' maps composed in slice order (``m_ab = m_b[m_a]``)."""
    n_chunks = _check(text, table, chunk)
    s = table.shape[0]
    nxt, _ = gram_tables(table, None, gram)
    flat = _clamped(table)
    rows = text.view(n_chunks, chunk)
    lq = slice_length(chunk, slices)
    total = torch.arange(s, device=text.device).repeat(n_chunks, 1)
    for t in range(slices):
        lo, hi = min(chunk, t * lq), min(chunk, (t + 1) * lq)
        states = torch.arange(s, device=text.device).repeat(n_chunks, 1)
        g, rest = _grams(rows[:, lo:hi], gram)
        for j in range(g.shape[1]):
            states = torch.gather(nxt[:, g[:, j]].T, 1, states)
        for j in range(rest.shape[1]):
            states = flat[states, rest[:, j:j + 1]]
        total = torch.gather(states, 1, total)       # m_ab = m_b[m_a]
    return total.to(torch.int32)


def count_hits_gram_plain(text: torch.Tensor, table: torch.Tensor,
                          accept: torch.Tensor, starts: torch.Tensor, *,
                          chunk: int, gram: int = 4
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`count_hits` in the kernel's formulation: one packed k-gram
    entry (next state, accepting visits within the k steps) a step, the
    chunk's last ``chunk % k`` symbols one a step."""
    n_chunks = _check(text, table, chunk)
    _check_int32("accept", accept, text, (table.shape[0],))
    _check_int32("starts", starts, text, (n_chunks,))
    nxt, hk = gram_tables(table, accept, gram)
    n1, h1 = gram_tables(table, accept, 1)
    states = starts.to(torch.int64).clamp(0, table.shape[0] - 1)
    hits = torch.zeros_like(states)
    g, rest = _grams(text.view(n_chunks, chunk), gram)
    for j in range(g.shape[1]):
        hits += hk[states, g[:, j]]
        states = nxt[states, g[:, j]]
    for j in range(rest.shape[1]):
        hits += h1[states, rest[:, j]]
        states = n1[states, rest[:, j]]
    return hits.to(torch.int32), states.to(torch.int32)


# -- the kernels' wrappers -------------------------------------------------------

def state_map(text: torch.Tensor, table: torch.Tensor, *, chunk: int,
              block_threads: int = 256, gram: int = 4) -> torch.Tensor:
    """text: (T,) uint8; table: (S, 4) int32 -> maps (T/chunk, S) int32.

    S <= 16 takes the vector route, S > 16 the gather route
    (``route_of``); both count as launches of ``state_map``."""
    n_chunks = _check(text, table, chunk)
    s = table.shape[0]
    route = route_of(s)
    block_threads, k = _check_launch(route, s, block_threads, gram)
    if text.device.type == "cpu":
        return state_map_plain(text, table, chunk=chunk)
    lib = _library()
    maps = torch.empty((n_chunks, s), dtype=torch.int32, device=text.device)
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = (lib.dna_state_map_vec if route == "vector"
              else lib.dna_state_map_gather)
        rc = fn(text.data_ptr(), table.data_ptr(), maps.data_ptr(), n_chunks,
                int(chunk), s, block_threads, k, stream)
    _raise_if_refused(lib, rc, f"dna_state_map ({route}, block_threads="
                               f"{block_threads}, gram={k})")
    state_map.launches += 1
    state_map.route_launches[route] += 1
    state_map.last_route = route
    return maps


def count_hits(text: torch.Tensor, table: torch.Tensor, accept: torch.Tensor,
               starts: torch.Tensor, *, chunk: int, block_threads: int = 256,
               gram: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Per chunk, from ``starts[chunk]``: (accepting visits, end state),
    each (T/chunk,) int32."""
    n_chunks = _check(text, table, chunk)
    s = table.shape[0]
    block_threads, k = _check_launch("count", s, block_threads, gram)
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
                                n_chunks, int(chunk), s, block_threads, k,
                                stream)
    _raise_if_refused(lib, rc, f"dna_count_hits(block_threads={block_threads},"
                               f" gram={k})")
    count_hits.launches += 1
    return counts, ends


state_map.launches = 0
state_map.route_launches = {route: 0 for route in ROUTES}
state_map.last_route = None
count_hits.launches = 0
