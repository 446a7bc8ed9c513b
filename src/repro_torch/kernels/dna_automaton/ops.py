"""Public API: parallel DFA motif matching + motif-table construction.

``fa_match`` = state-map kernel -> associative compose of the chunk maps
(an O(log n_chunks) prefix scan of S-vectors, plain PyTorch as it is
plain JAX in the reference) -> count kernel.  Composition is
``m_ab = m_b[m_a]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import resolve_device
from ...convert import dfa_to_device
from .. import largest_aligned_divisor, resolve_launch_params
from .kernel import (count_hits, count_hits_plain, state_map,
                     state_map_plain)

DNA_SYMBOLS = "ACGT"

DEFAULTS = {"map_chunk": 65536, "count_chunk": 65536, "block_threads": 64,
            "gram": 4}


def build_motif_dfa(motif: str) -> tuple[np.ndarray, np.ndarray]:
    """KMP-style DFA over {A,C,G,T} recognising ``motif`` occurrences.

    Returns (table (S, 4) int32, accept (S,) bool) with S = len(motif)+1;
    the accept state loops via its failure function so overlapping
    occurrences all count.
    """
    m = len(motif)
    sym_of = {c: i for i, c in enumerate(DNA_SYMBOLS)}
    pat = [sym_of[c] for c in motif]
    table = np.zeros((m + 1, 4), np.int32)
    table[0, :] = 0
    if m:
        table[0, pat[0]] = 1
    x = 0
    for j in range(1, m + 1):
        for c in range(4):
            table[j, c] = table[x, c]
        if j < m:
            table[j, pat[j]] = j + 1
            x = table[x, pat[j]]
    accept = np.zeros(m + 1, bool)
    accept[m] = True
    return table, accept


def compose_maps(maps: torch.Tensor) -> torch.Tensor:
    """Prefix-compose chunk state maps: out[i] = m_0..i (inclusive).

    A Hillis–Steele scan: ceil(log2 n) rounds, each composing every map
    with the prefix that ends ``d`` rows above it (a then b = ``b[a]``).
    """
    m = maps.to(torch.int64)
    n, d = m.shape[0], 1
    while d < n:
        m = torch.cat([m[:d], torch.gather(m[d:], 1, m[:-d])])
        d *= 2
    return m.to(maps.dtype)


def random_dna_text(t: int, *, seed: int, device=None) -> torch.Tensor:
    """``t`` uniform symbols in [0, 4) as a uint8 tensor made on ``device``
    (``None`` = the card) from ``torch.Generator(device).manual_seed(seed)``,
    filled slice by slice so no wider temporary of the whole text exists."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    text = torch.empty(t, dtype=torch.uint8, device=dev)
    step = 1 << 28
    for lo in range(0, t, step):
        n = min(step, t - lo)
        text[lo:lo + n] = torch.randint(0, 4, (n,), dtype=torch.uint8,
                                        device=dev, generator=gen)
    return text


def _match(text, table, accept, mc, cc, start_state, map_fn, count_fn):
    """state maps at ``mc`` -> prefix compose -> counts at ``cc``."""
    t = text.shape[0]
    maps = map_fn(text, table, chunk=mc)
    prefix = compose_maps(maps)                       # (T/mc, S)
    # start state of count chunk k = automaton state at position k*cc,
    # i.e. the prefix map after map chunk k*(cc/mc) - 1
    rep = cc // mc
    starts = torch.cat([
        torch.full((1,), start_state, dtype=torch.int32, device=text.device),
        prefix[rep - 1::rep, start_state][:t // cc - 1],
    ])
    counts, _ = count_fn(text, table, accept, starts, chunk=cc)
    return counts.sum(dtype=torch.int32)


def fa_match_plain(text: torch.Tensor, table, accept, *, chunk: int = 2048,
                   start_state: int = 0) -> torch.Tensor:
    """``fa_match`` through the kernels' plain PyTorch versions, on the
    device ``text`` lies on: the parity oracle of the kernel path."""
    table, accept = dfa_to_device(table, accept, text.device)
    c = largest_aligned_divisor(text.shape[0], chunk)
    return _match(text, table, accept, c, c, start_state,
                  state_map_plain, count_hits_plain)


def fa_match(text, table, accept, *, chunk: int | None = None,
             map_chunk: int | None = None, count_chunk: int | None = None,
             block_threads: int | None = None, gram: int | None = None,
             start_state: int = 0, tuned: bool | None = None,
             device=None) -> torch.Tensor:
    """Total motif matches in ``text`` ((T,) uint8 symbols). int32 scalar.

    The two passes chunk independently (``map_chunk``/``count_chunk``);
    ``chunk`` sets both at once (legacy knob).  The count pass needs the
    automaton state at its own chunk boundaries, so ``count_chunk`` must
    be a multiple of ``map_chunk`` — otherwise it is clamped down to the
    map granularity.  ``gram`` is the symbols a table lookup advances
    (1, 2 or 4).  ``tuned=True`` resolves the cached best launch
    parameters for this (shape, dtype, device); ``tuned=None`` does so
    only when tuning was enabled globally
    (``repro_torch.tune.kernels.configure``).

    ``device=None`` runs where ``text`` lies when it is a tensor, else on
    the card (and raises when there is none); the plain PyTorch versions
    of the kernels run only for ``device="cpu"`` or a CPU tensor.
    """
    if device is None and isinstance(text, torch.Tensor):
        dev = text.device
    else:
        dev = resolve_device(device)
    text = torch.as_tensor(text).to(dev)
    table, accept = dfa_to_device(table, accept, dev)
    t = text.shape[0]
    meta = {"t": t, "s": table.shape[0]}
    p = resolve_launch_params(
        "dna_automaton", meta, "uint8", defaults=DEFAULTS,
        overrides={"map_chunk": map_chunk if map_chunk is not None else chunk,
                   "count_chunk": (count_chunk if count_chunk is not None
                                   else chunk),
                   "block_threads": block_threads, "gram": gram},
        tuned=tuned, device=dev)
    mc = largest_aligned_divisor(t, p["map_chunk"])
    cc = largest_aligned_divisor(t, p["count_chunk"])
    if cc % mc:
        cc = mc
    launch = {"block_threads": p["block_threads"], "gram": p["gram"]}
    return _match(text, table, accept, mc, cc, start_state,
                  functools.partial(state_map, **launch),
                  functools.partial(count_hits, **launch))
