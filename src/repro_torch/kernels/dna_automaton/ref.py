"""Plain sequential oracle for finite-automaton DNA motif matching.

The paper's workload (PaREM [24] / refs [11,12]): run a DFA over a DNA
byte stream and count accepting-state visits (motif matches).  One
symbol at a time, in numpy — for tests at small ``T`` only.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def fa_match_ref(text, table, accept, start_state: int = 0):
    """text: (T,) uint8 symbols in [0, n_sym); table: (S, n_sym) int32;
    accept: (S,) bool.  Returns (match_count, final_state) as ints."""
    text, table, accept = _np(text), _np(table), _np(accept)
    state, hits = int(start_state), 0
    for sym in text.tolist():
        state = int(table[state, sym])
        hits += int(bool(accept[state]))
    return hits, state


def chunk_state_map_ref(chunk, table) -> np.ndarray:
    """End state for EVERY start state after consuming ``chunk``.

    This is the associative element of parallel FA matching: maps compose
    as ``m_ab = m_b[m_a]``.  Returns (S,) int32.
    """
    chunk, table = _np(chunk), _np(table)
    states = np.arange(table.shape[0], dtype=np.int32)
    for sym in chunk.tolist():
        states = table[states, sym]
    return states.astype(np.int32)
