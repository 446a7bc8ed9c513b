"""DFA motif matching over DNA text (the paper's workload)."""

from .kernel import count_hits, state_map
from .ops import (DEFAULTS, DNA_SYMBOLS, build_motif_dfa, compose_maps,
                  fa_match, fa_match_plain, random_dna_text)

__all__ = ["DEFAULTS", "DNA_SYMBOLS", "build_motif_dfa", "compose_maps",
           "count_hits", "fa_match", "fa_match_plain", "random_dna_text",
           "state_map"]
