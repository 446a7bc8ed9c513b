"""The Mamba-1 selective scan (Jamba's state-space layers)."""

from .kernel import selective_scan_fwd, selective_scan_fwd_plain
from .ops import DEFAULTS, selective_scan

__all__ = ["DEFAULTS", "selective_scan", "selective_scan_fwd",
           "selective_scan_fwd_plain"]
