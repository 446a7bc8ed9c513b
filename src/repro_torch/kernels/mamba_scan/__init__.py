"""The Mamba-1 selective scan (Jamba's state-space layers)."""

from .kernel import (selective_scan_bwd, selective_scan_bwd_plain,
                     selective_scan_fwd, selective_scan_fwd_plain)
from .ops import (BWD_DEFAULTS, DEFAULTS, SelectiveScan, defaults,
                  selective_scan)

__all__ = ["BWD_DEFAULTS", "DEFAULTS", "SelectiveScan", "defaults",
           "selective_scan",
           "selective_scan_bwd", "selective_scan_bwd_plain",
           "selective_scan_fwd", "selective_scan_fwd_plain"]
