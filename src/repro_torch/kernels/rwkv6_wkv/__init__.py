"""The RWKV-6 wkv recurrence (RWKV-6 "Finch" time mix)."""

from .kernel import wkv6_bwd, wkv6_bwd_plain, wkv6_fwd, wkv6_fwd_plain
from .ops import BWD_DEFAULTS, DEFAULTS, Wkv6, wkv6

__all__ = ["BWD_DEFAULTS", "DEFAULTS", "Wkv6", "wkv6", "wkv6_bwd",
           "wkv6_bwd_plain", "wkv6_fwd", "wkv6_fwd_plain"]
