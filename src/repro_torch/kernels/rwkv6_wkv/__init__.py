"""The RWKV-6 wkv recurrence (RWKV-6 "Finch" time mix)."""

from .kernel import wkv6_fwd, wkv6_fwd_plain
from .ops import DEFAULTS, wkv6

__all__ = ["DEFAULTS", "wkv6", "wkv6_fwd", "wkv6_fwd_plain"]
