"""The dry run's kernel census: the launches a step would have made.

A kernel wrapper given **meta** tensors (``launch.dryrun``: a step traced
for its shapes, on no device) allocates its outputs and the scratch its
CUDA path allocates, as meta tensors of the same shapes and dtypes,
launches nothing and records the call here instead: by wrapper, by
program, and with the work that ``PERF.md`` §6's ``bound_ms`` reckoning
gives for those shapes (``flops``: floating-point operations for the
attention kernels, the reckoning's instruction count for the scans;
``bytes``: each input read once, each output written once).  The
wrappers' ``.launches`` counters are never advanced by a meta call: they
count launches on the card.

Reset it just before a run and read it just after, as the ``.launches``
counters and ``dist.collectives.COUNTERS`` are read.
"""

from __future__ import annotations

__all__ = ["CENSUS", "Census", "causal_pairs"]


class Census:
    """Calls, programs, FLOPs and bytes of the kernels' meta calls, keyed
    by wrapper name."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.by: dict[str, dict] = {}

    def add(self, wrapper: str, programs, flops: float,
            nbytes: float) -> None:
        rec = self.by.setdefault(wrapper, {"calls": 0, "programs": {},
                                           "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        for prog in programs:
            rec["programs"][prog] = rec["programs"].get(prog, 0) + 1
        rec["flops"] += float(flops)
        rec["bytes"] += float(nbytes)

    def snapshot(self) -> dict:
        return {k: {**v, "programs": dict(v["programs"])}
                for k, v in sorted(self.by.items())}

    def flops(self) -> float:
        return sum(v["flops"] for v in self.by.values())


CENSUS = Census()


def causal_pairs(tq: int, tk: int, causal: bool, q_offset: int = 0) -> int:
    """The (query, key) pairs attention computes: ``tq * tk``, or under
    the causal mask the keys at or before each query's position
    ``q_offset + i`` (``tq (tq + 1) / 2`` for a square block)."""
    if not causal:
        return tq * tk
    lo, hi = q_offset + 1, q_offset + tq     # keys a query sees, unclipped
    full = max(0, hi - max(lo, tk) + 1)      # queries that see all tk keys
    top = min(hi, tk - 1)
    part = (top - lo + 1) * (lo + top) // 2 if top >= lo else 0
    return full * tk + part
