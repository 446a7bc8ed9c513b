"""The collective census of one step, from the port's own counters.

The counterpart of the reference's ``roofline/hlo.py``, which parses the
partitioned HLO and weights each computation's collectives by the trip
counts of the loops around it, because ``cost_analysis`` and a text scan
see a scan body once.  The port has no HLO: every collective is an
explicit call, counted by op and mesh axes where it runs
(``dist.collectives.COUNTERS``), and PyTorch runs eagerly, so a loop's
collectives are counted once a trip as they run.  The census is then
exact by construction: ``weighted`` equals ``raw`` and ``loops`` is empty.

Per call, ``hlo.py``'s ring model by op, the group size ``g`` from the
counter key's axes on ``mesh``:

  all-gather / reduce-scatter   bytes * (g-1)/g     per rank
  all-reduce                    2 * bytes * (g-1)/g (RS + AG)

``bytes`` are what the call hands the backend: an all-gather's gathered
output, a reduce-scatter's whole input (``hlo.py`` reads a
reduce-scatter's result, the shard, so its model moves ``g`` times less
for the same call), an all-reduce's tensor (sum or max).
"""

from __future__ import annotations

import math

__all__ = ["COLLECTIVES", "collective_census"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the counter's op -> the HLO collective it is
_KIND = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce"}


def _transfer(kind: str, nbytes: int, g: int) -> float:
    """The ring model's bytes a rank sends (a float: the counters sum a
    key's calls before the model is applied)."""
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * (g - 1) / max(g, 1)
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / max(g, 1)
    return float(nbytes)


def collective_census(counters: dict, mesh) -> dict:
    """The per-rank census of ``counters`` (``COUNTERS.snapshot()``, keys
    ``"<op>@<axis>+<axis>"``) on ``mesh`` (anything with a ``shape`` map
    of axis sizes): per HLO kind ``{count, bytes, transfer_bytes}``,
    ``raw`` and ``weighted`` (equal), ``transfer_bytes_per_step``, the
    empty ``loops``, and ``by_key``, the transfer bytes of each counter
    key."""
    raw = {k: {"count": 0, "bytes": 0, "transfer_bytes": 0}
           for k in COLLECTIVES}
    by_key = {}
    for key, rec in sorted(counters.items()):
        op, _, axes = key.partition("@")
        kind = _KIND[op]
        g = math.prod(mesh.shape[a] for a in axes.split("+") if a)
        transfer = _transfer(kind, rec["bytes"], g)
        raw[kind]["count"] += rec["calls"]
        raw[kind]["bytes"] += rec["bytes"]
        raw[kind]["transfer_bytes"] += transfer
        by_key[key] = transfer
    weighted = {k: {f: float(v) for f, v in st.items()}
                for k, st in raw.items()}
    return {"weighted": weighted, "raw": raw,
            "transfer_bytes_per_step": float(sum(
                v["transfer_bytes"] for v in raw.values())),
            "loops": [], "by_key": by_key}
