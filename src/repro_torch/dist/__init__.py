"""Distribution subsystem: mesh rules, collectives, compression,
seq-decode, restarts.

The port of the reference's work-distribution runtime over a mesh of
**ranks** (processes joined by ``torch.distributed``; ``ranks``), packaged
as the reference's four substrates and the collectives between ranks:

``sharding`` / ``api`` — the mesh-rules system.
    :class:`~repro_torch.dist.sharding.ShardingConfig` declares how a
    workload maps onto mesh axes; ``scfg.rules(mesh)`` compiles it to a
    logical-axis table that :func:`~repro_torch.dist.api.use_rules`
    installs and :func:`~repro_torch.dist.api.constrain` consults.  The
    ``*_specs`` helpers derive per-leaf layouts.  Each rank holds its own
    part of every tensor: the layouts are realised where data enters a
    rank (the batch rows, the cache stripes, ``LM.shard``'s parameter
    blocks), and the compute layout (``sharding.compute_layout``) tells
    the models which heads, columns, vocabulary and experts are theirs.

``collectives`` — the collectives between the ranks.
    All-reduce, all-gather, reduce-scatter and max over a mesh's axes,
    each an ``autograd.Function`` (the others' transposes), counted by op
    and axes.

``compression`` — gradient wire formats.
    Per-tensor int8 and top-k substrates, the error-feedback wrapper
    (``compress_with_feedback``), a compressed all-reduce-mean over a
    rank group, and ``wire_bytes`` accounting.

``seq_decode`` — sequence-sharded decode attention.
    The decode kernel over each rank's stripe of the KV cache with a
    cross-rank logsumexp combine; ``models.attention.decode_attention``
    dispatches here for a cache allocated as a stripe.

``fault`` — supervised restarts.
    ``run_with_restarts`` re-invokes a checkpointing training loop after
    failures.
"""

from . import (api, collectives, compression, fault,  # noqa: F401
               seq_decode, sharding)
from .api import constrain, constrain_leading, current_rules, use_rules
from .fault import GroupFailure, RestartReport, run_with_restarts

__all__ = ["GroupFailure", "RestartReport", "api", "collectives",
           "compression", "constrain", "constrain_leading", "current_rules",
           "fault", "run_with_restarts", "seq_decode", "sharding",
           "use_rules"]
