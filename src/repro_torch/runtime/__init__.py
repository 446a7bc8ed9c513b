"""Online work-distribution runtime: the paper's tuner made live.

The offline layer (``repro_torch.core``) finds a near-optimal static
work split with SAML; this package keeps the loop closed at run time:

``scheduler`` — chunked online dispatch.
    :class:`~repro_torch.runtime.scheduler.ChunkedScheduler` splits each
    batch into device-aligned chunks, overlaps dispatch across N
    ``DeviceGroup``s (double-buffered, bounded in-flight depth) and
    rebalances the split from measured per-chunk times via
    :func:`~repro_torch.runtime.scheduler.ewma_rebalance` — the N-group
    generalization of ``proportional_rebalance``.

``feedback`` — online surrogate refits.
    :class:`~repro_torch.runtime.feedback.OnlineSurrogateLoop` appends
    live (config, time) observations and warm-refits the BDTR pair in
    place (``fit_more`` + incremental hist binning), so the next
    ``saml`` searches a surrogate grounded in live data.

``store`` — persistent tuning cache.
    :class:`~repro_torch.runtime.store.TuningStore` keys recorded
    ``TuneResult``s by workload signature (space hash + shapes + device
    topology); ``repro_torch.tune.TuningSession(store=...)`` serves
    repeated workloads with zero new measurements.

``stream`` — streaming pipeline.
    :class:`~repro_torch.runtime.stream.StreamingPipeline` drives a
    stream of batches with overlapped transfer/compute per chunk (a side
    copy stream and events on the card, a worker thread on the host);
    ``dna_stream_builder`` is the paper's motif-count step, and
    ``launch/serve.py`` uses the pipeline for its ``--stream`` modes.

``guard`` — kill-switch guardrail.
    :class:`~repro_torch.runtime.guard.ServeGuard` watches the realized
    step-time trajectory through a
    :class:`~repro_torch.runtime.guard.KillSwitch` and pins the last
    known-good static split when the online controller regresses,
    re-arming after a cool-down probe.

``simulate`` — deterministic sims, clocks and fault injection.
    :class:`~repro_torch.runtime.simulate.VirtualClock` +
    :class:`~repro_torch.runtime.simulate.FaultPlan` /
    :class:`~repro_torch.runtime.simulate.FaultInjector` script failures
    (kill/slow/transient/recover, plus process-level crash/torn)
    against the serial-device sim or real dispatch, deterministically.

``checkpoint`` — crash durability.
    :class:`~repro_torch.runtime.checkpoint.WalWriter` appends a CRC'd
    write-ahead request log that survives ``kill -9`` and truncates
    torn tails on reopen; :func:`~repro_torch.runtime.checkpoint.save_snapshot`
    / :func:`~repro_torch.runtime.checkpoint.load_snapshot` checkpoint
    soft state with checksums (corruption quarantines via
    :func:`~repro_torch.runtime.checkpoint.quarantine` instead of
    crashing); :class:`~repro_torch.runtime.checkpoint.MeasurementLedger`
    makes tuning runs resumable — a crashed search replays its measured
    prefix from the ledger instead of re-spending the budget.
"""

from .checkpoint import (MeasurementLedger, SimulatedCrash, WalWriter,
                         load_snapshot, quarantine, read_wal, save_snapshot)
from .feedback import OnlineSurrogateLoop
from .guard import KillSwitch, ServeGuard, fallback_from_store
from .scheduler import ChunkedScheduler, EwmaController, ewma_rebalance
from .simulate import (FaultInjector, FaultPlan, GroupFailure, VirtualClock,
                       make_serial_sim_builder, parse_fault_plan,
                       sim_skew_groups)
from .store import TuningStore, space_fingerprint, workload_signature
from .stream import StreamingPipeline, dna_stream_builder

__all__ = [
    "ChunkedScheduler", "EwmaController", "ewma_rebalance",
    "KillSwitch", "ServeGuard", "fallback_from_store",
    "MeasurementLedger", "SimulatedCrash", "WalWriter",
    "load_snapshot", "quarantine", "read_wal", "save_snapshot",
    "FaultInjector", "FaultPlan", "GroupFailure", "VirtualClock",
    "make_serial_sim_builder", "parse_fault_plan", "sim_skew_groups",
    "OnlineSurrogateLoop",
    "TuningStore", "space_fingerprint", "workload_signature",
    "StreamingPipeline", "dna_stream_builder",
]
