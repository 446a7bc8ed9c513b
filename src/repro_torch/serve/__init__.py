"""repro_torch.serve: request-level serving above the chunked scheduler.

The runtime (``repro_torch.runtime``) moves *batches*; real serving moves
*requests* — they arrive whenever they arrive, carry deadlines and
priorities, and the system's job is to keep the admitted latency
distribution inside the SLO while shedding what it cannot serve.  This
package is that layer, built as four small pieces:

  * :mod:`~repro_torch.serve.request` — the request lifecycle state machine
    and the deterministic (seeded, ``VirtualClock``-friendly) arrival
    source;
  * :mod:`~repro_torch.serve.admission` — SLO-aware admission, load shedding
    and bounded retry (the documented policy: queue backpressure,
    degraded-mode priority shedding, deadline feasibility on a live
    EWMA service estimate);
  * :mod:`~repro_torch.serve.batcher` — continuous batching (join
    mid-stream, retire per-request) with the three knobs exposed as a
    ``ConfigSpace`` tuned through the paper's ``TuningSession``;
  * :mod:`~repro_torch.serve.engine` — the run loop binding source ->
    admission -> batcher -> scheduler/guard, instrumented through
    ``repro_torch.obs``, plus the shared sim rig (``make_sim_engine``).

Everything is wall-clock independent under the sim rig: the same seed
and fault plan journal the same decision sequence on any machine.
``docs/serving.md`` documents the policies and the latency anatomy.
The package is framework-free: the JAX package's modules of the same
names, re-homed onto this package's runtime; on the sim rig both write
the same journals and write-ahead logs byte for byte.
"""

from .admission import (AdmissionController, ServiceEstimator,  # noqa: F401
                        SHED_REASONS, SloPolicy)
from .batcher import (BatcherConfig, ContinuousBatcher,  # noqa: F401
                      FormedBatch, batcher_space, tune_batcher)
from .engine import ServeEngine, make_sim_engine  # noqa: F401
from .request import (Request, RequestClass, RequestSource,  # noqa: F401
                      REQUEST_STATES)

__all__ = [
    "AdmissionController", "ServiceEstimator", "SloPolicy", "SHED_REASONS",
    "BatcherConfig", "ContinuousBatcher", "FormedBatch", "batcher_space",
    "tune_batcher",
    "ServeEngine", "make_sim_engine",
    "Request", "RequestClass", "RequestSource", "REQUEST_STATES",
]
