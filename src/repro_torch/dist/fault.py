"""Supervised restarts around a checkpointing training loop.

A copy of the reference's ``dist/fault.py``, which has no framework in it.

``run_with_restarts`` is the single-process supervisor: it invokes the
training callable, and on any exception re-invokes it so the loop's own
checkpoint auto-resume (``repro_torch.launch.train.train_loop`` restores the
latest complete checkpoint and the data pipeline replays from the step
counter) continues the run.  Because checkpoints are atomic and the
pipeline is counter-indexed, the recovered trajectory is bitwise
identical to an uninterrupted run (tested in
``tests/test_torch_train.py``).

``fail_at_step`` injects a one-shot failure into the *first* attempt —
the supervisor strips it from retries, mirroring a transient node loss
rather than a deterministic bug.  After ``max_restarts`` failed retries
the last exception propagates.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["GroupFailure", "RestartReport", "run_with_restarts"]


class GroupFailure(RuntimeError):
    """A device group failed at dispatch or completion time.

    The shared failure type of both fault layers: the *training* path
    treats it like any other exception (``run_with_restarts`` retries
    from the last checkpoint), while the *serving* path recognizes it
    structurally: the reference's ``runtime.ChunkedScheduler`` demotes
    the raising group, re-projects the surviving shares and re-dispatches
    the group's unfinished chunks to survivors (see
    ``docs/resilience.md``).  The port's runtime layer is not there yet;
    the type is here so that both layers share it when it is.
    """


def _accepts_fail_at_step(fn: Callable[..., Any]) -> bool:
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        # not introspectable: fail closed — injecting anyway could raise a
        # TypeError the retry loop would silently absorb
        return False
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               or p.name == "fail_at_step" for p in params)


@dataclass
class RestartReport:
    """What the supervisor observed: total ``attempts`` (including the
    successful one), the failure messages, and the final result."""

    attempts: int
    failures: list[str] = field(default_factory=list)
    result: Any = None


def run_with_restarts(fn: Callable[..., Any], *, max_restarts: int = 3,
                      fail_at_step: int | None = None,
                      **kwargs: Any) -> RestartReport:
    """Run ``fn(**kwargs)`` under restart supervision.

    ``fn`` must be resumable: each invocation should pick up from its own
    durable state (for ``train_loop``, pass ``ckpt_dir``).  Returns a
    :class:`RestartReport`; raises the last exception once
    ``max_restarts`` retries are exhausted.
    """
    if fail_at_step is not None and not _accepts_fail_at_step(fn):
        # injecting into a fn that can't take the kwarg would raise a
        # TypeError that the supervisor dutifully retries without the
        # injection — the recovery path would never actually run
        raise TypeError(
            "fail_at_step injection requires fn to accept a "
            "'fail_at_step' keyword (as train_loop does)")
    failures: list[str] = []
    attempts = 0
    while True:
        attempts += 1
        call_kw = dict(kwargs)
        if attempts == 1 and fail_at_step is not None:
            call_kw["fail_at_step"] = fail_at_step
        try:
            result = fn(**call_kw)
        except Exception as e:  # noqa: BLE001 — supervisor boundary
            failures.append(f"{type(e).__name__}: {e}")
            if attempts > max_restarts:
                raise
            continue
        return RestartReport(attempts=attempts, failures=failures,
                             result=result)
