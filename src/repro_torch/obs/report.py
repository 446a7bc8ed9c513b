"""Render an observed run into a human summary + ``obs_summary.json``.

One :class:`~repro_torch.obs.Observer` accumulates three views of a run —
trace spans, metric handles, journal events.  This module folds them
into a single machine-readable summary (written as
``obs_summary.json`` by ``launch/serve.py --metrics-out``) and a short
text rendering for the terminal:

  * every counter and gauge verbatim;
  * every histogram as count / mean / p50 / p95 / p99 (the latency-
    percentile accounting the serving front end needs);
  * journal event counts by kind, plus the full ordered event list
    (the summary is self-contained: a CI artifact reader needs no
    second file to see what decisions the run took);
  * trace size (the spans themselves stay in the trace file);
  * a provenance ``meta`` block (:mod:`repro_torch.obs.provenance`).
"""

from __future__ import annotations

import json
from pathlib import Path

from .provenance import build_meta

__all__ = ["render", "summarize", "write_summary"]


def summarize(observer, *, extra: dict | None = None,
              date: str | None = None, events: bool = True) -> dict:
    """JSON-ready summary of everything the observer accumulated."""
    out = {
        "meta": build_meta(date),
        "metrics": observer.metrics.to_dict(),
        "journal": {
            "n_events": len(observer.journal),
            "by_kind": observer.journal.kinds(),
        },
        "trace": {"n_events": len(observer.tracer)},
    }
    if events:
        out["journal"]["events"] = list(observer.journal.events)
    if extra:
        out.update(extra)
    return out


def render(summary: dict) -> str:
    """Terminal rendering of a :func:`summarize` dict."""
    lines = ["== obs summary =="]
    meta = summary.get("meta", {})
    sha = (meta.get("git_sha") or "?")[:12]
    lines.append(f"commit {sha}  torch {meta.get('torch', '?')}  "
                 f"cuda {meta.get('cuda') or '-'}  "
                 f"driver {meta.get('driver') or '-'}  "
                 f"device {meta.get('device_name') or 'cpu'}")
    m = summary.get("metrics", {})
    for name, v in m.get("counters", {}).items():
        lines.append(f"counter   {name} = {v}")
    for name, v in m.get("gauges", {}).items():
        lines.append(f"gauge     {name} = {v}")
    for name, h in m.get("histograms", {}).items():
        if h.get("count"):
            lines.append(
                f"histogram {name}: n={h['count']} mean={h['mean']:.6f} "
                f"p50={h['p50']:.6f} p95={h['p95']:.6f} p99={h['p99']:.6f}")
        else:
            lines.append(f"histogram {name}: empty")
    by_kind = summary.get("journal", {}).get("by_kind", {})
    if by_kind:
        kinds = "  ".join(f"{k}×{n}" for k, n in sorted(by_kind.items()))
        lines.append(f"journal   {kinds}")
    lines.append(f"trace     {summary.get('trace', {}).get('n_events', 0)} "
                 "events")
    return "\n".join(lines)


def write_summary(observer, path, *, extra: dict | None = None,
                  date: str | None = None) -> dict:
    """Write ``obs_summary.json``; returns the summary dict."""
    summary = summarize(observer, extra=extra, date=date)
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1, default=str) + "\n")
    return summary
