"""Validate saved obs artifacts against the checked-in schema.

CI's obs-smoke job runs a scripted fault drill through
``launch/serve.py --stream --fault-plan ... --trace-out --journal-out``
and then calls::

    python -m repro_torch.obs --trace trace.json --journal journal.jsonl \
        --schema docs/obs_schema.json \
        --require group_demoted,chunks_redispatched,killswitch_tripped

which checks (a) both files parse, (b) every event satisfies the
structural schema, (c) the journal's event kinds all appear in the
schema catalog (so the checked-in file cannot drift silently from
``EVENT_KINDS``), and (d) the ``--require`` kinds each occur at least
once and their *first* occurrences are in the given order — the causal
assertion "the demotion preceded the re-dispatch preceded the guard
trip" as an exit code.

``--wal wal.jsonl`` additionally validates a write-ahead request log
(``runtime.checkpoint``): every record parses with a matching CRC and a
dense LSN (a torn tail is an error here — the engine truncates it on
reopen, so a *post-recovery* WAL must be clean), no request retires
twice, and with ``--wal-complete`` every admitted request has a
terminal retire record — the crash drill's "no request lost, none
double-retired" assertion as an exit code.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .journal import EVENT_KINDS, load_journal, validate_events
from .trace import load_trace, validate_trace


def _load_schema(path: str | None) -> dict:
    if path is None:
        return {}
    return json.loads(Path(path).read_text())


def check_required_order(events: list[dict], kinds: list[str]) -> list[str]:
    """Errors when any kind is absent or first occurrences are out of order."""
    errors = []
    first = {}
    for ev in events:
        k = ev.get("kind")
        if k in kinds and k not in first:
            first[k] = ev.get("seq", len(first))
    prev = None
    for k in kinds:
        if k not in first:
            errors.append(f"required journal event {k!r} never occurred")
            continue
        if prev is not None and first[k] < first[prev]:
            errors.append(f"causal order violated: first {k!r} (seq "
                          f"{first[k]}) precedes first {prev!r} "
                          f"(seq {first[prev]})")
        prev = k
    return errors


def check_wal(path: str, *, complete: bool = False) -> tuple[list[str], dict]:
    """(errors, stats) of a write-ahead request log.

    Structural: every line parses, CRCs match, LSNs are dense (the
    reader stops at the first bad line, so a surviving torn tail shows
    up as ``torn``).  Semantic: at most one valid retire per request id;
    with ``complete=True`` every admitted id must also retire — the
    crash-drill accounting invariant.
    """
    from ..runtime.checkpoint import read_wal
    errors: list[str] = []
    records, torn = read_wal(path)
    if torn is not None:
        errors.append(f"torn tail at line {torn['line']} "
                      f"({torn['reason']}); run the engine once with "
                      "--resume to truncate it")
    admits: set[int] = set()
    retired: dict[int, int] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "admit":
            admits.add(rec["rid"])
        elif kind == "retire":
            rid = rec["rid"]
            if rid in retired:
                errors.append(f"request {rid} retired twice "
                              f"(lsn {retired[rid]} and {rec['lsn']})")
            else:
                retired[rid] = rec["lsn"]
    ghost = set(retired) - admits
    if ghost:
        errors.append(f"retired but never admitted: {sorted(ghost)[:8]}")
    if complete:
        lost = admits - set(retired)
        if lost:
            errors.append(f"admitted but never retired (lost): "
                          f"{sorted(lost)[:8]} "
                          f"({len(lost)}/{len(admits)})")
    stats = {"records": len(records), "admitted": len(admits),
             "retired": len(retired), "torn": torn is not None}
    return errors, stats


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="validate trace/journal artifacts against the schema")
    ap.add_argument("--trace", help="Chrome-trace JSON file to validate")
    ap.add_argument("--journal", help="decision-journal JSONL file to validate")
    ap.add_argument("--schema", default=None,
                    help="checked-in schema (docs/obs_schema.json)")
    ap.add_argument("--require", default=None,
                    help="comma-separated journal kinds that must occur, "
                         "first occurrences in this causal order")
    ap.add_argument("--wal", help="write-ahead request log (JSONL) to "
                    "validate: CRCs, dense LSNs, no double retire")
    ap.add_argument("--wal-complete", action="store_true",
                    help="with --wal: every admitted request must have "
                    "a terminal retire record (post-recovery accounting)")
    args = ap.parse_args(argv)
    if not args.trace and not args.journal and not args.wal:
        ap.error("nothing to validate: pass --trace, --journal "
                 "and/or --wal")

    schema = _load_schema(args.schema)
    errors: list[str] = []

    if args.trace:
        events = load_trace(args.trace)
        errors += [f"trace: {e}" for e in validate_trace(events)]
        want_phases = schema.get("trace", {}).get("phases")
        if want_phases:
            seen = {e.get("ph") for e in events if isinstance(e, dict)}
            extra = seen - set(want_phases)
            if extra:
                errors.append(f"trace: phases {sorted(extra)} not in schema")
        print(f"[obs] trace   {args.trace}: {len(events)} events")

    if args.journal:
        events = load_journal(args.journal)
        known = frozenset(schema.get("journal", {}).get("kinds") or EVENT_KINDS)
        # the checked-in catalog and the code catalog must agree exactly
        if schema.get("journal", {}).get("kinds") is not None \
                and known != EVENT_KINDS:
            errors.append(
                "journal: schema kinds differ from EVENT_KINDS "
                f"(schema-only: {sorted(known - EVENT_KINDS)}, "
                f"code-only: {sorted(EVENT_KINDS - known)})")
        errors += [f"journal: {e}" for e in validate_events(events, known)]
        if args.require:
            kinds = [k.strip() for k in args.require.split(",") if k.strip()]
            errors += [f"journal: {e}"
                       for e in check_required_order(events, kinds)]
        by_kind: dict[str, int] = {}
        for ev in events:
            by_kind[ev.get("kind", "?")] = by_kind.get(ev.get("kind", "?"), 0) + 1
        summary = "  ".join(f"{k}×{n}" for k, n in sorted(by_kind.items()))
        print(f"[obs] journal {args.journal}: {len(events)} events  {summary}")

    if args.wal:
        wal_errors, stats = check_wal(args.wal, complete=args.wal_complete)
        errors += [f"wal: {e}" for e in wal_errors]
        print(f"[obs] wal     {args.wal}: {stats['records']} records  "
              f"{stats['admitted']} admitted  {stats['retired']} retired")

    if errors:
        for e in errors:
            print(f"[obs] ERROR {e}", file=sys.stderr)
        return 1
    print("[obs] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
