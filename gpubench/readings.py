"""The readings a cell's correctness limits are set from, at the cell's
own size, many seeds in one process:

  program   the port as the cell runs it, against the float32 reference
            (``--compute-dtype float32``: the port's products in float32,
            a witness for the kernels apart from bf16 rounding)
  control   the reference one precision below the configuration's bf16
            (every product's operands in float8), against the reference
  <fault>   the port with its timed path broken (``FAULTS``)

    python3 gpubench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults half_batch] [--out FILE]

Each reading is one JSON line: its kind, seed and every number ``check``
compares.  Training needs no window; prefill serves the first cycle of
the cell's batches.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from gpubench import harness  # noqa: E402


class _Cycle:
    """A probe that keeps the window serving until ``n`` units ran."""

    def __init__(self, n: int):
        self.n = n

    def unit(self, i, flops=0.0):
        return contextlib.nullcontext()

    def traced(self, i):
        return i < self.n


# -- faults: the timed path broken underneath ---------------------------------------

@contextlib.contextmanager
def half_batch():
    """Training: the step sees the first half of its rows only (the mean
    taken over them).  Prefill: the first half of a batch's rows are
    served, and the rest get the first row's answers."""
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM

    train_step, prefill = steps.train_step, LM.prefill

    def short_step(model, opt, batch, *a, **k):
        rows = next(iter(batch.values())).shape[0]
        return train_step(model, opt, {n: v[:max(rows // 2, 1)]
                                       for n, v in batch.items()}, *a, **k)

    def short_prefill(self, tokens, **k):
        rows = tokens.shape[0]
        half = max(rows // 2, 1)
        logits, states = prefill(self, tokens[:half], **k)
        pick = torch.cat([torch.arange(half), torch.zeros(rows - half,
                                                          dtype=torch.long)])
        pick = pick.to(logits.device)
        states = [{n: t[pick] if torch.is_tensor(t) else t
                   for n, t in st.items()} for st in states]
        return logits[pick], states

    steps.train_step, LM.prefill = short_step, short_prefill
    try:
        yield
    finally:
        steps.train_step, LM.prefill = train_step, prefill


@contextlib.contextmanager
def token_altered():
    """Prefill: each served first token replaced by the next id."""
    from repro_torch.models.lm import LM

    prefill = LM.prefill

    def altered(self, tokens, **k):
        logits, states = prefill(self, tokens, **k)
        top = logits.argmax(-1, keepdim=True)
        # the next id gets the best logit: the argmax moves by one
        logits = logits.scatter(-1, (top + 1) % logits.shape[-1],
                                logits.amax(-1, keepdim=True) + 1.0)
        return logits, states

    LM.prefill = altered
    try:
        yield
    finally:
        LM.prefill = prefill


@contextlib.contextmanager
def state_unchanged():
    """Training: the step returns the parameters and moments unchanged."""
    from repro_torch.launch import steps

    train_step = steps.train_step

    def frozen(model, opt, batch, *a, **k):
        saved = {n: p.detach().clone() for n, p in model.named_parameters()}
        moments = {w: {n: m.clone() for n, m in opt[w].items()}
                   for w in ("m", "v")}
        out = train_step(model, opt, batch, *a, **k)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n])
            for w in ("m", "v"):
                for n, m in opt[w].items():
                    m.copy_(moments[w][n])
        return out

    steps.train_step = frozen
    try:
        yield
    finally:
        steps.train_step = train_step


FAULTS = {"half_batch": half_batch, "token_altered": token_altered,
          "state_unchanged": state_unchanged}


# -- readings -------------------------------------------------------------------------

def train_readings(cell, kind, control: bool, fault=None) -> list[dict]:
    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        state = kind.setup(cell)
    prog = state["program"]
    kind.free(state)
    ref = kind.reference_numbers(cell, prog["batches"])
    out = [{"kind": fault or "program", **_train_numbers(kind, cell, prog,
                                                        ref)}]
    if control:
        low = kind.reference_numbers(cell, prog["batches"], "fp8")
        out.append({"kind": "control", **_train_numbers(kind, cell, low,
                                                        ref)})
    return out


def _train_numbers(kind, cell, prog: dict, ref: dict) -> dict:
    """The compared numbers, and beside them (``worst_*``) the numbers
    they stand in for: every step's loss, the worst leaf."""
    from gpubench.reference import common
    out = {c.name: c.value for c in kind.compare(prog, ref,
                                                 cell.workload["limits"])}
    grads = common.leaf_gaps(prog["grads"], ref["grads"])
    change = common.leaf_gaps(prog["change"], ref["change"])
    out["worst_loss_rel"] = max(abs(p - r) / abs(r) for p, r in
                                zip(prog["losses"], ref["losses"]))
    out["worst_grad_leaf"] = max(grads.items(), key=lambda kv: kv[1])
    out["worst_change_leaf"] = max(change.items(), key=lambda kv: kv[1])
    return out


def prefill_readings(cell, kind, control: bool, fault=None) -> list[dict]:
    model = kind.build(cell)
    batches, sample = kind.plan(cell)
    state = {"cell": cell, "model": model, "batches": batches,
             "sample": sample, "kept": {}}
    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        kind.window(state, 0.0, _Cycle(len(batches)))
    kind.free(state)
    p = kind.reference_weights(cell)
    prog, low = [], []
    for b, row in sample:
        logits, states, hidden = kind.reference_outputs(cell, p,
                                                        batches[b][row])
        prog.append(kind.compare_one(state["kept"][(b, row)], logits,
                                     states))
        if control:
            # the control need not decode: its gap is read at every
            # position of the prompt, of the token it puts first there
            lq, sq, hq = kind.reference_outputs(cell, p, batches[b][row],
                                                "fp8")
            low.append({**kind.compare_one(kind.as_program(lq, sq), logits,
                                           states),
                        "logit_gap_every_position": kind.widest_gap(
                            cell, p, hidden, hq, "fp8")})
            del lq, sq, hq
        del logits, states, hidden
    out = [{"kind": fault or "program", **kind.worst(prog)}]
    if control:
        out.append({"kind": "control", **kind.worst(low)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default=None)
    args = ap.parse_args(argv)
    bench = harness.read_json(ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    sink = open(args.out, "a") if args.out else None
    runs = [(s, None) for s in seeds] + [(s, f) for f in faults
                                        for s in sorted(controls)]
    for seed, fault in runs:
        t0 = time.time()
        cell, kind = harness.load_cell(bench, args.workload, seed,
                                       args.device)
        if args.compute_dtype:
            cell.config["arch"]["compute_dtype"] = args.compute_dtype
        read = train_readings if cell.mix["kind"] == "train" \
            else prefill_readings
        rows = read(cell, kind, fault is None and seed in controls, fault)
        for row in rows:
            if args.compute_dtype and row["kind"] == "program":
                row["kind"] = f"program_{args.compute_dtype}"
            row.update(seed=seed, seconds=time.time() - t0)
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
