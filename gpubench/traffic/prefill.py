"""Prefill traffic: an offline long-context evaluation (RULER's mix), the
prompt phase alone, served in a closed loop one batch at a time.

RULER evaluates every task at a set of lengths with the same number of
samples at each.  The mix lists those ``lengths``; a prompt is a length
less ``answer_tokens``, which leave its answer room within the length.  A
batch holds the prompts of one length that fit in ``batch_tokens``
(``batch_tokens // length`` rows), and a cycle serves
``requests_per_length`` requests of every length, so a length's batches
in a cycle are as many as its rows divide that number.  The cycle's order
is fixed (``order``); the seed draws the tokens and the sample that
``check`` compares.  Per batch: ``LM.prefill(tokens, max_len=prompt +
1)``, the argmax of the last position's logits, and that first token
copied to the host.

``check`` holds a sample of the window's first cycle against the plain
reference, run once over each sampled prompt: one batch of each length
drawn from the seed, its first, middle and last rows.  For each: how far
the served token's logit lies below the reference's best, the last
position's logits, and every state the prefill wrote (a KV cache's keys
and values up to the prompt's end).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from gpubench import counts, weights
from gpubench.harness import Check, port_arch
from gpubench.reference import common


def shapes(mix: dict) -> list[tuple[int, int, int]]:
    """(rows, prompt length, batches a cycle) of each length."""
    out = []
    for length in mix["lengths"]:
        rows = max(mix["batch_tokens"] // length, 1)
        out.append((rows, length - mix["answer_tokens"],
                    max(mix["requests_per_length"] // rows, 1)))
    return out


def order(counts_: list[int]) -> list[int]:
    """The cycle's batches as indices of their length: a length with
    ``c`` batches places its k-th at (k + 1/2) / c of the cycle, so every
    stretch of the cycle holds its share of each length.  The same for
    every seed, so that where the window ends within a cycle does not
    change with the seed."""
    slots = [((k + 0.5) / c, j) for j, c in enumerate(counts_)
             for k in range(c)]
    return [j for _, j in sorted(slots)]


def build(cell):
    from repro_torch.models.lm import LM

    leaves = cell.reference.leaves(cell.arch, serving=True)
    model = LM(port_arch(cell.arch), device="meta")
    model.load_state_dict(weights.make(leaves, cell.seed, cell.device),
                          strict=True, assign=True)
    return model.cast_for_serving()


def serve(model, tokens: torch.Tensor):
    """One batch: (first tokens on the host, last logits, decode state)."""
    logits, states = model.prefill(tokens, max_len=tokens.shape[1] + 1)
    first = logits[:, -1].argmax(-1)
    return first.cpu(), logits, states


def plan(cell) -> tuple[list[torch.Tensor], list[tuple[int, int]]]:
    """The cycle's batches of tokens, and the sampled (batch, row) pairs."""
    mix = cell.mix
    sh = shapes(mix)
    gen = torch.Generator()
    gen.manual_seed(cell.seed)
    dev_gen = torch.Generator(device=cell.device)
    dev_gen.manual_seed((cell.seed * 1_000_003 + 2) % 2 ** 63)
    batches, of_length = [], []
    for j in order([c for _, _, c in sh]):
        rows, prompt, _ = sh[j]
        batches.append(torch.randint(0, cell.arch["vocab_size"],
                                     (rows, prompt), generator=dev_gen,
                                     device=cell.device))
        of_length.append(j)
    sample = []
    for j in range(len(sh)):
        mine = [b for b, jj in enumerate(of_length) if jj == j]
        b = mine[int(torch.randint(len(mine), (1,), generator=gen))]
        rows = batches[b].shape[0]
        sample += [(b, r) for r in sorted({0, rows // 2, rows - 1})]
    return batches, sample


def setup(cell) -> dict:
    model = build(cell)
    batches, sample = plan(cell)
    # the largest batch alone: on the card the first cycle's batches of
    # every other shape then take as long as later ones (PERF.md)
    serve(model, max(batches, key=lambda t: t.numel() * t.shape[1]))
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    return {"cell": cell, "model": model, "batches": batches,
            "sample": sample, "kept": {}}


def keep(state: dict, b: int, first, logits, states) -> None:
    """The sampled rows' outputs of batch ``b``: served token, last
    logits, and each layer's state (a cache cut to the prompt)."""
    length = state["batches"][b].shape[1]
    for bb, row in state["sample"]:
        if bb != b:
            continue
        layers = []
        for st in states:
            mine = {}
            for key, t in st.items():
                if not torch.is_tensor(t):
                    continue
                t = t[row]
                mine[key] = (t[:length] if key in ("k", "v") else t).clone()
            layers.append(mine)
        state["kept"][(b, row)] = {"token": int(first[row]),
                                   "logits": logits[row, -1].float().clone(),
                                   "states": layers}


def window(state: dict, seconds: float, probe) -> dict:
    """Serves batches in the cycle's order until ``seconds`` have passed
    and the first cycle is done: the prompt tokens of every batch whose
    first tokens reached the host, over the time."""
    cell, model, batches = state["cell"], state["model"], state["batches"]
    sampled = {b for b, _ in state["sample"]}
    requests = tokens = 0
    i = 0
    t0 = time.perf_counter()
    while True:
        b = i % len(batches)
        rows, length = batches[b].shape
        with probe.unit(i, counts.prefill_flops(cell.arch, rows, length)):
            first, logits, states = serve(model, batches[b])
        requests += rows
        tokens += rows * length
        if i < len(batches) and b in sampled:
            keep(state, b, first, logits, states)
        del logits, states
        i += 1
        if (time.perf_counter() - t0 >= seconds and i >= len(batches)
                and not probe.traced(i)):
            break
    elapsed = time.perf_counter() - t0
    return {"attempted": requests, "failed": 0,
            "metrics": {"prefill_tokens_per_s": tokens / elapsed}}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def compare_one(prog: dict, ref_logits: torch.Tensor,
                ref_states: list) -> dict:
    """One request's readings: the served token's gap below the
    reference's best, the logits' and the worst state's relative
    distance."""
    ref_logits = ref_logits.double()
    gap = float(ref_logits.max() - ref_logits[prog["token"]])
    worst = 0.0
    for mine, theirs in zip(prog["states"], ref_states):
        for key, t in theirs.items():
            worst = max(worst, rel(mine[key], t[0]))
    return {"logit_gap": gap, "logits_rel": rel(prog["logits"], ref_logits),
            "state_rel": worst}


def reference_weights(cell) -> dict:
    return weights.make(cell.reference.leaves(cell.arch, serving=True),
                        cell.seed, cell.device)


def reference_outputs(cell, p: dict, tokens: torch.Tensor, quant=None):
    """(last logits (V,), states, final hidden states (T, D)) of the
    reference over one prompt."""
    with common.exact_float32():
        logits, states, hidden = cell.reference.prefill(
            p, tokens[None], cell.arch, quant)
    return logits[0], states, hidden[0]


def widest_gap(cell, p: dict, hidden: torch.Tensor, low: torch.Tensor,
               quant: str, rows: int = 1024) -> float:
    """At every position, how far the reference's logit of the token that
    ``low`` (a lower-precision run's hidden states) puts first lies below
    the reference's best: the widest, over the prompt."""
    worst = 0.0
    with common.exact_float32():
        for i in range(0, hidden.shape[0], rows):
            ref = cell.reference.logits(p, hidden[i:i + rows], cell.arch)
            top = cell.reference.logits(p, low[i:i + rows], cell.arch,
                                        quant).argmax(-1, keepdim=True)
            gap = ref.amax(-1) - ref.gather(-1, top)[:, 0]
            worst = max(worst, float(gap.max()))
    return worst


def as_program(logits: torch.Tensor, states: list) -> dict:
    """A reference run's outputs in the shape ``keep`` stores the
    program's (the control's readings compare them alike)."""
    return {"token": int(logits.argmax()), "logits": logits,
            "states": [{k: t[0] for k, t in st.items()} for st in states]}


def worst(readings: list[dict]) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def free(state: dict) -> None:
    state.pop("model", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: dict) -> list[Check]:
    cell, limits = state["cell"], state["cell"].workload["limits"]
    free(state)
    p = reference_weights(cell)
    readings = []
    for b, row in state["sample"]:
        prog = state["kept"].get((b, row))
        if prog is None:             # never served in the window
            readings.append({"logit_gap": math.inf, "logits_rel": math.inf,
                             "state_rel": math.inf})
            continue
        logits, states, _ = reference_outputs(cell, p,
                                              state["batches"][b][row])
        readings.append(compare_one(prog, logits, states))
        del logits, states
    w = worst(readings)
    return [Check(name, w[name], limits[name])
            for name in ("logit_gap", "logits_rel", "state_rel")]
