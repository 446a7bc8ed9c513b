"""Training traffic: one rank's share of a data-parallel pre-training job.

Every step takes ``batch`` fresh rows of ``seq_len + 1`` tokens drawn on
the device from the seed (inputs and next-token labels) and runs the
port's ``launch/steps.py::train_step`` (``LM.loss`` under remat, the
backward, AdamW).  A step ends by reading its loss.

Set-up builds the model and its optimizer state once, from the benchmark's
weights, and drives that same object through its first ``check_steps``
steps through the window's own call and feed: their losses, the first
gradient (from the first moment after one step) and the change of every
parameter after them are what ``check`` holds
against the plain reference, which follows the same steps from the same
weights and rows in float32.  The window then goes on training it.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from gpubench import counts, weights
from gpubench.harness import Check, port_arch
from gpubench.reference import common


def norms(tree: dict) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))
            for n, t in tree.items()}


class Feed:
    """Rows of tokens drawn on the device from the seed, a step at a time."""

    def __init__(self, cell, batch: int, seq_len: int):
        self.gen = torch.Generator(device=cell.device)
        self.gen.manual_seed((cell.seed * 1_000_003 + 1) % 2 ** 63)
        self.shape = (batch, seq_len + 1)
        self.vocab = cell.arch["vocab_size"]
        self.device = cell.device

    def next(self) -> dict:
        x = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                          device=self.device)
        return {"tokens": x[:, :-1].contiguous(),
                "labels": x[:, 1:].contiguous()}


def build(cell):
    """(the port's model on the benchmark's weights, its optimizer state,
    the AdamW configuration)."""
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    leaves = cell.reference.leaves(cell.arch)
    model = LM(port_arch(cell.arch), device="meta")
    model.load_state_dict(weights.make(leaves, cell.seed, cell.device),
                          strict=True, assign=True)
    o = cell.mix["optimizer"]
    opt_cfg = AdamWConfig(learning_rate=o["learning_rate"], b1=o["b1"],
                          b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"],
                          grad_clip=o["grad_clip"])
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    return model, opt, opt_cfg


def step(state: dict, batch: dict) -> dict:
    """One optimizer step of the port on ``batch``: its ``loss`` and
    ``gnorm`` (the gradient's norm before the clip), on the card."""
    from repro_torch.launch import steps
    return steps.train_step(state["model"], state["opt"], batch,
                            state["opt_cfg"], remat=state["remat"])


def program_numbers(state: dict, cell) -> dict:
    """The first ``check_steps`` steps of the program: their losses, the
    first gradient's leaf norms (the first moment after one step is
    (1 - b1) times the clipped gradient; the step's ``gnorm`` gives the
    clip), each leaf's change after them."""
    o = cell.mix["optimizer"]
    first, losses, grads = [], [], {}
    for i in range(cell.mix["check_steps"]):
        batch = state["feed"].next()
        first.append(batch)
        out = step(state, batch)
        losses.append(float(out["loss"]))
        if i == 0:
            clip = min(1.0, o["grad_clip"] / max(float(out["gnorm"]), 1e-12))
            grads = {n: v / (1.0 - o["b1"]) / clip for n, v in
                     norms(state["opt"]["m"]).items()}
    start = weights.make(state["leaves"], cell.seed, cell.device)
    params = dict(state["model"].named_parameters())
    change = {n: float(torch.linalg.vector_norm(
        params[n].detach() - start[n], dtype=torch.float64)) for n in start}
    del start
    return {"batches": first, "losses": losses, "grads": grads,
            "change": change}


def setup(cell) -> dict:
    mix = cell.mix
    model, opt, opt_cfg = build(cell)
    state = {"cell": cell, "model": model, "opt": opt, "opt_cfg": opt_cfg,
             "remat": mix["remat"], "leaves": cell.reference.leaves(cell.arch),
             "feed": Feed(cell, mix["batch"], mix["seq_len"])}
    state["program"] = program_numbers(state, cell)
    return state


def window(state: dict, seconds: float, probe) -> dict:
    cell, mix = state["cell"], state["cell"].mix
    tokens = mix["batch"] * mix["seq_len"]
    flops = counts.train_step_flops(cell.arch, mix["batch"], mix["seq_len"])
    steps = failed = 0
    t0 = time.perf_counter()
    while True:
        with probe.unit(steps, flops):
            loss = float(step(state, state["feed"].next())["loss"])
        steps += 1
        failed += not math.isfinite(loss)
        if time.perf_counter() - t0 >= seconds and not probe.traced(steps):
            break
    elapsed = time.perf_counter() - t0
    return {"attempted": steps, "failed": failed,
            "metrics": {"train_tokens_per_s": steps * tokens / elapsed}}


def reference_numbers(cell, batches: list, quant=None) -> dict:
    """The plain reference's steps on the same weights and rows."""
    ref, arch, opt = cell.reference, cell.arch, cell.mix["optimizer"]
    leaves = cell.reference.leaves(arch)
    with common.exact_float32():
        params = {n: t.requires_grad_() for n, t in
                  weights.make(leaves, cell.seed, cell.device).items()}
        adam: dict = {}
        losses, grads = [], {}
        for i, batch in enumerate(batches):
            loss = ref.loss(params, batch["tokens"], batch["labels"], arch,
                            quant)
            loss.backward()
            with torch.no_grad():
                g = {n: p.grad for n, p in params.items()}
                out = common.adamw_step(params, g, adam, opt)
            if i == 0:
                grads = norms(g)
            del out, g
            for p in params.values():
                p.grad = None
            losses.append(float(loss.detach()))
        del adam
        start = weights.make(leaves, cell.seed, cell.device)
        change = {n: float(torch.linalg.vector_norm(
            params[n].detach() - start[n], dtype=torch.float64))
            for n in start}
    return {"losses": losses, "grads": grads, "change": change}


def compare(prog: dict, ref: dict, limits: dict) -> list[Check]:
    """The first step's loss (relative gap); the first gradient before
    the clip and each parameter's change after the checked steps, by the
    median leaf (``common.leaf_gaps``).  Leaves whose reference gradient
    is under a thousandth of the median leaf's move by round-off alone and
    are left out of the change.

    Why these and not every step's loss, the clipped gradient, or the
    worst leaf: the gradients of RWKV-6's bonus ``u`` and of ``W_r``,
    ``W_k`` nearly cancel (the group norm after the recurrence is blind
    to the bonus term's scale), so any bf16 run reads those leaves many
    times off; they swing the global norm, and through the clip every
    leaf by one factor; and Adam's first steps move each weight by about
    the learning rate along its gradient's sign, so where rounding flips a
    sign the runs part, and later losses differ by the same in float32.
    PERF.md has the readings."""
    loss = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    grad = common.median(list(common.leaf_gaps(prog["grads"],
                                               ref["grads"]).values()))
    med = common.median(list(ref["grads"].values()))
    moved = [n for n, v in ref["grads"].items() if v >= 1e-3 * med]
    change = common.median(list(common.leaf_gaps(
        prog["change"], ref["change"], moved).values()))
    return [Check("loss_rel", loss, limits["loss_rel"]),
            Check("grad_gap_median", grad, limits["grad_gap_median"]),
            Check("update_gap_median", change, limits["update_gap_median"])]


def free(state: dict) -> None:
    """Drop the program's model and optimizer state."""
    for key in ("model", "opt"):
        state.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(state: dict) -> list[Check]:
    cell = state["cell"]
    free(state)
    ref = reference_numbers(cell, state["program"]["batches"])
    return compare(state["program"], ref, cell.workload["limits"])
