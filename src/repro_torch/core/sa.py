"""Simulated Annealing over discrete config spaces.

Faithful implementation of the paper's algorithm (Fig. 3):

    T <- initial temperature; s <- random config
    while T > T_min:
        s' <- neighbor(s)
        if E(s') < E(s): accept
        else: accept with p = exp((E - E') / T)       (Eq. 4)
        T <- T * (1 - coolingRate)                    (Eq. 3)

Two engines are provided:

  * ``simulated_annealing`` — the reference scalar chain.  One energy
    evaluation per iteration; this is what the paper runs, and what SAM /
    SAML wrap (with a measurement or an ML model as ``energy_fn``).
  * ``vectorized_sa`` — beyond-paper: many independent chains advanced in
    lockstep, all chains one tensor, with a batched energy function (e.g.
    the packed BDTR predictor).  One surrogate call scores every chain's
    proposal per iteration instead of one measurement per iteration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .. import resolve_device
from .space import ConfigSpace

__all__ = ["SAResult", "SASchedule", "simulated_annealing", "vectorized_sa"]


@dataclass(frozen=True)
class SASchedule:
    """Annealing schedule — the paper's geometric cooling (Eq. 3)."""

    initial_temp: float = 10.0
    cooling_rate: float = 0.003
    min_temp: float = 1e-4
    # Normalise acceptance by the initial energy so the schedule does not
    # depend on the absolute scale of the objective (seconds vs ms).
    relative_energy: bool = True

    def n_iterations(self) -> int:
        """Iterations until T < min_temp under geometric cooling."""
        return int(
            math.ceil(
                math.log(self.min_temp / self.initial_temp)
                / math.log(1.0 - self.cooling_rate)
            )
        )

    @staticmethod
    def for_iterations(n: int, initial_temp: float = 10.0,
                       min_temp: float = 1e-4) -> "SASchedule":
        """Pick the cooling rate so the chain runs ~n iterations (paper's
        'we can adjust the number of iterations ... by adjusting the cooling
        function')."""
        rate = 1.0 - (min_temp / initial_temp) ** (1.0 / max(n, 1))
        return SASchedule(initial_temp=initial_temp, cooling_rate=rate,
                          min_temp=min_temp)


@dataclass
class SAResult:
    best_config: dict
    best_energy: float
    n_iterations: int
    n_evaluations: int
    # history rows: (iteration, current_energy, best_energy, temperature)
    history: list[tuple[int, float, float, float]] = field(default_factory=list)
    # best-so-far (energy, config) sampled at requested checkpoints
    checkpoints: dict[int, tuple[float, dict]] = field(default_factory=dict)


def simulated_annealing(
    space: ConfigSpace,
    energy_fn: Callable[[Mapping[str, Any]], float],
    *,
    schedule: SASchedule = SASchedule(),
    seed: int = 0,
    initial: Mapping[str, Any] | None = None,
    max_iterations: int | None = None,
    checkpoint_at: Sequence[int] = (),
    record_history: bool = False,
) -> SAResult:
    """Reference scalar SA chain (the paper's algorithm)."""
    rng = np.random.default_rng(seed)
    cur = dict(initial) if initial is not None else space.random(rng)
    space.validate(cur)
    cur_e = float(energy_fn(cur))
    best, best_e = dict(cur), cur_e
    scale = abs(cur_e) if (schedule.relative_energy and cur_e) else 1.0

    t = schedule.initial_temp
    n_evals = 1
    it = 0
    history: list[tuple[int, float, float, float]] = []
    checkpoints: dict[int, float] = {}
    checkpoint_set = set(int(c) for c in checkpoint_at)
    limit = max_iterations if max_iterations is not None else schedule.n_iterations()

    while t > schedule.min_temp and it < limit:
        cand = space.neighbor(cur, rng)
        cand_e = float(energy_fn(cand))
        n_evals += 1
        if cand_e < cur_e:
            accept = True
        else:
            # Paper Eq. 4: p = exp((E - E') / T); with optional energy
            # normalisation so temperatures are unit-free.
            p = math.exp((cur_e - cand_e) / scale / t)
            accept = rng.random() < p
        if accept:
            cur, cur_e = cand, cand_e
        if cur_e < best_e:
            best, best_e = dict(cur), cur_e
        it += 1
        t *= 1.0 - schedule.cooling_rate
        if record_history:
            history.append((it, cur_e, best_e, t))
        if it in checkpoint_set:
            checkpoints[it] = (best_e, dict(best))

    return SAResult(best_config=best, best_energy=best_e, n_iterations=it,
                    n_evaluations=n_evals, history=history,
                    checkpoints=checkpoints)


# ---------------------------------------------------------------------------
# Vectorized multi-chain SA (beyond-paper optimization).
# ---------------------------------------------------------------------------

def vectorized_sa(
    space: ConfigSpace,
    energy_fn_torch: Callable[[torch.Tensor], torch.Tensor],
    *,
    n_chains: int = 32,
    n_iterations: int = 2000,
    schedule: SASchedule = SASchedule(),
    seed: int = 0,
    checkpoint_at: Sequence[int] = (),
    device=None,
) -> SAResult:
    """Run ``n_chains`` independent SA chains in lockstep.

    ``energy_fn_torch`` maps a feature matrix ``(n, feature_dim)`` (as
    produced by ``space.encode``) on ``device`` to energies ``(n,)`` —
    e.g. ``bdtr.predict_fn_torch(device)``.  Configurations are carried
    as one ``(n_chains, n_params)`` tensor of value indices; features are
    built by table lookup; all random draws come from one
    ``torch.Generator`` on ``device`` (``None`` = the card).  The random
    stream differs from the reference's ``jax.random`` one, so the two
    engines are compared by outcome, never draw by draw.

    ``checkpoint_at`` records, for each given (1-based) iteration number,
    the best-so-far (energy, config) across ALL chains at that iteration
    — the multi-chain analogue of the scalar engine's best-so-far
    checkpoints (``history``, by contrast, follows the winning chain).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n_params = len(space.params)
    card = torch.as_tensor(space.cardinalities, dtype=torch.int64, device=dev)
    table, _ = space.index_feature_table()
    table_t = torch.as_tensor(table, dtype=torch.float32, device=dev)
    ordinal = torch.as_tensor([p.ordinal for p in space.params], device=dev)
    param_ix = torch.arange(n_params, device=dev)
    chain_ix = torch.arange(n_chains, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint_below(high):          # high: int64 tensor, elementwise bound
        draw = (uniform(*high.shape) * high).to(torch.int64)
        return torch.minimum(draw, high - 1)

    def energy_of(idx):               # (n_chains, n_params) -> (n_chains,)
        feats = table_t[param_ix, idx].sum(dim=1)
        return energy_fn_torch(feats).to(torch.float32)

    idx = randint_below(card.expand(n_chains, n_params))
    e = energy_of(idx)
    scale = e.abs() + 1e-12 if schedule.relative_energy \
        else torch.ones_like(e)
    best_idx, best_e = idx.clone(), e.clone()
    trace_e = torch.empty((n_iterations, n_chains), device=dev)
    want_cp = sorted({int(c) for c in checkpoint_at
                      if 1 <= int(c) <= n_iterations})
    cp_idx: dict[int, torch.Tensor] = {}

    t = schedule.initial_temp
    for it in range(n_iterations):
        # one draw per decision: param choice, step size, step direction,
        # categorical resample, acceptance
        which = randint_below(torch.full((n_chains,), n_params, device=dev))
        step = (randint_below(torch.full((n_chains,), 2, device=dev)) + 1) \
            * torch.where(uniform(n_chains) < 0.5, 1, -1)
        cur = idx[chain_ix, which]
        c = card[which]
        ord_val = torch.minimum((cur + step).clamp(min=0), c - 1)
        bounced = torch.minimum((cur - step).clamp(min=0), c - 1)
        ord_val = torch.where(ord_val == cur, bounced, ord_val)
        cat_val = randint_below(c)
        cand = idx.clone()
        cand[chain_ix, which] = torch.where(ordinal[which], ord_val, cat_val)
        ce = energy_of(cand)
        accept = (ce < e) | (uniform(n_chains) < torch.exp((e - ce) / scale / t))
        idx = torch.where(accept[:, None], cand, idx)
        e = torch.where(accept, ce, e)
        better = e < best_e
        best_idx = torch.where(better[:, None], idx, best_idx)
        best_e = torch.where(better, e, best_e)
        trace_e[it] = best_e
        if it + 1 in want_cp:
            cp_idx[it + 1] = best_idx.clone()
        t *= 1.0 - schedule.cooling_rate

    winner = int(torch.argmin(best_e))
    cfg = space.from_indices(best_idx[winner].tolist())
    trace = trace_e.cpu().numpy()     # (n_iterations, n_chains)
    # a checkpoint is the best-so-far across ALL chains at that iteration
    # (every chain has spent its budget by then), not the eventual
    # winner's state — the winner may lag at intermediate iterations
    checkpoints = {}
    for it in want_cp:
        c = int(np.argmin(trace[it - 1]))
        checkpoints[it] = (float(trace[it - 1, c]),
                           space.from_indices(cp_idx[it][c].tolist()))
    win_e = trace[:, winner] if n_iterations else np.zeros(0)
    return SAResult(
        best_config=cfg,
        best_energy=float(best_e[winner]),
        n_iterations=n_iterations,
        n_evaluations=n_chains * (n_iterations + 1),
        history=[(i + 1, float(win_e[i]), float(win_e[i]), 0.0)
                 for i in range(0, n_iterations, max(1, n_iterations // 64))],
        checkpoints=checkpoints,
    )
