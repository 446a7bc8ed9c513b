"""The training step: loss and gradients (optionally over microbatches),
global-norm clip, AdamW.

The port of the body of the reference's ``make_train_step``
(``launch/steps.py``).  The rest of that module (``StepBundle``, the
sharding trees, ``make_prefill_step``, ``make_serve_step``) is ``jit`` and
sharding plumbing with no counterpart on one card: PyTorch runs eagerly,
``LM.prefill``/``LM.decode_step`` (an encoder-decoder's
``EncDec.prefill_cross``/``decode_step``) are the serving steps, and the
step below takes either model and updates the parameters and the
optimizer state in place where the reference donates and returns them.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models import LM, EncDec
from ..optim.adamw import AdamWConfig, apply_updates

__all__ = ["train_step"]


def _split(batch: dict, n: int) -> list[dict]:
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n} "
                         "microbatches")
    return [{k: v[i * (rows // n):(i + 1) * (rows // n)]
             for k, v in batch.items()} for i in range(n)]


def train_step(model: LM | EncDec, opt_state: dict, batch: dict,
               opt_cfg: AdamWConfig, *, microbatches: int = 1,
               remat: bool | str = False,
               grad_compression: str = "none") -> dict:
    """One optimizer step on ``batch`` (tensors on the model's device).

    With ``microbatches > 1`` the batch's rows are split evenly and the
    gradients summed in float32, then averaged, as the reference's scan
    does.  Updates ``model``'s parameters and ``opt_state`` in place and
    returns ``{"loss", "gnorm", "step"}`` (0-dim tensors; ``gnorm`` is the
    pre-clip global norm).  The AdamW update runs inside a profiler range
    named ``adamw``.
    """
    if grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={grad_compression!r}: dist/compression.py is "
            "not ported to repro_torch yet")
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    if microbatches > 1:
        gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in _split(batch, microbatches):
            loss, _ = model.loss(mb, remat=remat)
            loss.backward()
            for n, p in params.items():
                gsum[n] += p.grad.float()
                p.grad = None
            lsum += loss.detach()
        grads = {n: g.div_(microbatches) for n, g in gsum.items()}
        loss = lsum / microbatches
    else:
        loss, _ = model.loss(batch, remat=remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        loss = loss.detach()
    with record_function("adamw"):
        gnorm = apply_updates(params, grads, opt_state, opt_cfg,
                              decay_mask=model.decay_mask())
    del grads
    model.zero_grad(set_to_none=True)
    return {"loss": loss, "gnorm": gnorm, "step": opt_state["count"]}
