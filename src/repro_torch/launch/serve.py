"""Serving entry point: batched prefill, then a decode loop with KV caches.

    python -m repro_torch.launch.serve --arch qwen2.5-3b          # the card
    python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke --device cpu

A random prompt batch (``numpy.random.default_rng(seed)``, as in the
reference) is prefilled through the flash-attention kernel, then ``gen``
tokens are decoded greedily through the split-KV decode kernel.  The
weights are random, drawn from ``--seed`` on the device, and cast to
``compute_dtype`` once when the model is built.

``--tuned-kernels STORE`` enables the kernel-autotuning fast path: both
attention kernels resolve their cached best launch parameters
(``repro_torch.tune.kernels.tune_kernel``) for each call's shape, with zero
measurements at serve time and the defaults on a miss.

The reference ``serve.py``'s ``--stream``, ``--serve-requests`` and fault-drill
modes ride on its runtime and serving layers, which the port has not
reached yet.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from .. import configs, resolve_device
from ..models import LM, build_model

__all__ = ["main", "serve_session"]

log = logging.getLogger("repro_torch.serve")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve_session(cfg, *, batch: int, prompt_len: int, gen: int,
                  seed: int = 0, greedy: bool = True, model: LM | None = None,
                  device=None) -> dict:
    """Prefill a random prompt batch, then decode ``gen`` tokens.

    ``model`` takes an already-built ``LM`` (its device is used); otherwise
    one is built from ``seed`` on ``device`` (``None`` = the card) and cast
    for serving.  Times are host clock readings taken after a device
    synchronize, so they cover the device's work.  Runs under
    ``torch.inference_mode()``: the parameters require grad, and nothing
    here needs a graph.
    """
    if model is None:
        model = build_model(cfg, seed=seed,
                            device=resolve_device(device)).cast_for_serving()
    elif device is not None \
            and torch.device(device).type != model.device.type:
        raise ValueError(f"model lies on {model.device}, device={device!r}")
    dev = model.device
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt_len)),
                             dtype=torch.int64, device=dev)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(int(seed))

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if greedy:
            return logits[:, -1:].argmax(dim=-1)
        probs = torch.softmax(logits[:, -1], dim=-1)
        return torch.multinomial(probs, 1, generator=sampler)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = model.prefill(tokens, max_len=prompt_len + gen)
    last = pick(logits)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [last]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, state = model.decode_step(state, last, prompt_len + i)
        last = pick(logits)
        out.append(last)
    generated = torch.cat(out, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {
        "generated": generated.cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tuned-kernels", default=None, metavar="STORE",
                    help="kernel tuning store (JSON from "
                    "repro_torch.tune.kernels.tune_kernel): the attention "
                    "kernels resolve their cached best launch params per "
                    "shape, defaults on a miss")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    if args.tuned_kernels:
        from ..tune import kernels as ktune
        ktune.configure(args.tuned_kernels, device=dev)
    out = serve_session(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, seed=args.seed, device=dev)
    log.info(f"prefill {out['prefill_s']:.3f}s  decode {out['decode_s']:.3f}s"
             f"  {out['tokens_per_s']:.1f} tok/s on {dev}")
    log.info(f"sample tokens: {out['generated'][0, :12]}")


if __name__ == "__main__":
    main()
