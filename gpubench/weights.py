"""Weights made from ``--seed`` on the device, in the type they are run in.

A reference module lists its parameters as ``Leaf`` records (the names
the port's model uses, so the tensors load into it by name).  ``make``
fills one flat buffer a dtype with one ``randn`` call from a generator on
the device, then turns each leaf's slice into its distribution in place:
the same seed on the same device gives the same bits, so the reference can
make the weights again after the program has changed its own.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: str                  # "float32" | "bfloat16"
    kind: str                   # "normal" | "uniform" | "const"
    a: float = 1.0              # normal: std; uniform: low; const: value
    b: float = 0.0              # uniform: high


def numel(shape) -> int:
    return math.prod(shape)


def make(leaves: list[Leaf], seed: int, device) -> dict[str, torch.Tensor]:
    """{name: tensor}; each tensor a view of its dtype's flat buffer."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: dict[str, torch.Tensor] = {}
    for dtype in sorted({leaf.dtype for leaf in leaves}):
        mine = [leaf for leaf in leaves if leaf.dtype == dtype]
        dt = getattr(torch, dtype)
        buf = torch.randn(sum(numel(leaf.shape) for leaf in mine), dtype=dt,
                          device=device, generator=gen)
        at = 0
        for leaf in mine:
            n = numel(leaf.shape)
            view = buf[at:at + n].view(leaf.shape)
            at += n
            if leaf.kind == "normal":
                view.mul_(leaf.a)
            elif leaf.kind == "uniform":
                u = 0.5 * (1.0 + torch.erf(view.float() / math.sqrt(2.0)))
                view.copy_(leaf.a + (leaf.b - leaf.a) * u)
            elif leaf.kind == "const":
                view.fill_(leaf.a)
            else:
                raise ValueError(f"{leaf.name}: unknown kind {leaf.kind!r}")
            out[leaf.name] = view
    return out
