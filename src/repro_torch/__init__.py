"""repro_torch — the PyTorch/CUDA port of ``repro``.

A second package beside the JAX reference, written for one NVIDIA Hopper
card.  Sub-packages and functions keep the reference's names so a reader
finds the twin (``repro_torch.core.space`` <-> ``repro.core.space``);
inside, the idiom is PyTorch: plain functions on tensors, an explicit
``device=`` on every entry point, explicit ``numpy.random.Generator`` /
``torch.Generator`` objects.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repro``.  Every kernel the reference wrote in Pallas is a
CUDA C++ kernel here (``kernels/csrc/*.cu``), compiled with ``nvcc`` at
first use (``_build.py``) and bound with ``ctypes``.

Entry points run **on the card by default**: ``device=None`` means
``"cuda"`` and raises when no CUDA device is present.  Only an explicit
``device="cpu"`` (or a tensor that already lies on the CPU) takes the
plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; raises when CUDA is asked for and absent.

    There is deliberately no "no GPU found, carrying on on the CPU"
    branch: the CPU is used only when the caller says ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "explicitly to run the plain PyTorch versions")
    return dev
