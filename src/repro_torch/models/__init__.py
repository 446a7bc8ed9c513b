"""Model zoo: the PyTorch twins of the reference's architectures.

``LM`` runs the decoder-only families: dense, MoE, the recurrent RWKV-6
and the hybrid Mamba + attention stack (Jamba).  ``build_model`` raises
``NotImplementedError``, naming the missing part, for a family the port
lacks (the encoder-decoder model, the VLM patch frontend).
"""

from .config import ArchConfig, MambaConfig, MoEConfig, RwkvConfig
from .lm import LM, missing_layer

__all__ = ["ArchConfig", "LM", "MambaConfig", "MoEConfig", "RwkvConfig",
           "build_model", "missing_layer"]


def build_model(cfg: ArchConfig, *, seed: int = 0, device=None) -> LM:
    """The model for ``cfg`` with random weights from ``seed`` on
    ``device`` (``None`` = the card); raises ``NotImplementedError`` for a
    family the port cannot run yet (``missing_layer``)."""
    return LM(cfg, seed=seed, device=device)
