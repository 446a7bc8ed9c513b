"""Model zoo: the PyTorch twins of the reference's architectures.

``LM`` runs the decoder-only families: dense, MoE, the recurrent RWKV-6,
the hybrid Mamba + attention stack (Jamba) and the VLM (patch embeddings
prepended); ``EncDec`` the encoder-decoder (Whisper).  ``build_model``
picks one by ``cfg.encdec``, as the reference's does, and raises
``NotImplementedError``, naming the missing part, for a mixer, frontend
or position kind the port lacks (``missing_layer``).
"""

from .config import ArchConfig, MambaConfig, MoEConfig, RwkvConfig
from .encdec import EncDec
from .lm import LM, missing_layer

__all__ = ["ArchConfig", "EncDec", "LM", "MambaConfig", "MoEConfig",
           "RwkvConfig", "build_model", "missing_layer"]


def build_model(cfg: ArchConfig, *, seed: int = 0,
                device=None) -> LM | EncDec:
    """The model for ``cfg`` (``EncDec`` for an encoder-decoder config,
    else ``LM``) with random weights from ``seed`` on ``device`` (``None``
    = the card)."""
    cls = EncDec if cfg.encdec else LM
    return cls(cfg, seed=seed, device=device)
