"""The plain references, one module a model family: float32 PyTorch with
TF32 off, importing neither JAX, nor the JAX package, nor the port.  Each
gives ``leaves(arch, serving)``, ``loss(params, tokens, labels, arch,
quant)`` and ``prefill(params, tokens, arch, quant)``."""
