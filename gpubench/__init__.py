"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an
NVIDIA H100: ``run.py`` runs one cell; ``harness.py`` says what a cell is
made of."""
