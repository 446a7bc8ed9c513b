"""Entry points: ``python -m repro_torch.launch.serve``, ``.train``,
``.dryrun`` (the production-mesh dry run) and ``.perf`` (one cell under
overrides); the steps and their builders in ``steps``, the shape cells and
default policies in ``shapes`` and ``policies``."""
