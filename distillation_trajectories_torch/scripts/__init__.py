"""Command-line entry points of the port (``python -m
distillation_trajectories_torch.scripts.<name>``), with the flags of their
counterparts in the repository's ``scripts/``."""
