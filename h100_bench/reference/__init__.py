"""The plain reference: the U-Net equations, the engine chain, the metric
suite and the teacher train step in plain PyTorch.  Imports nothing of the
program."""
