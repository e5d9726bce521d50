"""The H100 benchmark of ``distillation_trajectories_torch``.

``run.py`` is the one command; ``BENCHMARK.json`` at the repository root
names the cells.  Everything that measures (traffic generation, the
reading of traces, the table of peaks, FLOP and byte counts, the plain
reference and the comparison that decides ``correct``) lives here, apart
from the program it measures.
"""
