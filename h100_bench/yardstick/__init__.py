"""The benchmark's yardstick: draws, FLOP and byte counts, peaks, weights
and the reading of a profiler trace.  Imports nothing of the program."""
