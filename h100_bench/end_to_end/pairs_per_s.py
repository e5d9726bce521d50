"""Trajectory pairs of every call completed in the window over those
calls' whole time (host clock, each call ended by a synchronise)."""


def read(window):
    return sum(window.unit_counts) / sum(window.seconds)
