"""Training images of every epoch completed in the window over those
epochs' whole time, the loss fetch included (host clock)."""


def read(window):
    return sum(window.unit_counts) / sum(window.seconds)
