"""The device memory the caching allocator held at its peak over set-up
and the window (``torch.cuda.max_memory_reserved``, graph pools
included), in GiB; over set-up and the window's first calls where the
traffic sets ``peak_after_calls``."""


def read(window):
    return window.peak_bytes / 2**30
