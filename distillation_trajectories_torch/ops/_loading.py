"""What the kernel wrappers share: the device test that picks the plain
version, and the loading of their Triton halves.

A Triton half (``cfg_update_triton``, ``adaln_triton``) is imported on its
wrapper's first launch, never when a module is imported: the CPU test suite
imports every wrapper where no triton exists.  Before the first such import
``TRITON_CACHE_DIR`` is set to ``build/triton/`` in the checkout, over any
value it had, so the kernels build there.
"""

from __future__ import annotations

import importlib
import os

TRITON_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "triton",
)

_HALVES: dict = {}


def on_cpu(*tensors) -> bool:
    """Whether every tensor is on the CPU, where a wrapper runs its plain
    version."""
    return all(a.device.type == "cpu" for a in tensors)


def triton_half(name: str):
    """The kernel module ``ops.<name>``, imported on first use."""
    module = _HALVES.get(name)
    if module is None:
        if not _HALVES:
            os.environ["TRITON_CACHE_DIR"] = TRITON_CACHE_DIR
        module = _HALVES[name] = importlib.import_module(f"{__package__}.{name}")
    return module
