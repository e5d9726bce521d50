"""Hand-written GPU kernels with their plain PyTorch versions.

``COUNTED`` holds the wrappers that count their launches on the card (a
``launches`` integer on each): a captured sampler chain
(``utils/graphs.py::CapturedCall``) adds a graph's launches to these counts
at each replay, so the counts stay the device's.  A new kernel's wrapper is
added here alone."""
from .cfg_update import cfg_engine_update, cfg_engine_update_reference
from .adaln import gate_add_ln_modulate, ln_modulate

COUNTED = (cfg_engine_update, ln_modulate, gate_add_ln_modulate)
