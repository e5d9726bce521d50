"""Hand-written GPU kernels with their plain PyTorch versions."""
from .cfg_update import cfg_engine_update, cfg_engine_update_reference
from .adaln import gate_add_ln_modulate, ln_modulate
