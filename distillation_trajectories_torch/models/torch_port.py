"""Reference torch ``DiffusionUNet`` checkpoints into and out of the port
(port of ``distillation_trajectories_tpu/models/torch_port.py``).

The reference saves bare ``model.state_dict()`` files; its users hold
directories of ``model_epoch_{e}.pt`` teachers and ``model_size_{sf}.pt``
students.  The port's U-Net carries the reference's module names
(:mod:`.unet`), so a reference state dict loads into it as it is, with
``strict=True``: a missing or surplus entry, or a wrong shape, raises
instead of giving a half-loaded model.  Export is the port model's own
state dict, on the CPU.  Everything here runs on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .unet import DiffusionUNet, make_unet

__all__ = [
    "infer_size_factor",
    "import_reference_unet_checkpoint",
    "export_reference_unet_state_dict",
]


def infer_size_factor(state_dict: Dict[str, Any]) -> Optional[float]:
    """Best-effort ``size_factor`` from a reference state dict's shapes.

    Scans sf ∈ {0.01, 0.02, …, 2.00} for values reproducing both
    ``base_channels = max(int(128·sf), 16)`` (enc1.conv1's out-channels) and
    ``time_emb_dim = max(int(256·sf), 16)`` (time_mlp.1's out-features).
    Both dims reach the 16 floor for every sf ≤ 0.06, so checkpoints there
    are indistinguishable by shape: raises ``ValueError`` listing the
    candidates instead of guessing (the weights would be the same, but the
    checkpoint would be saved under the wrong ``size_{sf}`` directory).
    Returns None when nothing matches.
    """
    base = int(state_dict["enc1.conv1.weight"].shape[0])
    ted = int(state_dict["time_mlp.1.weight"].shape[0])
    matches = [
        i / 100.0
        for i in range(1, 201)
        if max(int(128 * (i / 100.0)), 16) == base and max(int(256 * (i / 100.0)), 16) == ted
    ]
    if len(matches) > 1:
        raise ValueError(
            f"size_factor is ambiguous from shapes (base={base}, time_emb={ted}): any of "
            f"{matches} builds this architecture; pass --size_factor explicitly"
        )
    return matches[0] if matches else None


def import_reference_unet_checkpoint(path: str, config,
                                     size_factor: Optional[float] = None) -> DiffusionUNet:
    """The port U-Net, on the CPU, holding a reference ``.pt`` state dict
    (bare, or under ``"model_state_dict"``).

    ``size_factor=None`` infers it from the tensor shapes
    (:func:`infer_size_factor`).  The architecture is the config's
    (channels, norm, head); a state dict of another one raises.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    if size_factor is None:
        size_factor = infer_size_factor(sd)
        if size_factor is None:
            raise ValueError(f"could not infer size_factor from {path}; pass it explicitly")
        print(f"[torch-port] inferred size_factor={size_factor}")
    model = make_unet(config, size_factor=size_factor, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def export_reference_unet_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The reference-loadable state dict of a port U-Net: its own entries
    (reference module names) as CPU tensors."""
    return {k: v.detach().to("cpu").clone() for k, v in model.state_dict().items()}
