"""The benchmark's bridge to the program: the port's ``Config`` and U-Net,
built for a cell with the benchmark's weights.

Drivers import the program only through here and the entry points they
drive, so what the benchmark takes from the program stays in sight.
"""

from __future__ import annotations

from typing import Dict

import torch


def port_config(cfg: dict, device: torch.device, workdir: str, **fields):
    """The port's ``Config`` for a configuration file, its outputs under the
    run's work directory; ``fields`` set what the traffic sets (the
    sweep's T, the control's int8 lane)."""
    from distillation_trajectories_torch.config import Config

    args = dict(
        dataset=cfg["dataset"], image_size=cfg["image_size"], channels=cfg["channels"],
        batch_size=cfg["batch_size"], dropout=cfg["dropout"], lr=cfg["lr"],
        timesteps=cfg["timesteps"], beta_start=cfg["beta_start"], beta_end=cfg["beta_end"],
        noise_schedule=cfg["noise_schedule"], compute_dtype=cfg["compute_dtype"],
        norm=cfg["norm"], full_res_head=cfg["full_res_head"], base_dir=workdir,
        device=str(device))
    args.update(fields)
    return Config(**args)


def port_unet(config, size_factor: float, weights: Dict[str, torch.Tensor],
              device: torch.device) -> torch.nn.Module:
    """The port's ``DiffusionUNet`` at ``size_factor``, its storage made on
    the device and filled from ``weights`` (channels-last, as
    ``models.make_unet`` lays it out)."""
    from distillation_trajectories_torch.models.unet import DiffusionUNet

    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        model = DiffusionUNet(channels=config.channels, size_factor=size_factor, dtype=dtype,
                              norm=config.norm, full_res_head=bool(config.full_res_head),
                              dropout=config.dropout, remat=bool(config.remat))
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.to(memory_format=torch.channels_last)
