"""The unified teacher/student diffusion U-Net, the class-conditional DiT
transformer (``models.dit``; the trajectory sweep's other family),
:func:`make_model` (either, by ``Config.architecture``), weight/Adam-state
conversion to and from the JAX package's layout, the int8 inference lane
(``models.quantized``), reference-checkpoint migration
(``models.torch_port``), and the InceptionV3 feature trunk of FID
(``models.inception``)."""
from .unet import (
    DiffusionUNet,
    SimpleUNet,
    StudentUNet,
    make_unet,
    param_count,
    param_size_mb,
    resize_bilinear_align_corners,
    sinusoidal_time_embedding,
)
from .dit import DIT_VARIANTS, DiT, make_dit, require_unet
from .torch_port import (
    export_reference_unet_state_dict,
    import_reference_unet_checkpoint,
    infer_size_factor,
)
from .quantized import (
    calibrate_activation_scales,
    make_quantized_eval_fn,
    quantize_unet_variables,
    quantized_unet_apply,
)
from .convert import (
    alexnet_lpips_state_dict_from_variables,
    inception_state_dict_from_variables,
    load_optax_adam_state,
    load_unet_variables,
    optax_adam_state,
    params_tree_from_named,
    unet_state_dict_from_variables,
    variables_from_unet_state_dict,
)


def make_model(config, variant=None, device=None, seed: int = 0):
    """The model ``Config.architecture`` names: a U-Net at size factor
    ``variant`` (default 1.0, :func:`make_unet`) or a DiT of the published
    variant ``variant`` (default DiT-XL/2, :func:`make_dit`),
    seeded from ``seed`` on ``device`` (default ``config.device``)."""
    arch = getattr(config, "architecture", "unet")
    if arch == "unet":
        return make_unet(config, size_factor=1.0 if variant is None else float(variant),
                         device=device, seed=seed)
    if arch == "dit":
        return make_dit(config, "DiT-XL/2" if variant is None else variant, device=device,
                        seed=seed)
    raise ValueError(f"unknown architecture {arch!r}; have 'unet' and 'dit'")
