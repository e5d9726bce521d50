"""The unified teacher/student diffusion U-Net, weight/Adam-state
conversion to and from the JAX package's layout, and the InceptionV3
feature trunk of FID (``models.inception``)."""
from .unet import (
    DiffusionUNet,
    make_unet,
    param_count,
    resize_bilinear_align_corners,
    sinusoidal_time_embedding,
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
