"""The unified teacher/student diffusion U-Net and weight/Adam-state
conversion to and from the JAX package's layout."""
from .unet import (
    DiffusionUNet,
    make_unet,
    param_count,
    sinusoidal_time_embedding,
)
from .convert import (
    load_optax_adam_state,
    load_unet_variables,
    optax_adam_state,
    params_tree_from_named,
    unet_state_dict_from_variables,
    variables_from_unet_state_dict,
)
