"""The unified teacher/student diffusion U-Net, weight/Adam-state
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
