"""Editing: inpainting, latent manipulation, simulated prompt editing."""
from .core import EditingDraws, denoise_with_trajectory, to_image
from .masked_inpainting import (
    apply_masked_inpainting,
    create_random_mask,
    visualize_inpainting,
)
from .latent_manipulation import (
    apply_latent_manipulation,
    find_semantic_directions,
    generate_image_with_latents,
    visualize_latent_manipulation,
)
from .prompt_editing import (
    apply_prompt_editing,
    generate_image_with_trajectory,
    visualize_prompt_editing,
)
