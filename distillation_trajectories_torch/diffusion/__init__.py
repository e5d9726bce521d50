"""Diffusion schedules, the forward process and the samplers."""
from .schedules import (
    linear_beta_schedule,
    cosine_beta_schedule,
    get_diffusion_params,
    extract,
)
from .process import q_sample, p_losses
from .sampling import (
    engine_update,
    generate_trajectory_scan,
    generate_trajectory_batch_scan,
    draw_step_noise,
    CFG_COND_PAIRS,
    NOCFG_COND_PAIRS,
    subsampled_timestep_indices,
    p_sample,
    p_sample_ancestral,
    p_sample_loop,
)
