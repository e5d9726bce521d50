"""Analysis: dimensionality reduction, latent space, noise prediction and
the cross-size visualizations (the JAX package's ``analysis`` exports).
Each module also has a compute half that imports no plotting library."""
from .dimensionality import dimensionality_reduction_analysis, pca_fit_transform
from .latent_space import generate_latent_space_visualization
from .noise_prediction import (
    analyze_noise_prediction,
    calculate_noise_metrics,
)
from .visualization import (
    plot_time_dependent_grid,
    plot_time_dependent_combined,
    plot_trajectory_divergence_vs_timestep,
    generate_3d_model_size_visualization,
    create_denoising_comparison_plot,
)
