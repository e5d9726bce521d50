"""Training: train state and steps, the epoch loop, checkpoints, and the
teacher, distillation, resume and progressive trainers."""
from .state import (
    StepDraws,
    TorchDraws,
    TrainState,
    create_train_state,
    make_dit_teacher_epoch_fn,
    make_dit_teacher_train_step,
    make_distill_train_step,
    make_eval_fn_from_config,
    make_eval_model_fn,
    make_optimizer,
    make_teacher_train_step,
)
from .checkpoints import (
    AsyncCheckpointWriter,
    abstract_target,
    available_epochs,
    available_epochs_sharded,
    checkpoint_path,
    latest_epoch,
    load_checkpoint,
    load_checkpoint_sharded,
    save_checkpoint,
    save_checkpoint_sharded,
    save_dit_checkpoint,
    sharded_checkpoint_path,
    variables_from_checkpoint,
)
from .loop import run_train_epoch
from .teacher import generate_sample_grid, make_grid_fn, train_teacher
from .students import (
    distill_diffusion_model,
    load_teacher,
    print_size_factor_info,
    train_students,
)
from .continue_training import continue_training
from .progressive import (
    make_guided_eval_fn,
    make_progressive_distill_step,
    progressive_distill,
)
