"""Training: train state and steps, the epoch loop, checkpoints, and the
teacher, distillation, resume and progressive trainers."""
from .state import (
    StepDraws,
    TorchDraws,
    TrainState,
    create_train_state,
    make_distill_train_step,
    make_eval_fn_from_config,
    make_eval_model_fn,
    make_optimizer,
    make_teacher_train_step,
)
from .checkpoints import (
    AsyncCheckpointWriter,
    available_epochs,
    checkpoint_path,
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
    variables_from_checkpoint,
)
from .loop import run_train_epoch
from .teacher import make_grid_fn, train_teacher
from .students import distill_diffusion_model, load_teacher, train_students
from .continue_training import continue_training
from .progressive import (
    make_guided_eval_fn,
    make_progressive_distill_step,
    progressive_distill,
)
