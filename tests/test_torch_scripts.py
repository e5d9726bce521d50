"""The port's training CLIs: flags into Config, the three trainers end to
end on the CPU at a tiny size, the lanes that raise, and the default
device (``cuda``), which raises without a GPU."""

import os

import pytest
import torch

from distillation_trajectories_torch.scripts import continue_training, train_students, train_teacher
from distillation_trajectories_torch.training.checkpoints import available_epochs, load_checkpoint

torch.set_num_threads(2)


def _flags(tmp_path, *extra):
    return ["--dataset", "MNIST", "--image_size", "16", "--batch_size", "8", "--timesteps", "10",
            "--limit_batches", "2", "--num_samples", "4", "--base_dir", str(tmp_path), *extra]


def test_cli_trainers_run_on_the_cpu(tmp_path):
    state = train_teacher.main(_flags(tmp_path, "--epochs", "2", "--dropout", "0.1", "--device", "cpu"))
    assert state.step == 4 and state.model.drop.p == 0.1
    teacher_dir = os.path.join(tmp_path, "output", "models", "teacher")
    assert available_epochs(teacher_dir) == [1, 2]
    out = train_students.main(_flags(tmp_path, "--epochs", "1", "--custom_size_factors", "0.1,0.2",
                                     "--teacher_epoch", "1", "--device", "cpu"))
    assert set(out) == {0.1, 0.2}
    for sf in (0.1, 0.2):
        assert available_epochs(os.path.join(tmp_path, "output", "models", "students",
                                             f"size_{sf}")) == [1]
    state = continue_training.main(_flags(tmp_path, "--start_epoch", "2", "--epochs", "1",
                                          "--device", "cpu"))
    assert available_epochs(teacher_dir) == [1, 2, 3]
    assert int(load_checkpoint(teacher_dir, 3)["opt_state"]["0"]["count"]) == 6
    assert os.path.exists(os.path.join(tmp_path, "output", "results", "samples_epoch_3.png"))


@pytest.mark.parametrize("cli, extra", [
    (train_teacher, ["--mesh", "2,1"]),
    (train_teacher, ["--checkpoint_sharded"]),
    (continue_training, ["--start_epoch", "1", "--mesh", "4"]),
    (train_students, ["--sweep_parallel"]),
], ids=["teacher-mesh", "teacher-sharded", "continue-mesh", "students-sweep-parallel"])
def test_unported_lanes_raise(tmp_path, cli, extra):
    with pytest.raises(NotImplementedError):
        cli.main(_flags(tmp_path, *extra, "--device", "cpu"))


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train there")
    with pytest.raises(RuntimeError, match="cuda"):
        train_teacher.main(_flags(tmp_path, "--epochs", "1"))
