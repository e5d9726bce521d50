"""The port's training CLIs: flags into Config, the three trainers end to
end on the CPU at a tiny size, the multi-device lanes' flags, and the
default device (``cuda``), which raises without a GPU."""

import os

import numpy as np
import pytest
import torch

from distillation_trajectories_torch.config import Config
from distillation_trajectories_torch.models import make_unet, variables_from_unet_state_dict
from distillation_trajectories_torch.scripts import continue_training, train_students, train_teacher
from distillation_trajectories_torch.training.checkpoints import (
    available_epochs,
    load_checkpoint,
    save_checkpoint,
)

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
    """The multi-device lanes through the CLIs: ``--mesh`` in a process
    without its ranks raises JAX's ``ValueError``; ``--checkpoint_sharded``
    writes ``model_epoch_1.dcp``, which the readers take like a msgpack
    file; ``--sweep_parallel`` trains every student at once."""
    flags = _flags(tmp_path, *extra, "--device", "cpu", "--epochs", "1")
    models = os.path.join(tmp_path, "output", "models")
    if "--mesh" in extra:
        with pytest.raises(ValueError, match="needs [24] devices.*torchrun --nproc_per_node"):
            cli.main(flags)
    elif cli is train_teacher:
        state = cli.main(flags)
        teacher_dir = os.path.join(models, "teacher")
        assert os.path.isdir(os.path.join(teacher_dir, "model_epoch_1.dcp"))
        assert not os.path.exists(os.path.join(teacher_dir, "model_epoch_1.msgpack"))
        assert available_epochs(teacher_dir) == [1]
        payload = load_checkpoint(teacher_dir)
        want = variables_from_unet_state_dict(state.model.state_dict())
        got = payload["params"]["enc1"]["conv1"]["kernel"]
        np.testing.assert_array_equal(got, want["params"]["enc1"]["conv1"]["kernel"])
        assert payload["epoch"] == 1 and int(payload["opt_state"]["0"]["count"]) == 2
    else:
        save_checkpoint(os.path.join(models, "teacher"), 1,
                        make_unet(Config(device="cpu"), size_factor=1.0, device="cpu"))
        out = cli.main(flags + ["--custom_size_factors", "0.1,0.2", "--num_samples", "0"])
        assert set(out) == {0.1, 0.2}
        for sf in (0.1, 0.2):
            assert available_epochs(os.path.join(models, "students", f"size_{sf}")) == [1]
        with open(os.path.join(tmp_path, "output", "results", "sweep_parallel_metrics.jsonl")) as f:
            assert len(f.readlines()) == 2


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train there")
    with pytest.raises(RuntimeError, match="cuda"):
        train_teacher.main(_flags(tmp_path, "--epochs", "1"))


def test_train_students_help_says_what_sweep_parallel_does(capsys):
    """``--sweep_parallel`` trains (``test_unported_lanes_raise``), so its
    help gives JAX's meaning and no longer says that it raises."""
    with pytest.raises(SystemExit) as exit_info:
        train_students.main(["--help"])
    assert exit_info.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    assert "one student per device, concurrent steps" in text
    assert "raises" not in text and "not ported" not in text
