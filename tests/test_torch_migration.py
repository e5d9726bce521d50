"""Port parity: reference-checkpoint migration (``models/torch_port.py``
and the import / export CLIs).

The ``.pt`` files are written here from port models (no reference checkout
is needed).  The port's import CLI and the JAX package's
``import_reference_unet_checkpoint`` (saved the way the JAX CLI saves)
read the same file into equal msgpack trees; export then import gives back
every weight and statistic bit for bit; a wrong architecture raises.
"""

import os

import jax
import numpy as np
import pytest
import torch

from distillation_trajectories_tpu.models.torch_port import (
    import_reference_unet_checkpoint as jax_import,
)
from distillation_trajectories_tpu.models.torch_port import infer_size_factor as jax_infer
from distillation_trajectories_tpu.training.checkpoints import save_checkpoint as jax_save
from distillation_trajectories_torch.models import make_unet
from distillation_trajectories_torch.models.torch_port import (
    export_reference_unet_state_dict,
    import_reference_unet_checkpoint,
    infer_size_factor,
)
from distillation_trajectories_torch.scripts import (
    export_reference_checkpoint,
    import_reference_checkpoint,
)
from distillation_trajectories_torch.training.checkpoints import (
    checkpoint_path,
    msgpack_restore,
    save_checkpoint,
)
from torch_parity import configs

torch.set_num_threads(2)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _read(path):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _seeded(tcfg, size_factor, seed):
    """A port U-Net with seeded weights and moved BatchNorm statistics."""
    model = make_unet(tcfg, size_factor=size_factor, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5, generator=gen)
    return model


@pytest.mark.parametrize("size_factor", [0.1, 0.3, 0.5, 1.0, 0.07, 1.37])
def test_infer_size_factor_matches_jax(size_factor):
    _, tcfg = configs()
    sd = make_unet(tcfg, size_factor=size_factor, device="cpu").state_dict()
    got = infer_size_factor(sd)
    assert got == jax_infer(sd)
    model = make_unet(tcfg, size_factor=got, device="cpu")
    assert {k: v.shape for k, v in model.state_dict().items()} == {k: v.shape for k, v in sd.items()}


def test_infer_size_factor_raises_in_the_ambiguous_floor():
    _, tcfg = configs()
    sd = make_unet(tcfg, size_factor=0.05, device="cpu").state_dict()
    for fn in (infer_size_factor, jax_infer):
        with pytest.raises(ValueError, match="ambiguous"):
            fn(sd)
    assert infer_size_factor({"enc1.conv1.weight": torch.zeros(7, 1, 3, 3),
                              "time_mlp.1.weight": torch.zeros(9, 9)}) is None


@pytest.mark.parametrize("role, size_factor, wrapped", [("teacher", 1.0, False),
                                                        ("student", 0.3, True)])
def test_import_cli_matches_jax_import(tmp_path, role, size_factor, wrapped):
    jcfg, tcfg = configs(tmp_path, channels=3)  # the CLIs' Config: 3 channels
    state = _seeded(tcfg, size_factor, 3).state_dict()
    pt = str(tmp_path / "reference.pt")
    torch.save({"model_state_dict": state} if wrapped else state, pt)
    path = import_reference_checkpoint.main(
        [pt, "--role", role, "--epoch", "4", "--base_dir", str(tmp_path / "port"),
         "--dataset", "MNIST", "--image_size", "16"])
    want_dir = (tcfg.teacher_models_dir if role == "teacher" else tcfg.student_dir(size_factor))
    assert path == checkpoint_path(want_dir.replace(str(tmp_path), str(tmp_path / "port")), 4)

    jmodel, variables = jax_import(pt, jcfg)
    assert jmodel.size_factor == size_factor
    jpath = jax_save(str(tmp_path / "jax"), 4, params=variables["params"],
                     batch_stats=variables.get("batch_stats"),
                     extra={"imported_from": os.path.abspath(pt), "size_factor": size_factor})
    got, want = dict(_flat(_read(path))), dict(_flat(_read(jpath)))
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))
        else:
            assert got[k] == w, k
    assert got[("extra", "size_factor")] == size_factor


def test_export_then_import_round_trip_is_exact(tmp_path):
    _, tcfg = configs(tmp_path, channels=3)
    model = _seeded(tcfg, 0.2, 5)
    save_checkpoint(tcfg.student_dir(0.2), 2, model)
    pt = str(tmp_path / "exported" / "student.pt")
    export_reference_checkpoint.main([pt, "--role", "student", "--size_factor", "0.2",
                                      "--base_dir", str(tmp_path)])
    exported = torch.load(pt, map_location="cpu", weights_only=True)
    assert set(exported) == set(model.state_dict())
    assert export_reference_unet_state_dict(model).keys() == exported.keys()
    back_dir = str(tmp_path / "back")
    path = import_reference_checkpoint.main([pt, "--out", back_dir, "--epoch", "2",
                                             "--size_factor", "0.2"])
    via_file = export_reference_checkpoint.main([str(tmp_path / "again.pt"), "--checkpoint", path])
    again = torch.load(via_file, map_location="cpu", weights_only=True)
    restored = import_reference_unet_checkpoint(via_file, tcfg)
    assert restored.size_factor == 0.2
    for k, v in export_reference_unet_state_dict(model).items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(exported[k], v) and torch.equal(again[k], v), k
        assert torch.equal(restored.state_dict()[k], v), k
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    t, c = torch.tensor([1, 7]), torch.ones((2, 1))
    with torch.no_grad():
        assert torch.equal(restored.eval()(x, t, c, c), model.eval()(x, t, c, c))


def test_wrong_architecture_raises(tmp_path):
    _, tcfg = configs(tmp_path)
    pt = str(tmp_path / "model.pt")
    torch.save(make_unet(tcfg, size_factor=0.3, device="cpu").state_dict(), pt)
    with pytest.raises(RuntimeError, match="size mismatch"):
        import_reference_unet_checkpoint(pt, tcfg, size_factor=0.4)
    _, head_cfg = configs(full_res_head=True)
    with pytest.raises(RuntimeError, match="Missing key"):
        import_reference_unet_checkpoint(pt, head_cfg)
    extra = dict(torch.load(pt, weights_only=True), **{"extra.weight": torch.zeros(1)})
    torch.save(extra, pt)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        import_reference_unet_checkpoint(pt, tcfg)
