"""Convert a checkpoint back to a reference torch ``.pt`` state dict (the
flags of ``scripts/export_reference_checkpoint.py``), the inverse of
:mod:`.import_reference_checkpoint`: the reference loads the file with a
strict ``model.load_state_dict(...)``.  Host-only: it runs on the CPU and
takes no ``--device``.

    python -m distillation_trajectories_torch.scripts.export_reference_checkpoint out.pt
    python -m distillation_trajectories_torch.scripts.export_reference_checkpoint out.pt \
        --role student --size_factor 0.3 --epoch 5 --base_dir /data/run1
    python -m distillation_trajectories_torch.scripts.export_reference_checkpoint out.pt \
        --checkpoint output/models/teacher/model_epoch_10.msgpack
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export a checkpoint as a reference torch .pt file",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("out", type=str, help="output .pt path")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="explicit .msgpack file (overrides --role)")
    parser.add_argument("--role", choices=["teacher", "student"], default="teacher")
    parser.add_argument("--size_factor", type=float, default=None,
                        help="student size factor (required for --role student without "
                        "--checkpoint)")
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch (latest when omitted)")
    parser.add_argument("--dataset", choices=["MNIST", "CIFAR10"], default=None)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--base_dir", type=str, default=None)
    args = parser.parse_args(argv)

    import torch

    from ..config import Config
    from ..models.convert import unet_state_dict_from_variables
    from ..training.checkpoints import (
        checkpoint_path,
        latest_epoch,
        load_checkpoint,
        msgpack_restore,
        variables_from_checkpoint,
    )

    overrides = {"device": "cpu"}
    if args.dataset:
        overrides["dataset"] = args.dataset
    if args.image_size:
        overrides["image_size"] = args.image_size
    if args.base_dir:
        overrides["base_dir"] = args.base_dir
    config = Config(**overrides)

    if args.checkpoint:
        with open(args.checkpoint, "rb") as f:
            payload = msgpack_restore(f.read())
        src = args.checkpoint
    else:
        if args.role == "teacher":
            directory = config.teacher_models_dir
        else:
            if args.size_factor is None:
                parser.error("--size_factor is required for --role student")
            directory = config.student_dir(args.size_factor)
        epoch = args.epoch if args.epoch is not None else latest_epoch(directory)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints found in {directory}")
        payload = load_checkpoint(directory, epoch)
        src = checkpoint_path(directory, epoch)

    state_dict = unet_state_dict_from_variables(variables_from_checkpoint(payload))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    torch.save(state_dict, args.out)
    print(f"[torch-port] {src} -> {args.out} ({len(state_dict)} state-dict entries)")
    return args.out


if __name__ == "__main__":
    main()
