"""Convert a reference torch ``.pt`` U-Net checkpoint to the checkpoint
format every CLI here reads (the flags of
``scripts/import_reference_checkpoint.py``).

The state dict loads into the port's U-Net (``models/torch_port.py``) and is
saved as ``model_epoch_{e}.msgpack`` under the directory contract
(``output/models/teacher`` or ``output/models/students/size_{sf}``), with
``extra = {"imported_from", "size_factor"}``.  Host-only: it runs on the
CPU and takes no ``--device``.

    python -m distillation_trajectories_torch.scripts.import_reference_checkpoint \
        path/to/model_epoch_10.pt
    python -m distillation_trajectories_torch.scripts.import_reference_checkpoint model.pt \
        --role student --size_factor 0.3 --epoch 5 --base_dir /data/run1
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Import a reference torch U-Net checkpoint",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("checkpoint", type=str, help="reference .pt file")
    parser.add_argument("--role", choices=["teacher", "student"], default="teacher",
                        help="which models/ subdirectory to save under")
    parser.add_argument("--size_factor", type=float, default=None,
                        help="architecture size factor; inferred from the tensor shapes "
                        "when omitted")
    parser.add_argument("--epoch", type=int, default=1,
                        help="epoch label for the saved checkpoint name")
    parser.add_argument("--dataset", choices=["MNIST", "CIFAR10"], default=None)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--base_dir", type=str, default=None)
    parser.add_argument("--out", type=str, default=None,
                        help="explicit output DIRECTORY (overrides --role)")
    args = parser.parse_args(argv)

    from ..config import Config
    from ..models.torch_port import import_reference_unet_checkpoint
    from ..training.checkpoints import save_checkpoint

    overrides = {"device": "cpu"}
    if args.dataset:
        overrides["dataset"] = args.dataset
    if args.image_size:
        overrides["image_size"] = args.image_size
    if args.base_dir:
        overrides["base_dir"] = args.base_dir
    config = Config(**overrides).create_directories()

    model = import_reference_unet_checkpoint(args.checkpoint, config,
                                             size_factor=args.size_factor)
    sf = model.size_factor
    if args.out:
        out_dir = args.out
    elif args.role == "teacher":
        out_dir = config.teacher_models_dir
    else:
        out_dir = config.student_dir(sf)
    path = save_checkpoint(out_dir, args.epoch, model,
                           extra={"imported_from": os.path.abspath(args.checkpoint),
                                  "size_factor": sf})
    print(f"[torch-port] {args.checkpoint} (size_factor={sf}) -> {path}")
    return path


if __name__ == "__main__":
    main()
