"""Resume teacher training CLI (the flags of
``scripts/continue_training.py``, plus ``--device``).

    python -m distillation_trajectories_torch.scripts.continue_training \
        --start_epoch 1 --epochs 1
"""

import argparse

from ._common import add_common_flags, make_config


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Continue training a teacher model from a checkpoint",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--start_epoch", type=int, required=True,
                        help="Checkpoint epoch to resume from")
    parser.add_argument("--epochs", type=int, default=10,
                        help="Number of additional epochs to train")
    parser.add_argument("--timesteps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--dataset", type=str, default=None, choices=["MNIST", "CIFAR10"])
    parser.add_argument("--image_size", type=int, default=None)
    add_common_flags(parser)
    args = parser.parse_args(argv)

    from ..training import continue_training

    print(f"Starting from epoch: {args.start_epoch}")
    return continue_training(make_config(args), args.start_epoch)


if __name__ == "__main__":
    main()
