"""Teacher training CLI (the flags of ``scripts/train_teacher.py``, plus
``--device``).

    python -m distillation_trajectories_torch.scripts.train_teacher --epochs 1
"""

import argparse

from ._common import add_common_flags, add_model_flags, make_config


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a diffusion model teacher",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override the number of epochs for training")
    add_model_flags(parser)
    add_common_flags(parser)
    args = parser.parse_args(argv)

    from ..training import train_teacher

    return train_teacher(make_config(args), seed=args.seed)


if __name__ == "__main__":
    main()
