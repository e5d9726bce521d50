"""Student distillation CLI (the flags of ``scripts/train_students.py``,
plus ``--device``).

    python -m distillation_trajectories_torch.scripts.train_students \
        --custom_size_factors 0.1,0.5 --epochs 1
"""

import argparse

from ._common import add_common_flags, add_model_flags, make_config


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train student diffusion models with various size factors",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--custom_size_factors", type=str, default=None,
                        help='Comma-separated size factors, e.g. "0.1,0.5,0.9"')
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override the number of epochs for distillation")
    parser.add_argument("--teacher_epoch", type=int, default=None,
                        help="Teacher checkpoint epoch (latest when omitted)")
    parser.add_argument("--sweep_parallel", action="store_true",
                        help="Distribute the size-factor sweep itself across devices "
                        "(one student per device, concurrent steps) instead of the "
                        "reference's sequential loop")
    parser.add_argument("--skip_existing", action="store_true",
                        help="Skip size factors whose final-epoch checkpoint exists")
    add_model_flags(parser)
    add_common_flags(parser)
    args = parser.parse_args(argv)

    from ..training import train_students

    config = make_config(args)
    custom = None
    if args.custom_size_factors:
        custom = [float(sf) for sf in args.custom_size_factors.split(",")]
        print(f"Using custom size factors: {custom}")
    return train_students(config, custom_size_factors=custom, seed=args.seed,
                          sweep_parallel=args.sweep_parallel,
                          skip_existing=args.skip_existing,
                          teacher_epoch=args.teacher_epoch)


if __name__ == "__main__":
    main()
