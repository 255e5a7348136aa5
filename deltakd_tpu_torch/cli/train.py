"""Training CLI, with the flag surface of the reference's tools/train.py and
of the JAX package's ``deltakd_tpu.cli.train``. Runs on the card; ``--device
cpu`` runs the plain PyTorch path on the CPU.

    python -m deltakd_tpu_torch.cli.train --distillation-type soft \\
        --student-model deit_tiny_distilled_patch16_224 \\
        --teacher-model deit_small_distilled_patch16_224 \\
        --dataset cifar-100 --data-path dataset --epochs 300 ...
"""

from deltakd_tpu_torch.configs.config import parse_args
from deltakd_tpu_torch.train.loop import run


def main(argv=None):
    cfg = parse_args(argv)
    print(cfg)
    return run(cfg)


if __name__ == "__main__":
    main()
