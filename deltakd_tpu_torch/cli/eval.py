"""Checkpoint evaluation CLI (``deltakd_tpu/cli/eval.py``): load a checkpoint's
student (or its EMA), evaluate it on the validation split, print the metrics
and write them as JSON (next to the checkpoint unless ``--output`` says
otherwise). Under torchrun the student is replicated on every rank, as the
JAX eval CLI replicates it, whatever ``--mesh-shape`` says: each data rank
evaluates its shard of the split (the model ranks of a data row the same
one) and the sums are all-reduced over the data group; global rank 0
prints and writes them.

    python -m deltakd_tpu_torch.cli.eval --checkpoint checkpoints/run/checkpoint \\
        --dataset cifar-100 --data-path dataset [--use-ema]
"""

import argparse
import json
import os

from deltakd_tpu_torch import resolve_device
from deltakd_tpu_torch.ckpt.checkpoint import student_state_dict
from deltakd_tpu_torch.configs.config import add_train_args, config_from_namespace
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.loader import make_loader
from deltakd_tpu_torch.data.sources import build_source
from deltakd_tpu_torch.models.factory import load_teacher_student
from deltakd_tpu_torch.parallel import current, make_mesh, rank_device
from deltakd_tpu_torch.train.loop import eval_view, validate
from deltakd_tpu_torch.train.step import build_eval_step


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a checkpoint")
    add_train_args(parser)
    parser.add_argument("--use-ema", action="store_true",
                        help="evaluate the EMA weights instead of the raw ones")
    parser.add_argument("--output", type=str, default=None,
                        help="metrics JSON path (default: <checkpoint>/eval.json)")
    ns = parser.parse_args(argv)
    if not ns.checkpoint:
        parser.error("--checkpoint is required")
    cfg = config_from_namespace(ns)
    device = rank_device(resolve_device(cfg.device or "cuda"))
    mesh = make_mesh(cfg.mesh_shape, current())
    dp = mesh.data

    # the factory picks the student's path as run() does; the teacher is
    # never run, so it needs no weights
    _, student, _ = load_teacher_student(
        cfg.replace(allow_random_teacher=True, teacher_checkpoint=None),
        seed=cfg.seed, device=device)
    params, meta = student_state_dict(cfg.checkpoint, use_ema=ns.use_ema)
    student.load_state_dict(params)

    pin = cfg.pin_mem and device.type == "cuda"
    loader = make_loader(cfg, build_source(cfg, is_train=False),
                         batch_size=cfg.batch_size, is_train=False, world=dp.world,
                         rank=dp.rank, seed=cfg.seed, pin_memory=pin)
    eval_step = build_eval_step(student=eval_view(student),
                                aug=AugmentConfig.from_config(cfg))
    metrics = validate(eval_step, loader, cfg, device=device, pin=pin, prefix="test",
                       dp=dp)
    metrics["epoch"] = meta["epoch"]
    if mesh.is_main:
        print(json.dumps(metrics, indent=4))
        out_path = ns.output or os.path.join(cfg.checkpoint, "eval.json")
        with open(out_path, "w") as f:
            json.dump(metrics, f, indent=4)
    return metrics


if __name__ == "__main__":
    main()
