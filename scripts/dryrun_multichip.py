#!/usr/bin/env python3
"""The port's multi-chip dry run, the counterpart of ``__graft_entry__.py``
``dryrun_multichip(n)``: the train step of the recipes' paths on n ranks of a
(data, model) mesh.

    python3 scripts/dryrun_multichip.py 8                # eight ranks sharing the card
    python3 scripts/dryrun_multichip.py 8 --device cpu   # eight ranks on the CPU

It spawns n processes of one gloo group on localhost (on the card they share
it, as ``chip_smoke.py`` phase 15's ranks do) and runs, through the port's
``load_teacher_student``, ``build_train_step`` and ``build_eval_step``:

- at mesh (n / 2, 2) (n even; else (n, 1)), the JAX dry run's three cases at
  its widths (depth 3, D 64 / 128, 4 heads, 32 px, fp32, drop-path 0.1, its
  recipe's augmentation and mixup, batch 2 n accum): mgd; soft with a
  distilled student and ``grad_accum_steps=2``; wasskd-sinkhorn with 8
  iterations. Head dim 16 is not one the block kernels take
  (``ops/fused_block.py`` ``KERNEL_HEAD_DIMS``), so these models run PyTorch's
  own ops. Each case is one step, then the masked eval step with the last 3
  rows invalid: the count must be batch - 3, the loss and the eval sums
  finite, the step counted;
- at (n, 1), the soft step on the fused block with accumulation 2: on the
  CPU at the dry run's widths on the block's plain version; on the card at
  DeiT widths (D 192 / 384, 3 / 6 heads, head dim 64, depth 3) so that the
  block kernels run, each rank's launches held to one forward a block and
  micro-batch for each model and one backward for the student.

Global rank 0 prints one line a case in the JAX script's form; a rank that
fails its checks raises, and the script exits 1. Imports neither JAX nor the
JAX package.
"""

import argparse
import math
import os
import socket
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kd type, distilled student, grad accum, extra config): the JAX dry run's
SCENARIOS = (("mgd", False, 1, {}),
             ("soft", True, 2, {}),
             ("wasskd", False, 1, {"wasskd_type": "sinkhorn", "sinkhorn_iters": 8}))
IMG, DEPTH = 32, 3
# the dry run's widths, and DeiT's for the fused case on the card
MODELS = {"dry_student": dict(embed_dim=64, num_heads=4, distilled=False),
          "dry_student_distilled": dict(embed_dim=64, num_heads=4, distilled=True),
          "dry_teacher": dict(embed_dim=128, num_heads=4, distilled=True),
          "dry_deit_student": dict(embed_dim=192, num_heads=3, distilled=True),
          "dry_deit_teacher": dict(embed_dim=384, num_heads=6, distilled=True)}
FUSED_ACCUM = 2


def _register():
    from deltakd_tpu_torch.models import registry
    from deltakd_tpu_torch.models.vit import ViTConfig

    for name, kw in MODELS.items():
        registry.MODEL_REGISTRY[name] = ViTConfig(img_size=IMG, depth=DEPTH, num_classes=100,
                                                  **kw)


def _config(kd_type, accum, extra, batch, mesh_shape, student, teacher):
    from deltakd_tpu_torch.configs.config import TrainConfig

    return TrainConfig(input_size=IMG, batch_size=batch // mesh_shape[0], epochs=5,
                       warmup_epochs=1, dtype="float32", drop_path_rate=0.1,
                       distillation_type=kd_type, grad_accum_steps=accum, dataset="cifar-100",
                       allow_random_teacher=True, student_model=student, teacher_model=teacher,
                       mesh_shape=mesh_shape, **extra)


def _rows(batch, accum, data_world, data_rank):
    """A data rank's rows of the global batch: its share of each micro-batch."""
    mb = batch // accum // data_world
    return np.concatenate([np.arange(i * batch // accum + data_rank * mb,
                                     i * batch // accum + (data_rank + 1) * mb)
                           for i in range(accum)])


def _step(cfg, mesh, device, rng, batch, attention_fn):
    """One train step of ``cfg`` on ``mesh``, each data rank on its rows of a
    global batch of uint8 images made from ``rng`` (the same on every rank).
    Returns (the data ranks' mean train loss, the student after the step,
    the images, the labels)."""
    import torch

    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.data.mixup import MixupConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.loop import epoch_generators
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    kw = {} if attention_fn == "config" else {"attention_fn": attention_fn}
    teacher, student, aux = load_teacher_student(cfg, seed=0, device=device, mesh=mesh, **kw)
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 4)
    state = TrainState(student, tx=tx, aux=aux)
    kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                teacher_prefix=2)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=AugmentConfig.from_config(cfg),
                            mixup=MixupConfig.from_config(cfg, 100), tx=tx, dp=mesh.data)
    images = torch.from_numpy(rng.randint(0, 256, (batch, IMG, IMG, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(0, 100, (batch,)))
    rows = torch.from_numpy(_rows(batch, cfg.grad_accum_steps, mesh.data.world,
                                  mesh.data.rank))
    generator, shared = epoch_generators(cfg.seed, 0, torch.device(device), mesh.data)
    m = step(state, images[rows].to(device), labels[rows].to(device), generator,
             batch_generator=shared)
    loss = float(mesh.data.mean(m["train_loss"].float()))
    if not math.isfinite(loss):
        raise AssertionError(f"{cfg.distillation_type}: non-finite loss {loss}")
    if state.step != 1:
        raise AssertionError(f"{cfg.distillation_type}: the state counts {state.step} steps")
    return loss, student, images, labels


def _masked_eval(student, cfg, mesh, device, images, labels):
    """The masked eval step on the data rank's rows of ``images``, the last 3
    rows of the batch invalid; the data ranks' sums."""
    import torch

    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.train.loop import eval_view
    from deltakd_tpu_torch.train.step import build_eval_step

    n = images.shape[0]
    b = n // mesh.data.world
    mine = slice(mesh.data.rank * b, (mesh.data.rank + 1) * b)
    sums = build_eval_step(student=eval_view(student), aug=AugmentConfig.from_config(cfg))(
        images[mine].to(device), labels[mine].to(device),
        (torch.arange(n) < n - 3)[mine].to(device))
    names = sorted(sums)
    total = mesh.data.all_reduce(torch.stack([sums[k].float() for k in names]))
    return dict(zip(names, total.tolist()))


def _fused_launches(student_d, teacher_d):
    """The launches a rank of the fused fp32 soft step with FUSED_ACCUM
    micro-batches: a forward a block and micro-batch for each model and a
    backward for the student, each the block kernels' fp32 form."""
    n = DEPTH * FUSED_ACCUM
    return {("fused_block_fwd_f32", teacher_d): n, ("fused_block_fwd_f32", student_d): n,
            ("fused_block_bwd_f32", student_d): n}


def _rank(rank, world, port, device):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    from deltakd_tpu_torch import parallel
    from deltakd_tpu_torch.ops import fused_block as fb

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    _register()
    shape = (world // 2, 2) if world >= 2 and world % 2 == 0 else (world, 1)
    mesh = parallel.make_mesh(shape, parallel.current())
    rng = np.random.RandomState(0)
    say = print if mesh.is_main else (lambda *a, **k: None)
    for kd_type, distilled, accum, extra in SCENARIOS:
        batch = 2 * world * accum
        cfg = _config(kd_type, accum, extra, batch, shape,
                      "dry_student" + ("_distilled" if distilled else ""), "dry_teacher")
        loss, student, images, labels = _step(cfg, mesh, device, rng, batch, None)
        sums = _masked_eval(student, cfg, mesh, device, images, labels)
        if sums["count"] != batch - 3:
            raise AssertionError(f"eval mask count {sums['count']} != {batch - 3}")
        if not all(math.isfinite(v) for v in sums.values()):
            raise AssertionError(f"{kd_type}: non-finite eval sums {sums}")
        say(f"dryrun_multichip({world}): mesh={shape} type={kd_type} accum={accum} "
            f"loss={loss:.4f} eval_count={sums['count']:.0f} OK", flush=True)

    # the fused block on a pure data-parallel mesh
    dp_shape = (world, 1)
    dp_mesh = parallel.make_mesh(dp_shape, parallel.current())
    batch = 2 * world * FUSED_ACCUM
    deit = device == "cuda"
    student, teacher = (("dry_deit_student", "dry_deit_teacher") if deit
                        else ("dry_student_distilled", "dry_teacher"))
    cfg = _config("soft", FUSED_ACCUM, {}, batch, dp_shape, student, teacher)
    fb.reset_launches()
    loss, _, _, _ = _step(cfg, dp_mesh, device, rng, batch, "config")
    launches = dict(fb.LAUNCHES)
    if deit:
        want = _fused_launches(MODELS[student]["embed_dim"], MODELS[teacher]["embed_dim"])
        if launches != want:
            raise AssertionError(f"rank {rank}: fused block launches {launches}, expected {want}")
    elif launches:
        raise AssertionError(f"rank {rank}: launches on the CPU: {launches}")
    say(f"dryrun_multichip({world}): mesh={dp_shape} type=soft accum={FUSED_ACCUM} "
        f"FUSED-KERNEL loss={loss:.4f} "
        + (f"launches a rank {launches} " if deit else "(the block's plain version) ")
        + "OK", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="run on the card (default) or the CPU")
    args = parser.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: CUDA is not available; pass --device cpu", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        mp.start_processes(_rank, args=(args.n, port, args.device), nprocs=args.n,
                           start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"dryrun_multichip: a rank failed:\n{e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
