"""The epoch loop (``deltakd_tpu/train/loop.py``): the reference's engine.py
and train.py main loop.

``run(cfg)`` wires config -> device -> models -> data -> optimizer -> steps ->
epoch loop with validation, best-checkpoint tracking, resume / finetune,
SIGTERM handling and logging (reference tools/train.py:215-367,
tools/engine.py:8-131).

The host never waits on the card between log points: each batch goes to the
card from pinned memory without blocking, the step's 0-d metrics fold into
one running-sum tensor on the card, and the host reads it once every
``log_every`` steps and at the end of the epoch; validation sums on the card
and reads once. Every draw of an epoch comes from generators seeded from
(seed, epoch), and the loader's order from seed + epoch, so a resumed run
repeats a straight one bit for bit.

Under torchrun (``parallel.maybe_initialize_distributed``) the ranks form
the JAX package's (data, model) mesh of ``--mesh-shape`` (default: every
rank on the data axis). Each data rank trains its rows of the global batch
(``--batch-size`` is per data rank; the model axis does not multiply it):
the loaders shard by data rank (the RASampler with ``--repeated-aug``), the
per-image draws come from a generator seeded from (seed, epoch, data rank)
and the global batch's draws from one seeded from (seed, epoch) on every
rank, so the model ranks of one data row draw the same numbers; the models
hold each model rank's shards (``models.factory.shard_model``); the
parameters are broadcast from data rank 0 of each model column after they
are built or loaded; the epoch's metric sums and the validation sums are
all-reduced over the data group at their one read; global rank 0 alone logs
and writes checkpoints (gathered over its model group first); a SIGTERM on
any rank stops every rank after the same epoch.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deltakd_tpu_torch import resolve_device
from deltakd_tpu_torch.ckpt.checkpoint import (load_checkpoint, load_student_for_finetune,
                                               save_checkpoint)
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.loader import make_loader
from deltakd_tpu_torch.data.mixup import MixupConfig
from deltakd_tpu_torch.data.sources import build_source
from deltakd_tpu_torch.kd.losses import KDSettings
from deltakd_tpu_torch.models.factory import load_teacher_student
from deltakd_tpu_torch.obs.logger import get_timestamped_log_file_path, setup_logger
from deltakd_tpu_torch.obs.meters import MetricLogger
from deltakd_tpu_torch.obs.profiling import count_params, measure_throughput, model_gflops
from deltakd_tpu_torch.obs.wandb_adapter import WandbRun
from deltakd_tpu_torch.ops.fused_mlp import best_mlp_fn
from deltakd_tpu_torch.parallel import LOCAL, DataParallel, make_mesh
from deltakd_tpu_torch.parallel import current as current_dp
from deltakd_tpu_torch.parallel import rank_device
from deltakd_tpu_torch.train.optim import (PlateauController, get_lr_scale,
                                            lr_noise_multiplier, make_optimizer,
                                            set_lr_scale)
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_eval_step, build_train_step

EVAL_SUMS = ("loss_sum", "correct1", "correct5", "count")


def to_device(x, device: torch.device, pin: bool) -> torch.Tensor:
    """A host batch (numpy or tensor) on ``device``. With ``pin`` the copy
    leaves a fresh pinned buffer without blocking, so no staging buffer is
    overwritten while its copy is in flight."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    if device.type == "cpu":
        return t
    if pin and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=pin)


def epoch_generator(seed: int, epoch: int, device: torch.device,
                    rank: Optional[int] = None) -> torch.Generator:
    """The generator of an epoch's draws, seeded from (seed, epoch), or from
    (seed, epoch, rank) for one rank's own."""
    entropy = [seed, epoch] if rank is None else [seed, epoch, rank]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def epoch_generators(seed: int, epoch: int, device: torch.device,
                     dp: DataParallel = LOCAL) -> Tuple[torch.Generator, torch.Generator]:
    """(per-image, global-batch) generators of an epoch: at world 1 one
    generator serves both, as in a plain process; at world > 1 each rank
    draws its images' crops, flips, ops, erasing, drop-path and loss draws
    from its own and the global batch's draws from the shared one."""
    shared = epoch_generator(seed, epoch, device)
    if not dp.active:
        return shared, shared
    return epoch_generator(seed, epoch, device, dp.rank), shared


def train_one_epoch(state, train_step, loader, epoch: int, cfg, *,
                    device: torch.device, generator: torch.Generator,
                    batch_generator: Optional[torch.Generator] = None,
                    pin: bool = True, printer=print,
                    dp: DataParallel = LOCAL) -> Dict[str, float]:
    """One sweep over the train loader (reference tools/engine.py:8-76);
    ``state`` is updated in place. Returns the epoch's metric averages over
    the steps and the ranks; rank 0 logs its own steps' metrics."""
    metric_logger = MetricLogger(printer=printer)
    header = f"Epoch: [{epoch + 1}/{cfg.epochs}]"
    steps = len(loader)
    if cfg.steps_per_epoch:
        steps = min(steps, cfg.steps_per_epoch)
    names, sums, n_steps = None, None, 0
    batches = itertools.islice(loader.epoch(epoch), steps)
    for images, labels, _ in metric_logger.log_every(
            batches, cfg.log_every, header, total=steps, is_main=dp.is_main):
        metrics = train_step(state, to_device(images, device, pin),
                             to_device(labels, device, pin), generator,
                             batch_generator=batch_generator, epoch=epoch)
        if names is None:
            names = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in names])
        sums = vec if sums is None else sums + vec
        n_steps += 1
        if dp.is_main and n_steps % cfg.log_every == 0:
            metric_logger.update(**dict(zip(names, vec.tolist())))  # one read
    if not n_steps:
        return {}
    return dict(zip(names, (dp.all_reduce(sums) / (n_steps * dp.world)).tolist()))


@torch.no_grad()
def validate(eval_step, loader, cfg, *, device: torch.device, pin: bool = True,
             printer=print, prefix: str = "val", dp: DataParallel = LOCAL
             ) -> Dict[str, float]:
    """Masked-sum evaluation (reference tools/engine.py:78-104): the padded
    tail of the last batch is masked out; the sums are the ranks' (each rank
    evaluates its shard of the split)."""
    metric_logger = MetricLogger(printer=printer)
    steps = len(loader)
    if cfg.eval_steps:
        steps = min(steps, cfg.eval_steps)
    sums = None
    batches = itertools.islice(loader.epoch(0), steps)
    for images, labels, n_valid in metric_logger.log_every(
            batches, cfg.log_every, f"{prefix}:", total=steps, is_main=dp.is_main):
        labels = to_device(labels, device, pin)
        valid = torch.arange(labels.shape[0], device=device) < n_valid
        out = eval_step(to_device(images, device, pin), labels, valid)
        vec = torch.stack([out[k].double() for k in EVAL_SUMS])
        sums = vec if sums is None else sums + vec
    if sums is None:
        return {}
    loss_sum, correct1, correct5, count = dp.all_reduce(sums).tolist()
    n = max(count, 1.0)
    return {f"{prefix}_loss": loss_sum / n,
            f"{prefix}_acc1": correct1 / n * 100.0,
            f"{prefix}_acc5": correct5 / n * 100.0}


def eval_view(student):
    """The model validation runs: the student's parameters, single blocks,
    no features, and on the unfused path the forward-only fused MLP."""
    return student.view(mlp_fn=best_mlp_fn(student.attention_fn is not None),
                        block_pair_fn=None, collect_features=False)


def _profiler(cfg, device):
    """A torch.profiler over the first epoch when ``cfg.profile_dir`` is set."""
    if not cfg.profile_dir:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def run(cfg) -> Dict[str, float]:
    """Full training entry (reference tools/train.py:215-367). Runs on the
    card unless ``cfg.device`` is 'cpu'; without a card it raises. Under
    torchrun, or in a process group that already exists, it runs one rank of
    the mesh of ``cfg.mesh_shape`` (on card ``LOCAL_RANK``)."""
    device = rank_device(resolve_device(cfg.device or "cuda"))
    stop = threading.Event()
    try:   # the handler only sets a flag; the loop saves and returns
        previous = signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
        installed = True
    except ValueError:   # not in the main thread
        installed = False
    # cuDNN's convolution backward (the patch embedding) may otherwise pick an
    # algorithm that sums in a varying order
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _run(cfg, device, stop)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if installed:
            signal.signal(signal.SIGTERM, previous)


def _run(cfg, device: torch.device, stop: threading.Event) -> Dict[str, float]:
    mesh = make_mesh(cfg.mesh_shape, current_dp())   # with the JAX package's check
    dp = mesh.data
    pin = cfg.pin_mem and device.type == "cuda"
    log_file = get_timestamped_log_file_path(cfg.log_file)
    logger = setup_logger(log_file, is_main=mesh.is_main)
    logger.info(f"Training started with {cfg.teacher_model} as teacher and "
                f"{cfg.student_model} as student")
    logger.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                       if device.type == "cuda" else "")
                + f"; data axis of {dp.world} rank(s), model axis of {mesh.model.size}")

    teacher, student, aux = load_teacher_student(
        cfg, block_pair=os.environ.get("DELTAKD_PAIR") == "1", seed=cfg.seed,
        device=device, mesh=mesh)
    student_eval = eval_view(student)

    # startup banner: params / FLOPs / inference throughput (train.py:230-241):
    # the whole student's counts; the throughput of the eval view, which the
    # model ranks of data row 0 run together under a model axis
    if dp.rank == 0:
        throughput = measure_throughput(student_eval, batch_size=min(cfg.batch_size, 64),
                                        input_size=cfg.input_size)
    if mesh.is_main:
        params_m = count_params(student)
        flops = model_gflops(student, cfg.input_size)
        logger.info("Model Statistics:")
        logger.info(f"FLOPs: {flops:.2f}G")
        logger.info(f"Parameters: {params_m:.2f}M")
        logger.info(f"Throughput: {throughput:.2f} images/sec")
    wandb_run = WandbRun(enabled=cfg.wandb, project=cfg.wandb_project,
                         name=os.path.basename(log_file).replace(".log", ""), config=cfg,
                         is_main=mesh.is_main)
    if mesh.is_main:
        wandb_run.summary({"flops_G": flops, "params_M": params_m,
                           "throughput": throughput})

    # grad accumulation multiplies the train batch (the step splits it into
    # micro-batches); evaluation runs plain forwards at the batch size. Each
    # data rank loads its shard; the RASampler engages at a data axis > 1.
    train_loader = make_loader(cfg, build_source(cfg, is_train=True),
                               batch_size=cfg.batch_size * max(1, cfg.grad_accum_steps),
                               is_train=True, world=dp.world, rank=dp.rank,
                               repeated_aug=cfg.repeated_aug, seed=cfg.seed, pin_memory=pin)
    val_loader = make_loader(cfg, build_source(cfg, is_train=False),
                             batch_size=cfg.batch_size, is_train=False, world=dp.world,
                             rank=dp.rank, seed=cfg.seed, pin_memory=pin)
    steps_per_epoch = len(train_loader)
    if cfg.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, cfg.steps_per_epoch)
    tx = make_optimizer(cfg, trainable_parameters(student, aux), max(steps_per_epoch, 1))
    state = TrainState(student, tx=tx, aux=aux, ema_decay=cfg.ema_decay)

    start_epoch, best_val_acc = 0, 0.0
    if cfg.checkpoint:
        mesh.barrier()   # no rank reads a checkpoint before rank 0 has written it
        if cfg.resume:
            state, start_epoch, best_val_acc = load_checkpoint(cfg.checkpoint, state)
            logger.info(f"Resumed from {cfg.checkpoint} at epoch {start_epoch}")
        else:   # --finetune, or a bare --checkpoint
            load_student_for_finetune(cfg.checkpoint, student,
                                      num_prefix_tokens=student.cfg.num_prefix_tokens,
                                      log=logger.info)
            if cfg.finetune:
                logger.info(f"Finetuning from {cfg.checkpoint}")
    # every data rank starts from data rank 0's parameters (what DDP's
    # wrapper does); each model column broadcasts its own shards
    dp.broadcast(state.params)
    if state.ema_params is not None:
        dp.broadcast(state.ema_params)

    kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                teacher_prefix=teacher.cfg.num_prefix_tokens)
    aug = AugmentConfig.from_config(cfg)
    mixup = MixupConfig.from_config(cfg, num_classes=student.cfg.num_classes)
    train_step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher,
                                  aug=aug, mixup=mixup, tx=tx, aux=aux, dp=dp)
    eval_step = build_eval_step(student=student_eval, aug=aug)

    # --sched plateau: the decay on a stalled validation metric is the LR
    # scale on the optimizer state, set between epochs on the host. It rides
    # in the checkpoint, so a resumed run keeps its decayed LR. --lr-noise
    # rides on the same scale, times the plateau scale: installed at an
    # epoch's start and stripped again before the save, so the saved scale
    # is the plateau's alone.
    plateau_scale = get_lr_scale(state.opt_state)
    plateau_scale = 1.0 if plateau_scale is None else plateau_scale
    plateau = None
    if cfg.sched == "plateau":
        plateau = PlateauController(
            decay_rate=cfg.decay_rate, patience=cfg.patience_epochs,
            cooldown=cfg.cooldown_epochs, min_lr=cfg.min_lr, base_lr=cfg.lr,
            initial_scale=plateau_scale)

    if mesh.is_main:
        os.makedirs(cfg.save_dir, exist_ok=True)
    val_metrics: Dict[str, float] = {}
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        if cfg.lr_noise:
            noise = lr_noise_multiplier(cfg, epoch)
            set_lr_scale(state.opt_state, plateau_scale * noise)
            logger.info(f"lr noise: multiplier {noise:.6f}")
        generator, batch_generator = epoch_generators(cfg.seed, epoch, device, dp)
        with (_profiler(cfg, device) if epoch == start_epoch
              else contextlib.nullcontext()) as prof:
            train_metrics = train_one_epoch(
                state, train_step, train_loader, epoch, cfg, device=device,
                generator=generator, batch_generator=batch_generator, pin=pin, dp=dp)
        if prof is not None:
            trace_dir = cfg.profile_dir if mesh.world == 1 else os.path.join(
                cfg.profile_dir, f"rank{mesh.rank}")
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"trace_epoch{epoch}.json"))
        val_metrics = validate(eval_step, val_loader, cfg, device=device, pin=pin, dp=dp)
        wandb_run.log(train_metrics, step=epoch)
        wandb_run.log(val_metrics, step=epoch)
        logger.info(f"Epoch {epoch} ({time.time() - t0:.1f}s) - Train: {train_metrics} "
                    f"- Val: {val_metrics}")

        current = val_metrics.get("val_acc1", 0.0)
        if plateau is not None:
            # val_acc1 is the data ranks' all-reduced sum, so every rank sets
            # the same scale
            plateau_scale = plateau.epoch_end(current)
            logger.info(f"plateau scheduler: lr scale {plateau_scale:.6f}")
        if plateau is not None or cfg.lr_noise:
            set_lr_scale(state.opt_state, plateau_scale)
        is_best = current > best_val_acc
        best_val_acc = max(best_val_acc, current)
        if dp.rank == 0:   # data row 0 gathers its shards; global rank 0 writes
            save_checkpoint(os.path.join(cfg.save_dir, "checkpoint"), state,
                            epoch=epoch + 1, best_acc=best_val_acc, is_best=is_best,
                            write=mesh.is_main)
        mesh.barrier()
        if mesh.any_rank(stop.is_set(), device):   # every rank stops after the same epoch
            logger.info(f"SIGTERM received — checkpoint saved at epoch {epoch + 1}, "
                        f"exiting for resume")
            break

    logger.info("Training completed")
    logger.info(f"Final validation metrics: {val_metrics}")
    wandb_run.finish()
    return {**val_metrics, "best_val_acc": best_val_acc}
