"""One rank of the port's data-parallel checks on the CPU, for
``tests/test_torch_distributed.py``: ``python -m tests.torch_dp_worker RANK
WORLD PORT SPEC OUT`` joins a gloo group of WORLD processes on localhost:PORT,
runs the tasks the SPEC file (``torch.save``'d by the test) describes on its
rows of each global batch, and writes what it found to OUT/rank<RANK>.pt.
Imports torch and the port, never JAX.

Tasks: the soft, soft with two accumulated micro-batches, lrkd and diffkd
train steps on pinned images; mixup in its three modes on the global draws;
the epoch's two generators; the any-rank stop flag; ``validate`` on the
rank's shard; ``run()`` (the loaders it builds, who writes the checkpoints,
a straight run and a resumed one) and the eval CLI; then rank 0 alone runs
``run()`` in a world-1 group and in no group.
"""

import os
import sys

import torch
import torch.distributed as dist

from deltakd_tpu_torch import parallel
from deltakd_tpu_torch.cli.eval import main as eval_main
from deltakd_tpu_torch.configs.config import TrainConfig, parse_args
from deltakd_tpu_torch.data import mixup as tm
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.pipeline import Loader
from deltakd_tpu_torch.data.sources import ArraySource
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.kd.losses import DiffKDDraws, KDSettings
from deltakd_tpu_torch.models import registry
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.fused_block import fused_vit_block
from deltakd_tpu_torch.train import loop
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_eval_step, build_train_step

# the run() models: depth 2, D = 32 and 64, registered in this process only
RUN_MODELS = {"dp_tiny_distilled": dict(embed_dim=32, depth=2, num_heads=2, distilled=True),
              "dp_small_distilled": dict(embed_dim=64, depth=2, num_heads=2, distilled=True)}


def pinned_images(u8: torch.Tensor) -> torch.Tensor:
    """The post-transform batch both packages' steps take: u8 / 64 - 2."""
    return u8.float() / 64.0 - 2.0


def _model(kw, state_dict):
    m = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block)
    m.load_state_dict(state_dict)
    return m


def train_step_task(t, dp):
    """One train step on this rank's rows; the flat gradient it applied."""
    rows = torch.as_tensor(t["rows"][dp.rank])
    student = _model(t["student_kw"], t["student_sd"])
    teacher = _model(t["teacher_kw"], t["teacher_sd"])
    cfg = TrainConfig(aa="", color_jitter=0.0, **t["hp"])
    kd_type = cfg.distillation_type
    aux = None
    if t.get("aux_sd") is not None:
        aux = AuxHeads(kd_type, t["student_kw"]["embed_dim"], t["teacher_kw"]["embed_dim"],
                       torch.Generator().manual_seed(0), lrkd_rank=cfg.lrkd_rank)
        aux.load_state_dict(t["aux_sd"])
        student.collect_features = teacher.collect_features = {0, 1}
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 5)
    state = TrainState(student, tx=tx, aux=aux, ema_decay=cfg.ema_decay)
    applied = []
    apply = state.apply_gradients
    state.apply_gradients = lambda *, grads, **kw: (applied.append(grads.clone()),
                                                    apply(grads=grads, **kw))
    mixup = tm.MixupConfig.from_config(cfg, t["student_kw"]["num_classes"])
    fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2,
                                                             teacher_prefix=2),
                          student=student, teacher=teacher, aux=aux,
                          aug=AugmentConfig.from_config(cfg), mixup=mixup, tx=tx, dp=dp)
    u8 = t["u8"][rows]
    draws = None
    if t.get("diffkd") is not None:
        t_step, noise, keep = t["diffkd"]
        draws = DiffKDDraws(t_step[rows], [n[rows] for n in noise], [k[rows] for k in keep])
    m = fn(state, u8, t["labels"][rows], torch.Generator().manual_seed(0),
           images=pinned_images(u8),
           targets=None if t.get("targets") is None else t["targets"][rows],
           diffkd_draws=draws)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": applied[0],
            "params": state.params.clone(), "student": student.state_dict(),
            "aux": None if aux is None else aux.state_dict()}


def mixup_task(t, dp):
    out = {}
    for mode, (images, labels, draws, mc_kw) in t.items():
        b = images.shape[0] // dp.world
        rows = slice(dp.rank * b, (dp.rank + 1) * b)
        out[mode] = tm.mix_batch(images[rows], labels[rows], tm.MixupConfig(**mc_kw),
                                 tm.MixupDraws(*draws), dp)
    return out


def generators_task(dp):
    """One epoch's draws from each of the two generators."""
    per_image, batch = loop.epoch_generators(7, 3, torch.device("cpu"), dp)
    return {"per_image": torch.rand(8, generator=per_image),
            "batch": torch.rand(8, generator=batch),
            "aug": AugmentConfig.from_config(TrainConfig(dataset="cifar-100")).subset_ops,
            "aug_model_axis": AugmentConfig.from_config(
                TrainConfig(dataset="cifar-100", mesh_shape=(1, 2))).subset_ops}


def validate_task(t, dp):
    student = _model(t["student_kw"], t["student_sd"])
    cfg = TrainConfig(dataset="synthetic", input_size=32)
    loader = Loader(ArraySource(t["images"], t["labels"], t["student_kw"]["num_classes"]),
                    batch_size=t["batch_size"], is_train=False, world=dp.world, rank=dp.rank)
    eval_step = build_eval_step(student=student, aug=AugmentConfig.from_config(cfg))
    return loop.validate(eval_step, loader, cfg, device=torch.device("cpu"), pin=False,
                         dp=dp, printer=lambda *a: None)


def _argv(tmp, name, *extra):
    return ["--device", "cpu", "--synthetic-data", "--dataset", "synthetic", "--input-size",
            "32", "--batch-size", "4", "--steps-per-epoch", "2", "--eval-steps", "2",
            "--dtype", "float32", "--student-model", "dp_tiny_distilled", "--teacher-model",
            "dp_small_distilled", "--distillation-type", "soft", "--allow-random-teacher",
            "--log-every", "1", "--log-file", os.path.join(tmp, "logs", name),
            "--save-dir", os.path.join(tmp, name), *extra]


class RunRecorder:
    """Records the loaders run() builds and the checkpoint saves it makes."""

    def __init__(self):
        self.loaders, self.saves = [], []
        self._make_loader, self._save = loop.make_loader, loop.save_checkpoint

    def __enter__(self):
        def make_loader(cfg, source, **kw):
            ld = self._make_loader(cfg, source, **kw)
            self.loaders.append(dict(is_train=kw["is_train"], world=kw["world"],
                                     rank=kw["rank"], steps=len(ld), indices=ld.indices(0)))
            return ld

        def save_checkpoint(*args, **kw):
            self.saves.append(kw["epoch"])
            return self._save(*args, **kw)

        loop.make_loader, loop.save_checkpoint = make_loader, save_checkpoint
        return self

    def __exit__(self, *exc):
        loop.make_loader, loop.save_checkpoint = self._make_loader, self._save


def run_task(tmp, dp):
    with RunRecorder() as rec:
        straight = loop.run(parse_args(_argv(tmp, "straight", "--epochs", "2")))
        loop.run(parse_args(_argv(tmp, "resumed", "--epochs", "1")))
        ckpt = os.path.join(tmp, "resumed", "checkpoint")
        resumed = loop.run(parse_args(_argv(tmp, "resumed", "--epochs", "2", "--resume",
                                            "--checkpoint", ckpt)))
    test = eval_main(_argv(tmp, "straight", "--epochs", "2") + [
        "--checkpoint", os.path.join(tmp, "straight", "checkpoint"),
        "--output", os.path.join(tmp, "eval.json")])
    return {"straight": straight, "resumed": resumed, "eval": test,
            "loaders": rec.loaders, "saves": rec.saves,
            "stop": parallel.make_mesh(None, dp).any_rank(dp.rank == dp.world - 1,
                                                          torch.device("cpu"))}


def world_one_task(tmp, port):
    """run() in a world-1 gloo group, then in no group at all."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    in_group = loop.run(parse_args(_argv(tmp, "world1", "--epochs", "1")))
    dist.destroy_process_group()
    plain = loop.run(parse_args(_argv(tmp, "plain", "--epochs", "1")))
    return {"in_group": in_group, "plain": plain}


def main(rank, world, port, spec_path, out_dir):
    torch.set_num_threads(1)
    for name, kw in RUN_MODELS.items():
        registry.MODEL_REGISTRY[name] = ViTConfig(img_size=32, **kw)
    spec = torch.load(spec_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    dp = parallel.current()
    out = {"dp": (dp.world, dp.rank)}
    for name, task in spec["steps"].items():
        out[name] = train_step_task(task, dp)
    out["mixup"] = mixup_task(spec["mixup"], dp)
    out["generators"] = generators_task(dp)
    out["validate"] = validate_task(spec["validate"], dp)
    out["run"] = run_task(spec["tmp"], dp)
    dist.destroy_process_group()
    if rank == 0:
        out["world1"] = world_one_task(spec["tmp"], spec["port1"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
