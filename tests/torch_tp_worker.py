"""One rank of the port's tensor-parallel checks on the CPU, for
``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tensor_parallel_mesh.py`` and
``tests/test_torch_eight_ranks.py``: ``python -m tests.torch_tp_worker RANK
WORLD PORT SPEC OUT`` joins a gloo group of WORLD processes on
localhost:PORT, lays them out as the mesh the SPEC file (``torch.save``'d by
the test) names, or one after another as each mesh of its ``meshes``, runs
the tasks of each and writes what it found to OUT/rank<RANK>.pt. Imports
torch and the port, never JAX.

Tasks: train steps on pinned images, each model loaded from the JAX
package's parameters through ``flax_to_torch_shard`` (the rank's shards),
or at a model axis of 1 with ``fused`` through the fused block's plain
version, on the rows of the rank's data rank, each with ``eval`` followed
by the masked eval step on the data rank's rows of the step's images;
mixup in its three modes over the data group; with ``run`` in the spec,
``run()`` at mesh (2, 2) (two epochs straight, a finetune from its
checkpoint, the eval CLI), then on ranks 0 and 1 in a group of two at mesh
(2, 1) (two epochs straight, the (2, 2) run's epoch-1 checkpoint resumed,
the same finetune), then on all four ranks at (2, 2) again (the (2, 1)
run's epoch-1 checkpoint resumed); with ``run_meshes``, ``run()`` for one
epoch at each of its (mesh, per-data-rank batch) over the whole group.
"""

import os
import sys

import torch
import torch.distributed as dist

from deltakd_tpu_torch.cli.eval import main as eval_main
from deltakd_tpu_torch.configs.config import TrainConfig, parse_args
from deltakd_tpu_torch.data import mixup as tm
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.kd.losses import KDSettings, feature_indices
from deltakd_tpu_torch.models import registry
from deltakd_tpu_torch.models.convert import flax_to_torch, flax_to_torch_shard
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.attention import flash_attention
from deltakd_tpu_torch.ops.fused_block import fused_vit_block
from deltakd_tpu_torch.ops.fused_mlp import fused_mlp
from deltakd_tpu_torch.parallel import current, make_mesh
from deltakd_tpu_torch.parallel.tensor import full_state_dict, load_full_state_dict
from deltakd_tpu_torch.train import loop
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_eval_step, build_train_step

# the run() models: depth 2, a 3-head student (the gather route at M = 2)
# and a 4-head teacher, registered in this process only
RUN_MODELS = {"tp_tiny_distilled": dict(embed_dim=48, depth=2, num_heads=3, distilled=True),
              "tp_small_distilled": dict(embed_dim=64, depth=2, num_heads=4, distilled=True)}


def _model(kw, flax_params, mesh, teacher=False, fused=False):
    """The unfused model of the factory's TP route, this rank's shards; with
    ``fused`` (no model axis) the factory's fused route, whole."""
    if fused:
        m = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block)
        m.load_state_dict(flax_to_torch(flax_params))
        return m
    m = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, attention_fn=flash_attention,
                          mlp_fn=fused_mlp if teacher else None, tp=mesh.model)
    m.load_state_dict(flax_to_torch_shard(flax_params, kw["num_heads"], mesh.model.size,
                                          mesh.model.rank))
    return m


def _inverses(student, state, full):
    """The gathers the port runs, each against the cut it inverts: the
    parameters gathered (``full_state_dict``) against ``flax_to_torch``'s
    full state_dict ``full``, cut again (``load_full_state_dict``) against
    the shards, and the flat vector's gather and cut (``FlatShards``)."""
    gathered = full_state_dict(student)
    local = [p.detach().clone() for p in student.parameters()]
    load_full_state_dict(student, gathered)
    return {"gather": set(gathered) == set(full)
            and all(torch.equal(gathered[k], v) for k, v in full.items()),
            "cut": all(torch.equal(p, q) for p, q in zip(student.parameters(), local)),
            "flat": state.shards is None   # no model axis: nothing to gather
            or torch.equal(state.shards.cut(state.shards.gather(state.params)), state.params)}


def train_step_task(t, mesh):
    """One train step on the data rank's rows: the metrics, the flat gradient
    it applied (local, and gathered into the full layout), the local
    parameters and which of them are shards, the full parameters after the
    update, and before it whether the gathers invert the shard cut; with
    ``eval``, the masked eval step's sums on the data rank's rows of the
    step's images, the last 3 of the global batch invalid."""
    dp = mesh.data
    rows = torch.as_tensor(t["rows"][dp.rank])
    fused = t.get("fused", False)
    student = _model(t["student_kw"], t["student_params"], mesh, fused=fused)
    teacher = _model(t["teacher_kw"], t["teacher_params"], mesh, teacher=True, fused=fused)
    cfg = TrainConfig(aa="", color_jitter=0.0, **t["hp"])
    kd_type = cfg.distillation_type
    aux = None
    if t.get("aux_sd") is not None:
        aux = AuxHeads(kd_type, t["student_kw"]["embed_dim"], t["teacher_kw"]["embed_dim"],
                       torch.Generator().manual_seed(0))
        aux.load_state_dict(t["aux_sd"])
        student.collect_features = feature_indices(kd_type, t["student_kw"]["depth"])
        teacher.collect_features = feature_indices(kd_type, t["teacher_kw"]["depth"])
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 5)
    state = TrainState(student, tx=tx, aux=aux, ema_decay=cfg.ema_decay)
    inverses = _inverses(student, state, flax_to_torch(t["student_params"]))
    applied = []
    apply = state.apply_gradients
    state.apply_gradients = lambda *, grads, **kw: (applied.append(grads.clone()),
                                                    apply(grads=grads, **kw))
    prefix = student.cfg.num_prefix_tokens
    fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=prefix,
                                                             teacher_prefix=2),
                          student=student, teacher=teacher, aux=aux,
                          aug=AugmentConfig.from_config(cfg),
                          mixup=tm.MixupConfig.from_config(cfg, t["student_kw"]["num_classes"]),
                          tx=tx, dp=dp)
    u8 = t["u8"][rows]
    m = fn(state, u8, t["labels"][rows], torch.Generator().manual_seed(0),
           images=u8.float() / 64.0 - 2.0,
           targets=None if t.get("targets") is None else t["targets"][rows],
           mask_noise=None if t.get("noise") is None else t["noise"][rows])
    shards = state.shards   # None without a model axis: every tensor whole
    out = {"metrics": {k: float(v) for k, v in m.items()}, "grads": applied[0],
           "full_grads": applied[0] if shards is None else shards.gather(applied[0]),
           "params": state.params.clone(),
           "sharded": torch.zeros_like(state.params, dtype=torch.bool) if shards is None
           else shards.mask.clone(), "student": full_state_dict(student),
           "aux": None if aux is None else aux.state_dict(), "inverses": inverses}
    if t.get("eval"):
        n = t["u8"].shape[0]
        b = n // dp.world
        mine = slice(dp.rank * b, (dp.rank + 1) * b)
        sums = build_eval_step(student=student, aug=AugmentConfig.from_config(cfg))(
            t["u8"][mine], t["labels"][mine], torch.arange(n)[mine] < n - 3)
        out["eval"] = {k: float(v) for k, v in sums.items()}
    return out


def mixup_task(t, mesh):
    dp = mesh.data
    out = {}
    for mode, (images, labels, draws, mc_kw) in t.items():
        b = images.shape[0] // dp.world
        rows = slice(dp.rank * b, (dp.rank + 1) * b)
        out[mode] = tm.mix_batch(images[rows], labels[rows], tm.MixupConfig(**mc_kw),
                                 tm.MixupDraws(*draws), dp)
    return out


def _argv(tmp, name, mesh_shape, *extra, batch=4):
    return ["--device", "cpu", "--synthetic-data", "--dataset", "synthetic", "--input-size",
            "32", "--batch-size", str(batch), "--steps-per-epoch", "2", "--eval-steps", "2",
            "--dtype", "float32", "--student-model", "tp_tiny_distilled", "--teacher-model",
            "tp_small_distilled", "--distillation-type", "soft", "--allow-random-teacher",
            "--log-every", "1", "--ema-decay", "0.9", "--log-file",
            os.path.join(tmp, "logs", name),
            "--save-dir", os.path.join(tmp, name), "--mesh-shape", *mesh_shape.split(),
            *extra]


class SaveRecorder:
    """Records run()'s checkpoint saves: the epoch and whether this rank wrote."""

    def __init__(self):
        self.saves, self._save = [], loop.save_checkpoint

    def __enter__(self):
        def save_checkpoint(*args, **kw):
            self.saves.append((kw["epoch"], kw.get("write", True)))
            return self._save(*args, **kw)

        loop.save_checkpoint = save_checkpoint
        return self

    def __exit__(self, *exc):
        loop.save_checkpoint = self._save


def _ckpt(tmp, name):
    return os.path.join(tmp, name, "checkpoint")


def run_task(tmp, rank, ports):
    """run() at (2, 2) on four ranks, at (2, 1) on two, and at (2, 2) again;
    each resume starts from the other mesh's epoch-1 checkpoint."""
    out = {}
    with SaveRecorder() as rec:
        out["tp_straight"] = loop.run(parse_args(_argv(tmp, "tp_straight", "2 2",
                                                       "--epochs", "2")))
    out["tp_saves"] = rec.saves
    out["tp_finetune"] = loop.run(parse_args(_argv(
        tmp, "tp_finetune", "2 2", "--epochs", "1", "--finetune", "--checkpoint",
        _ckpt(tmp, "tp_straight"))))
    out["eval"] = eval_main(_argv(tmp, "tp_straight", "2 2", "--epochs", "2") + [
        "--checkpoint", _ckpt(tmp, "tp_straight"),
        "--output", os.path.join(tmp, f"eval{rank}.json")])
    dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{ports[0]}",
                                world_size=2, rank=rank)
        out["dp_straight"] = loop.run(parse_args(_argv(tmp, "dp_straight", "2 1",
                                                       "--epochs", "2")))
        out["dp_resumed"] = loop.run(parse_args(_argv(
            tmp, "dp_resumed", "2 1", "--epochs", "2", "--resume", "--checkpoint",
            os.path.join(_ckpt(tmp, "tp_straight"), "state-1"))))
        out["dp_finetune"] = loop.run(parse_args(_argv(
            tmp, "dp_finetune", "2 1", "--epochs", "1", "--finetune", "--checkpoint",
            _ckpt(tmp, "tp_straight"))))
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{ports[1]}",
                            world_size=4, rank=rank)
    out["tp_resumed"] = loop.run(parse_args(_argv(
        tmp, "tp_resumed", "2 2", "--epochs", "2", "--resume", "--checkpoint",
        os.path.join(_ckpt(tmp, "dp_straight"), "state-1"))))
    return out


def run_meshes_task(tmp, meshes):
    """run() for one epoch in the first warmup epoch (as
    ``tests/test_integration.py`` runs it) at each (mesh shape, per-data-rank
    batch) of ``meshes`` over the whole group; each result with this rank's
    checkpoint saves."""
    out = {}
    for shape, batch in meshes:
        name = "run_" + shape.replace(" ", "_")
        with SaveRecorder() as rec:
            out[shape] = loop.run(parse_args(_argv(tmp, name, shape, "--epochs", "1",
                                                   "--warmup-epochs", "1", batch=batch)))
        out[shape + " saves"] = rec.saves
    return out


def mesh_tasks(spec, mesh):
    """The train steps and mixup of ``spec`` on ``mesh``."""
    out = {"mesh": (mesh.shape, mesh.data.rank, mesh.model.rank)}
    for name, task in spec["steps"].items():
        out[name] = train_step_task(task, mesh)
    if spec.get("mixup"):
        out["mixup"] = mixup_task(spec["mixup"], mesh)
    return out


def main(rank, world, port, spec_path, out_dir):
    torch.set_num_threads(1)
    for name, kw in RUN_MODELS.items():
        registry.MODEL_REGISTRY[name] = ViTConfig(img_size=32, **kw)
    spec = torch.load(spec_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    if "meshes" in spec:
        out = {shape: mesh_tasks(s, make_mesh(shape, current()))
               for shape, s in spec["meshes"].items()}
    else:
        out = mesh_tasks(spec, make_mesh(spec["mesh_shape"], current()))
        out["subset_ops"] = AugmentConfig.from_config(
            TrainConfig(dataset="cifar-100", mesh_shape=spec["mesh_shape"])).subset_ops
    if spec.get("run"):
        out["run"] = run_task(spec["tmp"], rank, spec["run_ports"])
    if spec.get("run_meshes"):
        out["run"] = run_meshes_task(spec["tmp"], spec["run_meshes"])
    dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
