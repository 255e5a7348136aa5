"""The port's tensor parallelism on the CPU at mesh (1, 2): two gloo processes
(``tests/torch_tp_worker.py``, one thread each) hold the Megatron shards of
one replica (``parallel/tensor.py``), each model loaded from the JAX
package's parameters through ``flax_to_torch_shard``, against the JAX step
on ``make_mesh((1, 2), devices=jax.devices()[:2])`` of the 8-device CPU
platform that ``conftest.py`` sets up, its state placed by
``state_shardings`` and its teacher by ``param_shardings``:

- the soft step with a 4-head student (attention on each rank's 2 heads)
  and with a 3-head student (the qkv output gathered, attention on all 3),
  a 4-head teacher through the fused MLP's plain version on its shards:
  losses to 1e-5 of the step's largest loss value, grad norm and the
  gathered applied gradient's norm to 1e-4, the updated parameters
  (gathered) to 1e-6 absolute, as in ``tests/test_torch_distributed.py``;
  the replicated tensors the same bits on both ranks;
- process-free: ``param_spec`` against JAX's ``_param_spec`` over DeiT-Ti's
  tree and every aux head's, the shard cut and its inverse (the port's
  gathers held to the cut in the ranks), the
  ``ValueError`` for a dimension the model axis does not divide,
  ``subset_ops`` by mesh shape, and the recipes' "D M" launch.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.kd.aux import init_aux_params
from deltakd_tpu.kd.losses import FEATURE_TYPES
from deltakd_tpu.kd.losses import KDSettings as JKDSettings
from deltakd_tpu.models.registry import get_model_config as j_get_model_config
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.parallel import mesh as jmesh
from deltakd_tpu.train import step as jstep
from deltakd_tpu.train.optim import make_optimizer as j_make_optimizer
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch import parallel
from deltakd_tpu_torch.configs import config as pconfig
from deltakd_tpu_torch.data import augment as ta
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.models.convert import aux_flax_to_torch, flax_to_torch, flax_to_torch_shard
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.parallel import tensor as ptensor

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 10
KEY = jax.random.PRNGKey(0)
HP = dict(distillation_type="soft", alpha=0.5, tau=2.0, drop_path_rate=0.0, lr=1e-3,
          warmup_epochs=0, epochs=10, opt_eps=1e-4, clip_grad=1.0, ema_decay=0.9,
          dataset="cifar-10", input_size=32, dtype="float32")
BASE = dict(img_size=32, patch_size=8, depth=2, num_classes=C, distilled=True)
TEACHER = dict(BASE, embed_dim=64, num_heads=4)
STUDENTS = {"soft_4_heads": dict(BASE, embed_dim=32, num_heads=4),
            "soft_3_heads": dict(BASE, embed_dim=48, num_heads=3)}
MESH, BG = (1, 2), 8


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _shapes(items):
    return jax.eval_shape(lambda: JViT(JViTConfig(**dict(items)), dtype=jnp.float32).init(
        {"params": KEY}, jnp.zeros((1, 32, 32, 3))))["params"]


def random_tree(shapes, seed):
    """Parameters of JAX's tree ``shapes`` from a seed: std 0.02, LayerNorm
    scales about 1 (cheaper than the JAX init, biases not zero)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        v = 0.02 * rng.standard_normal(leaf.shape)
        return (v + (getattr(path[-1], "key", "") == "scale")).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def init_params(kw, seed):
    """The JAX ViT's parameters for ``kw``, random from ``seed``."""
    return random_tree(_shapes(tuple(sorted(kw.items()))), seed)


def data_rows(shape, batch, accum):
    """Data rank d's rows of the global batch: per micro-batch i its share."""
    D = shape[0]
    mb = batch // D
    return [np.concatenate([np.arange(i * batch + d * mb, i * batch + (d + 1) * mb)
                            for i in range(accum)]) for d in range(D)]


def jax_step(t, mesh):
    """The JAX step on ``mesh``, its state placed by ``state_shardings`` and
    the teacher by ``param_shardings``, its transform replaced by u8 / 64 - 2,
    its mixup by the pinned targets; with ``fused`` in ``t`` both models on
    the Pallas fused block in interpret mode (the JAX dry run's fused case).
    Returns (metrics, student state_dict, aux state_dict or None); with
    ``eval`` in ``t`` the metrics also hold ``eval_<sum>``: the masked eval
    step on the updated student over the step's images, the last 3 rows
    invalid (the JAX dry run's eval)."""
    block_fn = jfb.fused_vit_block if t.get("fused") else None
    j_student = JViT(JViTConfig(**t["student_kw"]), dtype=jnp.float32, block_fn=block_fn)
    j_teacher = JViT(JViTConfig(**t["teacher_kw"]), dtype=jnp.float32, block_fn=block_fn)
    jcfg = JTrainConfig(**t["hp"])
    targets, aux_tree = t["targets"], t["aux_tree"]
    with pytest.MonkeyPatch.context() as mp:
        if block_fn is not None:
            mp.setattr(jfb, "_INTERPRET", True)
        mp.setattr(jstep, "train_transform",
                   lambda k, x, ac: x.astype(jnp.float32) / 64.0 - 2.0)
        if targets is not None:
            mp.setattr(jstep, "apply_mixup",
                       lambda k, x, y, mc: (x, jnp.asarray(targets.numpy())))
        jtx = j_make_optimizer(jcfg, {"student": t["student_params"], "aux": aux_tree}, 5)
        jstate = JTrainState.create(student_params=t["student_params"], aux_params=aux_tree,
                                    tx=jtx, ema_decay=jcfg.ema_decay)
        fn = jstep.build_train_step(
            cfg=jcfg, kd=JKDSettings.from_config(
                jcfg, student_prefix=2 if t["student_kw"]["distilled"] else 1,
                teacher_prefix=2),
            student_module=j_student, teacher_module=j_teacher,
            aug=JAugmentConfig(input_size=32),
            mixup=None if targets is None else JMixupConfig(num_classes=C), tx=jtx,
            donate=False, batch_shard=jmesh.batch_sharding(mesh))
        shard = jmesh.batch_sharding(mesh)
        images = jax.device_put(jnp.asarray(t["u8"].numpy()), shard)
        labels = jax.device_put(jnp.asarray(t["labels"].numpy()), shard)
        jstate, metrics = fn(
            jax.device_put(jstate, jmesh.state_shardings(mesh, jstate)),
            jax.device_put(t["teacher_params"],
                           jmesh.param_shardings(mesh, t["teacher_params"])),
            images, labels, KEY, jnp.asarray(0, jnp.int32))
        metrics = {k: float(v) for k, v in metrics.items()}
        if t.get("eval"):
            n = images.shape[0]
            sums = jstep.build_eval_step(student_module=j_student,
                                         aug=JAugmentConfig.from_config(jcfg))(
                jstate.params["student"], images, labels,
                jax.device_put(np.arange(n) < n - 3, shard))
            metrics.update({f"eval_{k}": float(v) for k, v in sums.items()})
    jstate = jax.device_get(jstate)
    return (metrics, flax_to_torch(jstate.params["student"]),
            aux_flax_to_torch(jstate.params["aux"]) if aux_tree else None)


def step_spec(hp, student_kw, teacher_kw, shape, rng, seed, targets=True, aux_tree=None,
              batch=BG):
    """One step's task at global ``batch`` a micro-batch."""
    accum = hp.get("grad_accum_steps", 1)
    return dict(hp=hp, rows=data_rows(shape, batch, accum), student_kw=student_kw,
                teacher_kw=teacher_kw, student_params=init_params(student_kw, seed),
                teacher_params=init_params(teacher_kw, seed + 1), aux_tree=aux_tree or {},
                aux_sd=aux_flax_to_torch(aux_tree) if aux_tree else None,
                u8=torch.from_numpy(rng.randint(0, 256, (batch * accum, 32, 32, 3))
                                    .astype(np.uint8)),
                labels=torch.from_numpy(rng.randint(0, C, batch * accum)),
                targets=torch.from_numpy(rng.dirichlet(np.ones(C), batch).astype(np.float32))
                if targets else None)


def _without_trees(steps):
    return {k: {kk: vv for kk, vv in v.items() if kk != "aux_tree"} for k, v in steps.items()}


def launch(spec, world, tmp, jax_side):
    """Starts the ranks, runs ``jax_side()`` meanwhile; returns (the ranks'
    results, what ``jax_side`` returned)."""
    spec_path = str(tmp / "spec.pt")
    if "meshes" in spec:
        saved = {**spec, "meshes": {shape: {**s, "steps": _without_trees(s["steps"])}
                                    for shape, s in spec["meshes"].items()}}
    else:
        saved = {**spec, "steps": _without_trees(spec["steps"])}
    torch.save(saved, spec_path)
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_tp_worker", str(r),
                               str(world), str(port), spec_path, str(tmp)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        ref = jax_side()
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
            for r in range(world)], ref


def check_step(got, ref, name):
    """The bounds of ``tests/test_torch_distributed.py``: the data ranks'
    mean losses to 1e-5 of the largest, grad norm and the gathered applied
    gradient's norm to 1e-4, every rank's gathered parameters to 1e-6."""
    jm, jstudent, jaux = ref
    losses = ("train_loss", "base_loss", "distill_loss")
    largest = max(abs(jm[k]) for k in losses)
    for k in losses:
        got_k = np.mean([g[name]["metrics"][k] for g in got])
        assert abs(got_k - jm[k]) <= 1e-5 * largest, (k, got_k, jm[k])
    for g in got:
        np.testing.assert_allclose(g[name]["metrics"]["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)
        norm = float(torch.linalg.vector_norm(g[name]["full_grads"]))
        np.testing.assert_allclose(norm, jm["grad_norm"], rtol=1e-4)
        for pname, p in g[name]["student"].items():
            np.testing.assert_allclose(p.numpy(), jstudent[pname].numpy(), atol=1e-6,
                                       err_msg=pname)
        if jaux is not None:
            for pname, p in g[name]["aux"].items():
                np.testing.assert_allclose(p.numpy(), jaux[pname].numpy(), atol=1e-6,
                                           err_msg=pname)


def check_replicas(got, name, M):
    """Model ranks of one data row: the replicated tensors the same bits;
    data ranks of one model column: everything the same bits."""
    for g in got:
        a = got[g["mesh"][1] * M]   # model rank 0 of this data row
        repl = ~g[name]["sharded"]
        assert torch.equal(g[name]["params"][repl], a[name]["params"][repl])
        assert torch.equal(g[name]["grads"][repl], a[name]["grads"][repl])
        b = got[g["mesh"][2]]       # data rank 0 of this model column
        assert torch.equal(g[name]["params"], b[name]["params"])
        assert torch.equal(g[name]["full_grads"], got[0][name]["full_grads"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp12")
    rng = np.random.RandomState(0)
    hp = dict(HP, mesh_shape=MESH)
    spec = {"mesh_shape": MESH, "tmp": str(tmp),
            "steps": {name: step_spec(hp, kw, TEACHER, MESH, rng, 3 + i)
                      for i, (name, kw) in enumerate(STUDENTS.items())}}
    mesh = jmesh.make_mesh(MESH, devices=jax.devices()[:2])
    got, ref = launch(spec, 2, tmp,
                      lambda: {name: jax_step(t, mesh) for name, t in spec["steps"].items()})
    return got, ref


@pytest.mark.parametrize("name", list(STUDENTS))
def test_step_matches_the_jax_mesh(ranks, name):
    got, ref = ranks
    assert [g["mesh"] for g in got] == [((1, 2), 0, 0), ((1, 2), 0, 1)]
    check_step(got, ref[name], name)


@pytest.mark.parametrize("name", list(STUDENTS))
def test_ranks_hold_the_same_replicated_tensors(ranks, name):
    got, _ = ranks
    check_replicas(got, name, 2)
    # the shards differ between the model ranks, and hold 3 D^2 + 3 D^2 + 8 D^2
    # of the blocks' 12 D^2 weights each
    a, b = got
    sharded = a[name]["sharded"]
    assert not torch.equal(a[name]["params"][sharded], b[name]["params"][sharded])
    D, depth = STUDENTS[name]["embed_dim"], STUDENTS[name]["depth"]
    assert int(sharded.sum()) == depth * 12 * D * D // 2


@pytest.mark.parametrize("name", list(STUDENTS))
def test_the_gathers_invert_the_shard_cut(ranks, name):
    """On each rank, before the step: the student's parameters gathered over
    the model group and cut again (``full_state_dict`` and
    ``load_full_state_dict``, what a finetune load runs) are
    ``flax_to_torch``'s full state_dict and then the rank's shards, and the
    flat vector's gather and cut (``FlatShards``, what a checkpoint's save
    and resume run) give it back."""
    got, _ = ranks
    assert [g[name]["inverses"] for g in got] == [
        {"gather": True, "cut": True, "flat": True}] * len(got)


def test_subset_ops_follow_the_data_axis(ranks):
    """At mesh (1, 2) on two ranks the batch is not split: the RA subset ops
    run, as JAX's ``_mesh_is_single_data_shard`` says; in one process they
    follow the data axis of ``mesh_shape`` (None: the rank count)."""
    got, _ = ranks
    assert all(g["subset_ops"] for g in got)
    for shape, want in (((1, 2), True), ((2, 2), False), ((2, 1), False), (None, True)):
        assert ta.AugmentConfig.from_config(
            pconfig.TrainConfig(dataset="cifar-100", mesh_shape=shape)).subset_ops is want


def _port_name(path):
    """A Flax param path of the ViT as the port's parameter name."""
    names = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
    if names[0] == "patch_embed":
        return "patch_embed.proj." + {"kernel": "weight", "bias": "bias"}[names[1]]
    names = [n.replace("blocks_", "blocks.") for n in names]
    names[-1] = {"kernel": "weight", "scale": "weight"}.get(names[-1], names[-1])
    return ".".join(names)


def test_param_spec_names_the_tensors_jax_shards():
    """Over DeiT-Ti's tree (shapes only) and every aux head's, the port's
    rule on its names gives JAX's ``_param_spec``: column where JAX splits
    the output features, row where it splits the input features."""
    kinds = {jmesh.P(None, "model"): "column", jmesh.P("model", None): "row", jmesh.P(): None}
    cfg = j_get_model_config("deit_tiny_distilled_patch16_224", num_classes=100)
    tree = jax.eval_shape(lambda: JViT(cfg).init({"params": KEY}, jnp.zeros((1, 224, 224, 3))))
    want = {_port_name(path): kinds[jmesh._param_spec(path, leaf)] for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
    model = VisionTransformer(ViTConfig(depth=12, distilled=True, num_classes=100))
    got = {n: parallel.param_spec(n, p) for n, p in model.named_parameters()}
    assert got == want
    assert sum(k is not None for k in got.values()) == 48
    for kd_type in FEATURE_TYPES:
        aux_tree = jax.eval_shape(lambda t=kd_type: init_aux_params(KEY, t, 192, 384))
        leaves = jax.tree_util.tree_flatten_with_path(aux_tree)[0]
        assert all(jmesh._param_spec(path, leaf) == jmesh.P() for path, leaf in leaves)
        aux = AuxHeads(kd_type, 192, 384, torch.Generator().manual_seed(0))
        assert all(parallel.param_spec(n, p) is None for n, p in aux.named_parameters())


def gather_shards(shards, full, heads):
    """The inverse of ``shard_state_dict`` over every model rank's shards,
    placed by ``shard_index`` (the layout the port's gathers place by);
    ``full`` gives the full shapes."""
    M = len(shards)
    out = {}
    for name, t in full.items():
        where = ptensor.shard_index(name, t.shape, heads, M, 0)
        if where is None:
            out[name] = shards[0][name]
            continue
        out[name] = t.new_empty(t.shape)
        for r, sd in enumerate(shards):
            dim, index = ptensor.shard_index(name, t.shape, heads, M, r)
            out[name].index_copy_(dim, index, sd[name])
    return out


@pytest.mark.parametrize("heads,M", [(3, 2), (4, 2), (3, 3), (4, 4)])
def test_shards_gather_back_to_the_full_state_dict(heads, M):
    """Shard-then-gather is the identity, both head routes; the head-aligned
    qkv rows of a rank are its heads' q, k and v. (The port's own gathers,
    ``full_state_dict`` and ``FlatShards.gather``, are held to the cut in the
    gloo ranks: ``test_the_gathers_invert_the_shard_cut``.)"""
    D = 16 * heads
    model = VisionTransformer(ViTConfig(img_size=32, patch_size=8, embed_dim=D, depth=2,
                                        num_heads=heads, num_classes=C))
    sd = {k: torch.randn(v.shape) for k, v in model.state_dict().items()}
    shards = [ptensor.shard_state_dict(sd, heads, M, r) for r in range(M)]
    back = gather_shards(shards, sd, heads)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    w = sd["blocks.0.attn.qkv.weight"].view(3, heads, 16, D)
    got = shards[M - 1]["blocks.0.attn.qkv.weight"]
    if heads % M == 0:
        h = heads // M
        assert torch.equal(got, w[:, (M - 1) * h:].reshape(-1, D))
    else:
        assert torch.equal(got, sd["blocks.0.attn.qkv.weight"][-3 * D // M:])
    assert shards[0]["blocks.1.mlp.fc2.weight"].shape == (D, 4 * D // M)
    assert torch.equal(shards[0]["blocks.1.attn.qkv.bias"], sd["blocks.1.attn.qkv.bias"])


def test_flax_shards_gather_to_flax_to_torch():
    """``flax_to_torch_shard`` of every rank of a model axis of 2 and 3,
    gathered, is ``flax_to_torch``'s full state_dict."""
    params = init_params(dict(STUDENTS["soft_3_heads"]), 7)
    full = flax_to_torch(params)
    for M in (2, 3):
        back = gather_shards([flax_to_torch_shard(params, 3, M, r) for r in range(M)], full, 3)
        assert set(back) == set(full)
        for k, v in full.items():
            assert torch.equal(back[k], v), k


def test_a_dimension_the_model_axis_does_not_divide_raises():
    sd = VisionTransformer(ViTConfig(img_size=32, patch_size=8, embed_dim=48, depth=1,
                                     num_heads=3, num_classes=C)).state_dict()
    with pytest.raises(ValueError, match="blocks.0.attn.qkv.weight"):
        ptensor.shard_state_dict(sd, 3, 5, 0)
    with pytest.raises(ValueError, match="blocks.0.attn.proj.weight"):
        ptensor.shard_state_dict({"blocks.0.attn.proj.weight": torch.zeros(48, 48)}, 3, 7, 0)


ZOO_WIDTHS = ("deit_tiny_patch16_224", "deit_small_patch16_224", "deit_base_patch16_224",
              "vit_large_patch16_224")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ZOO_WIDTHS)
def test_every_model_axis_the_cut_takes_runs_the_mlp_kernel_or_is_refused(name, dtype):
    """For each width of the zoo and each model axis M whose shards the cut
    takes (M divides D and F): either the fused MLP forward takes the rank's
    hidden shard F/M at D, or ``check_mlp_shards`` refuses the model axis
    with a ValueError naming the model and F/M. Model axes 2, 4 and 8 run the
    kernel on every model (DeiT-Ti at 8: F/M = 96, the one-warpgroup plan's
    32-wide tail chunk); DeiT-Ti at 16 (F/M = 48) is refused in bf16."""
    from deltakd_tpu_torch.models.factory import check_mlp_shards
    from deltakd_tpu_torch.models.registry import get_model_config
    from deltakd_tpu_torch.ops.fused_mlp import forward_takes

    cfg = get_model_config(name, num_classes=C)
    D, F = cfg.embed_dim, 4 * cfg.embed_dim
    taken = []
    for M in range(2, D + 1):
        if D % M or F % M:
            continue
        if forward_takes(D, F // M, dtype):
            check_mlp_shards(name, C, M, dtype)
            taken.append(M)
        else:
            with pytest.raises(ValueError, match=f"{name}: .*F/M = {F}/{M} = {F // M} "):
                check_mlp_shards(name, C, M, dtype)
    assert {2, 4, 8} <= set(taken)
    assert (16 in taken) is not (name == "deit_tiny_patch16_224" and dtype == torch.bfloat16)


def test_the_factory_refuses_a_model_axis_before_building():
    """``load_teacher_student`` with kernels on builds DeiT-S / DeiT-Ti at a
    model axis of 8 in bf16 (the student's eval view gives the MLP kernel
    F/M = 96) and refuses a model axis that leaves the student's eval view an
    MLP shard the kernel does not take (DeiT-Ti at 16: F/M = 48), before a
    model is built; the fp32 form takes that shard, and so does the plain
    path with kernels off."""
    import dataclasses

    from deltakd_tpu_torch.models.factory import load_teacher_student

    cfg = pconfig.TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                              student_model="deit_tiny_distilled_patch16_224",
                              distillation_type="soft", allow_random_teacher=True,
                              dataset="cifar-100", mesh_shape=(1, 8))
    mesh = parallel.Mesh((1, 8), model=parallel.ModelParallel(8, 0))
    teacher, student, _ = load_teacher_student(cfg, device="cpu", mesh=mesh)
    assert student.dtype == torch.bfloat16 and student.attention_fn is not None
    assert student.blocks[0].mlp.fc1.weight.shape == (96, 192)
    assert teacher.blocks[0].mlp.fc1.weight.shape == (192, 384)
    cfg = dataclasses.replace(cfg, mesh_shape=(1, 16))
    mesh = parallel.Mesh((1, 16), model=parallel.ModelParallel(16, 0))
    with pytest.raises(ValueError, match="deit_tiny_distilled_patch16_224: .* = 48 "):
        load_teacher_student(cfg, device="cpu", mesh=mesh)
    tiny = dataclasses.replace(cfg, teacher_model=cfg.student_model)
    for config, attention_fn in ((dataclasses.replace(tiny, dtype="float32"), "config"),
                                 (tiny, None)):
        kw = {} if attention_fn == "config" else {"attention_fn": attention_fn}
        teacher, student, _ = load_teacher_student(config, device="cpu", mesh=mesh, **kw)
        assert student.blocks[0].mlp.fc1.weight.shape == (48, 192)


def test_one_rank_mesh_only_picks_the_path():
    mesh = parallel.make_mesh((1, 2), parallel.LOCAL)
    assert (mesh.shape, mesh.world, mesh.model.size, mesh.is_main) == ((1, 2), 1, 1, True)
    with pytest.raises(ValueError, match="model axis"):
        VisionTransformer(ViTConfig(depth=1), block_fn=lambda *a, **k: None,
                          tp=parallel.ModelParallel(2, 0))


def test_recipe_mesh_launches_data_times_model_processes(tmp_path):
    """``bash <recipe> "2 2"``: the JAX recipe runs one process with
    ``--mesh-shape 2 2``; the port's runs torchrun with 4 processes and the
    same flags."""
    from tests.test_torch_ckpt_cli import _recipe_argvs

    recipe = "soft-deit-tiny.sh"
    jcalls = _recipe_argvs(tmp_path, os.path.join(ROOT, "exp", recipe), "jax", ("2 2",))
    pcalls = _recipe_argvs(tmp_path, os.path.join(ROOT, "deltakd_tpu_torch", "exp", recipe),
                           "port", ("2 2",), launcher="torchrun")
    assert len(jcalls) == len(pcalls) == 1
    assert pcalls[0][:5] == ["--standalone", "--nproc_per_node", "4", "-m",
                             "deltakd_tpu_torch.cli.train"]
    assert jcalls[0][2:] == pcalls[0][5:]
    assert pconfig.parse_args(pcalls[0][5:]).mesh_shape == (2, 2)
