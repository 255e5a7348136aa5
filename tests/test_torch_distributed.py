"""The port's data parallelism on the CPU: two gloo processes
(``tests/torch_dp_worker.py``, depth 2, D = 32 and 64, 32 px, one thread
each), each on its rows of the global batch, against the JAX package on a
2-device mesh (``make_mesh((2, 1), devices=jax.devices()[:2])`` of the
8-device CPU platform that ``conftest.py`` sets up), whose sharded step is
the global batch's:

- the soft step, the soft step with ``grad_accum_steps=2`` (each rank's
  micro-batch i is its rows of the JAX step's micro-batch i), and the lrkd
  and diffkd steps (their global Gram matrices and mean weight; DiffKD on
  the JAX step's draws, ``tests/jax_draws.py``), all on the same pinned
  post-transform batch: losses (the ranks' mean) to 1e-5 of the step's
  largest loss value (a small distill loss is a sum of terms that cancel), grad norm
  and the applied gradient to 1e-4 of the largest value, the updated
  parameters to 1e-6 absolute as in ``test_torch_step.py``; both ranks'
  parameters the same bits;
- ``mix_batch`` in 'batch', 'elem' and 'pair' mode on the global draws,
  each rank's rows against JAX's ``apply_mixup`` of the global batch;
- run()'s loaders (the RASampler at world 2, the eval shards) against the
  JAX package's sampler; ``validate``'s all-reduced sums against the JAX
  eval step over both shards; rank 0 alone writes the checkpoints, a resumed
  run gives a straight run's bits, the val metrics and the eval CLI's are
  equal on both ranks;
- a world-1 process group gives the plain run's bits; the epoch's two
  generators; the stop flag; ``subset_ops``, which would change the
  transform of a split batch (so the ranks turn it off, as the JAX package
  does on a multi-device mesh); ``make_mesh``'s checks.
"""

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
from deltakd_tpu.data import sampler as jsampler
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.data.mixup import apply_mixup as japply_mixup
from deltakd_tpu.data.pipeline import Loader as JLoader
from deltakd_tpu.data.sources import ArraySource as JArraySource
from deltakd_tpu.kd.aux import init_aux_params
from deltakd_tpu.kd.losses import KDSettings as JKDSettings
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from deltakd_tpu.train import step as jstep
from deltakd_tpu.train.optim import make_optimizer as j_make_optimizer
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch import parallel
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data import augment as ta
from deltakd_tpu_torch.models.convert import aux_flax_to_torch, flax_to_torch
from deltakd_tpu_torch.train import loop
from tests import jax_draws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BG, C = 2, 8, 10           # two ranks of 4 rows each
STUDENT = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
               num_classes=C, distilled=True)
TEACHER = dict(STUDENT, embed_dim=64)
HP = dict(distillation_type="soft", alpha=0.5, tau=2.0, drop_path_rate=0.0, lr=1e-3,
          warmup_epochs=0, epochs=10, opt_eps=1e-4, clip_grad=1.0, ema_decay=0.9,
          dataset="cifar-10", input_size=32, dtype="float32")
STEPS = {"soft": dict(HP), "soft_accum": dict(HP, mixup=0.0, cutmix=0.0, grad_accum_steps=2),
         "lrkd": dict(HP, distillation_type="lrkd", lrkd_rank=8),
         "diffkd": dict(HP, distillation_type="diffkd")}
N_PATCHES = (32 // 8) ** 2
KEY = jax.random.PRNGKey(0)
VAL_N, VAL_B = 37, 4
MODES = ("batch", "elem", "pair")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(kw, seed):
    return jax.device_get(JViT(JViTConfig(**kw), dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)))["params"])


def _rows(accum):
    """Rank r's rows of the global batch: per micro-batch i its half of it."""
    mb = BG // WORLD
    return [np.concatenate([np.arange(i * BG + r * mb, i * BG + (r + 1) * mb)
                            for i in range(accum)]) for r in range(WORLD)]


def _jax_step(name, hp, s_params, t_params, aux_tree, u8, labels, targets, mesh):
    """The JAX step on the mesh, its transform replaced by u8 / 64 - 2 and
    its mixup by the pinned targets."""
    j_student = JViT(JViTConfig(**STUDENT), dtype=jnp.float32)
    j_teacher = JViT(JViTConfig(**TEACHER), dtype=jnp.float32)
    jcfg = JTrainConfig(**hp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "train_transform",
                   lambda k, x, ac: x.astype(jnp.float32) / 64.0 - 2.0)
        if targets is not None:
            mp.setattr(jstep, "apply_mixup", lambda k, x, y, mc: (x, jnp.asarray(targets)))
        jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": aux_tree}, 5)
        jstate = JTrainState.create(student_params=s_params, aux_params=aux_tree, tx=jtx,
                                    ema_decay=jcfg.ema_decay)
        fn = jstep.build_train_step(
            cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
            student_module=j_student, teacher_module=j_teacher,
            aug=JAugmentConfig(input_size=32),
            mixup=None if targets is None else JMixupConfig(num_classes=C), tx=jtx,
            donate=False, batch_shard=batch_sharding(mesh))
        repl, shard = replicated(mesh), batch_sharding(mesh)
        jstate, metrics = fn(jax.device_put(jstate, repl), jax.device_put(t_params, repl),
                             jax.device_put(jnp.asarray(u8), shard),
                             jax.device_put(jnp.asarray(labels), shard), KEY,
                             jnp.asarray(0, jnp.int32))
    jstate = jax.device_get(jstate)
    return ({k: float(v) for k, v in metrics.items()},
            flax_to_torch(jstate.params["student"]),
            aux_flax_to_torch(jstate.params["aux"]) if aux_tree else None)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two ranks, computes the JAX side meanwhile; returns (the
    ranks' results, the JAX references, the spec)."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(0)
    s_params, t_params = _init(STUDENT, 1), _init(TEACHER, 2)
    spec = {"steps": {}, "tmp": str(tmp), "port1": _free_port()}
    for name, hp in STEPS.items():
        accum = hp.get("grad_accum_steps", 1)
        kd_type = hp["distillation_type"]
        aux_tree = ({} if kd_type == "soft" else
                    init_aux_params(jax.random.PRNGKey(13), kd_type, STUDENT["embed_dim"],
                                    TEACHER["embed_dim"], lrkd_rank=8))
        t = dict(hp=hp, rows=_rows(accum), student_kw=STUDENT, teacher_kw=TEACHER,
                 student_sd=flax_to_torch(s_params), teacher_sd=flax_to_torch(t_params),
                 aux_sd=aux_flax_to_torch(aux_tree) if aux_tree else None,
                 aux_tree=aux_tree,
                 u8=torch.from_numpy(rng.randint(0, 256, (BG * accum, 32, 32, 3))
                                     .astype(np.uint8)),
                 labels=torch.from_numpy(rng.randint(0, C, BG * accum)),
                 targets=(None if accum > 1 else torch.from_numpy(
                     rng.dirichlet(np.ones(C), BG).astype(np.float32))))
        if kd_type == "diffkd":
            k_loss = jax.random.split(jax.random.fold_in(KEY, 0), 5)[2]
            d = jax_draws.diffkd_draws(k_loss, (BG, N_PATCHES, TEACHER["embed_dim"]))
            t["diffkd"] = (d.t_step, list(d.noise), list(d.keep))
        spec["steps"][name] = t
    spec["mixup"] = {}
    images = torch.from_numpy(rng.randn(BG, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, C, BG))
    for mode in MODES:
        jmc = JMixupConfig(num_classes=C, mode=mode)
        d = jax_draws.mixup_draws(jax.random.PRNGKey(5), BG, 32, 32, jmc)
        spec["mixup"][mode] = (images, labels, tuple(vars(d).values()),
                               dict(num_classes=C, mode=mode))
    spec["validate"] = dict(student_kw=dict(STUDENT, distilled=False),
                            student_sd=flax_to_torch(_init(dict(STUDENT, distilled=False), 3)),
                            images=rng.randint(0, 256, (VAL_N, 32, 32, 3)).astype(np.uint8),
                            labels=rng.randint(0, C, VAL_N), batch_size=VAL_B)
    spec_path = str(tmp / "spec.pt")
    torch.save({**spec, "steps": {k: {kk: vv for kk, vv in v.items() if kk != "aux_tree"}
                                  for k, v in spec["steps"].items()}}, spec_path)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dp_worker", str(r),
                               str(WORLD), str(port), spec_path, str(tmp)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        mesh = make_mesh((WORLD, 1), devices=jax.devices()[:WORLD])
        ref = {}
        for name, t in spec["steps"].items():
            ref[name] = _jax_step(name, t["hp"], s_params, t_params, t["aux_tree"],
                                  t["u8"].numpy(), t["labels"].numpy(),
                                  None if t["targets"] is None else t["targets"].numpy(),
                                  mesh)
        shard = batch_sharding(mesh)
        for mode in MODES:
            jmc = JMixupConfig(num_classes=C, mode=mode)
            ref[mode] = jax.device_get(jax.jit(
                lambda k, x, y, jmc=jmc: japply_mixup(k, x, y, jmc))(
                    jax.random.PRNGKey(5), jax.device_put(images.numpy(), shard),
                    jax.device_put(labels.numpy(), shard)))
        ref["validate"] = _jax_validate(spec["validate"])
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return got, ref, spec


def _jax_validate(v):
    """The JAX eval step's sums over both ranks' shards of the split."""
    jm = JViT(JViTConfig(**v["student_kw"]), dtype=jnp.float32)
    params = _init(v["student_kw"], 3)
    fn = jstep.build_eval_step(student_module=jm, aug=JAugmentConfig.from_config(
        JTrainConfig(dataset="synthetic", input_size=32)))
    sums = {}
    for r in range(WORLD):
        loader = JLoader(JArraySource(v["images"], v["labels"], C), batch_size=v["batch_size"],
                         is_train=False, world=WORLD, rank=r)
        for images, labels, n_valid in loader.epoch(0):
            out = fn(params, images, labels, np.arange(len(labels)) < n_valid)
            for k, x in jax.device_get(out).items():
                sums[k] = sums.get(k, 0.0) + float(x)
    n = sums["count"]
    return {"val_loss": sums["loss_sum"] / n, "val_acc1": sums["correct1"] / n * 100.0,
            "val_acc5": sums["correct5"] / n * 100.0}


def _close(a, b, rtol):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol)


@pytest.mark.parametrize("name", list(STEPS))
def test_step_matches_the_jax_mesh(ranks, name):
    got, ref, _ = ranks
    jm, jstudent, jaux = ref[name]
    losses = ("train_loss", "base_loss", "distill_loss")
    largest = max(abs(jm[k]) for k in losses)
    for k in losses:
        got_k = np.mean([g[name]["metrics"][k] for g in got])
        assert abs(got_k - jm[k]) <= 1e-5 * largest, (k, got_k, jm[k])
    for k in ("train_acc1", "train_acc5"):
        _close(np.mean([g[name]["metrics"][k] for g in got]), jm[k], 1e-5)
    for g in got:
        assert g["dp"][0] == WORLD
        _close(g[name]["metrics"]["grad_norm"], jm["grad_norm"], 1e-4)
        for pname, p in g[name]["student"].items():
            np.testing.assert_allclose(p.numpy(), jstudent[pname].numpy(), atol=1e-6,
                                       err_msg=pname)
        if jaux is not None:
            assert float(g[name]["metrics"]["distill_loss"]) > 0
            for pname, p in g[name]["aux"].items():
                np.testing.assert_allclose(p.numpy(), jaux[pname].numpy(), atol=1e-6,
                                           err_msg=pname)


@pytest.mark.parametrize("name", list(STEPS))
def test_ranks_apply_one_gradient_and_hold_the_same_parameters(ranks, name):
    """The all-reduced gradient is the same bits on both ranks, and so are
    the parameters after the update; the gradient's norm is JAX's."""
    got, ref, _ = ranks
    a, b = got
    assert torch.equal(a[name]["grads"], b[name]["grads"])
    assert torch.equal(a[name]["params"], b[name]["params"])
    norm = float(torch.linalg.vector_norm(a[name]["grads"]))
    assert abs(norm - ref[name][0]["grad_norm"]) <= 1e-4 * ref[name][0]["grad_norm"]


@pytest.mark.parametrize("mode", MODES)
def test_mixup_across_ranks_matches_jax(ranks, mode):
    got, ref, _ = ranks
    want_images, want_targets = ref[mode]
    b = BG // WORLD
    for r, g in enumerate(got):
        images, targets = g["mixup"][mode]
        np.testing.assert_allclose(images.numpy(), want_images[r * b:(r + 1) * b], atol=1e-5)
        np.testing.assert_allclose(targets.numpy(), want_targets[r * b:(r + 1) * b],
                                   atol=1e-6)


def test_epoch_generators_split_per_image_and_global_draws(ranks):
    got, _, _ = ranks
    a, b = (g["generators"] for g in got)
    assert torch.equal(a["batch"], b["batch"])
    assert not torch.equal(a["per_image"], b["per_image"])
    # the shared one is a plain process's generator; at world 1 it is the only one
    plain = loop.epoch_generator(7, 3, torch.device("cpu"))
    assert torch.equal(a["batch"], torch.rand(8, generator=plain))
    g1, g2 = loop.epoch_generators(7, 3, torch.device("cpu"), parallel.LOCAL)
    assert g1 is g2
    assert torch.equal(torch.rand(8, generator=g1),
                       torch.rand(8, generator=loop.epoch_generator(7, 3, torch.device("cpu"))))


def test_subset_ops_follow_the_rank_count(ranks):
    """Two ranks with ``mesh_shape`` None split the batch: no subset ops. With
    a mesh shape they follow its data axis, as JAX's
    ``_mesh_is_single_data_shard``: (1, 2) over the two ranks splits nothing."""
    got, _, _ = ranks
    assert not any(g["generators"]["aug"] for g in got)
    assert all(g["generators"]["aug_model_axis"] for g in got)
    assert ta.AugmentConfig.from_config(TrainConfig(dataset="cifar-100")).subset_ops


def test_subset_ops_would_change_a_split_batch():
    """The heavy RA ops on a subset of max(8, B / 8) rows: with sharpness drawn
    for all 32 rows, subset on and off give other bits, and two halves of 16
    do not give the whole batch's with the subset on (16 rows run, not 8);
    with it off they give the same bits. So the ranks turn it off."""
    g = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (32, 8, 8, 3), generator=g).float()
    sign = torch.where(torch.rand(ta.NUM_RAND_OPS, 32, generator=g) < 0.5, -1.0, 1.0)
    op = ta.OpDraws(torch.full((32,), 10), torch.ones(32, dtype=torch.bool),
                    torch.full((32,), 9.0), sign)

    def half(o, rows):
        return ta.OpDraws(o.op_idx[rows], o.apply[rows], o.m[rows], o.sign[:, rows])

    def run(subset):
        whole = ta._apply_ra_pixel_ops(imgs, op, subset_ok=subset)
        halves = torch.cat([ta._apply_ra_pixel_ops(imgs[s], half(op, s), subset_ok=subset)
                            for s in (slice(0, 16), slice(16, 32))])
        return whole, halves

    on_whole, on_halves = run(True)
    off_whole, off_halves = run(False)
    assert not torch.equal(on_whole, off_whole)
    assert not torch.equal(on_whole, on_halves)
    assert torch.equal(off_whole, off_halves)


def test_run_loaders_shard_as_the_jax_sampler(ranks):
    """run() at world 2: the RASampler (repeated_aug on by default) and the
    eval shards, each rank's indices the JAX package's."""
    got, _, _ = ranks
    n_train, n_val = 2048, 512    # the synthetic source's splits
    for r, g in enumerate(got):
        loaders = g["run"]["loaders"]
        train = [ld for ld in loaders if ld["is_train"]]
        val = [ld for ld in loaders if not ld["is_train"]]
        assert len(train) == len(val) == 3          # three run() calls
        for ld in train:
            assert (ld["world"], ld["rank"]) == (WORLD, r)
            want = jsampler.epoch_indices(0, n_train, is_train=True, world=WORLD, rank=r,
                                          repeated_aug=True, seed=42)
            np.testing.assert_array_equal(ld["indices"], want)
            assert ld["steps"] == len(want) // 4 == 256
        for ld in val:
            want = jsampler.epoch_indices(0, n_val, is_train=False, world=WORLD, rank=r,
                                          repeated_aug=True, seed=42)
            np.testing.assert_array_equal(ld["indices"], want)


def test_validate_sums_match_jax(ranks):
    got, ref, _ = ranks
    for g in got:
        _close(g["validate"]["val_loss"], ref["validate"]["val_loss"], 1e-5)
        assert g["validate"]["val_acc1"] == pytest.approx(ref["validate"]["val_acc1"], abs=1e-9)
        assert g["validate"]["val_acc5"] == pytest.approx(ref["validate"]["val_acc5"], abs=1e-9)


def test_rank0_writes_checkpoints_and_a_resume_repeats_a_straight_run(ranks):
    got, _, spec = ranks
    a, b = (g["run"] for g in got)
    assert a["saves"] == [1, 2, 1, 2] and b["saves"] == []
    assert a["straight"] == b["straight"] and a["resumed"] == b["resumed"]
    assert {k: v for k, v in a["resumed"].items() if k.startswith("val_")} == \
        {k: v for k, v in a["straight"].items() if k.startswith("val_")}
    tmp = spec["tmp"]
    x = torch.load(os.path.join(tmp, "straight", "checkpoint", "state-2", "state.pt"),
                   weights_only=True)
    y = torch.load(os.path.join(tmp, "resumed", "checkpoint", "state-2", "state.pt"),
                   weights_only=True)
    assert x["meta"] == y["meta"] and x["state"]["step"] == y["state"]["step"] == 4
    assert torch.equal(x["state"]["params"], y["state"]["params"])
    for k in ("mu", "nu"):
        assert torch.equal(x["state"]["opt"][k], y["state"]["opt"][k]), k


def test_eval_cli_reduces_over_ranks(ranks):
    got, _, _ = ranks
    a, b = (g["run"] for g in got)
    assert a["eval"] == b["eval"]
    assert (a["eval"]["test_loss"], a["eval"]["test_acc1"]) == \
        (a["straight"]["val_loss"], a["straight"]["val_acc1"])


def test_stop_flag_reaches_every_rank(ranks):
    got, _, _ = ranks
    assert all(g["run"]["stop"] for g in got)


def test_world_one_group_gives_the_plain_run(ranks):
    got, _, spec = ranks
    w1 = got[0]["world1"]
    assert w1["in_group"] == w1["plain"]
    tmp = spec["tmp"]
    x, y = (torch.load(os.path.join(tmp, d, "checkpoint", "state-1", "state.pt"),
                       weights_only=True) for d in ("world1", "plain"))
    assert torch.equal(x["state"]["params"], y["state"]["params"])
    assert torch.equal(x["state"]["opt"]["nu"], y["state"]["opt"]["nu"])


def test_make_mesh_checks_the_shape_against_the_ranks():
    two = parallel.DataParallel(world=2, rank=1)
    assert parallel.make_mesh((2,), two).shape == (2, 1)
    assert parallel.make_mesh((2,), two).data == two      # the default group
    assert parallel.make_mesh(None, two).shape == (2, 1)
    with pytest.raises(ValueError):
        parallel.make_mesh((4,), two)
    # a model axis over the ranks: the shape check (make_mesh then creates the
    # groups, which needs a process group)
    assert parallel.mesh_shape((1, 2), two.world) == (1, 2)
    with pytest.raises(ValueError):
        parallel.mesh_shape((2, 2), two.world)
    # one rank: the shape only picks the model path
    assert parallel.make_mesh((1, 2), parallel.LOCAL).shape == (1, 2)
    assert parallel.make_mesh((4,), parallel.LOCAL).shape == (4, 1)
    assert two.partner == 0 and parallel.DataParallel(world=3, rank=1).partner == 1


def test_initialize_is_a_no_op_without_torchrun(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not parallel.maybe_initialize_distributed("cpu")
    assert parallel.current() == parallel.LOCAL and parallel.world() == 1
    assert parallel.is_main_process()
