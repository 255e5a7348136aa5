"""The port's configuration surface, checkpoints, meters, FLOPs probe and
sweep against the JAX package's: every option string of JAX's
``add_train_args`` with its default; every ``exp/*.sh`` recipe and its copy
under ``deltakd_tpu_torch/exp/``, each parsed by its own package, to equal
values on every ``TrainConfig`` field; ``validate()``; the finetune merge
(to 1e-6 of the largest value, on weights carried across by
``models/convert.py``; the same keys dropped; the same ``ValueError`` for a
distilled source and a plain target); the checkpoint layout (round trip,
``.best``, a same-epoch re-save); ``SmoothedValue`` exactly; ``model_gflops``
within 10% of XLA's count; the sweep's trials exactly.
"""

import argparse
import dataclasses
import json
import os
import random
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.ckpt import checkpoint as jckpt
from deltakd_tpu.cli import sweep as jsweep
from deltakd_tpu.configs import config as jconfig
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.obs import meters as jmeters
from deltakd_tpu_torch.ckpt import checkpoint as pckpt
from deltakd_tpu_torch.cli import sweep as psweep
from deltakd_tpu_torch.configs import config as pconfig
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.obs import meters as pmeters
from deltakd_tpu_torch.obs.profiling import model_gflops
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(n for n in os.listdir(os.path.join(ROOT, "exp")) if n.endswith(".sh")
                 and not n.startswith("_"))


def _options(add_args):
    parser = argparse.ArgumentParser()
    add_args(parser)
    return {s: a for a in parser._actions for s in a.option_strings}


def test_every_jax_option_exists_with_its_default():
    jopts, popts = _options(jconfig.add_train_args), _options(pconfig.add_train_args)
    assert set(jopts) <= set(popts)
    for s, a in jopts.items():
        b = popts[s]
        assert (a.dest, a.default, a.nargs, a.choices, a.type) == \
               (b.dest, b.default, b.nargs, b.choices, b.type), s
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.TrainConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pconfig.TrainConfig)}
    assert jf == pf


def _recipe_argvs(tmp_path, script, tag, args=(), launcher="python"):
    """The argv of every training command a recipe runs with ``args``:
    ``launcher`` (``python``, or ``torchrun`` for a card count) on PATH is a
    stub that records its arguments."""
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir(exist_ok=True)
    record = tmp_path / f"{tag}.args"
    stub = stub_dir / launcher
    stub.write_text('#!/bin/bash\nprintf "%s\\0" "$@" >> "$RECORD"\nprintf "\\n\\0" >> "$RECORD"\n')
    stub.chmod(0o755)
    env = {**os.environ, "PATH": f"{stub_dir}:{os.environ['PATH']}", "RECORD": str(record)}
    for var in ("DATA_PATH", "TEACHER_CKPT", "EXTRA_FLAGS", "CKPT"):
        env.pop(var, None)
    subprocess.run(["bash", script, *args], env=env, check=True, cwd=str(tmp_path))
    calls, current = [], []
    for arg in record.read_bytes().split(b"\0")[:-1]:
        if arg == b"\n":
            calls.append(current)
            current = []
        else:
            current.append(arg.decode())
    return calls


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_copies_parse_to_the_same_config(tmp_path, recipe):
    jcalls = _recipe_argvs(tmp_path, os.path.join(ROOT, "exp", recipe), "jax")
    pcalls = _recipe_argvs(tmp_path, os.path.join(ROOT, "deltakd_tpu_torch", "exp", recipe),
                           "port")
    assert len(jcalls) == len(pcalls) >= 1
    for jargv, pargv in zip(jcalls, pcalls):
        assert jargv[:2] == ["-m", "deltakd_tpu.cli.train"]
        assert pargv[:2] == ["-m", "deltakd_tpu_torch.cli.train"]
        assert jargv[2:] == pargv[2:]
        jc = jconfig.parse_args(jargv[2:])
        pc = pconfig.parse_args(pargv[2:])
        for f in dataclasses.fields(jconfig.TrainConfig):
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name


def test_recipe_copies_differ_only_in_the_train_line():
    """Every recipe is its JAX copy; ``_common.sh`` differs in its comments and
    in the launch: the port's module, and torchrun when $1 gives a mesh ("N"
    or "D M": as many processes as the product)."""
    names = sorted(os.listdir(os.path.join(ROOT, "exp")))
    assert sorted(os.listdir(os.path.join(ROOT, "deltakd_tpu_torch", "exp"))) == names
    assert len(RECIPES) == 14
    for name in names:
        with open(os.path.join(ROOT, "exp", name)) as f:
            a = f.read().splitlines()
        with open(os.path.join(ROOT, "deltakd_tpu_torch", "exp", name)) as f:
            b = f.read().splitlines()
        if name == "_common.sh":
            a, b = ([x for x in lines if not x.startswith("#")] for lines in (a, b))
            assert a[:-1] == b[:-2], name
            assert a[-1] == 'TRAIN="python -m deltakd_tpu.cli.train"'
            assert b[-2:] == [
                'TRAIN="python -m deltakd_tpu_torch.cli.train"',
                'if [[ -n "$1" ]]; then TRAIN="torchrun --standalone --nproc_per_node '
                '$((${1// /*})) -m deltakd_tpu_torch.cli.train"; fi']
        else:
            assert a == b, name


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_copies_launch_one_process_per_card(tmp_path, recipe):
    """``bash <recipe> 2``: the JAX recipe runs one process over a data axis
    of 2; the port's runs torchrun with 2 processes and the same flags."""
    jcalls = _recipe_argvs(tmp_path, os.path.join(ROOT, "exp", recipe), "jax", ("2",))
    pcalls = _recipe_argvs(tmp_path, os.path.join(ROOT, "deltakd_tpu_torch", "exp", recipe),
                           "port", ("2",), launcher="torchrun")
    assert len(jcalls) == len(pcalls) >= 1
    for jargv, pargv in zip(jcalls, pcalls):
        assert jargv[:2] == ["-m", "deltakd_tpu.cli.train"]
        assert pargv[:5] == ["--standalone", "--nproc_per_node", "2", "-m",
                             "deltakd_tpu_torch.cli.train"]
        assert jargv[2:] == pargv[5:]
        assert pconfig.parse_args(pargv[5:]).mesh_shape == (2,)


@pytest.mark.parametrize("argv,raises", [
    (["--remode", "corner"], NotImplementedError),
    (["--recount", "0"], ValueError),
    (["--distillation-type", "aaakd"], SystemExit),
])
def test_validate_raises_as_jax(argv, raises):
    with pytest.raises(raises):
        jconfig.parse_args(argv)
    with pytest.raises(raises):
        pconfig.parse_args(argv)


def test_validate_warns_on_resplit_and_maps_amp():
    for mod in (jconfig, pconfig):
        with pytest.warns(UserWarning, match="resplit"):
            assert mod.parse_args(["--resplit"]).resplit
        assert mod.parse_args(["--amp", "--dtype", "float32"]).dtype == "bfloat16"
        assert mod.parse_args(["--fp16", "--dtype", "float32"]).dtype == "bfloat16"
    # what neither package trains raises when the port's config is made;
    # every optimizer, schedule and LR noise of the JAX package parses
    for argv in (["--sched", "tanh"], ["--opt", "lamb"], ["--opt", "sgdp"],
                 ["--remode", "corner"]):
        with pytest.raises(NotImplementedError):
            pconfig.parse_args(argv)
    with pytest.warns(UserWarning, match="cutmix-minmax"):
        assert pconfig.parse_args(["--cutmix-minmax", "0.2", "0.8"]).mixup_active
    cfg = pconfig.parse_args(["--opt", "sgd", "--sched", "step", "--lr-noise", "0.4", "0.8"])
    assert (cfg.opt, cfg.sched, cfg.lr_noise) == ("sgd", "step", (0.4, 0.8))
    assert pconfig.parse_args(["--device", "cpu"]).device == "cpu"
    assert pconfig.parse_args([]).device is None


# --------------------------------------------------------------------- finetune

SMALL = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2)


def _jax_params(img_size, num_classes, distilled, seed):
    """The JAX model's parameter tree, filled from a seed (traced, not
    compiled)."""
    m = JViT(JViTConfig(img_size=img_size, num_classes=num_classes, distilled=distilled,
                        **SMALL), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: m.init({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, img_size, img_size, 3))))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def _torch_name(jax_path):
    parts = jax_path.split("/")
    leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts[:-1] + [leaf])


def test_finetune_merge_matches_jax():
    """A 12-class plain student at 32 px (2x2 grid) into a 5-class one at 48 px
    (3x3): the heads dropped, pos_embed interpolated, the rest copied."""
    src, tgt = _jax_params(32, 12, False, 0), _jax_params(48, 5, False, 1)
    jlog, plog = [], []
    jmerged = jckpt._merge_for_finetune(src, tgt, 1, log=jlog.append)
    pmerged = pckpt._merge_for_finetune(flax_to_torch(src), flax_to_torch(tgt), 1,
                                        log=plog.append)
    want = flax_to_torch(jax.tree.map(np.asarray, jmerged))
    assert set(pmerged) == set(want)
    for k, v in want.items():   # the bicubic sums run in another order
        np.testing.assert_allclose(pmerged[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6 * float(v.abs().max()), err_msg=k)
    jdropped = sorted(_torch_name(line.split()[2].rstrip(":")) for line in jlog)
    pdropped = sorted(line.split()[2].rstrip(":") for line in plog)
    assert jdropped == pdropped == ["head.bias", "head.weight"]
    assert pmerged["pos_embed"].shape == (1, 10, 64)
    assert not torch.equal(pmerged["pos_embed"], flax_to_torch(tgt)["pos_embed"])


def test_finetune_distilled_into_plain_raises_as_jax():
    """A distilled source (2 prefix tokens) into a plain target (1): both
    packages read 17 patches off the source and refuse the grid."""
    src, tgt = _jax_params(64, 10, True, 0), _jax_params(64, 10, False, 1)
    with pytest.raises(ValueError, match="non-square patch grid: 17 patches"):
        jckpt._merge_for_finetune(src, tgt, 1, log=lambda *_: None)
    with pytest.raises(ValueError, match="non-square patch grid: 17 patches"):
        pckpt._merge_for_finetune(flax_to_torch(src), flax_to_torch(tgt), 1,
                                  log=lambda *_: None)


def _state(seed, ema=None, num_classes=10, img_size=32):
    model = VisionTransformer(ViTConfig(img_size=img_size, num_classes=num_classes,
                                        **SMALL), dtype=torch.float32)
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    cfg = pconfig.TrainConfig(epochs=3, warmup_epochs=1)
    tx = make_optimizer(cfg, trainable_parameters(model), 4)
    return model, tx, TrainState(model, tx=tx, ema_decay=ema)


def test_checkpoint_round_trip_and_best(tmp_path):
    model, tx, state = _state(0, ema=0.9)
    grads = torch.randn(state.params.shape, generator=torch.Generator().manual_seed(1))
    state.apply_gradients(grads=grads, tx=tx, ema_decay=0.9)
    d = str(tmp_path / "ck")
    pckpt.save_checkpoint(d, state, epoch=7, best_acc=55.5, is_best=True)
    with open(os.path.join(d, "meta.json")) as f:
        assert json.load(f) == {"epoch": 7, "best_acc": 55.5, "format": "torch-v1",
                                "state_dir": "state-7"}
    assert os.path.isfile(os.path.join(d + ".best", "state-7", "state.pt"))
    assert os.path.isfile(os.path.join(d + ".best", "meta.json"))
    other_model, _, other = _state(2, ema=0.9)
    restored, epoch, best = pckpt.load_checkpoint(d, other)
    assert restored is other
    assert (epoch, best) == (7, 55.5)
    assert torch.equal(other.params, state.params) and other.step == state.step == 1
    assert other.opt_state.count == 1
    assert torch.equal(other.opt_state.mu, state.opt_state.mu)
    assert torch.equal(other.opt_state.nu, state.opt_state.nu)
    assert torch.equal(other.ema_params, state.ema_params)
    # the parameters are views into the flat vector: the model sees the load
    assert torch.equal(other_model.pos_embed, model.pos_embed)
    assert torch.equal(other_model.blocks[1].mlp.fc2.weight, model.blocks[1].mlp.fc2.weight)
    with pytest.raises(ValueError, match="another model"):
        pckpt.load_checkpoint(d, _state(0, ema=0.9, num_classes=7)[2])
    # the student's parameters by name, raw or the EMA's (the eval CLI's --use-ema)
    for use_ema, flat in ((False, state.params), (True, state.ema_params)):
        params, meta = pckpt.student_state_dict(d, use_ema=use_ema)
        assert meta == {"epoch": 7, "best_acc": 55.5}
        assert set(params) == {n for n, _ in model.named_parameters()}
        assert torch.equal(torch.cat([params[n].reshape(-1) for n, _ in
                                      model.named_parameters()]), flat)


def test_same_epoch_resave_never_deletes_the_only_checkpoint(tmp_path):
    """The port's counterpart of the JAX package's test of the same name."""
    d = str(tmp_path / "ck")
    states = [_state(s)[2] for s in range(3)]
    pckpt.save_checkpoint(d, states[0], epoch=5, best_acc=0.0, is_best=False)
    pckpt.save_checkpoint(d, states[1], epoch=5, best_acc=0.0, is_best=False)
    dirs = [os.path.basename(p) for p in pckpt._committed_state_dirs(d)]
    assert dirs == ["state-5.prev", "state-5"], dirs
    target = _state(9)[2]
    _, epoch, _ = pckpt.load_checkpoint(d, target)
    assert epoch == 5 and torch.equal(target.params, states[1].params)
    pckpt.save_checkpoint(d, states[2], epoch=6, best_acc=0.0, is_best=False)
    dirs = [os.path.basename(p) for p in pckpt._committed_state_dirs(d)]
    assert dirs == ["state-5", "state-6"], dirs


def test_finetune_from_a_checkpoint_and_from_a_state_dict(tmp_path):
    src_model, _, src_state = _state(0, num_classes=12, img_size=32)
    d = str(tmp_path / "ck")
    pckpt.save_checkpoint(d, src_state, epoch=1, best_acc=0.0, is_best=False)
    torch.save({"model": src_model.state_dict()}, str(tmp_path / "student.pth"))
    for checkpoint in (d, str(tmp_path / "student.pth")):
        target, _, _ = _state(1, num_classes=5, img_size=48)
        head = target.head.weight.detach().clone()
        log = []
        got = pckpt.load_student_for_finetune(checkpoint, target, num_prefix_tokens=1,
                                              log=log.append)
        assert torch.equal(got["blocks.1.mlp.fc2.weight"], src_model.blocks[1].mlp.fc2.weight)
        assert torch.equal(target.blocks[0].attn.qkv.weight, src_model.blocks[0].attn.qkv.weight)
        assert torch.equal(target.head.weight, head)
        assert target.pos_embed.shape == (1, 10, 64)
        assert log and "head" in log[0]


# --------------------------------------------------------------------- obs, sweep

def test_smoothed_value_matches_jax():
    values = np.random.RandomState(0).randn(57).tolist()
    a, b = pmeters.SmoothedValue(), jmeters.SmoothedValue()
    for i, v in enumerate(values):
        a.update(v, n=1 + i % 3)
        b.update(v, n=1 + i % 3)
        for stat in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(a, stat) == getattr(b, stat), stat
        assert str(a) == str(b)
    a.synchronize_between_processes()   # no process group: nothing changes
    assert (a.count, a.total) == (b.count, b.total)


def test_model_gflops_matches_jax():
    from deltakd_tpu.models.factory import create_model as jcreate_model
    from deltakd_tpu.obs.profiling import model_gflops as jmodel_gflops
    from deltakd_tpu_torch.models.factory import create_model

    jm = jcreate_model("deit_tiny_patch16_224", num_classes=100, img_size=32,
                       dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 32, 32, 3))))["params"]
    want = jmodel_gflops(jm, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 32)
    pm = create_model("deit_tiny_patch16_224", num_classes=100, img_size=32,
                      dtype=torch.float32, device="cpu")
    got = model_gflops(pm, 32)
    assert abs(got - want) <= 0.1 * want, (got, want)


def test_sweep_draws_the_same_trials_as_jax():
    spec = psweep._load_yaml(os.path.join(ROOT, "deltakd_tpu_torch", "exp",
                                          "lrkd_sweep_config.yaml"))
    assert spec == jsweep._load_yaml(os.path.join(ROOT, "exp", "lrkd_sweep_config.yaml"))
    mini = psweep._mini_yaml(os.path.join(ROOT, "exp", "lrkd_sweep_config.yaml"))
    assert mini == jsweep._mini_yaml(os.path.join(ROOT, "exp", "lrkd_sweep_config.yaml"))
    assert mini["parameters"] == spec["parameters"] and mini["method"] == "bayes"
    params = spec["parameters"]
    for seed in range(3):
        ra, rb = random.Random(seed), random.Random(seed)
        assert ([psweep.sample_params(params, ra) for _ in range(5)]
                == [jsweep.sample_params(params, rb) for _ in range(5)])

    def score(p):
        return -((p["lrkd_alpha"] - 0.25) ** 2 + (p["lrkd_beta"] - 0.15) ** 2
                 + 0.001 * p["lrkd_rank"])

    ra, rb = random.Random(3), random.Random(3)
    ha, hb = [], []
    for _ in range(7):
        pa, pb = psweep.bayes_suggest(params, ha, ra), jsweep.bayes_suggest(params, hb, rb)
        assert pa == pb
        ha.append((pa, score(pa)))
        hb.append((pb, score(pb)))
