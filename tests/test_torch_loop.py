"""The port's epoch loop on the CPU: ``validate`` against the JAX package's
(the same val_loss to 1e-5 relative, the same acc1/acc5, on weights carried
across by ``models/convert.py``, with a padded tail), and ``run()`` and the
CLIs as the JAX package's ``tests/test_integration.py`` checks its own, at
32 px, batch 8, 2 steps an epoch, fp32 (``--device cpu``): end to end with a
profile of the first epoch; two runs the same bits; 3 straight epochs against
2 and a resumed third, the same bits (parameters, Adam moments, counts,
metrics); the eval CLI against run()'s last validation; the transfer chain
(head dropped, pos_embed interpolated 2x2 -> 3x3 and not dropped, the
backbone from the checkpoint); the val batch decoupled from
``grad_accum_steps``; a SIGTERM to a CLI subprocess saves and exits 0, and the
run resumes from that save; ``run()`` without a card raises.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.pipeline import Loader as JLoader
from deltakd_tpu.data.sources import ArraySource as JArraySource
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.train.loop import validate as jvalidate
from deltakd_tpu.train.step import build_eval_step as jbuild_eval_step
from deltakd_tpu_torch.ckpt.checkpoint import student_state_dict
from deltakd_tpu_torch.cli.eval import main as eval_main
from deltakd_tpu_torch.configs.config import TrainConfig, parse_args
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.pipeline import Loader
from deltakd_tpu_torch.data.registry import DATASET_STATS
from deltakd_tpu_torch.data.sources import synthetic_source
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.train import loop
from deltakd_tpu_torch.train.step import build_eval_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--synthetic-data", "--input-size", "32", "--batch-size", "8",
        "--steps-per-epoch", "2", "--eval-steps", "2", "--dtype", "float32",
        "--student-model", "deit_tiny_patch16_224", "--teacher-model",
        "deit_tiny_patch16_224", "--log-every", "1"]


def _argv(tmp, name, *extra, dataset="synthetic"):
    return TINY + ["--dataset", dataset, "--log-file", str(tmp / "logs" / f"{name}.log"),
                   "--save-dir", str(tmp / name), *extra]


@pytest.mark.parametrize("eval_steps", [None, 3])
def test_validate_matches_jax(eval_steps):
    """37 images in batches of 8: the last batch holds 5 and 3 of padding."""
    vcfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
                num_classes=10)
    jm = JViT(JViTConfig(**vcfg), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 32, 32, 3))))["params"]
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda s: (0.2 * rng.randn(*s.shape)).astype(np.float32), shapes)
    pm = VisionTransformer(ViTConfig(**vcfg), dtype=torch.float32)
    pm.load_state_dict(flax_to_torch(params))

    src = synthetic_source(n=37, hw=32, num_classes=10, seed=4)
    kw = dict(dataset="synthetic", input_size=32, eval_steps=eval_steps)
    pcfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
    want = jvalidate(params, jbuild_eval_step(student_module=jm,
                                              aug=JAugmentConfig.from_config(jcfg)),
                     JLoader(JArraySource(src.images, src.labels, 10), batch_size=8,
                             is_train=False), jcfg, printer=lambda *_: None)
    got = loop.validate(build_eval_step(student=pm, aug=AugmentConfig.from_config(pcfg)),
                        Loader(src, batch_size=8, is_train=False), pcfg,
                        device=torch.device("cpu"), printer=lambda *_: None)
    assert set(got) == set(want) == {"val_loss", "val_acc1", "val_acc5"}
    assert abs(got["val_loss"] - want["val_loss"]) <= 1e-5 * abs(want["val_loss"])
    assert got["val_acc1"] == want["val_acc1"] and got["val_acc5"] == want["val_acc5"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A: 3 straight epochs (a profile of the first); B: 2 epochs, then
    resumed to 3. MGD against a random teacher, so that the masking noise,
    drop-path and augmentation all draw."""
    tmp = tmp_path_factory.mktemp("runs")
    kd = ["--distillation-type", "mgd", "--allow-random-teacher", "--seed", "3"]
    cfg_a = parse_args(_argv(tmp, "a", *kd, "--epochs", "3",
                             "--profile-dir", str(tmp / "prof")))
    metrics_a = loop.run(cfg_a)
    cfg_b = parse_args(_argv(tmp, "b", *kd, "--epochs", "2"))
    loop.run(cfg_b)
    ckpt_b = str(tmp / "b" / "checkpoint")
    metrics_b = loop.run(cfg_b.replace(epochs=3, resume=True, checkpoint=ckpt_b))
    return dict(tmp=tmp, cfg_a=cfg_a, metrics_a=metrics_a, metrics_b=metrics_b,
                ckpt_a=str(tmp / "a" / "checkpoint"), ckpt_b=ckpt_b)


def _saved(ckpt, epoch):
    return torch.load(os.path.join(ckpt, f"state-{epoch}", "state.pt"), weights_only=True)


def _same_bits(a, b):
    sa, sb = a["state"], b["state"]
    assert a["meta"] == b["meta"]
    assert sa["names"] == sb["names"] and sa["step"] == sb["step"]
    assert sa["opt"]["count"] == sb["opt"]["count"] == sa["step"]
    for x, y in ((sa["params"], sb["params"]), (sa["opt"]["mu"], sb["opt"]["mu"]),
                 (sa["opt"]["nu"], sb["opt"]["nu"])):
        assert torch.equal(x, y)


def test_run_end_to_end(runs):
    m = runs["metrics_a"]
    assert {"val_loss", "val_acc1", "val_acc5", "best_val_acc"} <= set(m)
    assert all(np.isfinite(v) for v in m.values())
    ckpt = runs["ckpt_a"]
    assert sorted(os.listdir(ckpt)) == ["meta.json", "state-2", "state-3"]
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"epoch": 3, "best_acc": m["best_val_acc"], "format": "torch-v1",
                    "state_dir": "state-3"}
    assert _saved(ckpt, 3)["state"]["step"] == 6
    assert os.path.isfile(os.path.join(runs["tmp"], "prof", "trace_epoch0.json"))


def test_two_runs_give_the_same_bits(runs):
    """A's epoch-2 checkpoint (kept beside epoch 3) and B's, before B resumed."""
    _same_bits(_saved(runs["ckpt_a"], 2), _saved(runs["ckpt_b"], 2))


def test_resumed_run_gives_the_bits_of_a_straight_one(runs):
    _same_bits(_saved(runs["ckpt_a"], 3), _saved(runs["ckpt_b"], 3))
    assert runs["metrics_a"] == runs["metrics_b"]


def test_eval_cli_matches_the_last_validation(runs, tmp_path):
    out = str(tmp_path / "metrics.json")
    cfg = runs["cfg_a"]
    got = eval_main(TINY + ["--dataset", "synthetic", "--checkpoint", runs["ckpt_a"],
                            "--output", out])
    want = runs["metrics_a"]
    assert got["test_loss"] == want["val_loss"] and got["test_acc1"] == want["val_acc1"]
    assert got["test_acc5"] == want["val_acc5"] and got["epoch"] == cfg.epochs
    with open(out) as f:
        assert json.load(f) == got


def test_transfer_chain_through_run(tmp_path, monkeypatch):
    """Train on 12 classes at 32 px (2x2 grid), then --finetune on 5 classes at
    48 px (3x3), as the exp/*-transfer.sh recipes do."""
    stats = {"mean": (0.5, 0.5, 0.5), "std": (0.25, 0.25, 0.25)}
    monkeypatch.setitem(DATASET_STATS, "xfer_a", {**stats, "num_classes": 12})
    monkeypatch.setitem(DATASET_STATS, "xfer_b", {**stats, "num_classes": 5})
    base = ["--epochs", "1", "--distillation-type", "none"]
    loop.run(parse_args(_argv(tmp_path, "a", *base, dataset="xfer_a")))
    ckpt_a = str(tmp_path / "a" / "checkpoint")

    captured = {}
    real = loop.load_student_for_finetune

    def spy(checkpoint, student, *, num_prefix_tokens, log):
        lines = []
        captured["target"] = {n: p.detach().clone() for n, p in student.named_parameters()}
        captured["merged"] = real(checkpoint, student, num_prefix_tokens=num_prefix_tokens,
                                  log=lambda m: (lines.append(m), log(m)))
        captured["lines"] = lines
        return captured["merged"]

    monkeypatch.setattr(loop, "load_student_for_finetune", spy)
    argv_b = _argv(tmp_path, "b", *base, "--finetune", "--checkpoint", ckpt_a,
                   dataset="xfer_b")
    argv_b[argv_b.index("--input-size") + 1] = "48"
    metrics_b = loop.run(parse_args(argv_b))
    assert np.isfinite(metrics_b["val_loss"])

    merged, target, lines = captured["merged"], captured["target"], captured["lines"]
    assert merged["pos_embed"].shape == (1, 1 + 9, 192)
    assert not torch.equal(merged["pos_embed"], target["pos_embed"])
    assert not any("dropping pos_embed" in line for line in lines)
    assert any("dropping head.weight" in line for line in lines)
    assert torch.equal(merged["head.weight"], target["head.weight"])
    source, _ = student_state_dict(ckpt_a)
    for name in ("blocks.0.attn.qkv.weight", "blocks.11.mlp.fc2.bias", "cls_token"):
        assert torch.equal(merged[name], source[name])
    assert not torch.equal(merged["blocks.0.attn.qkv.weight"],
                           target["blocks.0.attn.qkv.weight"])

    argv_eval = TINY + ["--dataset", "xfer_b", "--checkpoint", str(tmp_path / "b" / "checkpoint"),
                        "--output", str(tmp_path / "b.json")]
    argv_eval[argv_eval.index("--input-size") + 1] = "48"
    got = eval_main(argv_eval)
    assert got["test_loss"] == metrics_b["val_loss"]


def test_val_loader_batch_decoupled_from_grad_accum(tmp_path, monkeypatch):
    seen = {}
    real = loop.make_loader

    def spy(cfg, src, *, batch_size, is_train, **kw):
        seen["train" if is_train else "val"] = batch_size
        return real(cfg, src, batch_size=batch_size, is_train=is_train, **kw)

    monkeypatch.setattr(loop, "make_loader", spy)
    cfg = parse_args(_argv(tmp_path, "acc", "--epochs", "1", "--grad-accum-steps", "4",
                           "--steps-per-epoch", "1"))
    assert np.isfinite(loop.run(cfg)["val_loss"])
    assert seen == {"train": 32, "val": 8}


def test_sigterm_saves_exits_0_and_resumes(tmp_path):
    argv = _argv(tmp_path, "sig", "--epochs", "1000", "--steps-per-epoch", "1",
                 "--eval-steps", "1")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    meta = tmp_path / "sig" / "checkpoint" / "meta.json"
    proc = subprocess.Popen([sys.executable, "-m", "deltakd_tpu_torch.cli.train", *argv],
                            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not meta.exists() and proc.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        assert meta.exists(), "no checkpoint before the deadline"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "SIGTERM received" in out
    with open(meta) as f:
        saved = json.load(f)["epoch"]
    assert 1 <= saved < 1000

    cfg = parse_args(argv).replace(epochs=saved + 1, resume=True,
                                   checkpoint=str(tmp_path / "sig" / "checkpoint"))
    loop.run(cfg)
    with open(meta) as f:
        assert json.load(f)["epoch"] == saved + 1


def test_sweep_runs_a_trial_through_run(tmp_path):
    """cli.sweep with the LRKD sweep config: one trial's flags reach run() and
    its record lands in the JSONL file."""
    from deltakd_tpu_torch.cli import sweep

    out = tmp_path / "sweep.jsonl"
    best = sweep.main(["--config", os.path.join(ROOT, "deltakd_tpu_torch", "exp",
                                                "lrkd_sweep_config.yaml"),
                       "--trials", "1", "--seed", "2", "--output", str(out), "--",
                       *_argv(tmp_path, "sweep", "--epochs", "1", "--steps-per-epoch", "1",
                              "--eval-steps", "1")])
    [record] = [json.loads(line) for line in out.read_text().splitlines()]
    assert record["trial"] == 0 and best == (record["val_acc1"], record["params"])
    assert record["params"]["lrkd_rank"] in (16, 32, 64, 128)
    assert np.isfinite(record["metrics"]["val_loss"])
    assert (tmp_path / "sweep" / "trial0" / "checkpoint" / "meta.json").exists()


def test_run_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(tmp_path, "nocard", "--epochs", "1")
    cfg = parse_args(argv[2:])    # no --device cpu
    assert cfg.device is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.run(cfg)
    assert not (tmp_path / "nocard").exists()
