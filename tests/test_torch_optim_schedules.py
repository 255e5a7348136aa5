"""The rest of the port's optimizer against the JAX package's
(``deltakd_tpu/train/optim.py``, ``train/loop.py``): every optimizer and
schedule, the LR scale, LR noise and the plateau controller, then run()'s use
of them and the checkpoint that carries them.

- For each opt in (adamw, sgd, adam) and sched in (cosine, step, plateau),
  with and without clipping, 7 updates (and the EMA) against JAX
  ``make_optimizer`` on the same numpy parameters and gradients, the LR
  scale set to 0.5 before the fourth update on both sides (the plateau's;
  cosine and step get theirs from ``lr_noise``): parameters to 1e-6
  absolute. The JAX side runs sgd and adam as its optax chains
  (``fused=False``), adamw both fused and chained.
- The step and plateau schedules at steps 0-9; PlateauController on a fixed
  accuracy sequence (ties, gains within the relative threshold, cooldown,
  the ``min_lr`` floor) and lr_noise_multiplier at epochs 0-20 with one and
  two bounds, the same bits as JAX's.
- run() for 3 tiny epochs on the CPU with ``validate`` pinned to a sequence:
  the scale in effect in each epoch (the plateau's after the epoch before,
  times the epoch's noise), the scale saved after each epoch (the
  plateau's alone), and a resumed run starting from the saved scale with the
  straight run's parameters; a checkpoint in the first format (no optimizer
  kind, no scale) loads as AdamW with scale 1.0.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.train import optim as jo
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
from deltakd_tpu_torch.configs.config import TrainConfig, parse_args
from deltakd_tpu_torch.train import loop
from deltakd_tpu_torch.train import optim as to
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters

torch.set_num_threads(1)

SCHED = dict(lr=1e-2, warmup_lr=1e-4, min_lr=1e-3, warmup_epochs=1, epochs=3,
             weight_decay=0.05, decay_epochs=1, decay_rate=0.5)
STEPS, SCALE_AT, SCALE = 7, 3, 0.5


def _param_arrays(rng):
    return {"w": rng.randn(4, 6).astype(np.float32),
            "bias": rng.randn(6).astype(np.float32),
            "pos_embed": rng.randn(1, 3, 4).astype(np.float32),
            "m2": rng.randn(3, 3).astype(np.float32)}


CASES = [(opt, sched, clip, fused) for opt in ("adamw", "sgd", "adam")
         for sched in ("cosine", "step", "plateau") for clip in (None, 1.0)
         for fused in ((True, False) if opt == "adamw" else (False,))]


@pytest.mark.parametrize("opt,sched,clip,fused", CASES)
def test_optimizer_matches_jax(opt, sched, clip, fused):
    rng = np.random.RandomState(0)
    init = _param_arrays(rng)
    grads = [_param_arrays(rng) for _ in range(STEPS)]
    hp = dict(SCHED, opt=opt, sched=sched, clip_grad=clip,
              lr_noise=None if sched == "plateau" else (0.0,))

    jcfg = JTrainConfig(**hp)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jtx = jo.make_optimizer(jcfg, {"student": jparams, "aux": {}}, 2, fused=fused)
    jstate = JTrainState.create(student_params=jparams, aux_params={}, tx=jtx, ema_decay=0.9)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    ttx = to.make_optimizer(TrainConfig(aa="", color_jitter=0.0, **hp),
                            trainable_parameters(module), 2)
    tstate = TrainState(module, tx=ttx, ema_decay=0.9)
    assert to.get_lr_scale(tstate.opt_state) == jo.get_lr_scale(jstate.opt_state) == 1.0
    assert tstate.opt_state.kind == ("adamw" if opt == "adamw" else opt)

    for i, g in enumerate(grads):
        if i == SCALE_AT:
            jstate = jstate.replace(opt_state=jo.set_lr_scale(jstate.opt_state, SCALE))
            to.set_lr_scale(tstate.opt_state, SCALE)
        jstate = jstate.apply_gradients(
            grads={"student": {k: jnp.asarray(v) for k, v in g.items()}, "aux": {}},
            tx=jtx, ema_decay=0.9)
        flat = torch.cat([torch.from_numpy(g[n.split(".", 1)[1]]).reshape(-1)
                          for n, _ in tstate.named_params])
        tstate.apply_gradients(grads=flat, tx=ttx, ema_decay=0.9)
    assert tstate.step == int(jstate.step) == STEPS
    assert to.get_lr_scale(tstate.opt_state) == jo.get_lr_scale(jstate.opt_state) == SCALE
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params["student"][k]),
                                   atol=1e-6, err_msg=k)
        assert not np.allclose(p.detach().numpy(), init[k])


def test_scale_multiplies_the_whole_update_and_a_state_without_one_passes():
    """Scale 0.25 against 1 from the same state: the change of the
    parameters is 0.25 times as large, weight decay included; a cosine
    schedule without noise has no scale and set_lr_scale leaves it so."""
    rng = np.random.RandomState(1)
    for opt in ("adamw", "sgd", "adam"):
        module = torch.nn.Module()
        for k, v in _param_arrays(rng).items():
            module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
        named = trainable_parameters(module)
        tx = to.make_optimizer(TrainConfig(aa="", color_jitter=0.0, opt=opt, sched="plateau",
                                           **SCHED), named, 2)
        flat = torch.cat([p.detach().reshape(-1) for _, p in named])
        g = torch.from_numpy(rng.randn(flat.numel()).astype(np.float32))
        moved = []
        for scale in (1.0, 0.25):
            state, p = tx.init(flat), flat.clone()
            to.set_lr_scale(state, scale)
            tx.update(g, state, p)
            moved.append(p - flat)
        torch.testing.assert_close(moved[1], 0.25 * moved[0], rtol=1e-5, atol=1e-7)
    tx = to.make_optimizer(TrainConfig(aa="", color_jitter=0.0, **SCHED), named, 2)
    state = tx.init(flat)
    assert to.set_lr_scale(state, 0.5) is state and to.get_lr_scale(state) is None


def test_global_norm_is_the_fp64_norm_rounded_at_full_length():
    """The clip's global norm over DeiT-Ti-distilled's 5,563,400 values is
    the fp64 norm rounded to fp32, where the CPU's fp32 norm over them is
    about 1e-4 off; the clip scales every value by it."""
    g = torch.randn(5_563_400, generator=torch.Generator().manual_seed(14)) * 0.05
    exact = torch.linalg.vector_norm(g.double())
    norm = to.global_norm(g)
    assert norm.dtype == torch.float32
    assert norm.item() == exact.float().item()
    clipped = to._clip(g, 5.0)
    np.testing.assert_allclose(torch.linalg.vector_norm(clipped.double()).item(), 5.0,
                               rtol=1e-6)


@pytest.mark.parametrize("opt,sched", [("lamb", "cosine"), ("adamw", "tanh")])
def test_make_optimizer_raises_as_jax(opt, sched):
    """What the config refuses, make_optimizer refuses too (a config made
    some other way); so does the JAX package's."""
    bad = TrainConfig(aa="", color_jitter=0.0)
    object.__setattr__(bad, "opt", opt)   # past the config's own check
    object.__setattr__(bad, "sched", sched)
    with pytest.raises(NotImplementedError):
        to.make_optimizer(bad, [("student.w", torch.zeros(2, 2))], 2)
    with pytest.raises(NotImplementedError):
        jo.make_optimizer(JTrainConfig(opt=opt, sched=sched), {"w": jnp.zeros((2, 2))}, 2)


@pytest.mark.parametrize("sched", ["step", "plateau"])
def test_schedule_matches_jax(sched):
    hp = dict(SCHED, sched=sched, warmup_epochs=2, decay_epochs=1.5)
    jsched = jo.make_schedule(JTrainConfig(**hp), 2)
    tsched = to.make_schedule(TrainConfig(aa="", color_jitter=0.0, **hp), 2)
    for step in range(10):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6)


ACC = [10.0, 10.0, 10.0005, 12.0, 12.0, 11.0, 11.5, 11.9, 12.0, 13.0, 12.5, 12.5, 12.5, 12.5,
       12.5, 12.5, 12.5, 12.5, 12.5, 12.5]


@pytest.mark.parametrize("patience,cooldown", [(0, 0), (1, 2), (2, 0)])
def test_plateau_controller_matches_jax(patience, cooldown):
    """Ties, a gain within the relative threshold 1e-4 (10 -> 10.0005), a
    drop, cooldown, and enough stalled epochs to reach the floor min_lr / lr
    (0.1 with decay 0.5)."""
    kw = dict(decay_rate=0.5, patience=patience, cooldown=cooldown, min_lr=1e-3, base_lr=1e-2)
    jc, tc = jo.PlateauController(**kw), to.PlateauController(**kw)
    got = [tc.epoch_end(a) for a in ACC]
    assert got == [jc.epoch_end(a) for a in ACC]
    assert min(got) == pytest.approx(0.1) and got[-1] == min(got)


@pytest.mark.parametrize("lr_noise", [(0.4,), (0.2, 0.6), None])
def test_lr_noise_multiplier_matches_jax(lr_noise):
    hp = dict(epochs=20, lr_noise=lr_noise, lr_noise_pct=0.67, seed=7)
    jcfg, tcfg = JTrainConfig(**hp), TrainConfig(aa="", color_jitter=0.0, **hp)
    got = [to.lr_noise_multiplier(tcfg, e) for e in range(21)]
    assert got == [jo.lr_noise_multiplier(jcfg, e) for e in range(21)]
    if lr_noise:
        lo = lr_noise[0] * 20
        hi = lr_noise[1] * 20 if len(lr_noise) > 1 else 21
        assert all((m != 1.0) == (lo <= e < hi) for e, m in enumerate(got))
        assert all(abs(m - 1.0) < 0.67 for m in got)
    else:
        assert got == [1.0] * 21


# -----------------------------------------------------------------------------
# run() and the checkpoint
# -----------------------------------------------------------------------------

TINY = ["--device", "cpu", "--synthetic-data", "--dataset", "synthetic", "--input-size", "32",
        "--batch-size", "8", "--steps-per-epoch", "1", "--eval-steps", "1", "--dtype",
        "float32", "--student-model", "deit_tiny_patch16_224", "--teacher-model",
        "deit_tiny_patch16_224", "--log-every", "1", "--seed", "5"]
PLATEAU = ["--sched", "plateau", "--lr-noise", "0.3", "--patience-epochs", "0",
           "--cooldown-epochs", "0", "--decay-rate", "0.5", "--lr", "1e-3", "--min-lr", "1e-4"]
VAL_ACC1 = [20.0, 19.0, 19.0]
REAL_EPOCH, REAL_SAVE = loop.train_one_epoch, loop.save_checkpoint


def _run(tmp_path, monkeypatch, name, *extra, start=0):
    """run() with validate returning VAL_ACC1 from epoch ``start`` on, in
    turn; returns the scales in effect at each epoch's start and saved after
    each epoch."""
    record = {"installed": [], "saved": []}
    epochs = iter(VAL_ACC1[start:])

    def train_one_epoch(state, *a, **kw):
        record["installed"].append(to.get_lr_scale(state.opt_state))
        return REAL_EPOCH(state, *a, **kw)

    def save(path, state, **kw):
        record["saved"].append(to.get_lr_scale(state.opt_state))
        return REAL_SAVE(path, state, **kw)

    monkeypatch.setattr(loop, "train_one_epoch", train_one_epoch)
    monkeypatch.setattr(loop, "save_checkpoint", save)
    monkeypatch.setattr(loop, "validate", lambda *a, **kw: {
        "val_loss": 1.0, "val_acc1": next(epochs), "val_acc5": 50.0})
    argv = TINY + ["--log-file", str(tmp_path / "logs" / f"{name}.log"), "--save-dir",
                   str(tmp_path / name), *PLATEAU, *extra]
    loop.run(parse_args(argv))
    return record


def test_run_drives_the_plateau_scale_and_the_noise_and_resumes(tmp_path, monkeypatch):
    straight = _run(tmp_path, monkeypatch, "a", "--epochs", "3")
    jc = jo.PlateauController(decay_rate=0.5, patience=0, cooldown=0, min_lr=1e-4,
                              base_lr=1e-3)
    want_saved = [jc.epoch_end(a) for a in VAL_ACC1]
    assert want_saved == [1.0, 0.5, 0.25]
    noise = [jo.lr_noise_multiplier(JTrainConfig(epochs=3, lr_noise=(0.3,), seed=5), e)
             for e in range(3)]
    assert noise[0] == 1.0 and noise[1] != 1.0 and noise[2] != 1.0
    assert straight["installed"] == [s * n for s, n in zip([1.0] + want_saved[:-1], noise)]
    assert straight["saved"] == want_saved
    ckpt = str(tmp_path / "a" / "checkpoint")
    saved = torch.load(os.path.join(ckpt, "state-3", "state.pt"), weights_only=True)
    assert saved["state"]["opt"]["scale"] == 0.25 and saved["state"]["opt"]["kind"] == "adamw"

    _run(tmp_path, monkeypatch, "b", "--epochs", "2")
    resumed = _run(tmp_path, monkeypatch, "b", "--epochs", "3", "--resume", "--checkpoint",
                   str(tmp_path / "b" / "checkpoint"), start=2)
    assert resumed["installed"] == straight["installed"][2:]
    other = torch.load(str(tmp_path / "b" / "checkpoint" / "state-3" / "state.pt"),
                       weights_only=True)["state"]
    assert torch.equal(other["params"], saved["state"]["params"])
    assert torch.equal(other["opt"]["mu"], saved["state"]["opt"]["mu"])


def test_a_checkpoint_without_kind_and_scale_loads_as_adamw(tmp_path):
    """The first format (``opt``: count, mu, nu) into an AdamW state with an
    LR scale (scale 1.0), one without (no scale), and an SGD state (refused)."""
    module = torch.nn.Module()
    module.register_parameter("w", torch.nn.Parameter(torch.randn(3, 4)))
    named = trainable_parameters(module)
    tx = to.make_optimizer(TrainConfig(aa="", color_jitter=0.0, **SCHED), named, 2)
    state = TrainState(module, tx=tx)
    state.apply_gradients(grads=torch.ones(12), tx=tx)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, epoch=1, best_acc=0.0,
                           is_best=False)
    tree = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    tree["state"]["opt"] = {k: tree["state"]["opt"][k] for k in ("count", "mu", "nu")}
    torch.save(tree, os.path.join(path, "state.pt"))
    for sched, scale in (("plateau", 1.0), ("cosine", None)):
        other = TrainState(module, tx=to.make_optimizer(
            TrainConfig(aa="", color_jitter=0.0, **dict(SCHED, sched=sched)), named, 2))
        other.opt_state.scale = None if scale is None else 0.3
        load_checkpoint(str(tmp_path / "ckpt"), other)
        assert other.opt_state.count == 1 and other.opt_state.scale == scale
        assert torch.equal(other.opt_state.mu, state.opt_state.mu)
    sgd = TrainState(module, tx=to.make_optimizer(
        TrainConfig(aa="", color_jitter=0.0, opt="sgd", **SCHED), named, 2))
    with pytest.raises(ValueError, match="optimizer 'adamw', not 'sgd'"):
        load_checkpoint(str(tmp_path / "ckpt"), sgd)
