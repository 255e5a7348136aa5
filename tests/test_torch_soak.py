"""The port's soak (``scripts/soak_run.py``) on the CPU: a tiny soak through
the port's ``run()`` (4 epochs, resumed at 2, a 2-block model at 32 px from
a JPEG folder) that the port's ``analyze`` passes, and the port's
``analyze`` against the JAX script's (``benchmarks/soak_run.py``) on the
port's logs: the same gate lines and numbers.

The JAX analyzer's time gate reads epochs 2-6 and the last five, so it
stops at that gate on a 4-epoch log; its lines up to there are held on the
tiny run's log, and every line on 24-epoch logs written in the port's
format from that run's own lines.
"""

import contextlib
import importlib.util
import io
import os
import re
import shutil

import pytest
import torch

from deltakd_tpu_torch.models import registry
from deltakd_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


soak_run = _load("scripts/soak_run.py", "torch_soak_run")
jax_soak = _load("benchmarks/soak_run.py", "jax_soak_run")

EPOCHS = 4
OVERRIDES = ["--student-model", "soak_test_student", "--teacher-model", "soak_test_teacher",
             "--input-size", "32", "--batch-size", "8", "--num-workers", "2"]


def _lines(fn, *args):
    """SOAK lines that ``fn`` prints, and what it returned or raised."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            out = fn(*args)
        except Exception as exc:   # noqa: BLE001 - the caller holds it
            out = exc
    return [line for line in buf.getvalue().splitlines() if line.startswith("SOAK")], out


@pytest.fixture(scope="module")
def tiny_soak(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for name in ("soak_test_student", "soak_test_teacher"):
        mp.setitem(registry.MODEL_REGISTRY, name, ViTConfig(
            img_size=32, patch_size=8, depth=2, embed_dim=64, num_heads=1, distilled=True))
    base = str(tmp_path_factory.mktemp("soak"))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ok, readings = soak_run.soak(EPOCHS, "cpu", OVERRIDES, data_sizes=(64, 16, 32),
                                         base=base)
    finally:
        mp.undo()
    return ok, readings, buf.getvalue()


def test_tiny_soak_passes_the_port_analyze(tiny_soak):
    ok, r, printed = tiny_soak
    assert ok, printed[-3000:]
    assert len(r["losses"]) == EPOCHS
    assert len(r["accs"]) == EPOCHS + 2          # the epochs and each phase's final line
    assert r["losses"][-1] < 0.6 * r["losses"][0]
    assert r["launches"] == {"phase1": {}, "phase2": {}}   # the CPU: plain versions
    data = os.path.join(r["base"], "data")
    assert sorted(os.listdir(os.path.join(data, "train", "class_0")))[:2] == [
        "img_0000.jpg", "img_0001.jpg"]
    assert "Resumed from" in printed and "at epoch 2" in printed
    # the checkpoint of every epoch, the last one the resumed run's
    assert os.path.isdir(os.path.join(r["base"], "ckpt", "checkpoint"))
    assert len(r["loader_wait_ms"]) == len(r["step_ms"]) == EPOCHS


def test_analyzers_agree_on_the_tiny_run(tiny_soak, tmp_path):
    base = tiny_soak[1]["base"]
    port, (ok, _) = _lines(soak_run.analyze, base, EPOCHS)
    copy = str(tmp_path / "jax")
    shutil.copytree(base, copy)
    ref, raised = _lines(jax_soak.analyze, copy, EPOCHS)
    assert ok
    # the JAX analyzer's five-epoch time window needs seven epochs
    assert isinstance(raised, IndexError)
    assert len(ref) == 4 and all(line.startswith("SOAK ok  : ") for line in ref)
    assert port[:4] == ref


def _synthetic(base, tmp_path, name, losses, times):
    """A 24-epoch run's artifacts in the port's format, each line made from
    the tiny run's own log and progress lines with other numbers."""
    with open(os.path.join(base, "progress.txt")) as f:
        progress = f.read().splitlines()
    logs = os.path.join(base, "logs")
    first_log = sorted(os.listdir(logs))[0]
    with open(os.path.join(logs, first_log)) as f:
        summary = next(line for line in f if " - Epoch 0 (" in line)
    step = next(line for line in progress
                if line.startswith("Epoch: [1/2]\t") and "train_loss" in line)
    out = tmp_path / name
    (out / "logs").mkdir(parents=True)
    lines, progress_lines = [], []
    for e, (loss, t) in enumerate(zip(losses, times)):
        line = re.sub(r"Epoch 0 \([0-9.]+s\)", f"Epoch {e} ({t:.1f}s)", summary)
        line = re.sub(r"'train_loss': [0-9.eE+-]+", f"'train_loss': {loss!r}", line)
        lines.append(re.sub(r"'val_acc1': [0-9.eE+-]+", f"'val_acc1': {min(50.0, 20.0 + 2 * e)}",
                            line))
        for i, frac in enumerate((0.5, 1.0)):
            p = re.sub(r"^Epoch: \[1/2\]", f"Epoch: [{e + 1}/24]", step)
            p = re.sub(r"time: [0-9.]+", f"time: {t / 10 * frac:.4f}", p)
            progress_lines.append(re.sub(r"data: [0-9.]+", f"data: {0.001 * (i + 1):.4f}", p))
    (out / "logs" / "soak.log_20260101_000000").write_text("".join(lines[:12]))
    (out / "logs" / "soak.log_20260101_000100").write_text("".join(lines[12:]))
    (out / "progress.txt").write_text("\n".join(progress_lines) + "\n")
    return str(out)


@pytest.mark.parametrize("resume", ["continues", "restarts"])
def test_analyzers_agree_on_24_epochs_and_catch_a_restart(tiny_soak, tmp_path, resume):
    losses = [6.9 - 0.2 * e for e in range(24)]
    if resume == "restarts":   # the resumed epoch jumps back to the first loss
        losses = losses[:12] + [6.9 - 0.4 * e for e in range(12)]
    times = [2.0 + 0.01 * e for e in range(24)]
    base = _synthetic(tiny_soak[1]["base"], tmp_path, resume, losses, times)
    port, (ok, readings) = _lines(soak_run.analyze, base, 24)
    copy = str(tmp_path / f"{resume}-jax")
    shutil.copytree(base, copy)
    ref, code = _lines(jax_soak.analyze, copy, 24)
    assert port[:9] == ref[:9]                    # every gate, its numbers, the readings
    assert port[-1] == ref[9]                     # the verdict line
    assert readings["losses"] == losses
    continuity = [line for line in port if "resume continuity" in line]
    if resume == "continues":
        assert ok and code == 0 and continuity[0].startswith("SOAK ok  : ")
    else:
        assert not ok and code == 1 and continuity[0].startswith("SOAK FAIL: ")
        assert all(line.startswith("SOAK ok  : ") for line in port[:5] if line != continuity[0])
