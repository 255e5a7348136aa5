"""The port's accuracy-equivalence harness (``scripts/equivalence_run.py``)
against the JAX package's (``benchmarks/equivalence_run.py``) on the CPU:
the same dataset bytes, the same host pipeline, mixup and schedule draws
from the same seeds, the same parsed config, the same band rule; and a tiny
``main`` through the port's ``run()`` on the CPU that writes its table.

The JAX script imports only numpy at module level, so it is loaded here as
a module; the JAX package itself is imported only where its ``parse_args``
and its ``main``'s table are compared.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from deltakd_tpu_torch.data.registry import DATASET_STATS
from deltakd_tpu_torch.models import registry
from deltakd_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


eq = _load("scripts/equivalence_run.py", "torch_equivalence_run")
jeq = _load("benchmarks/equivalence_run.py", "jax_equivalence_run")

# 2-block test models under the harness's names (head dim 16: the CPU runs
# the kernels' plain versions, which take any)
TEST_MODELS = {eq.STUDENT_SOFT: dict(embed_dim=32, num_heads=2, distilled=True),
               eq.STUDENT_PLAIN: dict(embed_dim=32, num_heads=2, distilled=False),
               eq.TEACHER: dict(embed_dim=48, num_heads=3, distilled=True)}


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_dataset_writer_matches_jax_bytes(tmp_path):
    eq.generate_dataset(str(tmp_path / "port"), 2, 2, seed=0)
    jeq.generate_dataset(str(tmp_path / "jax"), 2, 2, seed=0)
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(ref)
    assert len(port) == 1 + 2 * 2 * eq.NUM_CLASSES
    for name in ref:
        assert port[name] == ref[name], name
    assert json.loads(port["meta.json"]) == {"img_src": 256, "n_train": 2, "n_val": 2,
                                             "seed": 0}
    assert eq.dataset_matches(str(tmp_path / "port"), 2, 2)
    assert not eq.dataset_matches(str(tmp_path / "port"), 2, 3)


def _images(n=6, seed=3):
    from PIL import Image

    rng = np.random.RandomState(seed)
    return [Image.fromarray(eq._texture(rng, i % eq.NUM_CLASSES)) for i in range(n)]


@pytest.mark.parametrize("recipe", ["base", "ra", "3aug"])
@pytest.mark.parametrize("train", [True, False])
def test_host_pipeline_matches_jax(recipe, train):
    port = eq.HostPipeline(train, np.random.RandomState(7), recipe)
    ref = jeq.HostPipeline(train, np.random.RandomState(7), recipe)
    for img in _images() * 2:
        a, b = port(img), ref(img)
        assert a.dtype == b.dtype == torch.float32 and a.shape == (3, eq.INPUT, eq.INPUT)
        assert torch.equal(a, b)


def test_rand_augment_mixup_and_schedule_match_jax():
    port, ref = eq.HostRandAugment(np.random.RandomState(5)), jeq.HostRandAugment(
        np.random.RandomState(5))
    for img in _images(8) * 4:   # 32 images x 2 layers: every op of the table
        assert np.array_equal(np.asarray(port(img)), np.asarray(ref(img)))
    for op in range(15):
        a = port._apply_op(_images(1)[0], op, 9.0)
        b = ref._apply_op(_images(1)[0], op, 9.0)
        assert np.array_equal(np.asarray(a), np.asarray(b)), op

    args = (0.8, 1.0, 1.0, 0.5, 0.1, eq.NUM_CLASSES)
    port_mix, ref_mix = eq.TorchMixup(*args, np.random.RandomState(9)), jeq.TorchMixup(
        *args, np.random.RandomState(9))
    g = torch.Generator().manual_seed(0)
    for _ in range(12):
        x = torch.randn(8, 3, eq.INPUT, eq.INPUT, generator=g)
        y = torch.randint(0, eq.NUM_CLASSES, (8,), generator=g)
        (xa, ta), (xb, tb) = port_mix(x, y), ref_mix(x, y)
        assert torch.equal(xa, xb) and torch.equal(ta, tb)

    class Cfg:
        warmup_epochs, warmup_lr, lr, epochs, min_lr = 3, 1e-6, 5e-4, 40, 1e-5

    assert [eq._cosine_lr(Cfg, e) for e in range(45)] == [jeq._cosine_lr(Cfg, e)
                                                          for e in range(45)]


@pytest.mark.parametrize("recipe", ["base", "ra", "3aug"])
def test_make_cfg_matches_jax(recipe, tmp_path):
    from deltakd_tpu.configs.config import TrainConfig as JTrainConfig

    shared = None
    for objective in ("soft", "mgd", "wasskd", "vitkd"):
        for pixel_bf16 in (False, True):
            args = (str(tmp_path / "data"), "teacher.pth", objective, 1, 40,
                    str(tmp_path), recipe, pixel_bf16)
            port, ref = eq.make_cfg(*args), jeq.make_cfg(*args)
            shared = sorted({f for f in vars(port)} & {f for f in vars(ref)})
            # the harness's models: DeiT widths in the port, head dim 64
            names = {"student_model": {jeq.STUDENT_SOFT: eq.STUDENT_SOFT,
                                       jeq.STUDENT_PLAIN: eq.STUDENT_PLAIN},
                     "teacher_model": {jeq.TEACHER: eq.TEACHER}}
            for field in shared:
                got, want = getattr(port, field), getattr(ref, field)
                if field in names:
                    assert got == names[field][want], field
                else:
                    assert got == want, (field, got, want)
            assert port.dtype == "float32" and port.aug_pixel_bf16 is pixel_bf16
            bf16 = eq.make_cfg(*args, dtype="bfloat16", device="cpu")
            assert bf16.dtype == "bfloat16" and bf16.device == "cpu"
    assert len(shared) > 80 and len(shared) == len(vars(JTrainConfig()))


def _tiny_registries(monkeypatch):
    for name, dims in TEST_MODELS.items():
        monkeypatch.setitem(registry.MODEL_REGISTRY, name, ViTConfig(
            img_size=eq.INPUT, patch_size=8, depth=2, **dims))
    monkeypatch.setitem(DATASET_STATS, "texture8", {
        "mean": eq.MEAN, "std": eq.STD, "num_classes": eq.NUM_CLASSES})


def test_tiny_main_on_the_cpu_writes_its_table(tmp_path, monkeypatch, capsys):
    _tiny_registries(monkeypatch)
    out = tmp_path / "EQ.md"
    argv = ["--device", "cpu", "--objective", "both", "--seeds", "0", "1", "--epochs", "1",
            "--teacher-epochs", "1", "--train-per-class", "4", "--val-per-class", "2",
            "--batch-size", "8", "--workdir", str(tmp_path / "work"), "--out", str(out),
            "--commit", "test"]
    got = eq.compare(argv)
    text = out.read_text()
    assert text.startswith(eq.HEADER)
    section = text.split("<!-- table: recipe base, ours float32 -->")[1]
    assert "Card: no card: device cpu." in section and "Commit: test." in section
    for objective in ("soft", "mgd"):
        for seed in (0, 1):
            r = got["results"][(objective, seed)]
            assert r["ours"]["launches"] == {} and r["ours"]["steps"] == 4
            for stack in ("torch", "ours"):
                assert 0.0 <= r[stack]["final_acc"] <= r[stack]["best_acc"] <= 100.0
            assert (f"| {objective} | {seed} | {r['torch']['final_acc']:.2f} | "
                    f"{r['ours']['final_acc']:.2f} |") in section
        delta, band, verdict = got["verdicts"][objective]
        assert f"| {objective} | mean |" in section
        assert f"Δ={delta:.2f} | {verdict} band {band:.2f} |" in section
    assert got["ok"] == all(v[2] == "WITHIN" for v in got["verdicts"].values())

    # the cache serves every row again, and a second table of another dtype
    # reuses the torch rows
    capsys.readouterr()
    again = eq.compare(argv + ["--dtype", "bfloat16", "--objective", "soft"])
    printed = capsys.readouterr().out
    assert printed.count("torch cached") == 2 and "ours cached" not in printed
    assert again["results"][("soft", 0)]["torch"] == got["results"][("soft", 0)]["torch"]
    assert "<!-- table: recipe base, ours bfloat16 -->" in out.read_text()
    assert "<!-- table: recipe base, ours float32 -->" in out.read_text()


# made-up final top-1 by objective: (torch seeds, ours seeds)
MADE_UP = {"soft": ([60.0, 61.5, 59.0], [60.5, 62.0, 60.25]),      # within, band 3.75 -> 3
           "mgd": ([50.0, 50.5, 50.25], [53.0, 53.25, 52.5]),      # outside, band 2.0
           "wasskd": ([40.0, 41.0, 40.5], [41.0, 41.75, 42.0]),    # within, band 2.0 floor
           "vitkd": ([70.0, 71.5, 70.0], [72.0, 72.25, 72.5])}     # within, 1.5 x spread


def _made_up(stack, objective, seed):
    t, o = MADE_UP[objective]
    acc = (t if stack == "torch" else o)[seed]
    out = {"final_acc": acc, "best_acc": acc + 1.0}
    return out if stack == "torch" else dict(out, launches={}, steps=0)


def _mean_rows(path):
    rows = {}
    for line in open(path).read().splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if len(cells) == 6 and cells[1] == "mean":
            rows[cells[0]] = cells[2:]
    return rows


def test_band_verdict_matches_the_jax_band_rule(tmp_path, monkeypatch):
    # the JAX script's main on made-up results: no training, its own table
    monkeypatch.setattr(jeq, "dataset_matches", lambda *a: True)
    monkeypatch.setattr(jeq, "_register_harness_entries", lambda: None)
    monkeypatch.setattr(jeq, "torch_train_teacher",
                        lambda cfg, root, path, epochs: open(path, "wb").write(b"t") and 90.0)
    monkeypatch.setattr(jeq, "torch_train_student",
                        lambda cfg, root, tp, objective, seed, recipe: _made_up(
                            "torch", objective, seed))
    monkeypatch.setattr(jeq, "ours_train_student",
                        lambda root, tp, objective, seed, *a: _made_up("ours", objective, seed))
    jax_out = tmp_path / "jax.md"
    monkeypatch.setattr(sys, "argv", ["equivalence_run.py", "--objective", "all", "--seeds",
                                      "0", "1", "2", "--workdir", str(tmp_path / "jax"),
                                      "--out", str(jax_out)])
    assert jeq.main() == 1   # mgd is outside its band

    # the port's main on the same results
    monkeypatch.setattr(eq, "dataset_matches", lambda *a: True)
    monkeypatch.setattr(eq, "torch_train_teacher",
                        lambda cfg, root, path, epochs, device: open(path, "wb").write(b"t")
                        and 90.0)
    monkeypatch.setattr(eq, "torch_train_student",
                        lambda cfg, root, tp, objective, seed, recipe, device: _made_up(
                            "torch", objective, seed))
    monkeypatch.setattr(eq, "ours_train_student",
                        lambda root, tp, objective, seed, *a: _made_up("ours", objective, seed))
    port_out = tmp_path / "port.md"
    assert eq.main(["--objective", "all", "--seeds", "0", "1", "2", "--device", "cpu",
                    "--workdir", str(tmp_path / "port"), "--out", str(port_out)]) == 1

    ref, port = _mean_rows(jax_out), _mean_rows(port_out)
    assert sorted(ref) == sorted(port) == sorted(MADE_UP)
    assert port == ref
    verdicts = {k: v[-1].split()[0] for k, v in ref.items()}
    assert verdicts == {"soft": "WITHIN", "mgd": "OUTSIDE", "wasskd": "WITHIN",
                        "vitkd": "WITHIN"}
    for objective, (t, o) in MADE_UP.items():
        delta, band, verdict = eq.band_verdict(t, o)
        assert ref[objective][2] == f"Δ={delta:.2f}"
        assert ref[objective][3] == f"{verdict} band {band:.2f}"
