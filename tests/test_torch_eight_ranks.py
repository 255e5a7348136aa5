"""The port at eight ranks on the CPU: one spawn of eight gloo processes
(``tests/torch_tp_worker.py``, one thread each) lays itself out as each mesh
below in turn, against the JAX package on ``jax.devices()[:8]`` of the
8-device CPU platform that ``conftest.py`` sets up, with the bounds of
``tests/test_torch_tensor_parallel.py`` (losses to 1e-5 of the largest,
grad norm and gathered gradients to 1e-4, parameters to 1e-6):

- (4, 2): the cases of the JAX package's multi-chip dry run
  (``__graft_entry__.py`` ``dryrun_multichip(8)``: depth 3, 4 heads) — mgd
  (the masking noise of the JAX step's loss key pinned), soft with
  ``grad_accum_steps=2`` and wasskd-sinkhorn with 8 iterations — each
  followed by the masked eval step with the last 3 rows invalid against
  JAX's ``build_eval_step``; the replicated tensors the same bits on the two
  model ranks of each data row; mixup in its three modes over the data
  group of 4, each rank's rows against JAX's ``apply_mixup`` of the global
  batch;
- (8, 1): the dry run's fused case, the soft step with accumulation 2 on the
  fused block (the port's plain version here) against the JAX step on the
  Pallas block in interpret mode; mixup over eight data ranks (the pair
  partner of rank r is 7 - r);
- (2, 4) and (1, 8): the soft step (a 4-head student: one head a rank at 4,
  the qkv gather at 8), as ``tests/test_distributed.py`` runs (2, 4);
- ``run()`` at (4, 2) against ``run()`` at (8, 1) at global batch 32 (the
  counterpart of ``tests/test_integration.py:53-68``): ``val_loss`` and
  ``val_acc1`` to rtol 1e-4, global rank 0 alone writing;
- ``scripts/dryrun_multichip.py 8 --device cpu``: exits 0 with one line a
  case.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.data.mixup import apply_mixup as japply_mixup
from deltakd_tpu.kd.aux import init_aux_params
from deltakd_tpu.parallel import mesh as jmesh
from tests import jax_draws
from tests.test_torch_tensor_parallel import (BASE, C, HP, KEY, ROOT, STUDENTS, TEACHER,
                                              check_replicas, check_step, jax_step, launch,
                                              random_tree, step_spec)

torch.set_num_threads(1)

WORLD = 8
B = 16   # the global batch of a micro-batch: the dry run's 2 images a device
DRY_STUDENT = dict(BASE, depth=3, embed_dim=32, num_heads=4, distilled=False)
DRY_TEACHER = dict(BASE, depth=3, embed_dim=64, num_heads=4)
DRY_CASES = ("mgd", "soft_accum", "wasskd_sinkhorn")
MODES = ("batch", "elem", "pair")
N_PATCHES = (32 // 8) ** 2
RUN_MESHES = (("4 2", 8), ("8 1", 4))   # (mesh, per-data-rank batch): global 32


def _aux(kd_type, seed):
    """Aux-head parameters of JAX's tree, random from ``seed``."""
    return random_tree(jax.eval_shape(lambda: init_aux_params(KEY, kd_type, 32, 64)), seed)


def _dry_steps(rng):
    """The dry run's three cases at (4, 2), each with its masked eval."""
    shape = (4, 2)
    hp = dict(HP, mesh_shape=shape)
    out = {"mgd": step_spec(dict(hp, distillation_type="mgd", mgd_alpha=0.5), DRY_STUDENT,
                            DRY_TEACHER, shape, rng, 3, aux_tree=_aux("mgd", 13), batch=B)}
    k_loss = jax.random.split(jax.random.fold_in(KEY, 0), 5)[2]
    out["mgd"]["noise"] = torch.from_numpy(np.array(jax.random.uniform(k_loss, (B, N_PATCHES))))
    out["soft_accum"] = step_spec(dict(hp, mixup=0.0, cutmix=0.0, grad_accum_steps=2),
                                  dict(DRY_STUDENT, distilled=True), DRY_TEACHER, shape, rng, 5,
                                  targets=False, batch=B)
    out["wasskd_sinkhorn"] = step_spec(
        dict(hp, distillation_type="wasskd", wasskd_type="sinkhorn", sinkhorn_iters=8),
        DRY_STUDENT, DRY_TEACHER, shape, rng, 7, aux_tree=_aux("wasskd", 14), batch=B)
    for t in out.values():
        t["eval"] = True
    return out


def _mixup(rng, seed):
    """Each mode's global batch and the draws JAX makes from key ``seed``."""
    images = torch.from_numpy(rng.randn(B, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, C, B))
    out = {}
    for mode in MODES:
        d = jax_draws.mixup_draws(jax.random.PRNGKey(seed), B, 32, 32,
                                  JMixupConfig(num_classes=C, mode=mode))
        out[mode] = (images, labels, tuple(vars(d).values()), dict(num_classes=C, mode=mode))
    return out, seed


def _meshes(rng):
    fused = step_spec(dict(HP, mesh_shape=(8, 1), mixup=0.0, cutmix=0.0, grad_accum_steps=2),
                      dict(DRY_STUDENT, distilled=True), DRY_TEACHER, (8, 1), rng, 9,
                      targets=False, batch=B)
    fused["fused"] = True
    mixup_42, key_42 = _mixup(rng, 5)
    mixup_81, key_81 = _mixup(rng, 6)
    return {
        (4, 2): {"steps": _dry_steps(rng), "mixup": mixup_42, "mixup_key": key_42},
        (8, 1): {"steps": {"fused_soft_accum": fused}, "mixup": mixup_81, "mixup_key": key_81},
        (2, 4): {"steps": {"soft": step_spec(dict(HP, mesh_shape=(2, 4)),
                                             STUDENTS["soft_4_heads"], TEACHER, (2, 4), rng,
                                             11, batch=B)}},
        (1, 8): {"steps": {"soft": step_spec(dict(HP, mesh_shape=(1, 8)),
                                             STUDENTS["soft_4_heads"], TEACHER, (1, 8), rng,
                                             15, batch=B)}},
    }


def _jax_mixup(mesh, spec, seed):
    """JAX's ``apply_mixup`` of each mode's global batch on ``mesh``."""
    shard = jmesh.batch_sharding(mesh)
    out = {}
    for mode, (images, labels, _, kw) in spec.items():
        jmc = JMixupConfig(**kw)
        out[mode] = jax.device_get(jax.jit(
            lambda k, x, y, jmc=jmc: japply_mixup(k, x, y, jmc))(
                jax.random.PRNGKey(seed), jax.device_put(images.numpy(), shard),
                jax.device_put(labels.numpy(), shard)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eight")
    rng = np.random.RandomState(2)
    meshes = _meshes(rng)
    spec = {"meshes": meshes, "tmp": str(tmp), "run_meshes": RUN_MESHES}
    script = subprocess.Popen(
        [sys.executable, os.path.join("scripts", "dryrun_multichip.py"), "8", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def jax_side():
        ref = {}
        for shape, s in meshes.items():
            mesh = jmesh.make_mesh(shape, devices=jax.devices()[:WORLD])
            ref[shape] = {name: jax_step(t, mesh) for name, t in s["steps"].items()}
            if s.get("mixup"):
                ref[shape]["mixup"] = _jax_mixup(mesh, s["mixup"], s["mixup_key"])
        return ref

    try:
        got, ref = launch(spec, WORLD, tmp, jax_side)
        script_out = script.communicate(timeout=600)[0]
    finally:
        if script.poll() is None:
            script.kill()
    return got, ref, spec, (script.returncode, script_out)


def _at(got, shape):
    return [g[shape] for g in got]


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4), (1, 8)])
def test_ranks_lay_out_each_mesh_row_major(ranks, shape):
    got, _, _, _ = ranks
    M = shape[1]
    assert [g["mesh"] for g in _at(got, shape)] == [(shape, r // M, r % M)
                                                     for r in range(WORLD)]


@pytest.mark.parametrize("name", DRY_CASES)
def test_dry_run_case_at_4_2_matches_the_jax_mesh(ranks, name):
    got, ref, _, _ = ranks
    check_step(_at(got, (4, 2)), ref[(4, 2)][name], name)
    assert ref[(4, 2)][name][0]["distill_loss"] > 0


@pytest.mark.parametrize("name", DRY_CASES)
def test_masked_eval_at_4_2_matches_jax(ranks, name):
    """The data ranks' eval sums (model rank 0 of each row; its partner the
    same bits) against JAX's ``build_eval_step`` on the (4, 2) mesh after the
    step: the count is the batch less 3, the loss sum to 1e-5, the top-1 and
    top-5 counts exact."""
    got, ref, spec, _ = ranks
    ranks_42 = _at(got, (4, 2))
    jm = ref[(4, 2)][name][0]
    n = spec["meshes"][(4, 2)]["steps"][name]["u8"].shape[0]
    for a, b in zip(ranks_42[::2], ranks_42[1::2]):
        assert a[name]["eval"] == b[name]["eval"]
    sums = {k: sum(g[name]["eval"][k] for g in ranks_42[::2]) for k in ranks_42[0][name]["eval"]}
    assert sums["count"] == jm["eval_count"] == n - 3
    np.testing.assert_allclose(sums["loss_sum"], jm["eval_loss_sum"], rtol=1e-5)
    assert np.isfinite(sums["loss_sum"])
    for k in ("correct1", "correct5"):
        assert sums[k] == jm[f"eval_{k}"], k


@pytest.mark.parametrize("name", DRY_CASES)
def test_ranks_hold_the_same_replicated_tensors_at_4_2(ranks, name):
    got, _, _, _ = ranks
    check_replicas(_at(got, (4, 2)), name, 2)


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
@pytest.mark.parametrize("mode", MODES)
def test_mixup_over_the_data_group_matches_jax(ranks, mode, shape):
    """Each rank's rows of the mixed batch against JAX's ``apply_mixup`` of
    the global batch: a data group of 4 (model ranks of a row the same rows)
    and of 8, where 'pair' swaps rank r's rows with rank 7 - r's."""
    got, ref, _, _ = ranks
    want_images, want_targets = ref[shape]["mixup"][mode]
    b = B // shape[0]
    for g in _at(got, shape):
        d = g["mesh"][1]
        images, targets = g["mixup"][mode]
        np.testing.assert_allclose(images.numpy(), want_images[d * b:(d + 1) * b], atol=1e-5)
        np.testing.assert_allclose(targets.numpy(), want_targets[d * b:(d + 1) * b],
                                   atol=1e-6)


def test_fused_step_at_8_1_matches_the_interpreted_pallas_block(ranks):
    """The dry run's fused case: the soft step with two accumulated
    micro-batches on the fused block, each data rank on its rows, against the
    JAX step on the Pallas fused block in interpret mode over (8, 1); every
    rank the same bits."""
    got, ref, _, _ = ranks
    ranks_81 = _at(got, (8, 1))
    check_step(ranks_81, ref[(8, 1)]["fused_soft_accum"], "fused_soft_accum")
    check_replicas(ranks_81, "fused_soft_accum", 1)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_soft_step_at_a_model_axis_of_4_and_8_matches_the_jax_mesh(ranks, shape):
    got, ref, _, _ = ranks
    check_step(_at(got, shape), ref[shape]["soft"], "soft")
    check_replicas(_at(got, shape), "soft", shape[1])


def test_run_at_4_2_matches_run_at_8_1(ranks):
    """run() for one epoch in its first warmup epoch at global batch 32:
    (4, 2) at 8 a data rank against (8, 1) at 4, as the JAX package's
    integration test runs them; every rank reads the same; data rank 0's
    model ranks gather the checkpoint and global rank 0 alone writes."""
    got, _, _, _ = ranks
    runs = [g["run"] for g in got]
    for shape, _ in RUN_MESHES:
        assert all(r[shape] == runs[0][shape] for r in runs), shape
    tp, dp = runs[0]["4 2"], runs[0]["8 1"]
    for k in ("val_loss", "val_acc1"):
        np.testing.assert_allclose(tp[k], dp[k], rtol=1e-4, err_msg=k)
    assert [r["4 2 saves"] for r in runs] == [[(1, True)], [(1, False)]] + [[]] * 6
    assert [r["8 1 saves"] for r in runs] == [[(1, True)]] + [[]] * 7


def test_dryrun_script_runs_eight_ranks_on_the_cpu(ranks):
    """``scripts/dryrun_multichip.py 8 --device cpu``: one line a case, in the
    JAX dry run's form."""
    rc, out = ranks[3]
    assert rc == 0, out
    lines = [line for line in out.splitlines() if line.startswith("dryrun_multichip(8)")]
    assert [line.split(" type=")[1].split()[0] for line in lines] == [
        "mgd", "soft", "wasskd", "soft"], out
    assert all(line.endswith("OK") for line in lines)
    assert lines[-1].startswith("dryrun_multichip(8): mesh=(8, 1)") and "FUSED" in lines[-1]
    assert all("mesh=(4, 2)" in line and "eval_count=" in line for line in lines[:3])
