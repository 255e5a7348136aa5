"""The port's tensor parallelism on the CPU at mesh (2, 2): four gloo
processes (``tests/torch_tp_worker.py``), data rank ``r // 2`` and model rank
``r % 2``, against the JAX step on ``make_mesh((2, 2),
devices=jax.devices()[:4])`` (the cases of the JAX package's multi-chip dry
run, ``__graft_entry__.py``: depth 3, 4 heads), with the bounds of
``tests/test_torch_tensor_parallel.py``:

- mgd (the masking noise of the JAX step's loss key pinned), soft with
  ``grad_accum_steps=2`` and wasskd-sinkhorn with 8 iterations; the
  replicated tensors the same bits on the model ranks of a data row, each
  model column's ranks the same bits;
- mixup in 'batch', 'elem' and 'pair' mode over the data group, each data
  rank's rows against JAX's ``apply_mixup`` of the global batch;
- ``run()`` at (2, 2) against ``run()`` at (2, 1) at the same per-data-rank
  batch (the counterpart of ``tests/test_integration.py:53-69``):
  ``val_loss`` and ``val_acc1`` to rtol 1e-4; global rank 0 alone writes;
  the checkpoint holds the full tensors, a (2, 2) checkpoint resumes at
  (2, 1) and a (2, 1) one at (2, 2); a finetune at (2, 2) as at (2, 1); the
  eval CLI on the replicated student.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.data.mixup import apply_mixup as japply_mixup
from deltakd_tpu.kd.aux import init_aux_params
from deltakd_tpu.parallel import mesh as jmesh
from tests import jax_draws
from tests.test_torch_tensor_parallel import (BASE, BG, C, HP, KEY, check_replicas, check_step,
                                              free_port, jax_step, launch, random_tree,
                                              step_spec)

torch.set_num_threads(1)

MESH = (2, 2)
STUDENT = dict(BASE, depth=3, embed_dim=32, num_heads=4, distilled=False)
TEACHER = dict(BASE, depth=3, embed_dim=64, num_heads=4)
MODES = ("batch", "elem", "pair")
N_PATCHES = (32 // 8) ** 2


def _aux(kd_type, seed):
    """Aux-head parameters of JAX's tree, random from ``seed``."""
    return random_tree(jax.eval_shape(lambda: init_aux_params(KEY, kd_type, 32, 64)), seed)


def _steps(rng):
    hp = dict(HP, mesh_shape=MESH)
    out = {}
    aux = _aux("mgd", 13)
    out["mgd"] = step_spec(dict(hp, distillation_type="mgd", mgd_alpha=0.5), STUDENT,
                           TEACHER, MESH, rng, 3, aux_tree=aux)
    k_loss = jax.random.split(jax.random.fold_in(KEY, 0), 5)[2]
    out["mgd"]["noise"] = torch.from_numpy(np.array(jax.random.uniform(k_loss,
                                                                       (BG, N_PATCHES))))
    out["soft_accum"] = step_spec(dict(hp, mixup=0.0, cutmix=0.0, grad_accum_steps=2),
                                  dict(STUDENT, distilled=True), TEACHER, MESH, rng, 5,
                                  targets=False)
    out["wasskd_sinkhorn"] = step_spec(
        dict(hp, distillation_type="wasskd", wasskd_type="sinkhorn", sinkhorn_iters=8),
        STUDENT, TEACHER, MESH, rng, 7,
        aux_tree=_aux("wasskd", 14))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp22")
    rng = np.random.RandomState(1)
    spec = {"mesh_shape": MESH, "tmp": str(tmp), "steps": _steps(rng), "run": True,
            "run_ports": (free_port(), free_port()), "mixup": {}}
    images = torch.from_numpy(rng.randn(BG, 32, 32, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, C, BG))
    for mode in MODES:
        d = jax_draws.mixup_draws(jax.random.PRNGKey(5), BG, 32, 32,
                                  JMixupConfig(num_classes=C, mode=mode))
        spec["mixup"][mode] = (images, labels, tuple(vars(d).values()),
                               dict(num_classes=C, mode=mode))
    mesh = jmesh.make_mesh(MESH, devices=jax.devices()[:4])

    def jax_side():
        ref = {name: jax_step(t, mesh) for name, t in spec["steps"].items()}
        shard = jmesh.batch_sharding(mesh)
        for mode in MODES:
            jmc = JMixupConfig(num_classes=C, mode=mode)
            ref[mode] = jax.device_get(jax.jit(
                lambda k, x, y, jmc=jmc: japply_mixup(k, x, y, jmc))(
                    jax.random.PRNGKey(5), jax.device_put(images.numpy(), shard),
                    jax.device_put(labels.numpy(), shard)))
        return ref

    got, ref = launch(spec, 4, tmp, jax_side)
    return got, ref, spec


@pytest.mark.parametrize("name", ["mgd", "soft_accum", "wasskd_sinkhorn"])
def test_step_matches_the_jax_mesh(ranks, name):
    got, ref, _ = ranks
    assert [g["mesh"][1:] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    check_step(got, ref[name], name)
    assert ref[name][0]["distill_loss"] > 0


@pytest.mark.parametrize("name", ["mgd", "soft_accum", "wasskd_sinkhorn"])
def test_ranks_hold_the_same_replicated_tensors(ranks, name):
    got, _, _ = ranks
    check_replicas(got, name, 2)


@pytest.mark.parametrize("mode", MODES)
def test_mixup_over_the_data_group_matches_jax(ranks, mode):
    got, ref, _ = ranks
    want_images, want_targets = ref[mode]
    b = BG // MESH[0]
    for g in got:
        d = g["mesh"][1]
        images, targets = g["mixup"][mode]
        np.testing.assert_allclose(images.numpy(), want_images[d * b:(d + 1) * b], atol=1e-5)
        np.testing.assert_allclose(targets.numpy(), want_targets[d * b:(d + 1) * b],
                                   atol=1e-6)
    assert not any(g["subset_ops"] for g in got)


def test_run_at_2_2_matches_run_at_2_1(ranks):
    """The same per-data-rank batch and draws: the tensor-parallel run's
    validation is the data-parallel run's; every rank reads the same."""
    got, _, _ = ranks
    runs = [g["run"] for g in got]
    for key in ("tp_straight", "tp_finetune", "tp_resumed"):
        assert all(r[key] == runs[0][key] for r in runs), key
    tp, dp = runs[0]["tp_straight"], runs[0]["dp_straight"]
    for k in ("val_loss", "val_acc1"):
        np.testing.assert_allclose(tp[k], dp[k], rtol=1e-4, err_msg=k)
    assert runs[0]["dp_straight"] == runs[1]["dp_straight"]


def test_rank0_alone_writes_the_full_checkpoint(ranks):
    """Data row 0 gathers (both its model ranks call the save), global rank 0
    alone writes; the file holds the full names and shapes of a one-rank
    run, the (2, 1) run's, each tensor within 1e-5 of it after two epochs."""
    got, _, spec = ranks
    saves = [g["run"]["tp_saves"] for g in got]
    assert saves[0] == [(1, True), (2, True)]
    assert saves[1] == [(1, False), (2, False)]
    assert saves[2] == saves[3] == []
    tp, dp = (torch.load(os.path.join(spec["tmp"], d, "checkpoint", "state-2", "state.pt"),
                         weights_only=True)["state"] for d in ("tp_straight", "dp_straight"))
    assert tp["names"] == dp["names"] and tp["shapes"] == dp["shapes"]
    for k in ("params", "ema"):
        np.testing.assert_allclose(tp[k].numpy(), dp[k].numpy(), atol=1e-5, err_msg=k)
    for k in ("mu", "nu"):
        np.testing.assert_allclose(tp["opt"][k].numpy(), dp["opt"][k].numpy(), atol=1e-5,
                                   err_msg=k)
    assert tp["step"] == dp["step"] == 4


def test_checkpoints_resume_across_mesh_shapes(ranks):
    """The (2, 2) run's epoch-1 checkpoint resumed to a second epoch at
    (2, 1), and the (2, 1) run's at (2, 2): each as the straight runs, to
    rtol 1e-4."""
    got, _, _ = ranks
    run = got[0]["run"]
    for resumed in ("dp_resumed", "tp_resumed"):
        for k in ("val_loss", "val_acc1"):
            np.testing.assert_allclose(run[resumed][k], run["dp_straight"][k], rtol=1e-4,
                                       err_msg=(resumed, k))


def test_finetune_loads_into_the_shards(ranks):
    """--finetune from the (2, 2) run's checkpoint: the sharded student loads
    the backbone through a full copy, each rank cuts its shards; one epoch
    then validates as the same finetune at (2, 1)."""
    got, _, _ = ranks
    run = got[0]["run"]
    assert all(g["run"]["tp_finetune"] == run["tp_finetune"] for g in got)
    for k in ("val_loss", "val_acc1"):
        np.testing.assert_allclose(run["tp_finetune"][k], run["dp_finetune"][k], rtol=1e-4,
                                   err_msg=k)


def test_eval_cli_on_the_replicated_student(ranks):
    got, _, _ = ranks
    evals = [g["run"]["eval"] for g in got]
    assert all(e == evals[0] for e in evals)
    straight = got[0]["run"]["tp_straight"]
    np.testing.assert_allclose(evals[0]["test_loss"], straight["val_loss"], rtol=1e-5)
    assert evals[0]["test_acc1"] == straight["val_acc1"]
