"""The port learns a task: the counterpart of ``tests/test_learning.py``
``test_pipeline_learns_texture_task``. The same 4-class texture data
(h-stripes / v-stripes / checkerboard / solid, crop- and flip-invariant), the
same 32 px ViT (patch 4, D = 48, 4 heads, depth 4), fp32, no KD, lr 2e-3, no
warmup, no erasing, mixup or aa; 200 steps at B = 32 through the port's
``create_model`` / ``build_train_step`` / ``build_eval_step``, then held-out
top-1 on 128 images above the JAX test's bar of 50% (chance 25%). The port
starts from the JAX test's own initial weights (``PRNGKey(1)``, carried
across by ``flax_to_torch``), so that both start from the same point.

One case per block route: the fused block, block pairs and the unfused path
(``flash_attention``; the eval view adds ``fused_mlp``). On the CPU each runs
its kernels' plain versions, the functions the card's kernels are held
against. A step-by-step parity test cannot see a gradient that is biased
but inside its tolerance; over 200 steps such a bias would compound.

    python -m tests.test_torch_learning

prints the JAX test's own held-out reading and the port's on each route
from the same start.

    python -m tests.test_torch_learning --deit-tiny-224 PATH

writes the initial weights of the JAX package's 224 px test
(``test_fused_stack_learns_texture_task_224_tpu``: DeiT-Tiny, 4 classes,
``init_params`` with ``PRNGKey(1)``) as a port state dict to ``PATH``, for
``scripts/learning_schedules.py --weights``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.models.vit import ViTConfig as JaxViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.kd.losses import KDSettings
from deltakd_tpu_torch.models import registry
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.factory import create_model
from deltakd_tpu_torch.models.vit import ViTConfig
from deltakd_tpu_torch.ops.attention import flash_attention
from deltakd_tpu_torch.ops.fused_block import fused_vit_block, fused_vit_block_pair
from deltakd_tpu_torch.ops.fused_mlp import fused_mlp
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_eval_step, build_train_step
from tests.test_learning import IMG, _make_data

torch.set_num_threads(1)

B, STEPS, N_TRAIN, N_TEST = 32, 200, 512, 128
MODEL = "texture_vit_patch4_32"
WIDTHS = dict(img_size=IMG, patch_size=4, embed_dim=48, depth=4, num_heads=4)

# route -> (create_model's block options, the eval view's overrides)
ROUTES = {
    "fused": (dict(block_fn=fused_vit_block), {}),
    "pairs": (dict(block_fn=fused_vit_block, block_pair_fn=fused_vit_block_pair),
              dict(block_pair_fn=None)),
    "unfused": (dict(block_fn=None, attention_fn=flash_attention), dict(mlp_fn=fused_mlp)),
}


def jax_initial_weights():
    """The JAX test's student weights before its first step, as a port state
    dict."""
    student = JaxVisionTransformer(JaxViTConfig(**WIDTHS, num_classes=4), dtype=jnp.float32)
    params = student.init({"params": jax.random.PRNGKey(1)},
                          jnp.zeros((1, IMG, IMG, 3)))["params"]
    return flax_to_torch(params)


def port_reading(route, weights):
    """The port's held-out top-1 (%) on ``route`` after STEPS steps from
    ``weights``, and its last train loss."""
    cfg = TrainConfig(batch_size=B, distillation_type="none", dataset="cifar-100",
                      input_size=IMG, dtype="float32", drop_path_rate=0.0, epochs=100,
                      lr=2e-3, warmup_epochs=0, reprob=0.0, mixup=0.0, cutmix=0.0, aa="")
    blocks, eval_view = ROUTES[route]
    student = create_model(MODEL, num_classes=4, img_size=IMG, dtype=torch.float32,
                           collect_features=False, seed=1, device="cpu", **blocks)
    student.load_state_dict(weights)
    aug = AugmentConfig.from_config(cfg)
    tx = make_optimizer(cfg, trainable_parameters(student), 1000)
    state = TrainState(student, tx=tx)
    step = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=student,
                            teacher=None, aug=aug, mixup=None, tx=tx)
    eval_step = build_eval_step(student=student.view(collect_features=False, **eval_view),
                                aug=aug)

    train_imgs, train_labels = _make_data(N_TRAIN, 0)
    test_imgs, test_labels = _make_data(N_TEST, 1)
    gen = torch.Generator().manual_seed(4)
    for i in range(STEPS):
        idx = np.arange(i * B, i * B + B) % N_TRAIN
        m = step(state, torch.from_numpy(train_imgs[idx]),
                 torch.from_numpy(train_labels[idx]).long(), gen)
    loss = float(m["train_loss"])
    assert np.isfinite(loss)

    correct = count = 0.0
    for lo in range(0, N_TEST, B):
        out = eval_step(torch.from_numpy(test_imgs[lo:lo + B]),
                        torch.from_numpy(test_labels[lo:lo + B]).long(), B)
        correct += float(out["correct1"])
        count += float(out["count"])
    return correct / count * 100, loss


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_port_learns_texture_task(route, monkeypatch):
    monkeypatch.setitem(registry.MODEL_REGISTRY, MODEL, ViTConfig(**WIDTHS))
    acc, loss = port_reading(route, jax_initial_weights())
    print(f"[{route}] held-out top-1 {acc:.1f}% after {STEPS} steps, last train loss "
          f"{loss:.4f}")
    assert acc > 50.0, f"{route}: held-out acc {acc:.1f}% (chance 25%): the port does not learn"


def jax_reading():
    """The held-out top-1 (%) that ``test_pipeline_learns_texture_task``
    itself reaches: the test run as it is, its eval step's sums recorded."""
    import tests.test_learning as tl

    outs, real = [], tl.build_eval_step

    def recording(**kw):
        eval_step = real(**kw)

        def step(*args):
            out = eval_step(*args)
            outs.append(out)
            return out
        return step

    tl.build_eval_step = recording
    try:
        tl.test_pipeline_learns_texture_task()
    finally:
        tl.build_eval_step = real
    return (sum(float(o["correct1"]) for o in outs) / sum(float(o["count"]) for o in outs)
            * 100)


def write_deit_tiny_224_weights(path):
    from deltakd_tpu.models import create_model as jax_create_model
    from deltakd_tpu.models import init_params

    student = jax_create_model("deit_tiny_patch16_224", num_classes=4, img_size=224,
                               dtype=jnp.bfloat16, collect_features=False)
    torch.save(flax_to_torch(init_params(student, jax.random.PRNGKey(1))), path)
    print(f"wrote the JAX 224 px test's initial DeiT-Tiny weights to {path}")


def main(argv):
    if "--deit-tiny-224" in argv:
        write_deit_tiny_224_weights(argv[argv.index("--deit-tiny-224") + 1])
        return 0
    registry.MODEL_REGISTRY[MODEL] = ViTConfig(**WIDTHS)
    print(f"JAX test_pipeline_learns_texture_task: held-out top-1 {jax_reading():.1f}%")
    weights = jax_initial_weights()
    for route in sorted(ROUTES):
        acc, loss = port_reading(route, weights)
        print(f"port {route}: held-out top-1 {acc:.1f}% after {STEPS} steps from the same "
              f"weights, last train loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
