#!/usr/bin/env python3
"""Whether the fused block's bf16 kernels bias the gradient that
chip_smoke.py phase 16a trains on, on one NVIDIA GPU.

    python3 scripts/gradient_fidelity.py [--seeds 1,2] [--probe 0,10,20,40,60,80,99]

For each seed: phase 16a's fused bf16 route (DeiT-Tiny, the texture task,
B = 128) trains at the JAX TPU test's constant 2e-3, and before each probed
step that step's batch, drawn once through the train transform, gives
three gradients of the cross entropy of the model's logits on the same
weights: the block's kernels (bf16), the kernels' plain versions (the same
bf16 math in PyTorch on the card) and the model's own PyTorch ops in fp32
with TF32 off (the reference). Printed per step: the relative error of each
bf16 gradient against the reference over all parameters, the largest over
the twelve blocks, the cosine with the reference, and how far the kernels'
gradient moves along the reference from the plain version's (a bias would
show there; rounding noise does not add up along one direction).
"""

import os
import subprocess
import sys

import torch
import torch.nn.functional as F

DEVICE = "cuda"


def _option(argv, flag, default):
    return argv[argv.index(flag) + 1] if flag in argv else default


def _grads(model, images, labels):
    model.zero_grad(set_to_none=True)
    out = model(images.to(model.dtype), train=True)
    F.cross_entropy(out.logits.float(), labels).backward()
    return {n: p.grad.float().clone() for n, p in model.named_parameters()}


def _flat(g, names):
    return torch.cat([g[n].reshape(-1) for n in names])


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gradient_fidelity: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "scripts"))
    import chip_smoke as cs
    from learning_schedules import _plain_block
    from deltakd_tpu_torch.data.augment import AugmentConfig, train_transform
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import create_model
    from deltakd_tpu_torch.ops import _build
    from deltakd_tpu_torch.ops import fused_block as fb
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    seeds = [int(s) for s in _option(argv, "--seeds", "1,2").split(",")]
    probe = {int(s) for s in _option(argv, "--probe", "0,10,20,40,60,80,99").split(",")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(["fused_block_fwd", "fused_block_bwd"])
    batches, _ = cs.learn_data(DEVICE)
    model = lambda **kw: create_model("deit_tiny_patch16_224", num_classes=4,  # noqa: E731
                                      img_size=cs.LEARN_SIZE, collect_features=False,
                                      device=DEVICE, **kw)
    reference = model(dtype=torch.float32, block_fn=None)
    for seed in seeds:
        cfg = cs._learn_config("bfloat16", cs.LEARN_STEPS, **cs.LEARN_CONSTANT)
        student = model(dtype=torch.bfloat16, block_fn=fb.fused_vit_block, seed=1 + seed)
        aug = AugmentConfig.from_config(cfg)
        tx = make_optimizer(cfg, trainable_parameters(student), 1)
        state = TrainState(student, tx=tx)
        step = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=student,
                                teacher=None, aug=aug, mixup=None, tx=tx)
        gen = torch.Generator(device=DEVICE).manual_seed(3 + seed)
        names = [n for n, _ in student.named_parameters()]
        blocks = sorted({n.split(".")[1] for n in names if n.startswith("blocks.")}, key=int)
        for i in range(max(probe) + 1):
            images, labels = batches[i % len(batches)]
            if i in probe:
                x = train_transform(torch.Generator(device=DEVICE).manual_seed(1000 + i),
                                    images, aug)
                kernel = _grads(student, x, labels)
                with _plain_block(cs, fb):
                    plain = _grads(student, x, labels)
                reference.load_state_dict(student.state_dict())
                ref = _grads(reference, x, labels)
                student.zero_grad(set_to_none=True)
                k, p, r = (_flat(g, names) for g in (kernel, plain, ref))
                per_block = [[_flat(g, [n for n in names if n.startswith(f"blocks.{b}.")])
                              for g in (kernel, plain, ref)] for b in blocks]
                along = float(torch.dot(k - p, r) / r.norm() ** 2)
                print(f"[fidelity] seed {seed} step {i} ({smi}): relative error against fp32 "
                      f"kernels {_rel(k, r):.5f}, plain bf16 {_rel(p, r):.5f}, kernels "
                      f"against plain {_rel(k, p):.5f}; largest over the blocks kernels "
                      f"{max(_rel(bk, br) for bk, _, br in per_block):.5f}, plain "
                      f"{max(_rel(bp, br) for _, bp, br in per_block):.5f}; cosine with fp32 "
                      f"kernels {float(F.cosine_similarity(k, r, 0)):.6f}, plain "
                      f"{float(F.cosine_similarity(p, r, 0)):.6f}; kernels minus plain along "
                      f"fp32 {along:+.2e} of it; gradient norm {float(r.norm()):.4g}",
                      flush=True)
            m = step(state, images, labels, gen)
            if i + 1 in (25, 50, 75, 100):
                print(f"[fidelity] seed {seed} after step {i + 1}: train top-1 "
                      f"{float(m['train_acc1']):.1f}%, loss {float(m['train_loss']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
