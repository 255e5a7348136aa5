"""Carries weights from the JAX package's Flax param tree to a timm-named
PyTorch state_dict: the inverse of ``timm_to_flax``
(``deltakd_tpu/models/import_timm.py``).

Dense kernels [in, out] become nn.Linear weights [out, in]; the patch-embed
conv kernel goes HWIO -> OIHW; LayerNorm ``scale`` becomes ``weight``; the
fused QKV keeps its (3, heads, head_dim) output packing. ``aux_flax_to_torch``
does the same for the aux-head tree of ``deltakd_tpu/kd/aux.py``, and
``flax_to_torch_shard`` cuts the ViT's state_dict to one model rank's
shards (the aux heads are replicated).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from deltakd_tpu_torch.parallel.tensor import shard_state_dict


def flax_block_to_torch(block: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One Flax Block subtree -> its parameters by timm name within the block
    (``norm1.weight``, ``attn.qkv.weight``, ...)."""
    sd: Dict[str, np.ndarray] = {}

    def linear(tree, name):
        sd[f"{name}.weight"] = np.asarray(tree["kernel"]).T
        if "bias" in tree:      # a model without a qkv bias has none
            sd[f"{name}.bias"] = np.asarray(tree["bias"])

    def layernorm(tree, name):
        sd[f"{name}.weight"] = np.asarray(tree["scale"])
        sd[f"{name}.bias"] = np.asarray(tree["bias"])

    layernorm(block["norm1"], "norm1")
    linear(block["attn"]["qkv"], "attn.qkv")
    linear(block["attn"]["proj"], "attn.proj")
    layernorm(block["norm2"], "norm2")
    linear(block["mlp"]["fc1"], "mlp.fc1")
    linear(block["mlp"]["fc2"], "mlp.fc2")
    return _tensors(sd)


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ViT params (nested dict of arrays) -> timm-named fp32 state_dict."""
    sd: Dict[str, Any] = {}
    for tok in ("cls_token", "dist_token", "pos_embed"):
        if tok in params:
            sd[tok] = np.asarray(params[tok])
    sd["patch_embed.proj.weight"] = np.asarray(
        params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = np.asarray(params["patch_embed"]["bias"])
    depth = len([k for k in params if k.startswith("blocks_")])
    for i in range(depth):
        for name, t in flax_block_to_torch(params[f"blocks_{i}"]).items():
            sd[f"blocks.{i}.{name}"] = t
    sd["norm.weight"] = np.asarray(params["norm"]["scale"])
    sd["norm.bias"] = np.asarray(params["norm"]["bias"])
    for head in ("head", "head_dist"):
        if head in params:
            sd[f"{head}.weight"] = np.asarray(params[head]["kernel"]).T
            sd[f"{head}.bias"] = np.asarray(params[head]["bias"])
    return _tensors({k: np.asarray(v) for k, v in sd.items()})


def aux_flax_to_torch(aux_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX aux-head tree (nested dicts and lists of arrays) -> the fp32
    state_dict of ``kd.aux.AuxHeads``: a dense ``kernel`` [in, out] becomes
    ``weight`` [out, in], a conv ``kernel`` HWIO becomes OIHW, ``mask_token``
    stays as it is; nested dicts name submodules (``denoise.time1``,
    ``saliency_attn.qk``, ``generation.conv2``) and list entries are named by
    their index (``curkd_align_mid.3``)."""
    sd: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        if isinstance(tree, (list, tuple)):
            for i, sub in enumerate(tree):
                walk(sub, f"{prefix}{i}.")
        elif isinstance(tree, Mapping) and "kernel" in tree:
            kernel = np.asarray(tree["kernel"])
            sd[f"{prefix}weight"] = (kernel.T if kernel.ndim == 2
                                     else kernel.transpose(3, 2, 0, 1))
            sd[f"{prefix}bias"] = np.asarray(tree["bias"])
        elif isinstance(tree, Mapping):
            for k, sub in tree.items():
                walk(sub, f"{prefix}{k}.")
        else:
            sd[prefix[:-1]] = np.asarray(tree)

    walk(aux_params, "")
    return _tensors(sd)


def flax_to_torch_shard(params: Mapping[str, Any], num_heads: int, size: int,
                        rank: int) -> Dict[str, torch.Tensor]:
    """``flax_to_torch`` cut to model rank ``rank``'s shards over a model axis
    of ``size`` (``parallel.tensor.shard_state_dict``): what a
    ``VisionTransformer(..., tp=...)`` of that rank loads."""
    return shard_state_dict(flax_to_torch(params), num_heads, size, rank)
