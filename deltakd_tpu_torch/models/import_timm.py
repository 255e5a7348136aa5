"""timm/DeiT checkpoint import (``deltakd_tpu/models/import_timm.py``): a
locally stored state_dict into the port's ``VisionTransformer``, whose
parameters already carry timm's names and layouts.

The semantics are those of the JAX package's ``timm_to_flax``, as timm loads
a pretrained model: a parameter whose shape differs from the file's (a
classifier head for another class count) keeps its fresh initialisation and
is reported as skipped; the position embedding is interpolated bicubically
onto the target grid, after its prefix is aligned when the file and the model
differ in a distillation token; keys the import does not read are reported as
unconsumed. Values are copied into the parameters, never shared with the
file's tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from deltakd_tpu_torch.models.pos_embed import interpolate_pos_embed

_KNOWN_PREFIXES = ("cls_token", "dist_token", "pos_embed", "patch_embed", "blocks.",
                   "norm.", "head", "pre_logits")


def _to_tensor(v: Any):
    """A CPU tensor; a value that is no number (a string beside the weights)
    stays a numpy array, and the import leaves it unconsumed."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    a = np.asarray(v)
    return torch.from_numpy(a) if a.dtype.kind in "biuf" else a


def strip_module_prefix(key: str) -> str:
    """DDP checkpoints prefix every key with 'module.'."""
    return key[7:] if key.startswith("module.") else key


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file into a flat name -> CPU tensor dict: ``.npz`` and
    ``.npy`` (a pickled dict) through numpy; anything else through
    ``torch.load`` on the CPU, unwrapping a 'model', 'state_dict' or
    'model_ema' entry (DeiT files hold other, non-tensor entries beside it)."""
    if path.endswith((".npz", ".npy")):
        data = np.load(path, allow_pickle=True)
        if hasattr(data, "files"):
            return {k: _to_tensor(data[k]) for k in data.files}
        return {k: _to_tensor(v) for k, v in data.item().items()}
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("model", "state_dict", "model_ema"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    return {strip_module_prefix(k): _to_tensor(v) for k, v in ckpt.items()}


@torch.no_grad()
def timm_to_torch(state: Mapping[str, Any], model) -> Dict[str, List[str]]:
    """Copy a timm state_dict into ``model``'s parameters. Returns the report
    {'loaded': [...], 'skipped': [...], 'unconsumed': [...]} by parameter
    name."""
    state = {strip_module_prefix(k): _to_tensor(v) for k, v in state.items()}
    params = dict(model.named_parameters())
    loaded, skipped = [], []

    def put(name, value):
        p = params[name]
        if tuple(p.shape) != tuple(value.shape):
            skipped.append(name)
            return
        p.copy_(value.to(p.dtype))
        loaded.append(name)

    if "cls_token" in state:
        put("cls_token", state["cls_token"])
    if "dist_token" in state and "dist_token" in params:
        put("dist_token", state["dist_token"])
    if "pos_embed" in state:
        src = state["pos_embed"].float()
        src_prefix = 2 if "dist_token" in state else 1
        tgt_prefix = 2 if "dist_token" in params else 1
        if src_prefix != tgt_prefix:
            # keep the CLS slot: duplicate it for a new DIST slot, or drop DIST
            src = torch.cat([src[:, :1]] * tgt_prefix + [src[:, src_prefix:]], dim=1)
        put("pos_embed", interpolate_pos_embed(
            src, tgt_prefix, params["pos_embed"].shape[1] - tgt_prefix))
    if "patch_embed.proj.weight" in state:
        put("patch_embed.proj.weight", state["patch_embed.proj.weight"])
        put("patch_embed.proj.bias", state["patch_embed.proj.bias"])

    def linear(prefix):
        if prefix + ".weight" not in state:
            return
        put(prefix + ".weight", state[prefix + ".weight"])
        if prefix + ".bias" in state:
            put(prefix + ".bias", state[prefix + ".bias"])

    def layernorm(prefix):
        if prefix + ".weight" in state:
            put(prefix + ".weight", state[prefix + ".weight"])
            put(prefix + ".bias", state[prefix + ".bias"])

    for i in range(len(model.blocks)):
        layernorm(f"blocks.{i}.norm1")
        linear(f"blocks.{i}.attn.qkv")
        linear(f"blocks.{i}.attn.proj")
        layernorm(f"blocks.{i}.norm2")
        linear(f"blocks.{i}.mlp.fc1")
        linear(f"blocks.{i}.mlp.fc2")
    layernorm("norm")
    linear("head")
    if "head_dist.weight" in params:
        linear("head_dist")
    unconsumed = sorted(k for k in state if not k.startswith(_KNOWN_PREFIXES))
    return {"loaded": loaded, "skipped": skipped, "unconsumed": unconsumed}
