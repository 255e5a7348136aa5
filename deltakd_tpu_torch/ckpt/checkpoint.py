"""Checkpoint, resume and finetune (``deltakd_tpu/ckpt/checkpoint.py``).

The reference's semantics (reference tools/utils.py:90-160,
tools/train.py:270-286, 349-357): a training checkpoint holds the epoch, the
parameters of student and aux heads, the optimizer state and the EMA, is
rewritten every epoch, and is copied to a ``.best`` sibling on a new best
validation accuracy; ``--resume`` restores everything, ``--finetune`` loads
the student's backbone only, dropping shape-mismatched heads and
interpolating the position embedding onto the new patch grid.

The layout is the JAX package's, written with ``torch.save`` instead of
orbax, and the same at every mesh shape (a tensor-parallel run gathers its
shards before it writes and cuts them from the full tensors when it
resumes): ``<save_dir>/state-<epoch>/state.pt`` holds the flat fp32 parameter
vector with its names and shapes, the optimizer's kind, count and buffers
(AdamW's and Adam's moments, SGD's trace) and its LR scale, the EMA, the step
count, the epoch and the best accuracy, all on the CPU. A checkpoint without
the optimizer's kind and scale (the first format) loads as AdamW with scale
1.0. Each save
writes a temporary directory and renames it when complete; the previous
epoch's directory stays until the next save, a same-epoch re-save parks the
old directory at ``.prev``, and ``meta.json`` (``format``, ``state_dir``)
points at the newest. So a crash at any point leaves a complete checkpoint.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from deltakd_tpu_torch.models.import_timm import load_state_dict, timm_to_torch
from deltakd_tpu_torch.models.pos_embed import interpolate_pos_embed
from deltakd_tpu_torch.models.vit import VisionTransformer
from deltakd_tpu_torch.parallel.tensor import full_state_dict, load_full_state_dict

_STATE_DIR = "state"
_STATE_FILE = "state.pt"
_BEST_SUFFIX = ".best"
_META = "meta.json"
_FORMAT = "torch-v1"
_PREV_SUFFIX = ".prev"    # a same-epoch re-save parks the old directory here
_TMP_SUFFIX = ".tmp"


def _committed_state_dirs(save_dir: str) -> List[str]:
    """Committed state dirs under save_dir, oldest to newest: ``state-<epoch>``
    and its ``.prev`` sibling, which sorts just below it. A directory is
    renamed to these names only once complete."""
    out = []
    if not os.path.isdir(save_dir):
        return out
    for name in os.listdir(save_dir):
        full = os.path.join(save_dir, name)
        if not os.path.isdir(full):
            continue
        prev = 1
        if name.endswith(_PREV_SUFFIX):
            name, prev = name[:-len(_PREV_SUFFIX)], 0
        if name.startswith(_STATE_DIR + "-"):
            tail = name[len(_STATE_DIR) + 1:]
            if tail.isdigit():
                out.append(((int(tail), prev), full))
    return [p for _, p in sorted(out)]


def _replace_dir(src: str, dst: str) -> None:
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    os.replace(src, dst)


def _write_json(path: str, obj) -> None:
    tmp = path + _TMP_SUFFIX
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _full_shapes(state) -> List[List[int]]:
    if state.shards is not None:
        return [list(s) for s in state.shards.full_shapes]
    return [list(p.shape) for _, p in state.named_params]


def _state_to_dict(state) -> Dict:
    """A TrainState as CPU tensors and Python values, in a one-rank run's
    layout: under tensor parallelism every flat vector is gathered over the
    model group (collective)."""
    opt = state.opt_state
    full = (lambda t: t) if state.shards is None else state.shards.gather   # noqa: E731
    return {
        "names": [n for n, _ in state.named_params],
        "shapes": _full_shapes(state),
        "params": full(state.params.detach()).cpu(),
        "opt": {"kind": opt.kind, "count": int(opt.count), "scale": opt.scale,
                **{b: full(getattr(opt, b).detach()).cpu() for b in opt.BUFFERS}},
        "ema": None if state.ema_params is None else full(state.ema_params.detach()).cpu(),
        "step": int(state.step),
    }


def save_checkpoint(save_dir: str, state, *, epoch: int, best_acc: float,
                    is_best: bool, write: bool = True) -> Optional[str]:
    """Write ``save_dir/state-<epoch>`` and ``meta.json``; copy both to
    ``save_dir.best`` on a new best (reference utils.py:90-93). Returns the
    state dir. Under tensor parallelism every model rank of the writer's
    data row calls it, since the shards are gathered first; those with
    ``write`` False only take part in the gather (and return None)."""
    tree = {"state": _state_to_dict(state),
            "meta": {"epoch": int(epoch), "best_acc": float(best_acc)}}
    if not write:
        return None
    save_dir = os.path.abspath(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{_STATE_DIR}-{epoch}")
    # drop superseded checkpoints but keep the newest committed one until
    # this save has committed
    committed = _committed_state_dirs(save_dir)
    keep = committed[-1] if committed else None
    for old in committed:
        if old != keep and old != path:
            shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(path):
        # a same-epoch re-save: ``path`` may be the only committed checkpoint,
        # so park it (an atomic rename) instead of deleting it
        _replace_dir(path, path + _PREV_SUFFIX)
    tmp = path + _TMP_SUFFIX
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, _STATE_FILE))
    os.replace(tmp, path)
    _write_json(os.path.join(save_dir, _META),
                {"epoch": int(epoch), "best_acc": float(best_acc), "format": _FORMAT,
                 "state_dir": os.path.basename(path)})
    if is_best:
        best_dir = save_dir + _BEST_SUFFIX
        tmp = best_dir + _TMP_SUFFIX
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shutil.copytree(path, os.path.join(tmp, os.path.basename(path)))
        shutil.copy2(os.path.join(save_dir, _META), os.path.join(tmp, _META))
        _replace_dir(tmp, best_dir)
    return path


def _resolve_state_dir(save_dir: str) -> str:
    """The newest committed state dir under save_dir: the one meta.json points
    at, else the newest by name; a state dir itself is taken as it is."""
    if os.path.isfile(os.path.join(save_dir, _STATE_FILE)):
        return save_dir
    try:
        with open(os.path.join(save_dir, _META)) as f:
            pointed = json.load(f).get("state_dir")
        if pointed and os.path.isdir(os.path.join(save_dir, pointed)):
            return os.path.join(save_dir, pointed)
    except (OSError, ValueError):
        pass
    committed = _committed_state_dirs(save_dir)
    if committed:
        return committed[-1]
    raise FileNotFoundError(f"Checkpoint not found: no state dir under {save_dir}")


def _read(save_dir: str) -> Dict:
    path = os.path.join(_resolve_state_dir(os.path.abspath(save_dir)), _STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def load_checkpoint(save_dir: str, state) -> Tuple[object, int, float]:
    """Restore a TrainState in place for --resume (reference
    train.py:274-280). Returns (state, next_epoch, best_acc); the state's
    parameter names and full shapes must be the checkpoint's. Under tensor
    parallelism each rank cuts its shards from the full tensors, so a
    checkpoint resumes at any mesh shape."""
    tree = _read(save_dir)
    saved = tree["state"]
    names = [n for n, _ in state.named_params]
    if saved["names"] != names or saved["shapes"] != _full_shapes(state):
        raise ValueError(f"{save_dir} holds another model's parameters")
    if (saved["ema"] is None) != (state.ema_params is None):
        raise ValueError(f"{save_dir}: the EMA does not match --ema-decay")
    opt, saved_opt = state.opt_state, saved["opt"]
    if saved_opt.get("kind", "adamw") != opt.kind:
        raise ValueError(f"{save_dir} holds the state of optimizer "
                         f"{saved_opt.get('kind', 'adamw')!r}, not {opt.kind!r}")
    cut = (lambda t: t) if state.shards is None else state.shards.cut   # noqa: E731
    state.params.copy_(cut(saved["params"]))
    opt.count = saved_opt["count"]
    for b in opt.BUFFERS:
        getattr(opt, b).copy_(cut(saved_opt[b]))
    if opt.scale is not None:
        saved_scale = saved_opt.get("scale")
        opt.scale = 1.0 if saved_scale is None else float(saved_scale)
    if state.ema_params is not None:
        state.ema_params.copy_(cut(saved["ema"]))
    state.step = saved["step"]
    return state, int(tree["meta"]["epoch"]), float(tree["meta"]["best_acc"])


def student_state_dict(save_dir: str, *, use_ema: bool = False
                       ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """The student's parameters of a checkpoint by their model names (the
    EMA's with ``use_ema``, where the checkpoint has one), and its meta
    (epoch, best_acc)."""
    tree = _read(save_dir)
    saved = tree["state"]
    flat = saved["ema"] if use_ema and saved["ema"] is not None else saved["params"]
    out, offset = {}, 0
    for name, shape in zip(saved["names"], saved["shapes"]):
        n = math.prod(shape)
        if name.startswith("student."):
            out[name[len("student."):]] = flat[offset:offset + n].view(shape)
        offset += n
    return out, tree["meta"]


def _merge_for_finetune(source: Mapping[str, torch.Tensor],
                        target: Mapping[str, torch.Tensor], num_prefix_tokens: int,
                        log=print) -> Dict[str, torch.Tensor]:
    """Copy the source's tensors whose names the target has; interpolate
    pos_embed onto the target's grid; drop what still differs in shape
    (reference tools/utils.py:112-160)."""
    out = {k: v.detach().clone() for k, v in target.items()}
    for k, v in source.items():
        if k not in out:
            continue
        tgt = out[k]
        if k == "pos_embed":
            v = interpolate_pos_embed(v, num_prefix_tokens,
                                      tgt.shape[1] - num_prefix_tokens)
        if tuple(v.shape) != tuple(tgt.shape):
            log(f"[finetune] dropping {k}: {tuple(v.shape)} vs {tuple(tgt.shape)}")
            continue
        out[k] = v.to(device=tgt.device, dtype=tgt.dtype)
    return out


@torch.no_grad()
def load_student_for_finetune(checkpoint: str, student, *, num_prefix_tokens: int,
                              log=print) -> Dict[str, torch.Tensor]:
    """Load a student backbone into ``student``'s parameters in place, from a
    checkpoint directory of this package or a torch/timm state_dict file.
    Returns the parameters by name after the load. A student sharded over a
    model axis loads into a full copy of itself on the CPU (its shards
    gathered, collective), which each rank then cuts."""
    if getattr(student, "tp", None) is not None:
        full = VisionTransformer(student.cfg, dtype=student.dtype)
        full.load_state_dict({k: v.cpu() for k, v in full_state_dict(student).items()})
        out = load_student_for_finetune(checkpoint, full,
                                        num_prefix_tokens=num_prefix_tokens, log=log)
        load_full_state_dict(student, out)
        return out
    if os.path.isdir(checkpoint):
        merged = _merge_for_finetune(student_state_dict(checkpoint)[0],
                                     dict(student.named_parameters()),
                                     num_prefix_tokens, log)
        for name, p in student.named_parameters():
            p.copy_(merged[name])
    else:
        report = timm_to_torch(load_state_dict(checkpoint), student)
        if report["skipped"]:
            log(f"[finetune] reinitialized (shape mismatch): {report['skipped']}")
    return {n: p.detach().clone() for n, p in student.named_parameters()}
