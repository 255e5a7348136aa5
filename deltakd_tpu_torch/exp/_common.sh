#!/bin/bash
# Shared recipe preamble for the TPU-native CLI (no torchrun: one process
# drives the whole jax.sharding.Mesh; pass the data-axis size as $1 to
# override the default of "all devices").
#
# Env overrides:
#   DATA_PATH     dataset root                (default: dataset)
#   TEACHER_CKPT  local timm/torch state_dict for the pretrained teacher
#                 (replaces the reference's timm-hub download)
#   EXTRA_FLAGS   appended verbatim

DATA_PATH=${DATA_PATH:-dataset}
MESH_FLAGS=""
if [[ -n "$1" ]]; then MESH_FLAGS="--mesh-shape $1"; fi
TEACHER_FLAGS=""
if [[ -n "$TEACHER_CKPT" ]]; then TEACHER_FLAGS="--teacher-checkpoint $TEACHER_CKPT"; fi
TRAIN="python -m deltakd_tpu_torch.cli.train"
