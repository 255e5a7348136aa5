#!/bin/bash
# Shared recipe preamble for the PyTorch/CUDA port. Pass the mesh as $1 to
# launch one process per card under torchrun (NCCL; --batch-size is per data
# rank, as in the reference's DDP launch and the JAX package's data axis):
# "N" puts N cards on the data axis, "D M" runs D*M cards as the JAX
# package's (data, model) mesh, a model axis of M sharding the blocks
# (tensor parallelism). Without $1 the recipe runs one plain process.
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
if [[ -n "$1" ]]; then TRAIN="torchrun --standalone --nproc_per_node $((${1// /*})) -m deltakd_tpu_torch.cli.train"; fi
