"""Builds the package's CUDA kernels with nvcc at first use and loads them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
bound with ctypes: no PyTorch headers are compiled, so a build takes seconds.
Libraries go to ``deltakd_tpu_torch/_build/`` (ignored by git), named by a
digest of the sources and flags, so an edited source is rebuilt. Only the
sources in this checkout are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_INT, _PTR, _I64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong


def _block_signatures(name: str) -> dict:
    return {f"dk_{name}_workspace": ([_INT] * 5, ctypes.c_size_t),
            f"dk_{name}": ([ctypes.POINTER(_PTR)] + [_INT] * 5
                           + [ctypes.c_float, _PTR], _INT)}


# The C interface of each source: function -> (argument types, result type).
# Every pointer and the stream are c_void_p, or ctypes would cut them to 32 bits.
SIGNATURES = {
    # the forward in bf16 and fp32, one of its linear products alone in
    # either form (gemm_sm90.cuh), and the fp32 weight operand's split alone
    "fused_block_fwd": {**_block_signatures("fused_block_fwd"),
                        **_block_signatures("fused_block_fwd_f32"),
                        **{f"dk_linear_sm90{form}": ([ctypes.POINTER(_PTR)] + [_INT] * 4
                                                     + [ctypes.c_float, _INT, _INT, _PTR], _INT)
                           for form in ("", "_f32")},
                        "dk_linear_sm90_f32_workspace": ([_INT] * 2, ctypes.c_size_t),
                        "dk_tf32_split": ([_PTR, _INT, _INT, _INT, _PTR, _PTR], _INT)},
    # the backward in bf16 and fp32, and one of its weight gradients alone
    # in either form (gemm_sm90.cuh)
    "fused_block_bwd": {**_block_signatures("fused_block_bwd"),
                        **_block_signatures("fused_block_bwd_f32"),
                        **{f"dk_weight_grad_sm90{form}_workspace": ([_INT] * 3, ctypes.c_size_t)
                           for form in ("", "_f32")},
                        **{f"dk_weight_grad_sm90{form}": ([_PTR] * 2 + [_INT] * 3 + [_PTR] * 3,
                                                          _INT) for form in ("", "_f32")}},
    # the pair forward and backward in bf16 and fp32
    "fused_block_pair": {**_block_signatures("fused_pair_fwd"),
                         **_block_signatures("fused_pair_bwd"),
                         **_block_signatures("fused_pair_fwd_f32"),
                         **_block_signatures("fused_pair_bwd_f32")},
    "sort": {
        "dk_sort_tiles": ([_INT, _INT], _INT),
        "dk_sort_bitonic": ([_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR], _INT),
        "dk_sort_sl1_fwd": ([_PTR] * 4 + [_INT] * 4 + [_PTR], _INT),
        "dk_sort_sl1_bwd": ([_PTR, _PTR, _PTR, _I64, _INT, _PTR], _INT),
        # the long route (n > 4096): runs, one merge stage, a phase's finish
        "dk_sort_long_runs": ([_PTR] * 4 + [_INT] * 4 + [_PTR], _INT),
        "dk_sort_long_stage": ([_PTR, _INT, _I64, _INT, _INT, _INT, _PTR], _INT),
        "dk_sort_long_finish_value": ([_PTR] * 2 + [_INT] * 5 + [_PTR], _INT),
        "dk_sort_long_finish_sl1": ([_PTR] * 4 + [_INT] * 5 + [_PTR], _INT),
    },
    # tensors, their (batch, head, row) strides, outputs, B, H, N, stream;
    # the _f32 forms take the same arguments; the backwards a workspace
    # before the stream (dk_flash_bwd_route: and a route after it)
    "attention": {
        **{f"dk_flash_fwd{form}": ([_PTR] * 3 + [_I64] * 9 + [_PTR] * 2 + [_INT] * 3 + [_PTR],
                                   _INT) for form in ("", "_f32")},
        **{f"dk_flash_bwd{form}_workspace": ([_INT] * 3, ctypes.c_size_t)
           for form in ("", "_f32")},
        **{f"dk_flash_bwd{form}": ([_PTR] * 4 + [_I64] * 12 + [_PTR] * 5 + [_INT] * 3
                                   + [_PTR] * 2, _INT) for form in ("", "_f32")},
        "dk_flash_bwd_route_workspace": ([_INT] * 4, ctypes.c_size_t),
        "dk_flash_bwd_route": ([_PTR] * 4 + [_I64] * 12 + [_PTR] * 5 + [_INT] * 3
                               + [_PTR] * 2 + [_INT], _INT),
    },
    "fused_mlp": {
        "dk_fused_mlp_fwd": ([_PTR] * 6 + [_INT] * 3 + [_PTR], _INT),
        "dk_fused_mlp_fwd_f32_workspace": ([_INT] * 3, ctypes.c_size_t),
        "dk_fused_mlp_fwd_f32": ([_PTR] * 7 + [_INT] * 3 + [_PTR], _INT),
        **{f"dk_fused_mlp_bwd{form}_workspace": ([_INT] * 3, ctypes.c_size_t)
           for form in ("", "_f32")},
        **{f"dk_fused_mlp_bwd{form}": ([_PTR] * 11 + [_INT] * 3 + [_PTR], _INT)
           for form in ("", "_f32")},
    },
}

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_CSRC), os.pardir, "_build")
SOURCES = ("fused_block_fwd", "fused_block_bwd", "fused_block_pair", "sort", "attention",
           "fused_mlp")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return path


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fn in sorted(os.listdir(_CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(_CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.normpath(os.path.join(
        _BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so"))


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc per
    source, all started together. Returns each compiled source's nvcc log
    (ptxas register and spill counts); raises with the log on failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build([name])
        lib = ctypes.CDLL(_library_path(name))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return _libs[name]
