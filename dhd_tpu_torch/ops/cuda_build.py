"""Build the port's CUDA sources (``dhd_tpu_torch/csrc/*.cu``) with nvcc
into shared libraries with a plain C interface, loaded with ctypes, and
register each kernel's launch as a ``torch.library`` custom op
(:func:`kernel_op`).

A library is built at first use into ``build/dhd_tpu_torch/`` at the repo
root, named by the hash of its source, so an edited source is rebuilt and a
built one is reused.  :func:`build` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

import torch

from dhd_tpu_torch import profiling

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dhd_tpu_torch"
SOURCES = ("mghs_pool", "segment_sum", "cost_volume", "layer_norm",
           "window_attention", "unet_epilogue")   # every csrc/<name>.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, in parallel,
    each nvcc run counted under ``kernel_builds``.  Returns nvcc's output
    (registers, shared memory, spills) by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
        profiling.count("kernel_builds")
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)            # atomic: concurrent builds agree
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed;
    the first load in the process is the set-up span
    ``setup.kernel_load`` and counts under ``kernel_loads``."""
    if name not in _loaded:
        with profiling.span("setup.kernel_load", always=True):
            build([name])
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        profiling.count("kernel_loads")
    return _loaded[name]


def kernel_op(name: str, launch: Callable, fake: Callable,
              mutates_args: Tuple[str, ...] = ()) -> Callable:
    """``launch`` (a kernel's launch on checked CUDA tensors, its type
    annotations the op's schema) registered as the custom op
    ``dhd_tpu_torch::<name>`` for CUDA tensors, with ``fake`` giving its
    outputs from the input shapes alone; ``mutates_args`` names the
    arguments the kernel writes into.  Returns the call the wrapper
    makes: under a trace (``torch.export``) the op, which an exported
    program records and runs on the card; otherwise ``launch`` itself,
    sparing a served frame the op's Python dispatch on each of its
    launches (~80 a DHD-L frame)."""
    op = torch.library.custom_op(f"dhd_tpu_torch::{name}", launch,
                                 mutates_args=mutates_args,
                                 device_types="cuda")
    op.register_fake(fake)

    def call(*args):
        return (op if torch.compiler.is_compiling() else launch)(*args)
    return call
