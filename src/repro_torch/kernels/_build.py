"""Build the package's CUDA sources into shared libraries and load them.

Each ``kernels/csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/lib<name>.so`` at
the root of the checkout, at first use, then loaded with ``ctypes``.  A
library newer than its source is reused.  Only the sources in this
package are read, so a bare checkout builds on its own.

Flags are per source (:func:`flags`): ``fusion_eval``, ``flash_decode``
and ``wkv6`` are built with ``-fmad=false``, since their agreement with
their plain twins (bit for bit, or within the f32 gate) rests on the twins'
roundings; ``flash_attention`` is built without it, so the softmax's
scale-and-subtract is one FMA, and its TMA maps need no ``-lcuda`` (the
encoder is reached through ``cudaGetDriverEntryPoint``).

:func:`refuse_grad` is the wrappers' shared guard: no kernel has a
backward, so none may be called where autograd would record it.
"""
from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCE_FLAGS", "flags",
           "build", "load", "build_info", "sm_count", "refuse_grad"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCE_FLAGS = {"fusion_eval": ("-fmad=false",),
                "flash_decode": ("-fmad=false",),
                "wkv6": ("-fmad=false",),
                "flash_attention": ()}


def flags(name: str) -> tuple:
    """The nvcc flags that ``csrc/<name>.cu`` is built with."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, out, t0) or
    None when the library is already up to date."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    out = BUILD_DIR / f"lib{name}.so"
    if out.is_file() and out.stat().st_mtime >= src.stat().st_mtime:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)
    _INFO[name] = {"build_s": time.perf_counter() - t0, "log": log,
                   "cached": False}


def build(*names: str) -> None:
    """Compile the named sources, all ``nvcc`` processes started together."""
    with _LOCK:
        jobs = {}
        for name in names:
            job = _start(name)
            if job is None:
                _INFO.setdefault(name, {"build_s": 0.0, "log": "",
                                        "cached": True})
            else:
                jobs[name] = job
        for name, job in jobs.items():
            _finish(name, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
                _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, which the kernels' launch
    plans size their grids by."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def build_info(name: str) -> dict | None:
    """Build time (s), compiler log and whether a cached library was used."""
    return _INFO.get(name)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record a call of kernel ``name``.  The
    kernels write into fresh tensors and have no backward, as the
    reference's Pallas kernels have none, so a recorded call would cut
    every gradient through it without a word.  The wrappers check before
    they dispatch on the device, so a CPU call refuses as a card call
    does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the reference's Pallas "
            f"kernel): call it under torch.no_grad(), or differentiate the "
            f"model at impl=\"dense\" (the reference's impl=\"xla\")")
