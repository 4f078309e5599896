"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C entry point and compiles, with one
``nvcc`` per source and all of them started together, into
``build/repro_torch/<hash>/<name>.so`` at the repository root, keyed by a
hash of every source and the flags.  The libraries are loaded with
``ctypes``.  Nothing here runs when a module is imported: the first kernel
launch builds, or ``build_all()`` does it up front.

Flags: ``sm_90a``, no ``--use_fast_math`` (it would change the Eq. 20
divide and the 2^-126 tail) and ``-fmad=false``, so that nvcc never fuses a
multiply and an add that the plain versions round separately.
``-split-compile=0`` runs the optimizer over a source's device functions
on every host thread (``flash_attention.cu`` holds some fifty kernel
instances and is the longest of the builds).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("mxint_matmul", "mxint_ln_matmul", "mxint_softmax", "mxint_gelu",
           "mxint_layernorm", "flash_attention", "launch_fixture")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-split-compile=0")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, Callable] = {}


def _root_build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return _root_build_dir() / source_hash()


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every kernel that is not built yet, in parallel; returns
    name -> library path.  Raises with nvcc's output on a failure."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = {n: out_dir / f"{n}.so" for n in KERNELS
            if not (out_dir / f"{n}.so").exists()}
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, lib)          # atomic: a concurrent build may race
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: out_dir / f"{n}.so" for n in KERNELS}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_dir() / f"{name}.so"
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def entry(name: str, argtypes: Sequence, lib: str = None) -> Callable:
    """The C entry point ``<name>_launch`` of kernel ``name``, found in the
    library of source ``lib`` (default: ``name``), with its argument types
    declared (``c_void_p`` for pointers and the stream); it returns
    ``cudaGetLastError()`` as an int."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(library(lib or name), f"{name}_launch")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise on a launch that CUDA refused (the C entry point
    returns ``cudaGetLastError()``)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Check that every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
