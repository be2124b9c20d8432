"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``: a few seconds per file, where a build
through ``torch.utils.cpp_extension`` (PyTorch's headers) takes minutes.
Libraries go to ``<repo>/build/kernels/`` (gitignored), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is reused.  ``build()`` starts one ``nvcc`` per missing library, all at
once, and waits for them all.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no fast math — ``-fmad=false``
keeps every multiply and add separately rounded, as the JAX reference
rounds them, so the scan kernel stays within f32 round-off of its plain
version over K·N dependent steps.  A kernel that wants fused multiply-adds
writes ``fmaf`` itself (the Gram kernel does).

Nothing here runs at import time: the first ``load`` builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("dfr_scan", "dfr_scan_grad", "ridge_gram", "block_copy", "readout_apply")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    """Path of the built library for source ``name`` (hash of source + flags)."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, in parallel.

    Returns ``{name: {"seconds": float, "ptxas": str, "cached": bool}}``;
    ``ptxas`` is the assembler's report (registers, shared memory, spills).
    Raises RuntimeError with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    running = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log,
                        "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, building it at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, argtypes: tuple):
    """C entry point ``symbol`` of library ``name``, its ``argtypes`` set
    once and ``restype`` an int (a cudaError_t)."""
    fn = getattr(load(name), symbol)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, entering the
    device's context only when it is not the current device."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)
