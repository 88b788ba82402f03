"""Build the hand-written CUDA kernels at first use and load them by ctypes.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into ``kernels/build/`` (git-ignored). The file name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. ``build()`` starts one ``nvcc`` per source at once. The sources
expose a plain C interface (no PyTorch headers), which is what keeps a
build to seconds.

Calling convention of every entry point: device pointers and the CUDA
stream as ``c_void_p``, sizes as ``c_longlong`` / ``c_int``, floats as
``c_float``; the function returns ``cudaGetLastError()`` after its launch
and the Python wrapper raises on a non-zero code, with the message of
``<name>_error_string``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("page_gather", "flash_attention", "backup_reduce", "rwkv6_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build repro_torch's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Tuple[Path, Path]:
    src = SRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source {src} is missing")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named source whose library is not built yet, one
    ``nvcc`` per source, all in parallel. Returns seconds per source
    (0.0 for a cached build). Raises with the compiler's output on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        src, lib = _target(name)
        if lib.is_file():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                            f"{out}")
            continue
        os.replace(tmp, lib)              # atomic: a reader never sees half
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def resource_usage(name: str) -> str:
    """What ptxas reports for each kernel of ``csrc/<name>.cu`` (registers,
    spill stores and loads, shared memory): ``nvcc -Xptxas -v`` on a cubin,
    compiled apart from the library and thrown away."""
    src, _ = _target(name)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC")]
    out = subprocess.run([_nvcc(), *flags, "-cubin", "-Xptxas", "-v",
                          "-o", os.devnull, str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v {name}.cu failed:\n"
                           f"{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
