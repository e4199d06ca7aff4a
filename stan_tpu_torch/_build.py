"""Build the port's CUDA sources with nvcc at first use and bind them with ctypes.

The kernels have a plain C interface (``csrc/*.cu``), so one ``nvcc`` call
builds a shared library in seconds; nothing includes PyTorch's headers.
The library goes into ``stan_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Pointers and the stream are passed
as ``ctypes.c_void_p`` from ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the CPU tests import every module of the port
on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "stencil_sweep.cu"
BUILD_DIR = _PKG / "_build"
# sm_90a (not sm_90): the Hopper-only instructions exist only for that
# target. -Xptxas -v writes registers, shared memory and spills to the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> pathlib.Path:
    """Compile csrc/stencil_sweep.cu unless the library for this exact
    source and flag set exists; return the library's path. The compiler's
    output is kept beside it, with the suffix ``.log``."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{SOURCE.stem}-{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.stencil_sweep_f32, lib.stencil_sweep_f64):
            fn.argtypes = [p, p, p, i, i, i, i, i, p]
            fn.restype = i
        lib.stencil_sweep_error_string.argtypes = [i]
        lib.stencil_sweep_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = library().stencil_sweep_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
