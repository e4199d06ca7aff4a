"""Build the port's CUDA sources with nvcc, and its host C++ sources with the
host compiler, at first use; bind both with ctypes.

The kernels have a plain C interface (``csrc/*.cu``), so one ``nvcc`` call
builds a shared library from a source in seconds; nothing includes
PyTorch's headers. Every source becomes its own library, and the ``nvcc``
calls for all of them start together. A library goes into
``stan_tpu_torch/_build/`` (listed in .gitignore), named by a hash of its
source, every header under ``csrc/`` (``*.cuh``, ``*.h``) and the flags, so
an edited source is rebuilt, an edited header rebuilds every library, and
an unchanged one is loaded as it is. Pointers and the stream are passed as
``ctypes.c_void_p`` from ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``.

The host runtime (``csrc/*.cpp``: plain C++ with OpenMP, no CUDA) is
built the same way by the host C++ compiler (``c++`` on ``PATH``, with
HOST_FLAGS) into the same folder, named by a hash of its source and the
flags; it never needs a CUDA toolkit, so the CPU tests build it too.

Nothing here runs at import: the CPU tests import every module of the port
on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# sm_90a (not sm_90): the Hopper-only instructions exist only for that
# target. -Xptxas -v writes registers, shared memory and spills to the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-fopenmp", "-shared")

_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entry points of each source and their argument types.
_ENTRIES = {
    "stencil_sweep": {
        # up, table, out, SX, NNY, NNZ, is_low, is_high, stream
        "stencil_sweep_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "stencil_sweep_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "theta_sweep": {
        # up, tables, coef, out, B, SX, NNY, NNZ, is_low, is_high, stream
        "theta_sweep_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "theta_sweep_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "general_apply": {
        # u, m, conn, dN, detJw, D, inc, f, out, B, E, nn, G, nnode, maxdeg,
        # D's (system, element) strides, dN's and detJw's (element, Gauss
        # point) strides, stream
        "general_apply_f32": [_P] * 9 + [_I] * 12 + [_P],
        "general_apply_f64": [_P] * 9 + [_I] * 12 + [_P],
    },
}

_libs: dict = {}


def sources() -> list:
    """Every CUDA source of the port, sorted by name."""
    return sorted(CSRC.glob("*.cu"))


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library for this exact source, the headers beside it and
    the flag set lives: an edit to any of them gives another path."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted([*source.parent.glob("*.cuh"), *source.parent.glob("*.h")])
    for path in (source, *headers):
        key.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> dict:
    """Compile every csrc/*.cu whose library is missing, one nvcc per
    source, all started together, and wait for all of them; return
    {source stem: library path}. Each compiler's output is kept beside its
    library, with the suffix ``.log``. Raises if any build failed."""
    libs = {src.stem: (src, library_path(src)) for src in sources()}
    todo = [(src, lib) for src, lib in libs.values() if not lib.exists()]
    if todo:
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc = _nvcc()
        running = []
        for src, lib in todo:
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            running.append((src, lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, lib, tmp, proc in running:
            out, _ = proc.communicate()
            lib.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{src.name}: nvcc exit code {proc.returncode}"
                              f"\n{out}")
            else:
                os.replace(tmp, lib)  # atomic: others see all or nothing
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in libs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu; the first call builds every
    source that needs it."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        for fn_name, argtypes in _ENTRIES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check(code: int, what: str, name: str) -> None:
    """Raise if a C entry of csrc/<name>.cu returned a CUDA error code."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def host_library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the host library built from this exact source with HOST_FLAGS
    lives: an edit to either gives another path."""
    key = hashlib.sha256(" ".join(HOST_FLAGS).encode() + b"\0"
                         + source.read_bytes())
    return BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}.so"


def build_host(source: pathlib.Path) -> pathlib.Path:
    """Compile a host C++ source with ``c++`` unless its library exists;
    return the library's path. The compiler's output is kept beside the
    library, with the suffix ``.log``. Raises RuntimeError, with that
    output, when there is no compiler or the build fails."""
    lib = host_library_path(source)
    if lib.exists():
        return lib
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ on PATH): the port's "
                           f"host runtime {source.name} is built at first use")
    lib.parent.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    log_tmp = tmp.with_suffix(".log")
    log_tmp.write_text(proc.stdout)
    os.replace(log_tmp, lib.with_suffix(".log"))
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {source.name} (exit code "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: others see all or nothing
    return lib


def host_library(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cpp, loaded; built first if it is
    missing. Its caller keeps it (native.py for stanfem)."""
    return ctypes.CDLL(str(build_host(CSRC / f"{name}.cpp")))
