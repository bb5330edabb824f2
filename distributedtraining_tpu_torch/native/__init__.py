"""Host-side C++ components of the port, loaded through ``ctypes`` — the
port's copy of the JAX package's ``native/``.

``native/<name>.cpp`` (a plain C interface, no ``Python.h``) is compiled
at first use into the build directory of the CUDA libraries
(``ops/_cuda.BUILD_DIR``: ``_build/`` beside the package, or the roles'
``--compile-cache-dir``) as ``lib<name>-<hash>.so``, the hash over the
source, the compiler and its flags, so a restart on the same directory
builds nothing. The compiler is ``g++`` where it is on ``PATH``, else
``nvcc``, which hands the file to its host compiler. A build writes a
temporary file and renames it, so concurrent first uses race
harmlessly.

Unlike the JAX loader, which returns None and lets the packer take its
Python loop, :func:`load` raises with the compiler's output when the
library cannot be built or loaded: no caller quietly takes the plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import threading
import time
from pathlib import Path

from ..ops import _cuda

SRC_DIR = Path(__file__).resolve().parent
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
# nvcc hands a .cpp file to its host compiler; -fPIC must reach it
NVCC_HOST_FLAGS = ("-O2", "-shared", "-std=c++17", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def compiler() -> tuple[str, list[str]]:
    """``(name, argv without sources)`` of the host build: ``g++`` on
    PATH, else ``nvcc``. Raises RuntimeError when neither is there."""
    gxx = shutil.which("g++")
    if gxx:
        return "g++", [gxx, *HOST_FLAGS]
    try:
        nvcc = _cuda.nvcc_path()
    except RuntimeError as e:
        raise RuntimeError(
            "no C++ compiler for the host packer (native/packing.cpp): "
            "neither g++ on PATH nor nvcc") from e
    return "nvcc", [nvcc, *NVCC_HOST_FLAGS]


def library_path(name: str, compiler_name: str | None = None) -> Path:
    """Where ``native/<name>.cpp`` builds to in the current build
    directory, keyed by the source, the compiler's name and its
    flags."""
    if compiler_name is None:
        compiler_name = compiler()[0]
    flags = HOST_FLAGS if compiler_name == "g++" else NVCC_HOST_FLAGS
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join((compiler_name, *flags)).encode())
    return _cuda.BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile ``native/<name>.cpp`` unless it is built already; the
    seconds the compiler took (0.0 for a library already built). Raises
    RuntimeError with the compiler's output on failure."""
    which, cmd = compiler()
    out = library_path(name, which)
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    _cuda.compile_atomic([*cmd, str(SRC_DIR / f"{name}.cpp")], out,
                         f"native/{name}.cpp")
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp`` in the current build
    directory, built first if needed. Raises RuntimeError when it cannot
    be built or loaded."""
    with _LOCK:
        path = str(library_path(name))
        lib = _LIBS.get(path)
        if lib is None:
            build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"failed to load {path}: {e}") from e
            _LIBS[path] = lib
        return lib
