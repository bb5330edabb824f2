"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``<build dir>/lib<name>-<hash>.so``
at first use and loaded with ``ctypes``; the hash covers the source, the
headers it may include (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads at once.
Each source builds on its own, so a caller may start one ``build`` per
source at once (chip_smoke.py does). Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.

The build directory is ``_build/`` beside the package unless
:func:`set_build_dir` names another (the roles' ``--compile-cache-dir``);
the host packer (``native/``) builds into the same directory through
:func:`compile_atomic`. A build writes a temporary file and renames it,
so processes that build one library at once (xdist workers, the ranks
of a world) race harmlessly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# compiler runs in this process, the host packer's included (a build
# that finds its library runs none)
compiles = 0
_COUNT_LOCK = threading.Lock()


def set_build_dir(path) -> Path:
    """Build the CUDA libraries and the host packer into ``path`` from
    now on, creating it; returns it. Called once, before any build (the
    roles do so at their build for ``--compile-cache-dir``): a library
    this process loaded already stays loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(os.path.abspath(path))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def compile_atomic(cmd: list, out: Path, what: str) -> str:
    """Run the compiler ``cmd`` with ``-o <tmp>`` appended, keep its
    output beside ``out`` as ``<out>.log``, then rename the temporary
    file to ``out``; returns the compiler's output. Raises
    RuntimeError with that output when the compiler fails or cannot be
    started."""
    global compiles
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    with _COUNT_LOCK:
        compiles += 1
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"build of {what} failed: {cmd[0]} could not "
                           f"be started: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build of {what} failed ({cmd[0]} exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    out.with_name(out.name + ".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return proc.stdout


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of distributedtraining_tpu_torch are built from source "
        "at first use")


def sources() -> list[str]:
    """The kernel sources: the names of ``csrc/*.cu``, sorted."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already, and return
    the seconds ``nvcc`` took (0.0 for a library already built). The
    compiler's report (registers, spills, shared memory per kernel) is
    kept beside the library as ``<lib>.log``. Raises RuntimeError with
    the compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    compile_atomic([nvcc_path(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")],
                   out, f"the CUDA kernels of {name}.cu")
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
