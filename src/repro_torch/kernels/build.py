"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, loaded through :mod:`ctypes` — no PyTorch headers, so a build
takes seconds.  Libraries land in ``build/repro_torch/`` at the repository
root (git-ignored) under a name keyed by a hash of the sources and flags: a
process builds a library at most once, an edited source rebuilds, and a
second process finds the first one's build.  :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module, and the
host that runs them has no ``nvcc``.
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
from typing import Dict, Iterable

__all__ = ["SOURCES", "build_all", "load", "nvcc_path", "BUILD_LOG"]

SOURCES = ("fxp_layer", "fxp_mlp_model", "fxp_qmatmul", "fxp_svm_model",
           "tree_ensemble")
_CSRC = Path(__file__).resolve().with_name("csrc")
_HEADERS = ("fxp_common.cuh", "fxp_tile.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")
# Report registers, shared memory and spills per kernel; does not change
# the binary, so it stays out of the build key.
_VERBOSE = ("-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output of the build this process ran (ptxas resource lines).
BUILD_LOG: Dict[str, str] = {}


def _build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host with "
                       "the CUDA toolkit (PATH, $CUDA_HOME or /usr/local/cuda)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for part in (*_HEADERS, f"{name}.cu"):
        h.update(part.encode())
        h.update((_CSRC / part).read_bytes())
    return _build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every missing library, one ``nvcc`` per source in parallel.

    Returns seconds spent per library built (0.0 for one already on disk).
    Raises with the compiler's output if any build fails.
    """
    names = tuple(names)
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    nvcc = nvcc_path()
    _build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, *_VERBOSE, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)  # atomic: racing builders publish whole files
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib
