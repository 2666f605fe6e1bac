"""On-demand nvcc build of the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with ctypes (the
on-demand g++ build of native/binding.py is the model).  Nothing is
built at import: the first launch of a kernel builds it, and
``build_all`` starts one ``nvcc`` per source, all at once, for callers
that want every kernel ready up front.

Outputs go to ``csrc/build/`` (gitignored), named by a hash of the
source and the flags, so an edited source rebuilds and a stale library
is never loaded.  Concurrent processes serialise on a file lock per
source and rename a per-process temporary into place.  ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            path = os.path.join(root, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return path


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Take the source's build lock and start nvcc unless the library
    exists.  Returns (lock_file, process or None, tmp path, lib path)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = _lib_path(name)
    lock_file = open(os.path.join(BUILD_DIR, name + ".lock"), "w")
    fcntl.flock(lock_file, fcntl.LOCK_EX)
    if os.path.exists(lib):
        return lock_file, None, None, lib
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, os.path.join(CSRC, name + ".cu"), "-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return lock_file, proc, tmp, lib


def _finish(name: str, lock_file, proc, tmp: Optional[str], lib: str,
            timeout: float) -> None:
    try:
        if proc is None:
            return
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(f"nvcc timed out building {name}.cu")
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}.cu:\n{text}")
        with open(os.path.join(BUILD_DIR, name + ".ptxas.txt"), "w") as f:
            f.write(text)
        os.replace(tmp, lib)
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)
        lock_file.close()


def build_all(names: Optional[List[str]] = None,
              timeout: float = 600.0) -> Dict[str, float]:
    """Build the named kernels (default: every csrc/*.cu), one nvcc per
    source, all started together.  Returns seconds per source (0.0 when
    the library was already built); raises if any build fails."""
    names = sources() if names is None else names
    t0 = time.monotonic()
    started = [(name, *_start(name)) for name in names]
    seconds: Dict[str, float] = {}
    errors = []
    for name, lock_file, proc, tmp, lib in started:
        try:
            _finish(name, lock_file, proc, tmp, lib, timeout)
        except RuntimeError as e:
            errors.append(str(e))
        seconds[name] = 0.0 if proc is None else time.monotonic() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v output of the last build of ``name``."""
    path = os.path.join(BUILD_DIR, name + ".ptxas.txt")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The compiled library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
