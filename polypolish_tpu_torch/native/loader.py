"""On-demand build of the native (C++) SAM packer (counterpart of the
build half of polypolish_tpu/native/binding.py).

``build()`` compiles sam_packer.cc with g++ -O3 into libsampacker.so
next to this file unless the library is newer than the source.  The
build is race-safe: concurrent processes (pytest-xdist workers) take a
file lock, compile to a per-process temporary name and ``os.replace``
the result.  The port has no pure-Python fallback: a failed build
raises.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sam_packer.cc")
_LIB = os.path.join(_HERE, "libsampacker.so")


def build() -> str:
    """Compile sam_packer.cc unless the library is newer than it;
    returns the library's path.

    Under a file lock so that concurrent processes build once; the
    compiler writes a per-process temporary that is renamed into place
    atomically, so a reader never maps a half-written library."""
    src_mtime = os.path.getmtime(_SRC)
    with open(_LIB + ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= src_mtime:
            return _LIB
        tmp = f"{_LIB}.tmp.{os.getpid()}"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            _SRC, "-o", tmp, "-lz",
        ]
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    "building the native SAM packer failed:\n"
                    + proc.stderr.decode(errors="replace")
                )
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _LIB
