"""Race-safe builds of polypolish_tpu's native library
(``libsampacker.so``) and reference replica binary (``ppref``) for the
tests.

polypolish_tpu/native/binding.py (``_build``) and native/replica.py
(``build``) compile with no lock into one shared temporary, rename it
into place, and trust any file that is newer than its source.  Parallel
pytest workers on a fresh checkout race so: one worker can rename
another's half-linked temporary into place, which then looks fresh to
every later build and is never rebuilt.  The repository's root
``conftest.py`` calls ``build_jax_native`` and ``build_jax_replica`` in
every pytest process before any test module is imported, so those
unlocked builds find usable files and compile nothing.  This module
imports nothing of polypolish_tpu at import time, and no file of
polypolish_tpu is edited.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "polypolish_tpu", "native")
LIB = os.path.join(NATIVE, "libsampacker.so")
LIB_SRC = os.path.join(NATIVE, "sam_packer.cc")
PPREF = os.path.join(NATIVE, "ppref")
PPREF_SRC = os.path.join(NATIVE, "ref_replica.cc")


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def _executable(path: str) -> bool:
    return os.access(path, os.X_OK)


def locked_build(path, src, cmd, usable, force=False):
    """Build ``path`` from ``src`` with ``cmd(output)`` under an fcntl
    lock next to it, unless it is newer than the source and
    ``usable(path)`` (or ``force``); the compiler writes a per-process
    temporary that is renamed into place."""
    with open(path + ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        fresh = (os.path.exists(path)
                 and os.path.getmtime(path) >= os.path.getmtime(src)
                 and usable(path))
        if fresh and not force:
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            subprocess.run(cmd(tmp), check=True, capture_output=True,
                           timeout=600)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def build_jax_native(force=False):
    """libsampacker.so with the g++ command of binding._build; fresh
    only if it loads."""
    locked_build(LIB, LIB_SRC,
                 lambda out: ["g++", "-O3", "-march=native", "-std=c++17",
                              "-shared", "-fPIC", LIB_SRC, "-o", out, "-lz"],
                 _loads, force)


def build_jax_replica():
    """ppref with the g++ command of replica.build; fresh only if it is
    executable."""
    locked_build(PPREF, PPREF_SRC,
                 lambda out: ["g++", "-O2", "-std=c++17", PPREF_SRC, "-o",
                              out],
                 _executable)


def ensure_jax_native():
    """Build polypolish_tpu's native library race-safely and make its
    loader retry; returns the loaded library or None.

    A process whose unlocked build or dlopen lost the race marks the
    build failed for the rest of its life (``binding._build_failed``);
    this resets that flag from the test side so that ``load_library()``
    tries again.  If the library in place cannot be loaded, it is
    rebuilt once."""
    from polypolish_tpu.native import binding

    for force in (False, True):
        build_jax_native(force)
        binding._build_failed = False
        try:
            lib = binding.load_library()
        except OSError:  # dlopen of a half-written library
            lib = None
        if lib is not None:
            return lib
    return None


def ensure_jax_replica():
    """The same for the replica binary: build it under the lock and
    reset ``replica._build_failed``.  Returns its path or None."""
    from polypolish_tpu.native import replica

    build_jax_replica()
    replica._build_failed = False
    return replica.build()
