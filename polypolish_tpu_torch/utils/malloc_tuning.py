"""glibc malloc tuning for hosts where page faults are slow
(counterpart of polypolish_tpu/utils/malloc_tuning.py).

glibc returns large free()d blocks to the kernel at once (mmap
threshold 128 KB), so every polish run faults its working buffers in
again.  Raising the mmap threshold and disabling trim keeps those
buffers on the heap, faulted once per process: repeat runs in one
process (the batch pipeline, long-lived services) then reuse warm
pages.

A no-op where libc.so.6 or mallopt is missing.
"""

from __future__ import annotations

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_malloc(mmap_threshold: int = 1 << 30,
                trim_threshold: int = (1 << 31) - 1) -> bool:
    """Apply mallopt tuning once per process; returns True if applied."""
    global _done
    if _done:
        return True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, mmap_threshold)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, trim_threshold)
        _done = bool(ok1) and bool(ok2)
        return _done
    except Exception:
        return False
