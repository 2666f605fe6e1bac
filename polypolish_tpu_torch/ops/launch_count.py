"""The kernels' launch counters (``chunk_counts.launches`` and
``overflow_counts.launches``, ints, and ``lanes_counts.launches``, a
Counter by entry point) and the one lock that guards them.  ``batch``
launches kernels from several worker threads, and ``+= 1`` is a
read-modify-write that loses counts without it."""

from __future__ import annotations

import threading

LOCK = threading.Lock()


def bump(wrapper, entry=None) -> None:
    """Add one launch to ``wrapper.launches`` (under ``entry`` when it
    is a Counter)."""
    with LOCK:
        if entry is None:
            wrapper.launches += 1
        else:
            wrapper.launches[entry] += 1
