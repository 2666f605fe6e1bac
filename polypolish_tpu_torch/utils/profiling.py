"""Timers and tracing of the polish path (counterpart of
polypolish_tpu/utils/profiling.py; the reference only has wall-clock
timing at polish.rs:28/88).

- ``phase(name)``: process-wide per-phase wall timers (``timings()``,
  ``reset_timings()``), printed to stderr as ``[timing]`` lines when
  POLYPOLISH_TPU_TIMINGS=1.
- ``maybe_trace()``: wraps a block in a ``torch.profiler`` trace (CPU and,
  when a GPU is present, CUDA activities) when
  POLYPOLISH_TPU_PROFILE=<dir> is set; the Chrome trace goes to that
  directory.
- ``StageTimer``: created by the caller and passed down the path; each
  ``stage(name)`` block adds its wall time to ``seconds[name]`` and
  appends ``(name, seconds)`` to ``laps`` (the windowed paths run each
  stage once per window, so the laps give per-window times).  With
  ``sync_device`` set, a block first waits for that CUDA device, so
  device work queued inside the block is charged to it (kernel times
  are then the launch-to-finish time of that stage; the cost is one
  synchronisation per block).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

_TIMINGS: Dict[str, float] = {}
_ENABLED = bool(os.environ.get("POLYPOLISH_TPU_TIMINGS"))


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    t0 = time.monotonic()
    try:
        yield
    finally:
        dt = time.monotonic() - t0
        _TIMINGS[name] = _TIMINGS.get(name, 0.0) + dt
        if _ENABLED:
            print(f"[timing] {name}: {dt:.3f}s", file=sys.stderr)


def timings() -> Dict[str, float]:
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()


@contextlib.contextmanager
def maybe_trace() -> Iterator[None]:
    trace_dir = os.environ.get("POLYPOLISH_TPU_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"polish_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"[profile] torch trace written to {path}", file=sys.stderr)


class StageTimer:
    def __init__(self, sync_device: Optional[torch.device] = None) -> None:
        self.seconds: Dict[str, float] = {}
        self.laps: List[Tuple[str, float]] = []
        self.sync_device = sync_device

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_device is not None:
                torch.cuda.synchronize(self.sync_device)
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.laps.append((name, dt))
