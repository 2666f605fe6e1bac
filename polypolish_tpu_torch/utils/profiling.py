"""Per-stage wall timers for the polish path (counterpart of
polypolish_tpu/utils/profiling.py, whose jax trace has no port yet).

A ``StageTimer`` is created by the caller and passed down the path;
each ``stage(name)`` block adds its wall time to ``seconds[name]`` and
appends ``(name, seconds)`` to ``laps`` (the windowed paths run each
stage once per window, so the laps give per-window times).
With ``sync_device`` set, a block first waits for that CUDA device, so
device work queued inside the block is charged to it (kernel times are
then the launch-to-finish time of that stage; the cost is one
synchronisation per block).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch


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
