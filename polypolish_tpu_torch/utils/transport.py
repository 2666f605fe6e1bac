"""Host-to-device link measurement and the backend cost model of
``--backend auto`` (counterpart of polypolish_tpu/utils/transport.py).

The model is the JAX package's (main.rs:112-126 dispatch analog):

    host_s   = sam_bytes / HOST_ENGINE_BYTES_PER_S
    device_s = sam_bytes / (PARSE_SPEEDUP * host_rate)  (parse+fold+pack)
             + sam_bytes * UPLOAD_FRACTION / bw     (pack upload)
             + N_DISPATCH * latency                 (round trips)
             + KERNEL_EPS_S                         (the rest)

and ``auto`` picks the device path iff device_s < host_s.  The SAM byte
count is known before the backend is chosen; bandwidth and latency are
measured once per process (pageable host-to-device copies timed to a
``torch.cuda.synchronize()``).  POLYPOLISH_TPU_TRANSPORT=fast|slow
replaces the measurement (fast: 8 GB/s and 50 us, slow: 1.2 GB/s and
0.25 s), and POLYPOLISH_TPU_HOST_RATE the host engine's rate.

The constants are the port's own: medians of three warm host and three
warm lanes-path ``polish`` runs on the E. coli 50x workload
(benchmarks/workload.py, 540,129,773 B of SAM in two files), taken in
turn by phase 12 of ``python3 chip_smoke.py``, which prints them again
on every run, on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
with 8 host CPU cores:

- HOST_ENGINE_BYTES_PER_S: SAM bytes over the host backend's whole
  ``polish`` time, 0.879 s (0.925, 0.879, 0.834);
- PARSE_SPEEDUP: that time over the lanes path's parse + fold + pack,
  0.844 s (0.761, 0.844, 0.885);
- UPLOAD_FRACTION: the packed4 lane pack's 301,989,888 B per SAM byte;
- N_DISPATCH: the lanes path's blocking host-device round trips (six
  uploads, the tile-row read and upload of kernel A, three overflow
  uploads and the order-flag read of kernel B, two decision fetches);
- KERNEL_EPS_S: the rest of the lanes path's 1.160 s (1.092, 1.160,
  1.211): its total less parse + fold + pack, the pack upload and the
  round trips at the run's link (5.25e9 B/s, 39.2 us).  The kernel,
  consensus and fetch stages are 0.110 s of its 0.257 s; the threshold
  upload, finish and stage syncs are the rest.  So the model gives
  back both measured totals at the point it was calibrated on.

With these constants ``auto`` takes the host backend at every SAM size
on a link below about 8.7e9 B/s, as the pageable copies measured here
(5.25-7.77e9 B/s over five runs) are.  Warm totals move 10-20% between
runs on the same code, and PARSE_SPEEDUP with them (1.04-1.26 over
three runs): the choice at E. coli size is within that noise.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

HOST_ENGINE_BYTES_PER_S = 6.145e8
PARSE_SPEEDUP = 1.041
UPLOAD_FRACTION = 0.559
N_DISPATCH = 14
KERNEL_EPS_S = 0.257

# coarse link class of transport_grade() (callers that do not know their
# workload size); the cost model above is what auto uses
FAST_TRANSPORT_BYTES_PER_S = 1e9

_SNIFF_BYTES = 4 << 20
_LAT_BYTES = 4 << 10

_cached_grade: Optional[str] = None
_cached_link: Optional[Tuple[float, float]] = None


def _copy_s(buf: np.ndarray, device: torch.device) -> float:
    """Wall seconds of one host-to-device copy of ``buf``."""
    t0 = time.perf_counter()
    torch.from_numpy(buf).to(device, copy=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def measure_device_bandwidth(size_bytes: int = _SNIFF_BYTES,
                             device="cuda") -> float:
    """Measured host-to-device bandwidth in bytes/s (best of 2)."""
    device = torch.device(device)
    buf = np.zeros(size_bytes, dtype=np.uint8)
    best = min(_copy_s(buf, device) for _ in range(2))
    return size_bytes / max(best, 1e-9)


def measure_link(refresh: bool = False, device="cuda") -> Tuple[float, float]:
    """(bandwidth bytes/s, latency s), measured once per process.

    Latency = best wall time of a tiny (4 KB) copy; bandwidth = bytes /
    (large-probe time - latency)."""
    global _cached_link
    if _cached_link is not None and not refresh:
        return _cached_link
    device = torch.device(device)
    lat = min(_copy_s(np.zeros(_LAT_BYTES, np.uint8), device)
              for _ in range(3))
    big = np.zeros(_SNIFF_BYTES, dtype=np.uint8)
    t_big = min(_copy_s(big, device) for _ in range(2))
    # Jitter guard: on a noisy link the best tiny-probe time can exceed
    # the best large-probe time, making (t_big - lat) ~ 0 and the
    # inferred bandwidth absurd, which would flip auto to the device
    # path.  Clamp the payload time to at least half the large-probe
    # wall time.
    bw = _SNIFF_BYTES / max(t_big - lat, t_big * 0.5, 1e-9)
    _cached_link = (bw, lat)
    return _cached_link


def _accelerator(device) -> bool:
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def predict_backend(sam_bytes: int, refresh: bool = False, device="cuda"):
    """('host' | 'device', details dict) from the cost model.

    Honors POLYPOLISH_TPU_TRANSPORT=fast|slow (operators who know their
    topology; also the test hook).  Returns 'host' with a reason when no
    GPU is in use (``device`` is the CPU, or torch sees no CUDA device);
    a failing measurement on a GPU raises, as every device step of the
    port does, instead of falling back to the host."""
    host_rate = HOST_ENGINE_BYTES_PER_S
    try:
        host_rate = float(os.environ.get("POLYPOLISH_TPU_HOST_RATE",
                                         host_rate))
    except ValueError:
        pass
    override = os.environ.get("POLYPOLISH_TPU_TRANSPORT")
    if override == "fast":
        bw, lat = 8e9, 5e-5
    elif override == "slow":
        bw, lat = 1.2e9, 0.25
    elif not _accelerator(device):
        return "host", {"reason": "no accelerator"}
    else:
        bw, lat = measure_link(refresh=refresh, device=device)
    host_s = sam_bytes / host_rate
    device_s = (sam_bytes / (PARSE_SPEEDUP * host_rate)
                + sam_bytes * UPLOAD_FRACTION / bw
                + N_DISPATCH * lat
                + KERNEL_EPS_S)
    details = {
        "sam_bytes": int(sam_bytes),
        "bandwidth_bytes_per_s": bw,
        "latency_s": lat,
        "predicted_host_s": round(host_s, 3),
        "predicted_device_s": round(device_s, 3),
    }
    return ("device" if device_s < host_s else "host"), details


def transport_grade(refresh: bool = False, device="cuda") -> str:
    """'fast' | 'slow' | 'none' (no GPU), cached per process.  Override
    with POLYPOLISH_TPU_TRANSPORT=fast|slow."""
    global _cached_grade
    override = os.environ.get("POLYPOLISH_TPU_TRANSPORT")
    if override in ("fast", "slow"):
        return override
    if _cached_grade is not None and not refresh:
        return _cached_grade
    if not _accelerator(device):
        _cached_grade = "none"
        return _cached_grade
    bw = measure_device_bandwidth(device=device)
    _cached_grade = "fast" if bw >= FAST_TRANSPORT_BYTES_PER_S else "slow"
    return _cached_grade
