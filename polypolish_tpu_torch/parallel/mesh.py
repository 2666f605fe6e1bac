"""The (data, pos) device grid (counterpart of
polypolish_tpu/parallel/mesh.py; the reference has no parallelism).

The polishing workload has two natural parallel axes:

- ``data``: alignment-event batches, whose vote counts merge with an
  exact integer sum over this axis;
- ``pos``: the assembly position axis; the (8, P) count tensor and the
  consensus split by position range because votes are position-local.

The JAX package's grid is a ``jax.sharding.Mesh`` of distinct devices.
Here it is a numpy grid of ``torch.device``s that may repeat one device
(every cell ``cuda:0`` on a one-card machine, ``cpu`` in the tests):
the grid says how the work is cut, not how many cards there are.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("data", "pos")


def mesh_shape_for(
    n_devices: int, prefer_pos: Optional[int] = None
) -> Tuple[int, int]:
    """Pick a (data, pos) factorisation of n_devices.

    Position sharding is preferred once there are >= 4 devices (it cuts
    both HBM footprint and psum volume); pure data-parallel below that.
    """
    if prefer_pos is not None:
        if n_devices % prefer_pos != 0:
            raise ValueError(
                f"prefer_pos={prefer_pos} does not divide n_devices={n_devices}"
            )
        return n_devices // prefer_pos, prefer_pos
    if n_devices >= 4 and n_devices % 2 == 0:
        return 2, n_devices // 2
    return n_devices, 1


class Mesh:
    """A (data, pos) grid of torch devices: ``devices`` is an object
    array of shape ``shape`` = (n_data, n_pos)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray) -> None:
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"mesh needs a non-empty 2-D device grid; got "
                             f"shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Tuple[int, int]:
        return self.devices.shape

    def __repr__(self) -> str:
        cells = ", ".join(str(d) for d in self.devices.reshape(-1))
        return f"Mesh({self.shape[0]}x{self.shape[1]}: {cells})"


def visible_devices(device) -> list:
    """The devices a grid over ``device`` spans by default: every visible
    CUDA device for "cuda" without an index, else ``device`` alone."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a device grid over 'cuda' needs a GPU, but "
                "torch.cuda.is_available() is False; pass CPU devices "
                "(e.g. devices=['cpu'] * 8) to run the kernels' plain "
                "PyTorch versions"
            )
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(
    n_data: Optional[int] = None,
    n_pos: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2D (data, pos) grid over ``devices`` (default: every visible
    CUDA device; raises when there is none).  A list may repeat a
    device, e.g. ``["cpu"] * 8`` or ``["cuda:0"] * 4``."""
    if devices is None:
        devices = visible_devices("cuda")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_data is None or n_pos is None:
        n_data, n_pos = mesh_shape_for(n, prefer_pos=n_pos)
    if n_data * n_pos != n:
        raise ValueError(f"mesh {n_data}x{n_pos} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_data, n_pos))
