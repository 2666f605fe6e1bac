"""The device polisher: vote counting + consensus (counterpart of
polypolish_tpu/models/polisher.py, ``LanesPolisher``).

A native lane pack goes in; the (8, P) count tensor and the compact
per-position decisions come out.  On a CUDA device the votes run
through the two hand-written kernels — the lanes vote kernel over the
lane blocks and the chunk vote kernel over the cap-overflow list — and
the consensus is elementwise torch on the device.  On the CPU the same
calls run the kernels' plain PyTorch versions.

The JAX package split long block streams into slabs for a scalar-memory
limit of the TPU; one launch of the lanes vote kernel takes any block
count, so there are no slabs here.  The overflow list always takes the
chunk vote kernel (the JAX package's "mxu" overflow mode; its XLA
scatter mode gives the same counts).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from polypolish_tpu_torch.ops.consensus import ST_CHANGED, consensus_dense_core
from polypolish_tpu_torch.ops.vote_chunks import chunk_counts, prepare_chunks
from polypolish_tpu_torch.ops.vote_lanes import (
    R_SUB,
    TILE_W,
    lanes_counts,
    to_packed4,
)
from polypolish_tpu_torch.utils.profiling import StageTimer


class LanesPolisher(nn.Module):
    """forward_pack(vb, block_tile, valid_thr, invalid_thr, low_depth,
    orig_id, ov_pos, ov_vid) -> (counts (8, P) int32, adopted (P,)
    uint8, status (P,) uint8), all on ``device``.

    No learned parameters: the per-contig state is the pack, the
    thresholds and orig_id."""

    def __init__(self, num_positions: int, device, r_sub: int = R_SUB,
                 tile_w: int = TILE_W,
                 timer: Optional[StageTimer] = None) -> None:
        super().__init__()
        if r_sub % 4:
            raise ValueError(f"packed4 lanes need r_sub % 4 == 0; got {r_sub}")
        self.num_positions = num_positions
        self.device = torch.device(device)
        self.r_sub = r_sub
        self.tile_w = tile_w
        self.n_tiles = max(1, -(-num_positions // tile_w))
        self.timer = timer if timer is not None else StageTimer()

    def vote_counts(self, vb: np.ndarray, block_tile: np.ndarray,
                    ov_pos=None, ov_vid=None) -> torch.Tensor:
        """(8, n_tiles*tile_w) int32 counts on the device from a host
        pack: ``vb`` is the pack's int32 packed4 rows (uint8 byte rows
        are converted here), ``block_tile`` its block->tile map, and
        (ov_pos, ov_vid) the cap-overflow events.  The caller keeps the
        pack alive until this returns."""
        if vb.dtype == np.uint8:
            vb = to_packed4(vb, self.r_sub)
        if vb.dtype != np.int32:
            raise ValueError(f"vb must be packed4 int32; got {vb.dtype}")
        timer = self.timer
        with timer.stage("upload"):
            d_vb = torch.from_numpy(vb).to(self.device)
            d_bt = torch.from_numpy(block_tile).to(self.device)
        with timer.stage("kernel_a"):
            counts = lanes_counts(d_vb, d_bt, self.n_tiles, self.r_sub,
                                  self.tile_w)
        if ov_pos is not None and len(ov_pos):
            with timer.stage("kernel_b"):
                p_pad = self.n_tiles * self.tile_w
                cp, cv, ct, n_tiles = prepare_chunks(
                    np.asarray(ov_pos, dtype=np.int64),
                    np.asarray(ov_vid, dtype=np.int32), p_pad,
                )
                extra = chunk_counts(
                    torch.from_numpy(cp).to(self.device),
                    torch.from_numpy(cv).to(self.device),
                    torch.from_numpy(ct).to(self.device), n_tiles,
                )
                counts += extra[:, :p_pad]
        return counts

    def forward(self, counts: torch.Tensor, valid_thr: torch.Tensor,
                invalid_thr: torch.Tensor, low_depth: torch.Tensor,
                orig_id: torch.Tensor):
        """Consensus over the counts + compact results: status < 6
        always fits uint8, and new_id differs from orig_id only at
        CHANGED positions, where the adopted id is a dense id < 8 — so
        ship (adopted, status) as uint8 and let the host rebuild new_id
        from its own orig_id (which may hold interned ids >= 256)."""
        with self.timer.stage("consensus"):
            c = counts[:, : self.num_positions]
            new_id, status = consensus_dense_core(
                c, valid_thr, invalid_thr, low_depth, orig_id
            )
            adopted = torch.where(status == ST_CHANGED, new_id, 0)
            return c, adopted.to(torch.uint8), status.to(torch.uint8)

    def forward_pack(self, vb, block_tile, valid_thr, invalid_thr,
                     low_depth, orig_id, ov_pos=None, ov_vid=None):
        counts = self.vote_counts(vb, block_tile, ov_pos, ov_vid)
        return self(counts, valid_thr, invalid_thr, low_depth, orig_id)
