"""The device polishers: vote counting + consensus (counterpart of
polypolish_tpu/models/polisher.py).

- ``LanesPolisher``: a lane pack goes in; the (8, P) count tensor and
  the compact per-position decisions come out.  On a CUDA device the
  votes run through the lanes vote kernel over the lane blocks (the
  body's entry point) and the overflow vote kernel, which adds the
  cap-overflow list into the lanes kernel's counts in place.
- ``PolisherModel``: a chunk stream goes in (the mxu and xla polish
  paths); the votes run through the chunk vote kernel, or with
  ``use_kernel=False`` through a torch scatter-add (the JAX package's
  XLA path), and the consensus follows.

The consensus is elementwise torch on the device.  On the CPU the same
calls run the kernels' plain PyTorch versions.

The JAX package split long block streams into slabs for a scalar-memory
limit of the TPU; one launch of the lanes vote kernel takes any block
count, so there are no slabs here.  The JAX package folds the overflow
list either through its chunk kernel (its "mxu" overflow mode, after a
host pass that lays the list out as chunks over every tile) or through
an XLA scatter-add ("scatter", its default in interpret mode); both
give bitwise the same counts.  The port has one route, the overflow
vote kernel over the list as the packer emits it, and reads no
POLYPOLISH_TPU_OV_MODE: the variable changes no output of either
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from polypolish_tpu_torch.ops.consensus import ST_CHANGED, consensus_dense_core
from polypolish_tpu_torch.ops.vote import scatter_add_drop
from polypolish_tpu_torch.ops.vote_chunks import (
    E_LANE,
    E_SUB,
    TILE_P,
    chunk_counts,
    prepare_chunks,
)
from polypolish_tpu_torch.ops.vote_lanes import (
    R_SUB,
    TILE_W,
    _rows_per_block,
    lanes_counts,
    overflow_counts,
    to_packed4,
)
from polypolish_tpu_torch.utils.profiling import StageTimer
from polypolish_tpu_torch.vocab import DENSE_V


class PolisherModel(nn.Module):
    """forward(chunk_pos, chunk_vocab, chunk_tile, valid_thr,
    invalid_thr, low_depth, orig_id) -> (counts (8, P) int32, new_id
    (P,) int32, status (P,) int32), all on ``device``, over a fixed
    (padded) contig length P."""

    def __init__(self, num_positions: int, device="cuda",
                 use_kernel: bool = True,
                 timer: Optional[StageTimer] = None) -> None:
        super().__init__()
        self.num_positions = num_positions
        self.device = torch.device(device)
        self.n_tiles = max(1, -(-num_positions // TILE_P))
        self.use_kernel = use_kernel
        self.timer = timer if timer is not None else StageTimer()

    def forward(self, chunk_pos, chunk_vocab, chunk_tile, valid_thr,
                invalid_thr, low_depth, orig_id):
        # pack() ships int16 tile-local positions and int8 vocab ids;
        # they widen to the kernel's int32 layout here, on the device.
        # The uint8 layout (pad vocab 255) is the kernel's own.
        if chunk_pos.dtype in (torch.int16, torch.int8):
            chunk_pos = chunk_pos.to(torch.int32)
        if chunk_vocab.dtype in (torch.int16, torch.int8):
            chunk_vocab = chunk_vocab.to(torch.int32)
        P = self.num_positions
        if self.use_kernel:
            with self.timer.stage("kernel_b"):
                counts = chunk_counts(chunk_pos, chunk_vocab, chunk_tile,
                                      self.n_tiles)[:, :P]
        else:
            with self.timer.stage("scatter"):
                pos = chunk_pos.reshape(-1).to(torch.int64)
                voc = chunk_vocab.reshape(-1)
                tile = chunk_tile.to(torch.int64).repeat_interleave(
                    E_SUB * E_LANE)
                gpos = torch.where(pos >= 0, tile * TILE_P + pos, P)
                counts = scatter_add_drop(
                    torch.zeros((DENSE_V, P), dtype=torch.int32,
                                device=chunk_pos.device), voc, gpos)
        with self.timer.stage("consensus"):
            new_id, status = consensus_dense_core(
                counts, valid_thr, invalid_thr, low_depth, orig_id
            )
        return counts, new_id, status

    def pack(self, pos: np.ndarray, vocab: np.ndarray):
        """Host packing: event arrays -> device chunk tensors.
        Tile-local positions fit int16 (-1 = pad) and dense vocab ids
        fit int8, so the upload is 3 bytes/event instead of 8;
        forward() widens on the device."""
        chunk_pos, chunk_vocab, chunk_tile, n_tiles = prepare_chunks(
            pos, vocab, self.num_positions
        )
        if n_tiles != self.n_tiles:
            raise ValueError(f"packed {n_tiles} tiles, model has "
                             f"{self.n_tiles}")
        return (
            torch.from_numpy(chunk_pos.astype(np.int16)).to(self.device),
            torch.from_numpy(chunk_vocab.astype(np.int8)).to(self.device),
            torch.from_numpy(chunk_tile).to(self.device),
        )


def example_inputs(num_positions: int = 4096, n_events: int = 100_000,
                   seed: int = 0, device="cuda"):
    """Small seeded example batch: (model, forward args on device)."""
    rng = np.random.default_rng(seed)
    model = PolisherModel(num_positions, device)
    pos = rng.integers(0, num_positions, size=n_events).astype(np.int64)
    vocab = rng.integers(0, DENSE_V, size=n_events).astype(np.int32)
    chunk_pos, chunk_vocab, chunk_tile = model.pack(pos, vocab)
    depth = np.bincount(pos, minlength=num_positions).astype(np.float64)
    valid_thr = np.maximum(5, (depth * 0.5).round()).astype(np.int32)
    invalid_thr = (depth * 0.2).round().astype(np.int32)
    low_depth = depth < 5
    orig_id = rng.integers(1, 5, size=num_positions).astype(np.int32)
    args = (chunk_pos, chunk_vocab, chunk_tile) + tuple(
        torch.from_numpy(a).to(model.device)
        for a in (valid_thr, invalid_thr, low_depth, orig_id)
    )
    return model, args


class LanesPolisher(nn.Module):
    """forward_pack(vb, block_tile, valid_thr, invalid_thr, low_depth,
    orig_id, ov_pos, ov_vid) -> (counts (8, P) int32, adopted (P,)
    uint8, status (P,) uint8), all on ``device``.

    ``body`` picks the pack's row layout: 'packed4' (int32 rows of four
    bytes, the default) or the byte rows of 'packed' and 'cmp'; packed4
    falls to 'packed' when r_sub % 4 != 0, as the JAX package does.
    No learned parameters: the per-contig state is the pack, the
    thresholds and orig_id."""

    def __init__(self, num_positions: int, device, r_sub: int = R_SUB,
                 tile_w: int = TILE_W,
                 timer: Optional[StageTimer] = None,
                 body: str = "packed4") -> None:
        super().__init__()
        if body == "packed8":
            # the JAX LanesPolisher hands packed8 byte rows with a
            # byte-row block geometry; the nibble layout is reached
            # through dense_counts_lanes(body="packed8") instead
            raise ValueError("LanesPolisher takes byte or packed4 rows; "
                             "the packed8 layout goes through "
                             "ops.vote_lanes.dense_counts_lanes("
                             "body='packed8')")
        if body == "packed4" and r_sub % 4:
            body = "packed"
        _rows_per_block(r_sub, body)
        self.num_positions = num_positions
        self.device = torch.device(device)
        self.r_sub = r_sub
        self.tile_w = tile_w
        self.body = body
        self.n_tiles = max(1, -(-num_positions // tile_w))
        self.timer = timer if timer is not None else StageTimer()

    def vote_counts(self, vb: np.ndarray, block_tile: np.ndarray,
                    ov_pos=None, ov_vid=None) -> torch.Tensor:
        """(8, n_tiles*tile_w) int32 counts on the device from a host
        pack: ``vb`` is the pack's rows (int32 packed4 rows for body
        packed4, where uint8 byte rows are converted here; uint8 or int8
        byte rows otherwise), ``block_tile`` its block->tile map, and
        (ov_pos, ov_vid) the cap-overflow events (int32 positions and
        uint8 vocab ids, as the packers emit them).  The uploads are
        from pageable memory and have finished with the host arrays
        when they return; the caller keeps the pack alive until this
        returns."""
        if self.body == "packed4":
            if vb.dtype == np.uint8:
                vb = to_packed4(vb, self.r_sub)
            if vb.dtype != np.int32:
                raise ValueError(f"vb must be packed4 int32; got {vb.dtype}")
        elif vb.dtype not in (np.uint8, np.int8):
            raise ValueError(f"body {self.body}: vb must be uint8 or int8 "
                             f"byte rows; got {vb.dtype}")
        has_ov = ov_pos is not None and len(ov_pos) > 0
        timer = self.timer
        with timer.stage("upload"):
            d_vb = torch.from_numpy(vb).to(self.device)
            d_bt = torch.from_numpy(block_tile).to(self.device)
            if has_ov:
                d_op, d_ov = (
                    torch.from_numpy(np.ascontiguousarray(a, dtype=t))
                    .to(self.device)
                    for a, t in ((ov_pos, np.int32), (ov_vid, np.uint8)))
        with timer.stage("kernel_a"):
            counts = lanes_counts(d_vb, d_bt, self.n_tiles, self.r_sub,
                                  self.tile_w, self.body,
                                  block_tile_host=block_tile)
        if has_ov:
            with timer.stage("kernel_b"):
                overflow_counts(counts, d_op, d_ov)
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
