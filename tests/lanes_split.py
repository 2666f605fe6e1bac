"""A plain model of the work split of the port's lanes vote kernel
(polypolish_tpu_torch/csrc/lanes_vote.cu, packed4 and byte layouts), for
the tests.  The kernel makes the split itself on the card; this model
only states what it should be, and the CUDA tests hold the kernel to
lanes_counts_plain on packs that cross the split's boundaries."""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from polypolish_tpu_torch import _build
from polypolish_tpu_torch.ops import vote_lanes as tvl

# body -> the decoder struct of lanes_vote.cu that reads its rows
_DECODER = {"packed4": "Packed4", "packed": "Bytes", "cmp": "Bytes"}


def kernel_seg_rows(body: str) -> int:
    """Rows per segment of the split for a body: kSegRows of its decoder
    in the kernel source."""
    with open(os.path.join(_build.CSRC, "lanes_vote.cu")) as f:
        src = f.read()
    m = re.search(r"struct %s \{.*?kSegRows = (\d+);" % _DECODER[body], src,
                  re.S)
    return int(m.group(1))


def lane_segments(starts: np.ndarray, seg_rows: int) -> np.ndarray:
    """The split of a pack's rows as (n, 3) int64 rows (tile, row_begin,
    row_end).  The first n_tiles rows are each tile's first segment, in
    tile order (empty for a tile with no rows): its first ``seg_rows``
    rows, whose counts the first launch stores.  The rest, in row order,
    are the deep segments that the second launch adds: rows past their
    tile's first ``seg_rows``, cut at the multiples of ``seg_rows``.
    ``starts`` is a tile_row_start prefix.  No segment exceeds seg_rows
    rows."""
    starts = np.asarray(starts, dtype=np.int64)
    n_tiles = starts.size - 1
    begin = starts[:-1]
    first = np.stack([np.arange(n_tiles, dtype=np.int64), begin,
                      np.minimum(starts[1:], begin + seg_rows)], axis=1)
    row0 = np.arange(-(-int(starts[-1]) // seg_rows),
                     dtype=np.int64) * seg_rows
    # the tile holding each cut's first row: the last t whose start is at
    # most row0 (none for rows before the first tile)
    tile = np.searchsorted(begin, row0, side="right") - 1
    held = tile >= 0
    row0, tile = row0[held], tile[held]
    b = np.maximum(row0, starts[tile] + seg_rows)
    e = np.minimum(row0 + seg_rows, starts[tile + 1])
    deep = np.stack([tile, b, e], axis=1)[b < e]
    return np.concatenate([first, deep])


def emulate_split(vb, starts, n_tiles, tile_w, body, seg_rows):
    """The kernel's two launches in plain PyTorch: lanes_counts_plain
    over each segment's rows, stored for a tile's first segment and
    added for the others."""
    per_row = tvl.BODIES[body][0]
    out = torch.full((8, n_tiles * tile_w), -1, dtype=torch.int32)
    for i, (t, b, e) in enumerate(lane_segments(starts, seg_rows)):
        got = tvl.lanes_counts_plain(
            vb[b:e], torch.zeros(e - b, dtype=torch.int32), 1, per_row,
            tile_w, body)
        cols = slice(t * tile_w, (t + 1) * tile_w)
        if i < n_tiles:
            out[:, cols] = got
        else:
            out[:, cols] += got
    return out
