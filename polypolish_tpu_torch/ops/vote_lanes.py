"""Lane-aligned vote counting (counterpart of
polypolish_tpu/ops/vote_lanes.py).

Host layout ("lanes"): a tile is ``tile_w`` consecutive positions.  An
event at position p with dense vocab id v is stored as ONE byte (the
vocab id) at column ``p % tile_w`` of a row owned by tile
``p // tile_w``; a position's k-th event goes to the k-th row.  Empty
slots (and sparse-tier events) hold 255.  Rows come in blocks of
``r_sub``; ``block_tile`` maps each block to its tile, tiles in order.
The packed4 layout stores four byte-rows per int32 row (byte k of int32
row q = byte-row 4q+k), the input of the lanes vote kernel.

``lanes_counts`` turns a packed4 pack into the (8, n_tiles*tile_w)
int32 counts: on a CUDA tensor it launches the hand-written kernel
``csrc/lanes_vote.cu``; on a CPU tensor it runs ``lanes_counts_plain``,
the plain PyTorch version of the same function.  Counts are exact
integer sums, so both are bitwise equal to the host fold.

The packers here are numpy copies of the JAX package's
(``prepare_lanes``, ``choose_rows_per_tile``, ``geom_pad``,
``_pad_block_count``, ``to_packed4``); the native C++ twin is
``pp_lanes_from_runs`` (native/runs.py ``ParsedRuns.lanes``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from polypolish_tpu_torch.vocab import DENSE_V

TILE_W = 2048  # positions per tile
R_SUB = 32  # byte-rows per block
PAD_BYTE = 255  # empty slot / sparse-tier marker (== native overflow byte)
# Block streams longer than this are rounded to a multiple of it by the
# packers (the JAX kernel's slab contract; this kernel takes any count).
MAX_BLOCKS_PER_CALL = 32768
# Cost weight of routing one event through the overflow list instead of
# a lane slot, in slot-equivalents (the depth-stratified row-cap policy;
# sam_packer.cc pick_capped_rows reproduces it exactly).
OVERFLOW_WEIGHT = 64

# int32 words per step of the plain version (bounds its temporaries)
_PLAIN_WORDS = 1 << 22


def geom_pad(n: int, bits: int = 3, minimum: int = 8,
             slab: Optional[int] = None) -> int:
    """Round ``n`` up to a geometric bucket (<= 2^-bits relative
    padding); with ``slab`` set, sizes past one slab additionally round
    to a slab multiple.  The packers' padding formula; the C++ twins in
    sam_packer.cc mirror it."""
    n = max(int(n), minimum)
    shift = max(n.bit_length() - 1 - bits, 0)
    step = 1 << shift
    padded = -(-n // step) * step
    if slab is not None and padded > slab:
        padded = -(-padded // slab) * slab
    return padded


def _pad_block_count(vb: np.ndarray, block_tile: np.ndarray, n_tiles: int,
                     r_sub: int, tile_w: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Geometric block-count padding + slab rounding.  Pad blocks are
    all-255 rows mapped to the last tile."""
    n_blocks = block_tile.shape[0]
    padded = geom_pad(n_blocks, slab=MAX_BLOCKS_PER_CALL)
    if padded == n_blocks:
        return vb, block_tile
    extra = padded - n_blocks
    pad_vb = np.full((extra * r_sub, tile_w), PAD_BYTE, dtype=np.uint8)
    pad_tile = np.full(extra, n_tiles - 1, dtype=np.int32)
    return (np.concatenate([vb, pad_vb]),
            np.concatenate([block_tile, pad_tile]))


def choose_rows_per_tile(
    depth: np.ndarray, n_tiles: int, tile_w: int, r_sub: int,
    cap: bool = False,
) -> np.ndarray:
    """Rows allocated per tile.  cap=False: ceil(max_depth/r_sub)*r_sub.
    cap=True: depth-stratified — per tile, the row count C (multiple of
    r_sub) minimising C*tile_w + OVERFLOW_WEIGHT * sum(max(0, d_p - C));
    events above C at a position go to the overflow list."""
    d2 = depth.reshape(n_tiles, tile_w)
    max_per_tile = d2.max(axis=1)
    rows = np.maximum(
        r_sub, -(-max_per_tile // r_sub) * r_sub
    ).astype(np.int64)
    if not cap:
        return rows
    for t in np.nonzero(max_per_tile > r_sub)[0]:
        d = np.sort(d2[t])
        total = int(d.sum())
        prefix = np.concatenate(([0], np.cumsum(d)))
        r0 = int(rows[t])
        best_cost = r0 * tile_w  # overflow 0 at the exact max
        best_c = r0
        c = r0 - r_sub
        while c >= r_sub:
            i = int(np.searchsorted(d, c, side="right"))
            m = d.shape[0] - i  # positions with depth > c
            ov = (total - int(prefix[i])) - c * m
            cost = c * tile_w + OVERFLOW_WEIGHT * ov
            if cost < best_cost:
                best_cost = cost
                best_c = c
            c -= r_sub
        rows[t] = best_c
    return rows


def prepare_lanes(
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    r_sub: int = R_SUB,
    tile_w: int = TILE_W,
    cap: bool = False,
):
    """Pack events into the lane-aligned layout (numpy packer; the
    native twin is pp_lanes_from_runs).

    Returns (vb (n_blocks*r_sub, tile_w) uint8, block_tile (n_blocks,)
    int32, n_tiles).  Sparse-tier / out-of-range events are dropped.
    With cap=True two extra arrays are returned — (ov_pos int32, ov_vid
    uint8), sorted by (pos, vid) — the events above each tile's row cap.
    """
    if tile_w % 128 or r_sub % 8:
        raise ValueError(f"tile_w {tile_w} % 128 and r_sub {r_sub} % 8 "
                         "must be 0")
    n_tiles = max(1, -(-num_positions // tile_w))
    mask = (vocab >= 0) & (vocab < DENSE_V) & (pos >= 0) & (pos < num_positions)
    pos = np.asarray(pos[mask], dtype=np.int64)
    vocab = np.asarray(vocab[mask], dtype=np.uint8)

    depth = np.bincount(pos, minlength=n_tiles * tile_w).astype(np.int64)
    rows_per_tile = choose_rows_per_tile(
        depth, n_tiles, tile_w, r_sub, cap=cap
    )
    row_base = np.concatenate(([0], np.cumsum(rows_per_tile)))[:-1]
    total_rows = int(rows_per_tile.sum())

    # occurrence index of each event within its position (stable sort;
    # int32 keys take numpy's radix sort, safe while pos < 2^31)
    if num_positions <= 2**31:
        order = np.argsort(pos.astype(np.int32), kind="stable")
    else:  # pragma: no cover - no real genome is this long
        order = np.argsort(pos, kind="stable")
    spos = pos[order]
    pos_start = np.concatenate(([0], np.cumsum(depth)))
    occ = np.arange(spos.size, dtype=np.int64) - pos_start[spos]

    vb = np.full((total_rows, tile_w), PAD_BYTE, dtype=np.uint8)
    tile = spos // tile_w
    svocab = vocab[order]
    if cap:
        keep = occ < rows_per_tile[tile]
        row = row_base[tile[keep]] + occ[keep]
        vb[row, spos[keep] % tile_w] = svocab[keep]
        ovm = ~keep
        ov_pos = spos[ovm].astype(np.int32)
        ov_vid = svocab[ovm]
        o = np.lexsort((ov_vid, ov_pos))  # deterministic (pos, vid)
        ov_pos, ov_vid = ov_pos[o], ov_vid[o]
    else:
        row = row_base[tile] + occ
        vb[row, spos % tile_w] = svocab

    block_tile = np.repeat(
        np.arange(n_tiles, dtype=np.int32),
        (rows_per_tile // r_sub).astype(np.int64),
    )
    vb, block_tile = _pad_block_count(vb, block_tile, n_tiles, r_sub, tile_w)
    if cap:
        return vb, block_tile, n_tiles, ov_pos, ov_vid
    return vb, block_tile, n_tiles


def to_packed4(vb: np.ndarray, r_sub: int) -> np.ndarray:
    """Reorder a (rows, tile_w) uint8 lane buffer into the packed4
    layout: int32 (rows//4, tile_w) with byte k of each lane = row
    4q+k (little-endian).  Counts are row-order-invariant, so this is
    bitwise-neutral."""
    rows, w = vb.shape
    if rows % 4 or r_sub % 4:
        raise ValueError(f"rows {rows} and r_sub {r_sub} must be multiples "
                         "of 4")
    x = vb.reshape(rows // 4, 4, w).transpose(0, 2, 1)
    return np.ascontiguousarray(x).view(np.int32).reshape(rows // 4, w)


def _check_lanes_args(vb: torch.Tensor, block_tile: torch.Tensor,
                      n_tiles: int, r_sub: int, tile_w: int) -> None:
    if vb.dtype != torch.int32 or vb.dim() != 2 or vb.shape[1] != tile_w:
        raise ValueError(f"vb must be int32 (rows, {tile_w}); got "
                         f"{vb.dtype} {tuple(vb.shape)}")
    if block_tile.dtype != torch.int32 or block_tile.dim() != 1:
        raise ValueError("block_tile must be a 1-D int32 tensor")
    if r_sub % 4 or tile_w % 128 or n_tiles < 1:
        raise ValueError(f"bad geometry r_sub={r_sub} tile_w={tile_w} "
                         f"n_tiles={n_tiles}")
    if vb.shape[0] != block_tile.shape[0] * (r_sub // 4):
        raise ValueError(f"vb has {vb.shape[0]} rows for "
                         f"{block_tile.shape[0]} blocks of {r_sub // 4}")
    if vb.device != block_tile.device:
        raise ValueError("vb and block_tile must be on one device")
    if not (vb.is_contiguous() and block_tile.is_contiguous()):
        raise ValueError("vb and block_tile must be contiguous")


def lanes_counts_plain(vb: torch.Tensor, block_tile: torch.Tensor,
                       n_tiles: int, r_sub: int = R_SUB,
                       tile_w: int = TILE_W) -> torch.Tensor:
    """Plain PyTorch version of the lanes vote kernel: unpack the four
    bytes of every int32 slot, drop bytes >= 8, and accumulate ones at
    (v, tile*tile_w + column) with index_put_.  Works in steps of
    rows to bound its temporaries."""
    _check_lanes_args(vb, block_tile, n_tiles, r_sub, tile_w)
    dev = vb.device
    width = n_tiles * tile_w
    out = torch.zeros(DENSE_V * width, dtype=torch.int32, device=dev)
    if block_tile.numel() and (int(block_tile.min()) < 0
                               or int(block_tile.max()) >= n_tiles):
        raise ValueError("block_tile entries must lie in [0, n_tiles)")
    row_base = block_tile.to(torch.int64).repeat_interleave(r_sub // 4)
    row_base *= tile_w
    cols = torch.arange(tile_w, dtype=torch.int64, device=dev)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_WORDS // tile_w)
    for r0 in range(0, vb.shape[0], step):
        x = vb[r0:r0 + step]
        b = (x[:, :, None] >> shifts) & 0xFF  # (m, tile_w, 4) bytes
        slot = row_base[r0:r0 + step, None] + cols[None, :]
        keys = b.to(torch.int64) * width + slot[:, :, None]
        keys = keys[b < DENSE_V]
        out.index_put_((keys,), torch.ones_like(keys, dtype=torch.int32),
                       accumulate=True)
    return out.view(DENSE_V, width)


_kernel_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _kernel_lib
    if _kernel_lib is None:
        from polypolish_tpu_torch import _build

        lib = _build.load("lanes_vote")
        lib.lanes_vote_packed4.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lanes_vote_packed4.restype = ctypes.c_int
        _kernel_lib = lib
    return _kernel_lib


def tile_row_start(block_tile: np.ndarray, n_tiles: int,
                   rows_per_block: int) -> np.ndarray:
    """(n_tiles + 1,) int64 first int32 row of each tile (and the row
    count at the end) from a non-decreasing block->tile map; raises if
    the map is out of order or out of range."""
    bt = np.asarray(block_tile)
    if bt.size and (bt.min() < 0 or bt.max() >= n_tiles):
        raise ValueError("block_tile entries must lie in [0, n_tiles)")
    if np.any(np.diff(bt) < 0):
        raise ValueError("block_tile must be non-decreasing (the packers "
                         "emit tiles in order)")
    starts = np.searchsorted(bt, np.arange(n_tiles + 1), side="left")
    return starts.astype(np.int64) * rows_per_block


def lanes_counts(vb: torch.Tensor, block_tile: torch.Tensor, n_tiles: int,
                 r_sub: int = R_SUB, tile_w: int = TILE_W) -> torch.Tensor:
    """(8, n_tiles*tile_w) int32 vote counts of a packed4 lane pack.

    vb: int32 (n_blocks*r_sub/4, tile_w); block_tile: int32 (n_blocks,),
    non-decreasing, on the same device.  A CUDA tensor launches the
    lanes vote kernel (csrc/lanes_vote.cu) on the current stream; a CPU
    tensor runs lanes_counts_plain.  ``lanes_counts.launches`` counts
    kernel launches."""
    if vb.device.type == "cpu":
        return lanes_counts_plain(vb, block_tile, n_tiles, r_sub, tile_w)
    if vb.device.type != "cuda":
        raise ValueError(f"lanes_counts: unsupported device {vb.device}")
    _check_lanes_args(vb, block_tile, n_tiles, r_sub, tile_w)
    starts = tile_row_start(block_tile.cpu().numpy(), n_tiles, r_sub // 4)
    d_starts = torch.from_numpy(starts).to(vb.device)
    out = torch.empty((DENSE_V, n_tiles * tile_w), dtype=torch.int32,
                      device=vb.device)
    lib = _kernel()
    with torch.cuda.device(vb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lanes_vote_packed4(
            vb.data_ptr(), d_starts.data_ptr(), out.data_ptr(), n_tiles,
            tile_w, stream,
        )
    if err != 0:
        raise RuntimeError(f"lanes_vote_packed4 launch failed: CUDA error "
                           f"{err}")
    lanes_counts.launches += 1
    return out


lanes_counts.launches = 0
