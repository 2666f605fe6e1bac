"""Lane-aligned vote counting (counterpart of
polypolish_tpu/ops/vote_lanes.py).

Host layout ("lanes"): a tile is ``tile_w`` consecutive positions.  An
event at position p with dense vocab id v is stored as ONE byte (the
vocab id) at column ``p % tile_w`` of a row owned by tile
``p // tile_w``; a position's k-th event goes to the k-th row.  Empty
slots (and sparse-tier events) hold 255.  Rows come in blocks of
``r_sub``; ``block_tile`` maps each block to its tile, tiles in order.
The kernel input comes in three row layouts, named by the JAX kernel's
bodies:

- ``packed4``: int32 rows, four byte-rows each (byte k of int32 row q =
  byte-row 4q+k);
- ``packed`` and ``cmp``: the byte rows themselves, uint8 or int8 (the
  two TPU bodies differ only in how the TPU reduced them);
- ``packed8``: int32 rows, eight nibble-rows each (nibble k of row q =
  byte-row 8q+k, nibble 15 = pad).

``lanes_counts`` turns a pack into the (8, n_tiles*tile_w) int32
counts: on a CUDA tensor it launches the layout's entry point of the
hand-written kernel ``csrc/lanes_vote.cu``; on a CPU tensor it runs
``lanes_counts_plain``, the plain PyTorch version of the same function.
``overflow_counts`` adds a capped pack's overflow list into those
counts in place: the hand-written kernel ``csrc/overflow_vote.cu`` on
CUDA tensors, its plain version ``add_overflow_counts`` on CPU tensors.
Counts are exact integer sums, so all are bitwise equal to the host
fold.

The packers here are numpy copies of the JAX package's
(``prepare_lanes``, ``choose_rows_per_tile``, ``geom_pad``,
``_pad_block_count``, ``to_packed4``, ``to_packed8``); the native C++
twin is ``pp_lanes_from_runs`` (native/runs.py ``ParsedRuns.lanes``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from polypolish_tpu_torch.ops import launch_count
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


def to_packed8(vb: np.ndarray, r_sub: int) -> np.ndarray:
    """Reorder a (rows, tile_w) uint8 lane buffer into the packed8
    NIBBLE layout: int32 (rows//8, tile_w) with 4-bit field k of each
    lane = row 8q+k (dense vocab 0-7; any byte >= 8 — pad or
    sparse-tier — maps to nibble 15, which counts nothing, like bytes
    >= 8).  Counts are row-order-invariant, so this is bitwise-neutral;
    the pack halves to about 0.5 B/event."""
    rows, w = vb.shape
    if rows % 8 or r_sub % 8:
        raise ValueError(f"rows {rows} and r_sub {r_sub} must be multiples "
                         "of 8")
    nib = np.where(vb < DENSE_V, vb, 15).astype(np.uint32)
    x = nib.reshape(rows // 8, 8, w)
    out = np.zeros((rows // 8, w), np.uint32)
    for k in range(8):
        out |= x[:, k, :] << np.uint32(4 * k)
    return out.view(np.int32)


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


# body -> (byte-rows per array row, entry point of csrc/lanes_vote.cu)
BODIES = {
    "packed4": (4, "lanes_vote_packed4"),
    "packed": (1, "lanes_vote_bytes"),
    "cmp": (1, "lanes_vote_bytes"),
    "packed8": (8, "lanes_vote_packed8"),
}


def _rows_per_block(r_sub: int, body: str) -> int:
    """Array rows per block: r_sub byte-rows, except the packed4 (four
    byte-rows per int32 row) and packed8 (eight nibble-rows per int32
    row) layouts."""
    if body not in BODIES:
        raise ValueError(f"unknown lanes body {body!r}; expected one of "
                         f"{sorted(BODIES)}")
    per_row = BODIES[body][0]
    if r_sub % per_row:
        raise ValueError(f"body {body} needs r_sub % {per_row} == 0; got "
                         f"r_sub={r_sub}")
    return r_sub // per_row


def _check_lanes_args(vb: torch.Tensor, block_tile: torch.Tensor,
                      n_tiles: int, r_sub: int, tile_w: int,
                      body: str) -> None:
    rpb = _rows_per_block(r_sub, body)
    dtypes = ((torch.uint8, torch.int8) if BODIES[body][0] == 1
              else (torch.int32,))
    if vb.dtype not in dtypes or vb.dim() != 2 or vb.shape[1] != tile_w:
        raise ValueError(f"body {body}: vb must be {dtypes} (rows, "
                         f"{tile_w}); got {vb.dtype} {tuple(vb.shape)}")
    if block_tile.dtype != torch.int32 or block_tile.dim() != 1:
        raise ValueError("block_tile must be a 1-D int32 tensor")
    if tile_w % 128 or n_tiles < 1:
        raise ValueError(f"bad geometry r_sub={r_sub} tile_w={tile_w} "
                         f"n_tiles={n_tiles}")
    if vb.shape[0] != block_tile.shape[0] * rpb:
        raise ValueError(f"vb has {vb.shape[0]} rows for "
                         f"{block_tile.shape[0]} blocks of {rpb}")
    if vb.device != block_tile.device:
        raise ValueError("vb and block_tile must be on one device")
    if not (vb.is_contiguous() and block_tile.is_contiguous()):
        raise ValueError("vb and block_tile must be contiguous")


def _slots(x: torch.Tensor, body: str) -> torch.Tensor:
    """(m, w) array rows -> (m, w, slots) int32 slot values of the
    body's layout (bytes read unsigned, nibbles 0-15)."""
    if BODIES[body][0] == 1:
        return x.view(torch.uint8).to(torch.int32)[:, :, None]
    bits = 32 // BODIES[body][0]
    shifts = torch.arange(0, 32, bits, dtype=torch.int32, device=x.device)
    return (x[:, :, None] >> shifts) & ((1 << bits) - 1)


def lanes_counts_plain(vb: torch.Tensor, block_tile: torch.Tensor,
                       n_tiles: int, r_sub: int = R_SUB,
                       tile_w: int = TILE_W,
                       body: str = "packed4") -> torch.Tensor:
    """Plain PyTorch version of the lanes vote kernel: unpack the slots
    of every array row, drop values >= 8, and accumulate ones at
    (v, tile*tile_w + column) with index_put_.  Works in steps of rows
    to bound its temporaries."""
    _check_lanes_args(vb, block_tile, n_tiles, r_sub, tile_w, body)
    dev = vb.device
    width = n_tiles * tile_w
    out = torch.zeros(DENSE_V * width, dtype=torch.int32, device=dev)
    if block_tile.numel() and (int(block_tile.min()) < 0
                               or int(block_tile.max()) >= n_tiles):
        raise ValueError("block_tile entries must lie in [0, n_tiles)")
    rpb = _rows_per_block(r_sub, body)
    row_base = block_tile.to(torch.int64).repeat_interleave(rpb) * tile_w
    cols = torch.arange(tile_w, dtype=torch.int64, device=dev)
    step = max(1, _PLAIN_WORDS // tile_w)
    for r0 in range(0, vb.shape[0], step):
        b = _slots(vb[r0:r0 + step], body)  # (m, tile_w, slots)
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
        for name in sorted({entry for _, entry in BODIES.values()}):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        _kernel_lib = lib
    return _kernel_lib


def tile_row_start(block_tile: np.ndarray, n_tiles: int,
                   rows_per_block: int) -> np.ndarray:
    """(n_tiles + 1,) int64 first array row of each tile (and the row
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
                 r_sub: int = R_SUB, tile_w: int = TILE_W,
                 body: str = "packed4",
                 block_tile_host: Optional[np.ndarray] = None
                 ) -> torch.Tensor:
    """(8, n_tiles*tile_w) int32 vote counts of a lane pack.

    vb: (n_blocks*r_sub/s, tile_w) rows of the body's layout (s = 4 and
    int32 for packed4, 1 and uint8/int8 for packed and cmp, 8 and int32
    for packed8); block_tile: int32 (n_blocks,), non-decreasing, on the
    same device.  A CUDA tensor launches the body's entry point of the
    lanes vote kernel (csrc/lanes_vote.cu) on the current stream (packed4
    and byte rows: two kernels over a split of each tile's rows); a CPU
    tensor runs lanes_counts_plain.  The launch builds its tile prefix
    on the host from ``block_tile_host``, the host array that block_tile
    was uploaded from, where the caller has it; without it, from a copy
    of block_tile read back from the card, which waits for the stream.
    ``lanes_counts.launches`` counts entry-point launches (one per call)
    by entry point."""
    if vb.device.type == "cpu":
        return lanes_counts_plain(vb, block_tile, n_tiles, r_sub, tile_w,
                                  body)
    if vb.device.type != "cuda":
        raise ValueError(f"lanes_counts: unsupported device {vb.device}")
    _check_lanes_args(vb, block_tile, n_tiles, r_sub, tile_w, body)
    if vb.data_ptr() % 16:
        # the packed4 and byte kernels read rows in 16-byte pieces: a
        # view that starts mid-row is copied to a fresh (aligned) buffer
        vb = vb.clone()
    if block_tile_host is None:
        block_tile_host = block_tile.cpu().numpy()
    elif np.shape(block_tile_host) != tuple(block_tile.shape):
        raise ValueError(f"block_tile_host has shape "
                         f"{np.shape(block_tile_host)}, block_tile "
                         f"{tuple(block_tile.shape)}")
    starts = tile_row_start(block_tile_host, n_tiles,
                            _rows_per_block(r_sub, body))
    d_starts = torch.from_numpy(starts).to(vb.device)
    out = torch.empty((DENSE_V, n_tiles * tile_w), dtype=torch.int32,
                      device=vb.device)
    entry = BODIES[body][1]
    fn = getattr(_kernel(), entry)
    with torch.cuda.device(vb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vb.data_ptr(), d_starts.data_ptr(), out.data_ptr(),
                 n_tiles, tile_w, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    launch_count.bump(lanes_counts, entry)
    return out


lanes_counts.launches = collections.Counter()


def add_overflow_counts(counts: torch.Tensor, ov_pos, ov_vid
                        ) -> torch.Tensor:
    """Plain PyTorch version of the overflow vote kernel: add the
    depth-stratified overflow events (vocab bytes at positions whose
    depth exceeded the tile's row cap; numpy arrays or tensors) onto
    the kernel counts, in place, with one ``index_put_``.  Exact
    integer adds, bitwise-equal to having packed them into lane slots.
    Pad/sparse entries (vid >= 8 or pos outside [-P, P)) drop; a pos in
    [-P, 0) wraps, as JAX's mode='drop' scatter does.  A numpy array's
    upload is from pageable memory (it has finished when this returns,
    so the arrays may alias native memory that is freed next), and the
    drop's boolean compaction waits for the device."""
    from polypolish_tpu_torch.ops.vote import scatter_add_drop

    dev = counts.device
    vid, pos = (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
                for a in (ov_vid, ov_pos))
    return scatter_add_drop(counts, vid.to(dev), pos.to(dev))


def _check_overflow_args(counts: torch.Tensor, ov_pos: torch.Tensor,
                         ov_vid: torch.Tensor) -> None:
    if (counts.dtype != torch.int32 or counts.dim() != 2
            or counts.shape[0] != DENSE_V or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous int32 "
                         f"({DENSE_V}, width) tensor; got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if (ov_pos.dtype != torch.int32 or ov_vid.dtype != torch.uint8
            or ov_pos.dim() != 1 or ov_pos.shape != ov_vid.shape):
        raise ValueError(f"ov_pos and ov_vid must be int32 and uint8 of "
                         f"one length; got {ov_pos.dtype} "
                         f"{tuple(ov_pos.shape)}, {ov_vid.dtype} "
                         f"{tuple(ov_vid.shape)}")
    if not counts.device == ov_pos.device == ov_vid.device:
        raise ValueError("counts, ov_pos and ov_vid must be on one device")
    if not (ov_pos.is_contiguous() and ov_vid.is_contiguous()):
        raise ValueError("ov_pos and ov_vid must be contiguous")


_overflow_lib: Optional[ctypes.CDLL] = None


def _overflow_kernel() -> ctypes.CDLL:
    global _overflow_lib
    if _overflow_lib is None:
        from polypolish_tpu_torch import _build

        lib = _build.load("overflow_vote")
        lib.overflow_vote.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.overflow_vote.restype = ctypes.c_int
        lib.overflow_vote_grid_events.argtypes = []
        lib.overflow_vote_grid_events.restype = ctypes.c_int64
        _overflow_lib = lib
    return _overflow_lib


def overflow_counts(counts: torch.Tensor, ov_pos: torch.Tensor,
                    ov_vid: torch.Tensor) -> torch.Tensor:
    """Add a capped pack's overflow list into its counts, in place, and
    return counts: ``counts[vid, pos] += 1`` per event, dropping vid >= 8
    and pos outside [-P, P) (a pos in [-P, 0) wraps), as the JAX
    package's overflow fold does.

    counts: contiguous int32 (8, P), kernel A's output; ov_pos int32 and
    ov_vid uint8, 1-D, as the packers emit them (sorted by (pos, vid);
    any order counts the same), on counts' device.  CUDA tensors launch
    the overflow vote kernel (csrc/overflow_vote.cu) on the current
    stream, with no sync; CPU tensors run add_overflow_counts.
    ``overflow_counts.launches`` counts kernel launches (none for an
    empty list)."""
    _check_overflow_args(counts, ov_pos, ov_vid)
    if counts.device.type == "cpu":
        return add_overflow_counts(counts, ov_pos, ov_vid)
    if counts.device.type != "cuda":
        raise ValueError(f"overflow_counts: unsupported device "
                         f"{counts.device}")
    n = ov_pos.shape[0]
    if n == 0:
        return counts
    # the kernel reads 16-byte vectors: a view that starts mid-vector is
    # copied to a fresh (aligned) buffer
    if ov_pos.data_ptr() % 16:
        ov_pos = ov_pos.clone()
    if ov_vid.data_ptr() % 16:
        ov_vid = ov_vid.clone()
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _overflow_kernel().overflow_vote(
            ov_pos.data_ptr(), ov_vid.data_ptr(), n, counts.data_ptr(),
            counts.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"overflow_vote launch failed: CUDA error {err}")
    launch_count.bump(overflow_counts)
    return counts


overflow_counts.launches = 0


def dense_counts_lanes(
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    r_sub: int = R_SUB,
    tile_w: int = TILE_W,
    body: str = "packed",
    cap: bool = False,
    device="cuda",
) -> torch.Tensor:
    """(8, P) int32 dense vote counts on ``device`` through the lanes
    vote kernel with the given body's layout.  cap=True uses the
    depth-stratified layout and adds the overflow events back with
    overflow_counts."""
    _rows_per_block(r_sub, body)
    packed = prepare_lanes(pos, vocab, num_positions, r_sub, tile_w,
                           cap=cap)
    vb, block_tile, n_tiles = packed[:3]
    if body == "packed4":
        vb = to_packed4(vb, r_sub)
    elif body == "packed8":
        vb = to_packed8(vb, r_sub)
    out = lanes_counts(torch.from_numpy(vb).to(device),
                       torch.from_numpy(block_tile).to(device), n_tiles,
                       r_sub, tile_w, body)
    if cap and packed[3].size:
        overflow_counts(out, *(torch.from_numpy(a).to(out.device)
                               for a in packed[3:5]))
    return out[:, :num_positions]
