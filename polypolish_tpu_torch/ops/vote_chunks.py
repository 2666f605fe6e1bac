"""Chunk-layout vote counting (counterpart of
polypolish_tpu/ops/vote_pallas.py; renamed because the port has no
Pallas).

Host layout ("chunks"): dense-tier events (position, vocab id) are
bucketed by position tile (``tile_p`` positions per tile) and padded to
fixed-size chunks of ``e_sub*128`` events, each chunk owned by one tile
(``chunk_tile``), tiles in order, every tile at least one chunk (the
packers' layout; ``chunk_counts`` relies only on the order).  Pad
events carry position -1 (int32 layout, ``prepare_chunks``) or vocab 255
(uint8 layout, ``ParsedRuns.chunks``).

``chunk_counts`` turns a chunk stream into the (8, n_tiles*tile_p) int32
counts: on CUDA tensors it launches the hand-written kernel
``csrc/chunk_vote.cu``; on CPU tensors it runs ``chunk_counts_plain``,
the plain PyTorch version of the same function.  It counts the whole
pileup on the mxu polish path, the event path and in
``dense_counts_chunks``; the lanes path's cap-overflow list goes to the
overflow vote kernel (``vote_lanes.overflow_counts``).  The JAX package's
three kernel variants (``split``, ``fused``, ``unfused``) lay this one
function onto the TPU's matrix unit in three ways; one Hopper kernel
serves all three.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch

from polypolish_tpu_torch.ops import launch_count
from polypolish_tpu_torch.vocab import DENSE_V

TILE_P = 256  # positions per output tile
E_SUB = 8  # event rows per chunk
E_LANE = 128  # events per row
E_B = E_SUB * E_LANE  # events per chunk
# Chunk streams longer than this are rounded to a multiple of it by the
# packers (the JAX kernel's slab contract; this kernel takes any count).
MAX_CHUNKS_PER_CALL = 32768
MAX_TILE_P = 2048  # the kernel's histogram: 32 * tile_p bytes of smem
VARIANTS = ("unfused", "fused", "split")


def _variant_name(fused) -> str:
    """``fused`` accepts the legacy bools (False/True) or a variant name
    ('unfused' | 'fused' | 'split')."""
    if fused is True:
        return "fused"
    if fused is False:
        return "unfused"
    if fused in VARIANTS:
        return fused
    raise ValueError(f"unknown kernel variant: {fused!r}")


def prepare_chunks(
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    tile_p: int = TILE_P,
    e_sub: int = E_SUB,
    use_native: bool = True,
    chunk_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Bucket dense-tier events by position tile and pad to chunks.

    Returns (chunk_pos (C*e_sub, 128) int32, chunk_vocab likewise,
    chunk_tile (C,) int32, n_tiles).  use_native takes the C++
    counting sort (layout-identical to the numpy version below).
    chunk_multiple rounds each tile's chunk count up to this multiple
    (required by chunk_counts' chunks_per_step; numpy packer only)."""
    if chunk_multiple > 1:
        use_native = False
    if use_native:
        from polypolish_tpu_torch.native import binding

        return _pad_chunk_count(
            *binding.prepare_chunks_native(
                np.ascontiguousarray(pos, dtype=np.int64),
                np.ascontiguousarray(vocab, dtype=np.int32),
                num_positions, tile_p, e_sub,
            ),
            e_sub=e_sub,
        )
    e_b = e_sub * E_LANE
    mask = (vocab >= 0) & (vocab < DENSE_V) & (pos >= 0) & (pos < num_positions)
    pos = np.asarray(pos[mask], dtype=np.int64)
    vocab = np.asarray(vocab[mask], dtype=np.int32)
    n_tiles = max(1, -(-num_positions // tile_p))

    # int32 keys get numpy's radix sort (stable, O(n))
    tile32 = (pos // tile_p).astype(np.int32)
    order = np.argsort(tile32, kind="stable")
    pos = pos[order]
    vocab = vocab[order]
    tile = tile32[order].astype(np.int64)

    per_tile = np.bincount(tile, minlength=n_tiles)
    chunks_per_tile = np.maximum(1, -(-per_tile // e_b))
    if chunk_multiple > 1:
        k = chunk_multiple
        chunks_per_tile = (-(-chunks_per_tile // k)) * k
    n_chunks = int(chunks_per_tile.sum())

    flat_pos = np.full(n_chunks * e_b, -1, dtype=np.int32)
    flat_vocab = np.zeros(n_chunks * e_b, dtype=np.int32)
    chunk_tile = np.repeat(np.arange(n_tiles, dtype=np.int32), chunks_per_tile)

    # slot offset of each tile's first chunk, in flattened event slots
    chunk_start = np.concatenate(([0], np.cumsum(chunks_per_tile)))[:-1]
    tile_event_start = np.concatenate(([0], np.cumsum(per_tile)))[:-1]
    within_tile = np.arange(pos.size) - tile_event_start[tile]
    dst = chunk_start[tile] * e_b + within_tile
    flat_pos[dst] = (pos - tile * tile_p).astype(np.int32)
    flat_vocab[dst] = vocab
    chunk_pos = flat_pos.reshape(n_chunks * e_sub, E_LANE)
    chunk_vocab = flat_vocab.reshape(n_chunks * e_sub, E_LANE)
    return _pad_chunk_count(chunk_pos, chunk_vocab, chunk_tile, n_tiles,
                            e_sub=e_sub, multiple=chunk_multiple)


def _pad_chunk_count(chunk_pos, chunk_vocab, chunk_tile, n_tiles, e_sub,
                     multiple: int = 1):
    """Round the chunk count up to a geometric bucket (<= 12.5% extra),
    then to ``multiple``, and past MAX_CHUNKS_PER_CALL to a multiple of
    it.  Pad chunks carry only pad events (pos -1) and map to the last
    tile."""
    n_chunks = chunk_tile.shape[0]
    n = max(int(n_chunks), 8)
    shift = max(n.bit_length() - 1 - 3, 0)
    step = 1 << shift
    padded = -(-n // step) * step
    if multiple > 1:
        padded = -(-padded // multiple) * multiple
    if padded > MAX_CHUNKS_PER_CALL:
        padded = -(-padded // MAX_CHUNKS_PER_CALL) * MAX_CHUNKS_PER_CALL
    if padded == n_chunks:
        return chunk_pos, chunk_vocab, chunk_tile, n_tiles
    extra = padded - n_chunks
    pad_pos = np.full((extra * e_sub, E_LANE), -1, dtype=np.int32)
    pad_vocab = np.zeros((extra * e_sub, E_LANE), dtype=np.int32)
    pad_tile = np.full(extra, n_tiles - 1, dtype=np.int32)
    return (
        np.concatenate([chunk_pos, pad_pos]),
        np.concatenate([chunk_vocab, pad_vocab]),
        np.concatenate([chunk_tile, pad_tile]),
        n_tiles,
    )


def _check_chunk_args(chunk_pos: torch.Tensor, chunk_vocab: torch.Tensor,
                      chunk_tile: torch.Tensor, n_tiles: int, tile_p: int,
                      e_sub: int) -> None:
    if chunk_pos.dtype not in (torch.int32, torch.uint8) \
            or chunk_vocab.dtype != chunk_pos.dtype:
        raise ValueError("chunk_pos and chunk_vocab must both be int32 "
                         "or both uint8")
    if tile_p < E_LANE or tile_p % E_LANE or tile_p > MAX_TILE_P:
        raise ValueError(f"tile_p must be a multiple of {E_LANE} up to "
                         f"{MAX_TILE_P}; got {tile_p}")
    if chunk_pos.dtype == torch.uint8 and tile_p > 256:
        raise ValueError(f"the uint8 layout holds tile_p <= 256; got "
                         f"{tile_p}")
    if e_sub < 1:
        raise ValueError(f"e_sub must be >= 1; got {e_sub}")
    n_chunks = chunk_tile.shape[0]
    want = (n_chunks * e_sub, E_LANE)
    if tuple(chunk_pos.shape) != want or tuple(chunk_vocab.shape) != want:
        raise ValueError(f"chunk arrays must be {want}; got "
                         f"{tuple(chunk_pos.shape)}, "
                         f"{tuple(chunk_vocab.shape)}")
    if chunk_tile.dtype != torch.int32 or chunk_tile.dim() != 1:
        raise ValueError("chunk_tile must be a 1-D int32 tensor")
    if n_tiles < 1:
        raise ValueError(f"n_tiles must be >= 1; got {n_tiles}")
    if not (chunk_pos.device == chunk_vocab.device == chunk_tile.device):
        raise ValueError("chunk tensors must be on one device")
    if not (chunk_pos.is_contiguous() and chunk_vocab.is_contiguous()
            and chunk_tile.is_contiguous()):
        raise ValueError("chunk tensors must be contiguous")


def _check_steps(chunk_tile: torch.Tensor, chunks_per_step: int) -> None:
    """JAX's chunks_per_step contract: the chunk count is a multiple of
    k and each run of k chunks shares one tile (prepare_chunks with
    chunk_multiple=k gives both)."""
    k = chunks_per_step
    if k < 1:
        raise ValueError(f"chunks_per_step must be >= 1; got {k}")
    if k == 1:
        return
    n = chunk_tile.shape[0]
    if n % k:
        raise ValueError(f"{n} chunks are not a multiple of "
                         f"chunks_per_step={k}")
    steps = chunk_tile.view(n // k, k)
    if not bool((steps == steps[:, :1]).all()):
        raise ValueError(f"a step of chunks_per_step={k} chunks straddles "
                         "a tile boundary; pad each tile's chunks with "
                         f"prepare_chunks(chunk_multiple={k})")


def chunk_counts_plain(chunk_pos: torch.Tensor, chunk_vocab: torch.Tensor,
                       chunk_tile: torch.Tensor, n_tiles: int,
                       tile_p: int = TILE_P,
                       e_sub: int = E_SUB) -> torch.Tensor:
    """Plain PyTorch version of the chunk vote kernel: mask pad events
    (pos outside [0, tile_p), vocab outside [0, 8), tile outside
    [0, n_tiles)) and accumulate ones at (v, tile*tile_p + pos) with
    index_put_."""
    _check_chunk_args(chunk_pos, chunk_vocab, chunk_tile, n_tiles, tile_p,
                      e_sub)
    width = n_tiles * tile_p
    out = torch.zeros(DENSE_V * width, dtype=torch.int32,
                      device=chunk_pos.device)
    e_b = e_sub * E_LANE
    pos = chunk_pos.reshape(-1, e_b).to(torch.int64)
    voc = chunk_vocab.reshape(-1, e_b).to(torch.int64)
    tile = chunk_tile.to(torch.int64)[:, None]
    keep = ((pos >= 0) & (pos < tile_p) & (voc >= 0) & (voc < DENSE_V)
            & (tile >= 0) & (tile < n_tiles))
    keys = (voc * width + tile * tile_p + pos)[keep]
    out.index_put_((keys,), torch.ones_like(keys, dtype=torch.int32),
                   accumulate=True)
    return out.view(DENSE_V, width)


_kernel_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _kernel_lib
    if _kernel_lib is None:
        from polypolish_tpu_torch import _build

        lib = _build.load("chunk_vote")
        for fn in (lib.chunk_vote_i32, lib.chunk_vote_u8):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        _kernel_lib = lib
    return _kernel_lib


_ORDER = ("chunk_tile must be non-decreasing: the chunk layout keeps "
          "tiles in order (prepare_chunks and ParsedRuns.chunks emit it so)")


def _check_tile_order(chunk_tile: torch.Tensor) -> None:
    """The chunk layout's contract that the chunk vote kernel relies on,
    as the TPU kernels do (they zero a tile on its first chunk): tiles
    in order."""
    if chunk_tile.numel() > 1 and bool((chunk_tile[1:] < chunk_tile[:-1])
                                       .any()):
        raise ValueError(_ORDER)


def tile_chunk_start(chunk_tile: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(n_tiles + 1,) int64 first chunk of each tile: tile t owns chunks
    [start[t], start[t + 1]); chunks whose tile lies outside
    [0, n_tiles) fall before start[0] or from start[n_tiles] on.  Raises
    if chunk_tile is not non-decreasing.  The plain PyTorch version of
    the prefix that the chunk vote kernel's launch builds on the card
    (``chunk_vote_launch`` returns it)."""
    _check_tile_order(chunk_tile)
    tiles = torch.arange(n_tiles + 1, dtype=torch.int32,
                         device=chunk_tile.device)
    return torch.searchsorted(chunk_tile, tiles)


def chunk_vote_launch(chunk_pos: torch.Tensor, chunk_vocab: torch.Tensor,
                      chunk_tile: torch.Tensor, n_tiles: int,
                      tile_p: int = TILE_P, e_sub: int = E_SUB
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the chunk vote kernel on CUDA tensors, checked by
    ``chunk_counts``, without waiting for it: (counts, plan), where
    plan[:n_tiles + 1] is the tile prefix and plan[n_tiles + 1] is 1 if
    chunk_tile is out of order (counts are then not written).  Counts
    one launch in ``chunk_counts.launches``."""
    if chunk_pos.data_ptr() % 16 or chunk_vocab.data_ptr() % 16:
        raise ValueError("chunk_pos and chunk_vocab must be 16-byte "
                         "aligned (the kernel reads 16-byte vectors)")
    dev = chunk_pos.device
    plan = torch.empty(n_tiles + 2, dtype=torch.int64, device=dev)
    out = torch.empty((DENSE_V, n_tiles * tile_p), dtype=torch.int32,
                      device=dev)
    lib = _kernel()
    fn = lib.chunk_vote_i32 if chunk_pos.dtype == torch.int32 \
        else lib.chunk_vote_u8
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(chunk_pos.data_ptr(), chunk_vocab.data_ptr(),
                 chunk_tile.data_ptr(), chunk_tile.shape[0], plan.data_ptr(),
                 out.data_ptr(), n_tiles, tile_p, e_sub, stream)
    if err != 0:
        raise RuntimeError(f"chunk_vote launch failed: CUDA error {err}")
    launch_count.bump(chunk_counts)
    return out, plan


def chunk_counts(chunk_pos: torch.Tensor, chunk_vocab: torch.Tensor,
                 chunk_tile: torch.Tensor, n_tiles: int,
                 tile_p: int = TILE_P, e_sub: int = E_SUB,
                 chunks_per_step: int = 1,
                 variant: Union[bool, str] = "split") -> torch.Tensor:
    """(8, n_tiles*tile_p) int32 vote counts of a chunk stream.

    chunk_pos / chunk_vocab: (C*e_sub, 128), both int32 (pad pos -1) or
    both uint8 (pad vocab 255, tile_p <= 256); chunk_tile: int32 (C,),
    non-decreasing (checked; raises otherwise); tile_p a multiple of 128
    up to 2048.  ``variant`` names the JAX kernel variant ('split',
    'fused', 'unfused' or the legacy bools); all of them compute this
    one function, and one kernel serves them.  chunks_per_step = k > 1
    is JAX's step of k chunks, which must share a tile (checked; raises
    otherwise); the kernel counts tile by tile, so k changes nothing
    else.  CUDA tensors launch the chunk vote kernel (csrc/chunk_vote.cu)
    on the current stream and wait for its order flag; CPU tensors run
    chunk_counts_plain.  ``chunk_counts.launches`` counts kernel
    launches."""
    _variant_name(variant)
    _check_chunk_args(chunk_pos, chunk_vocab, chunk_tile, n_tiles, tile_p,
                      e_sub)
    _check_steps(chunk_tile, chunks_per_step)
    if chunk_pos.device.type == "cpu":
        _check_tile_order(chunk_tile)
        return chunk_counts_plain(chunk_pos, chunk_vocab, chunk_tile,
                                  n_tiles, tile_p, e_sub)
    if chunk_pos.device.type != "cuda":
        raise ValueError(f"chunk_counts: unsupported device "
                         f"{chunk_pos.device}")
    out, plan = chunk_vote_launch(chunk_pos, chunk_vocab, chunk_tile,
                                  n_tiles, tile_p, e_sub)
    if int(plan[n_tiles + 1]):
        raise ValueError(_ORDER)
    return out


chunk_counts.launches = 0


def dense_counts_chunks(
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    tile_p: int = TILE_P,
    e_sub: int = E_SUB,
    use_int8: bool = True,
    fused: Union[bool, str] = "split",
    chunks_per_step: int = 1,
    device="cuda",
) -> torch.Tensor:
    """(8, P) int32 dense vote counts on ``device`` through the chunk
    vote kernel (counterpart of dense_counts_pallas).  ``use_int8``
    picked the TPU matrix unit's operand type; the counts are exact
    either way, so it changes nothing here and is accepted for the same
    calls.  chunks_per_step = k > 1 packs with chunk_multiple=k."""
    del use_int8
    variant = _variant_name(fused)
    chunk_pos, chunk_vocab, chunk_tile, n_tiles = prepare_chunks(
        pos, vocab, num_positions, tile_p, e_sub,
        chunk_multiple=chunks_per_step,
    )
    out = chunk_counts(
        torch.from_numpy(chunk_pos).to(device),
        torch.from_numpy(chunk_vocab).to(device),
        torch.from_numpy(chunk_tile).to(device), n_tiles, tile_p, e_sub,
        chunks_per_step=chunks_per_step, variant=variant,
    )
    return out[:, :num_positions]
